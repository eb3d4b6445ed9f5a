"""The port's segmentation path against the benchmark's plain reference
(``benchmark/reference_seg.py``, float64, written from the reference's
description and importing nothing of the port), on the CPU: the cost
builder, the energy, the grid iterations with the CG x-update, the
sliding K2 scorer's CPU twin, the fix rule, the compacted operand, the
descents; ``utils.checkpoint.load_policy``'s reading of a policy's shape;
and the traced ``train.l2f.l2f_solve_seg``.  Three synthetic images of
about 24 x 24 (the benchmark's recipe), a seeded random policy written
in the checkpoint format so that both sides read the same weights."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from benchmark import reference as ref
from benchmark import reference_seg as rs
from benchmark.kinds.seg import image, intensities
from lpbox_admm_tpu_torch.adapters import segmentation as seg
from lpbox_admm_tpu_torch.config import SEG_CONFIG, PolicyConfig
from lpbox_admm_tpu_torch.core import qp
from lpbox_admm_tpu_torch.models import fused_policy
from lpbox_admm_tpu_torch.models.policy import build_policy, init_weights
from lpbox_admm_tpu_torch.train import l2f
from lpbox_admm_tpu_torch.utils.checkpoint import load_policy, \
    variable_arrays

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPTS = {name: os.path.join(ROOT, "checkpoints", name, "checkpoint",
                            "best_checkpoint.npz")
         for name in ("ca500_mha", "seg_mha")}
CFG = dataclasses.asdict(SEG_CONFIG)
PCFG = PolicyConfig(node_size=5, chunk_dim=5, window_mode="sliding")


def _images():
    rng = np.random.RandomState(2024)
    return [intensities(image(rng, h, w)) for h, w in
            ((24, 24), (20, 24), (24, 18))]


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The images, the port's problem, the reference's padded costs, and
    a random seg-shaped policy saved in the checkpoint format."""
    ims = _images()
    prob = seg.make_problem(ims, device="cpu")
    H, W = prob.grid
    B = len(ims)
    Wr = torch.zeros((B, 8, H, W), dtype=torch.float64)
    br = torch.zeros((B, H, W), dtype=torch.float64)
    cr = torch.zeros(B, dtype=torch.float64)
    for i, im in enumerate(ims):
        w, b, c = rs.costs(im)
        h, wd = im.shape
        Wr[i, :, :h, :wd], br[i, :h, :wd], cr[i] = w, b, c
    model = init_weights(build_policy("mha", 5, 5, 5),
                         torch.Generator().manual_seed(7))
    path = str(tmp_path_factory.mktemp("policy") / "random.npz")
    np.savez(path, **variable_arrays(model))
    return dict(images=ims, prob=prob, W=Wr, b=br, c=cr, path=path)


def _ref_state(prob, state, b_eff):
    return {"x": state.x, "z1": state.z1, "z2": state.z2,
            "free": state.free, "b_eff": b_eff, "ring": state.obj_ring,
            "count": state.obj_count, "done": state.done, "it": state.it}


def test_cost_builder_is_the_references(case):
    # exact: integer weights and costs, the same float64 formulas
    prob = case["prob"]
    assert torch.equal(prob.stencil.weights.double(), case["W"])
    assert torch.equal(prob.b.double(), case["b"])
    assert torch.equal(prob.const.double(), case["c"])
    assert torch.equal(prob.stencil.degree.double(), case["W"].sum(1))


def test_energy_is_the_references(case):
    # exact: x^T A' x + b^T x + c of a binary labelling is an integer
    # that float32 holds
    prob = case["prob"]
    g = torch.Generator().manual_seed(1)
    for _ in range(3):
        x = (torch.rand(prob.b.shape, generator=g) < 0.5).float() \
            * prob.mask.float()
        want = rs.energy(case["W"], case["b"], case["c"], x)
        got = qp._energy(prob, x)
        assert torch.equal(got.double(), want)


@pytest.mark.parametrize("steps", [1, 20])
def test_grid_iterations_follow_float64(case, steps):
    # 1e-4: the CG x-update stops at a residual of 1e-3 of the
    # right-hand side in either precision, at the same iteration unless
    # a residual sits at the bar, so the trajectories part by float32
    # rounding alone (4e-7 here, as the reference's own float32 run
    # reads); the reference with TF32 stencil products reads 6.4e-4
    prob = case["prob"]
    st0 = qp.init_state(prob, SEG_CONFIG)
    st, traj = qp.solve_window(st0, prob, SEG_CONFIG, steps, record=True)
    want = rs.iterate(_ref_state(prob, st0, case["b"]), case["W"], CFG,
                      steps, "float64", record=True)
    m = prob.mask[..., None]
    err = ((traj.double() - want["traj"]).abs() * m).max()
    assert float(err) <= 1e-4
    assert want["it"] == st.it
    assert torch.equal(want["done"], st.done)


def test_sliding_scorer_twin_is_the_references(case):
    # 1e-5: the plain twin of K2 and the module's forward compute in
    # float32 over 5 tokens of 128 features; the reference in float64
    rows = torch.rand((515, 10), generator=torch.Generator().manual_seed(3))
    truth = ref.Policy(case["path"], 5, 5, 5, 8, "cpu", "float64")
    want = truth.scores(rs.unfold(rows, 5, 5))
    model = load_policy(case["path"], device="cpu")
    pk = fused_policy.pack_policy_weights(model)
    twin = fused_policy.policy_scores_fused(pk, rows, PCFG)
    module = l2f.policy_scores(model, rows, PCFG)
    assert float((twin.double() - want).abs().max()) <= 1e-5
    assert float((module.double() - want).abs().max()) <= 1e-5
    # the unfold is the program's: token t is row[t:t + 5]
    toks = l2f.traj_to_tokens(rows, PCFG)
    assert torch.equal(toks.reshape(515, -1), rs.unfold(rows, 5, 5))


@pytest.mark.parametrize("gate,band,damage", [(0.0, 2, 0.0),
                                              (0.5, 2, 0.3),
                                              (1.0, 1, 0.0)])
def test_fix_rule_is_the_references(case, gate, band, damage):
    # exact where the score is clear of every bar by 1e-4 (float32
    # margins against float64's)
    prob = case["prob"]
    pcfg = dataclasses.replace(PCFG, boundary_gate=gate, boundary_band=band,
                               damage_gate=damage)
    st, _ = qp.solve_window(qp.init_state(prob, SEG_CONFIG), prob,
                            SEG_CONFIG, 10, record=False)
    g = torch.Generator().manual_seed(5)
    sig = torch.rand(prob.b.shape, generator=g)
    sig = torch.where(sig < 0.5, sig * 0.2, 1.0 - (1.0 - sig) * 0.2)
    m = l2f.qp_boundary_margins(st.x, prob.mask,
                                l2f._grid_margins(prob, pcfg), pcfg)
    got = l2f._fix_vec(sig, m)
    B = prob.batch
    base = ref.fix_margins(case["b"].reshape(B, -1),
                           prob.mask.reshape(B, -1), pcfg.fix_confidence,
                           damage).reshape(prob.b.shape)
    mr = rs.gated_margins(base, st.x, prob.mask, gate, band)
    want = rs.fix_rule(sig.double(), mr)
    clear = ((sig - (1 - mr)).abs() > 1e-4) & ((sig - mr).abs() > 1e-4)
    live = prob.mask & clear
    assert live.sum() > 0.9 * prob.mask.sum()
    assert torch.equal(got.double()[live], want[live])
    if gate > 0:
        assert (mr < base).any()


def _fixed_state(case):
    """The port's state after a window and a fix of the pixels the
    iterate has settled (x > 0.8 to 1, x < 0.2 to 0)."""
    prob = case["prob"]
    st, _ = qp.solve_window(qp.init_state(prob, SEG_CONFIG), prob,
                            SEG_CONFIG, 10, record=False)
    vec = torch.where(st.x > 0.8, 1.0, torch.where(st.x < 0.2, 0.0, -1.0))
    st = qp.apply_fix(st, prob, vec, SEG_CONFIG, min_fix=0)
    return prob, st


def test_compacted_operand_is_the_references_restriction(case):
    # exact: the flat A'_ff and b_eff hold small integers
    prob, st = _fixed_state(case)
    B = prob.batch
    n = prob.grid[0] * prob.grid[1]
    nfree = st.free.reshape(B, -1).sum(-1)
    assert (nfree > 0).all() and (nfree < prob.mask.reshape(B, -1)
                                  .sum(-1)).all()
    n_new = int(nfree.max()) + 7
    gst, gprob, idx = qp.compact(st, prob, SEG_CONFIG, n_new)
    rows, b_eff = rs.restrict(case["W"], case["b"], st.free, st.fixed_val)
    for i in range(B):
        k = int(nfree[i])
        order, coo = rows[i]
        assert torch.equal(idx[i, :k], order)
        ri, rv = gprob.A.row_idx[i, :k], gprob.A.row_val[i, :k]
        r = torch.arange(k)[:, None].expand_as(ri).reshape(-1)
        got = rs.canonical(idx[i][r], idx[i][ri.reshape(-1)],
                           rv.reshape(-1), n)
        want = rs.canonical(*coo, n)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert torch.equal(gprob.b[i, :k].double(),
                           b_eff[i].reshape(-1)[order])
        assert gprob.var_mask[i, :k].all() and not gprob.var_mask[i, k:].any()


def test_descents_are_the_references(case):
    # exact: every energy change is an integer float32 holds
    prob = case["prob"]
    st, _ = qp.solve_window(qp.init_state(prob, SEG_CONFIG), prob,
                            SEG_CONFIG, 20, record=False)
    rnd = lambda v: torch.where(st.free, (v >= 0.5).double(),
                                st.fixed_val.double())
    for sweeps, pairs in ((0, 0), (8, 0), (8, 4), (2, 3)):
        sol, e = qp.select_solution(st, prob, repair_sweeps=sweeps,
                                    pair_sweeps=pairs)
        want, e_want = rs.select(case["W"], case["b"], case["c"], prob.mask,
                                 rnd(st.x), rnd(st.best_sol), sweeps, pairs)
        assert torch.equal(sol.double(), want)
        assert torch.equal(e.double(), e_want)


def test_load_policy_reads_the_shape_from_the_checkpoint(case):
    ca = load_policy(CKPTS["ca500_mha"], device="cpu")
    sg = load_policy(CKPTS["seg_mha"], device="cpu")
    assert ca.classifier.layers[0].in_features == 20 * 128
    assert sg.classifier.layers[0].in_features == 5 * 128
    assert load_policy(case["path"], node_size=5, chunk_dim=5,
                       device="cpu").classifier.layers[0].in_features == 640
    with pytest.raises(ValueError, match="node_size=20.*node_size=5"):
        load_policy(CKPTS["seg_mha"], node_size=20, device="cpu")
    with pytest.raises(ValueError, match="chunk_dim=4.*chunk_dim=5"):
        load_policy(CKPTS["ca500_mha"], chunk_dim=4, device="cpu")


def test_traced_seg_solve_reports_its_layers(case):
    """``l2f_solve_seg`` under the tracer: the same answer as untraced,
    the spans, counters and read sites the benchmark reads."""
    prob = case["prob"]
    model = load_policy(CKPTS["seg_mha"], device="cpu")
    pcfg = dataclasses.replace(PCFG, fix_confidence=0.7)
    kw = dict(ws=10, max_iter=30, min_bucket=64, repair_sweeps=8,
              pair_sweeps=4)
    _, plain = l2f.l2f_solve_seg(prob, model, SEG_CONFIG, pcfg, **kw)
    tm = {}
    st, out = l2f.l2f_solve_seg(prob, model, SEG_CONFIG, pcfg, timings=tm,
                                **kw)
    for k in ("solution", "energy", "n_fixed"):
        assert torch.equal(out[k], plain[k]), k
    assert out["iterations"] == plain["iterations"] == 30
    assert set(tm) >= {"grid_s", "seg_compact_s", "flat_s", "qp_select_s",
                       "cg_iters", "bucket", "host_reads",
                       "host_read_sites", "host_read_wait_s"}
    assert all(tm[k] > 0 for k in ("grid_s", "seg_compact_s", "flat_s",
                                   "qp_select_s"))
    sites = tm["host_read_sites"]
    assert sites["cg.run"] >= tm["cg_iters"] > 0
    assert sites["seg.bucket_n"] == 1 and sites["seg.done"] >= 1
    assert tm["host_reads"] == sum(sites.values())
    assert 64 <= tm["bucket"] < prob.grid[0] * prob.grid[1]
    # the selection is the energy's: the reported energy is the labelling's
    assert torch.equal(out["energy"].double(),
                       rs.energy(case["W"], case["b"], case["c"],
                                 out["solution"]))
