"""The port's segmentation workload against the JAX package's on the CPU:
the adapter, the datasets, learned early fixing with the shipped
``seg_mha`` policy (masked and compacting), the boundary refinement,
the ``run_seg`` entry point end to end, and the referee constants of
``chip_smoke.py``'s seg phase.  Images are synthetic (the smoke's
recipe), at 24 x 32 and 40 x 40."""

import os
import sys
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpbox_admm_tpu import config as jconfig
from lpbox_admm_tpu.adapters import segmentation as jseg
from lpbox_admm_tpu.models.policy import build_policy as jbuild_policy
from lpbox_admm_tpu.train import imitation as jim
from lpbox_admm_tpu.train import l2f as jl2f
from lpbox_admm_tpu_torch import config as tconfig
from lpbox_admm_tpu_torch.adapters import segmentation as tseg
from lpbox_admm_tpu_torch.core import general as tgeneral
from lpbox_admm_tpu_torch.core import qp as tqp
from lpbox_admm_tpu_torch.train import imitation as tim
from lpbox_admm_tpu_torch.train import l2f as tl2f
from lpbox_admm_tpu_torch.utils.checkpoint import load_policy

from torch_port_util import (ROOT, SEG_CKPT, flax_variables_from_npz,
                             seg_images, seg_pcfg, seg_referee)

JCFG, TCFG = jconfig.SEG_CONFIG, tconfig.SEG_CONFIG


def test_cost_construction_matches_jax():
    for H, W in ((24, 32), (40, 40)):
        ims = seg_images(7, 3, H, W)
        I = ims[0]
        for a, b in zip(tseg.unary_cost(I), jseg.unary_cost(I)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(tseg.binary_weights(I),
                                      jseg.binary_weights(I))
        for a, b in zip(tseg.image_to_qp(I), jseg.image_to_qp(I)):
            np.testing.assert_array_equal(a, b)
        # mixed sizes pad with mask False
        mixed = ims[:2] + [ims[2][:H - 3, :W - 5]]
        jp = jseg.make_problem(mixed)
        tp = tseg.make_problem(mixed, device="cpu")
        assert tp.grid == (H, W) and tp.b.shape == (3, H, W)
        np.testing.assert_array_equal(tp.stencil.weights.numpy(),
                                      np.asarray(jp.stencil.weights))
        np.testing.assert_array_equal(tp.stencil.degree.numpy(),
                                      np.asarray(jp.stencil.degree))
        for f in ("b", "const", "mask"):
            np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                          np.asarray(getattr(jp, f)))
        ap = tseg.make_problem(mixed, align=True, device="cpu")
        assert ap.grid == (-(-H // 8) * 8, 128)


def test_image_recipe_is_the_smokes():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    for a, b in zip(chip_smoke.seg_images(5, 2, 24, 32),
                    seg_images(5, 2, 24, 32)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("band,gate", [(0, 1.0), (1, 1.0), (2, 0.5),
                                       (3, 1.0)])
def test_boundary_margins_match_jax(band, gate):
    rng = np.random.RandomState(band)
    x = rng.rand(2, 24, 32).astype(np.float32)
    mask = np.ones((2, 24, 32), bool)
    mask[1, :, 27:] = False
    mask[1, 20:] = False
    m = np.full(x.shape, 0.1, np.float32)
    kw = dict(boundary_band=band, boundary_gate=gate)
    ref = jl2f.qp_boundary_margins(jnp.asarray(x), jnp.asarray(mask),
                                   jnp.asarray(m), seg_pcfg(jconfig, **kw))
    got = tl2f.qp_boundary_margins(torch.from_numpy(x),
                                   torch.from_numpy(mask),
                                   torch.from_numpy(m), seg_pcfg(tconfig, **kw))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.fixture(scope="module")
def seg40():
    """Two 40 x 40 images in both packages, the plain datasets (test
    protocol's polish) and the seg_mha policy of each."""
    ims = seg_images(11, 2, 40, 40)
    jp = jseg.make_problem(ims)
    tp = tseg.make_problem(ims, device="cpu")
    jds = jim.build_dataset_qp(jp, JCFG, record_iters=50, repair_sweeps=8,
                               pair_sweeps=4)
    tds = tim.build_dataset_qp(tp, TCFG, record_iters=50, repair_sweeps=8,
                               pair_sweeps=4)
    model = load_policy(SEG_CKPT, node_size=5, chunk_dim=5, device="cpu")
    return dict(jp=jp, tp=tp, jds=jds, tds=tds, model=model,
                jmodel=jbuild_policy("mha"),
                jvars=flax_variables_from_npz(SEG_CKPT))


def test_build_dataset_qp_matches_jax(seg40):
    jds, tds = seg40["jds"], seg40["tds"]
    assert tds.traj.shape == (2, 1600, 50) and tds.labels.shape == (2, 1600)
    agree = (tds.labels.numpy() == np.asarray(jds.labels)).mean()
    assert agree >= 0.99, agree
    np.testing.assert_allclose(tds.oracle_obj.numpy(),
                               np.asarray(jds.oracle_obj), rtol=1e-3)
    np.testing.assert_allclose(tds.traj.numpy(), np.asarray(jds.traj),
                               rtol=0, atol=1e-3)
    assert tds.oracle_iters == int(jds.oracle_iters)


def _metrics(l2f_mod, state, prob, ds):
    return l2f_mod.l2f_metrics_qp(state, prob, ds.oracle_obj,
                                  ds.labels.reshape(prob.b.shape),
                                  repair_sweeps=8, pair_sweeps=4)


@pytest.mark.parametrize("mode", ["masked", "compact"])
def test_l2f_seg_mha_matches_jax(seg40, mode):
    """The test protocol (ws 10, 30 iterations, repair 8, pair 4) with
    seg_mha: pixels fixed within 2% and energies within 1% of JAX's."""
    s = seg40
    jfn = jl2f.l2f_solve if mode == "masked" else jl2f.l2f_solve_compact_qp
    tfn = tl2f.l2f_solve if mode == "masked" else tl2f.l2f_solve_compact_qp
    kw = {} if mode == "masked" else {"min_bucket": 64}
    js = jfn(s["jp"], s["jmodel"], s["jvars"], JCFG, seg_pcfg(jconfig),
             ws=10, max_iter=30, **kw)
    ts = tfn(s["tp"], s["model"], TCFG, seg_pcfg(tconfig), ws=10,
             max_iter=30, **kw)
    jm = _metrics(jl2f, js, s["jp"], s["jds"])
    tm = _metrics(tl2f, ts, s["tp"], s["tds"])
    jfix = np.asarray(jm["n_fixed"], float)
    assert (jfix > 0).all()
    np.testing.assert_allclose(tm["n_fixed"].numpy(), jfix, rtol=0.02)
    np.testing.assert_allclose(tm["energy"].numpy(),
                               np.asarray(jm["energy"]), rtol=0.01)
    assert ts.it == int(js.it) == 30


def test_l2f_gates_match_jax(seg40):
    """The masked path's grid-only options: the boundary gate every
    window, trajectory-extremity fixes limited to the first event, the
    |b|-rank gate, and the label-floor override."""
    s = seg40
    kw = dict(boundary_gate=1.0, boundary_band=2, traj_fix_thr=0.3,
              traj_fix_windows=1, damage_gate=0.5)
    js = jl2f.l2f_solve(s["jp"], s["jmodel"], s["jvars"], JCFG,
                        seg_pcfg(jconfig, **kw), ws=10, max_iter=30)
    ts = tl2f.l2f_solve(s["tp"], s["model"], TCFG, seg_pcfg(tconfig, **kw),
                        ws=10, max_iter=30)
    jfix = np.asarray(((~js.free) & s["jp"].mask).sum((-2, -1)), float)
    tfix = ((~ts.free) & s["tp"].mask).sum((-2, -1)).numpy()
    np.testing.assert_allclose(tfix, jfix, rtol=0.02)
    # pure trajectory fixing needs no policy
    only = dict(traj_fix_thr=0.3, traj_fix_only=True)
    js = jl2f.l2f_solve(s["jp"], s["jmodel"], s["jvars"], JCFG,
                        seg_pcfg(jconfig, **only), ws=10, max_iter=20)
    ts = tl2f.l2f_solve(s["tp"], s["model"], TCFG,
                        seg_pcfg(tconfig, **only), ws=10, max_iter=20)
    np.testing.assert_allclose(
        ((~ts.free) & s["tp"].mask).sum((-2, -1)).numpy(),
        np.asarray(((~js.free) & s["jp"].mask).sum((-2, -1)), float),
        rtol=0.02)
    # the label floor: fixed values are the oracle's labels
    labels = s["tds"].labels.reshape(s["tp"].b.shape)
    st = tl2f.l2f_solve(s["tp"], s["model"], TCFG, seg_pcfg(tconfig), ws=10,
                        max_iter=30, fix_values=labels)
    fixed = ~st.free & s["tp"].mask
    assert fixed.sum() > 0
    assert (st.fixed_val[fixed] == labels[fixed]).all()


def test_masked_equals_compact_and_recompaction_keeps_fixes(seg40,
                                                            monkeypatch):
    """As the JAX package's test asserts (its test_segmentation.py
    :403-444): the compacting path gives the masked path's quality and
    fixes.  Its re-compaction must persist the fixes made inside the
    flat problem (``_persist_fix_snapshot``): without it the pixels
    fixed there and dropped by the smaller bucket come back with the
    stale snapshot's value 0, and the fixed values part from the masked
    path's.  Confidence 0.7 fixes enough
    per window (227 -> 103 free pixels) for the bucket to halve."""
    s = seg40
    prob, model = s["tp"], s["model"]
    pcfg = seg_pcfg(tconfig, fix_confidence=0.7)
    calls = []
    real = tgeneral.compact_sparse

    def spy(*a, **k):
        calls.append(a[2])
        return real(*a, **k)

    monkeypatch.setattr(tgeneral, "compact_sparse", spy)
    st_a = tl2f.l2f_solve(prob, model, TCFG, pcfg, ws=10, max_iter=40)
    st_b = tl2f.l2f_solve_compact_qp(prob, model, TCFG, pcfg, ws=10,
                                     max_iter=40, min_bucket=64)
    assert calls, "the compact path re-compacted"
    sol_a, e_a = tqp.select_solution(st_a, prob)
    sol_b, e_b = tqp.select_solution(st_b, prob)
    m = prob.mask
    assert (sol_a == sol_b)[m].float().mean() >= 0.99
    np.testing.assert_allclose(e_b.numpy(), e_a.numpy(), rtol=0.01)
    fixed_a = (~st_a.free & m).sum((-2, -1))
    fixed_b = (~st_b.free & m).sum((-2, -1))
    np.testing.assert_array_equal(fixed_b.numpy(), fixed_a.numpy())
    both = ~st_a.free & ~st_b.free & m
    np.testing.assert_array_equal(st_b.fixed_val[both].numpy(),
                                  st_a.fixed_val[both].numpy())
    # without the snapshot the fixes made in the flat problem are lost
    monkeypatch.setattr(tl2f, "_persist_fix_snapshot",
                        lambda g, idx, free, fixed: (free, fixed))
    st_c = tl2f.l2f_solve_compact_qp(prob, model, TCFG, pcfg, ws=10,
                                     max_iter=40, min_bucket=64)
    both = ~st_a.free & ~st_c.free & m
    lost = (st_c.fixed_val[both] != st_a.fixed_val[both]).sum().item()
    assert lost > 0 and (st_c.fixed_val[both] <= st_a.fixed_val[both]).all()


def test_compact_path_warns_on_traj_flags(seg40):
    s = seg40
    pcfg = seg_pcfg(tconfig, traj_fix_thr=0.3)
    with pytest.warns(UserWarning, match="traj_fix_thr"):
        st = tl2f.l2f_solve_compact_qp(s["tp"], s["model"], TCFG, pcfg,
                                       ws=10, max_iter=10)
    # ignored, as in the JAX package: the same fixes as without the flag
    ref = tl2f.l2f_solve_compact_qp(s["tp"], s["model"], TCFG,
                                    seg_pcfg(tconfig), ws=10, max_iter=10)
    np.testing.assert_array_equal(st.free.numpy(), ref.free.numpy())
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tl2f.l2f_solve_compact_qp(s["tp"], s["model"], TCFG,
                                  seg_pcfg(tconfig), ws=10, max_iter=10)


def test_qp_refine_boundary(seg40):
    """The refinement re-frees boundary-band fixed pixels only and never
    raises the selected energy; its re-free equals the JAX package's."""
    s = seg40
    prob = s["tp"]
    st = tl2f.l2f_solve(prob, s["model"], TCFG, seg_pcfg(tconfig), ws=10,
                        max_iter=30)
    n0 = (~st.free & prob.mask).sum((-2, -1))
    assert n0.max() > 0
    _, e0 = tqp.select_solution(st, prob, repair_sweeps=4)
    for band, rounds in ((1, 1), (2, 2)):
        st2 = tl2f.qp_refine_boundary(st, prob, TCFG, iters=10,
                                      rounds=rounds, band=band)
        _, e1 = tqp.select_solution(st2, prob, repair_sweeps=4)
        n1 = (~st2.free & prob.mask).sum((-2, -1))
        assert (n1 <= n0).all() and (n1 < n0).any()
        assert (e1 <= e0 + 1e-3).all(), (e0, e1)
    from test_torch_qp import torch_qp_state
    js = jl2f.l2f_solve(s["jp"], s["jmodel"], s["jvars"], JCFG,
                        seg_pcfg(jconfig), ws=10, max_iter=30)
    jr = jl2f.qp_refine_boundary(js, s["jp"], JCFG, iters=0, band=2)
    tr = tl2f.qp_refine_boundary(torch_qp_state(js), prob, TCFG, iters=0,
                                 band=2)
    for f in ("free", "fixed_val", "b_eff", "x", "z1"):
        np.testing.assert_array_equal(getattr(tr, f).numpy(),
                                      np.asarray(getattr(jr, f)), f)


def test_l2f_metrics_qp_match_jax(seg40):
    from test_torch_qp import torch_qp_state
    s = seg40
    js = jl2f.l2f_solve(s["jp"], s["jmodel"], s["jvars"], JCFG,
                        seg_pcfg(jconfig), ws=10, max_iter=20)
    labels = np.asarray(s["jds"].labels).reshape(2, 40, 40)
    jm = jl2f.l2f_metrics_qp(js, s["jp"], s["jds"].oracle_obj,
                             jnp.asarray(labels), 8, 4)
    tm = tl2f.l2f_metrics_qp(torch_qp_state(js), s["tp"],
                             torch.from_numpy(np.array(
                                 s["jds"].oracle_obj)),
                             torch.from_numpy(labels), 8, 4)
    for k, v in jm.items():
        np.testing.assert_array_equal(np.asarray(tm[k]), np.asarray(v), k)


def _write_pngs(d, images):
    from PIL import Image
    os.makedirs(d)
    for i, im in enumerate(images):
        Image.fromarray(np.round(im * 263).astype(np.uint8), mode="L").save(
            os.path.join(d, f"{i}.png"))


def test_run_seg_phases_on_cpu(tmp_path):
    """solve, train (1 epoch from seg_mha, full validation) and test of
    ``python -m lpbox_admm_tpu_torch.experiments.run_seg`` on PNGs."""
    from lpbox_admm_tpu_torch.experiments import run_seg
    from lpbox_admm_tpu_torch.utils import io as uio
    imgs = str(tmp_path / "images")
    _write_pngs(imgs, seg_images(13, 4, 24, 32))
    common = ["-image_dir", imgs, "-n", "4", "-n_eval", "2", "-num_nodes",
              "768", "-device", "cpu", "-result_dir",
              str(tmp_path / "result"), "-save_dir", str(tmp_path / "save")]
    logs = []
    ds = run_seg.main(["-phase", "solve"] + common, log=logs.append)
    assert ds.traj.shape == (4, 768, 50)
    assert len(uio.read_allres(str(tmp_path / "result" / "xiter_all.csv"))
               ) == 4
    assert uio.read_xiter_csv(str(tmp_path / "result" / "0.csv")).shape \
        == (768, 50)
    assert (tmp_path / "result" / "output_3.png").exists()
    tr = run_seg.main(["-phase", "train", "-num_epochs", "1",
                       "-init_checkpoint", SEG_CKPT, "-eval_semantics",
                       "full"] + common, log=logs.append)
    assert np.isfinite(tr["history"][0]["loss"])
    best = tmp_path / "save" / "checkpoint" / "best_checkpoint.npz"
    assert best.exists()
    out = run_seg.main(["-phase", "test", "-checkpoint", str(best)] + common,
                       log=logs.append)
    assert out["compact"]
    assert np.isfinite(out["energy_gap"]).all() and out["n_fixed"].sum() > 0
    assert (tmp_path / "result" / "l2f_output_3.png").exists()
    out0 = run_seg.main(["-phase", "test", "-checkpoint", str(best),
                         "-compact", "0", "-refine_iters", "5"] + common,
                        log=logs.append)
    assert not out0["compact"] and np.isfinite(out0["energy_gap"]).all()
    assert any(line.startswith("[l2f]") for line in logs)
    with pytest.raises(ValueError, match="mesh"):
        run_seg.main(["-phase", "test", "-mesh", "2"] + common)


def test_npy_images_load_without_pil(tmp_path):
    im = seg_images(2, 1, 24, 32)[0]
    np.save(tmp_path / "0.npy", im)
    np.testing.assert_array_equal(tseg.load_image(str(tmp_path / "0.npy")),
                                  im)
    assert tseg.reference_image_paths(str(tmp_path)) == []


def test_smoke_referee_constants():
    """chip_smoke.py's SEG_REFEREE is the JAX package's CPU run on the
    smoke's 1e4-px images, recomputed here."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    images = chip_smoke.seg_images(chip_smoke.SEG_SEED, chip_smoke.SEG_BATCH,
                                   *chip_smoke.SEG_GRID)
    got = seg_referee(images, ws=chip_smoke.SEG_WS,
                      max_iter=chip_smoke.SEG_MAX_ITER,
                      repair=chip_smoke.SEG_REPAIR, pair=chip_smoke.SEG_PAIR)
    assert got == chip_smoke.SEG_REFEREE


def test_policy_trainer_step_on_seg_windows_matches_jax(seg40):
    """``PolicyTrainer`` with the seg policy config (5 tokens of 5,
    sliding, ws 10) resumed from ``seg_mha``: the episode batch (5
    episodes) equals the JAX package's on the same trajectories, and one
    step on its first 2048 rows gives the JAX trainer's loss and
    gradient (test_torch_imitation's bounds)."""
    from test_torch_imitation import GRAD_TOL, _grad_distances
    from lpbox_admm_tpu_torch.models.policy import build_policy
    jds = seg40["jds"]
    jpc, tpc = seg_pcfg(jconfig), seg_pcfg(tconfig)
    jx, jl, jw = (np.array(a) for a in jim.episode_batch(jds, jpc, 10,
                                                         n_episodes=5))
    as_t = lambda a: torch.from_numpy(np.array(a))
    port_ds = tim.TrajectoryDataset(
        traj=as_t(jds.traj), labels=as_t(jds.labels),
        var_mask=as_t(jds.var_mask), oracle_obj=as_t(jds.oracle_obj),
        oracle_iters=int(jds.oracle_iters))
    tx, tl, tw = tim.episode_batch(port_ds, tpc, 10, n_episodes=5)
    assert tx.shape == (5 * 2 * 1600, 5, 5)
    for got, ref in ((tx, jx), (tl, jl), (tw, jw)):
        np.testing.assert_array_equal(got.numpy(), ref)
    jt = jim.PolicyTrainer(jbuild_policy("mha"), jpc, JCFG, ws=10,
                           micro_rows=1024)
    tt = tim.PolicyTrainer(build_policy("mha", 5, 5), tpc, TCFG, ws=10,
                           micro_rows=1024, device="cpu")
    x, lab, w = jx[:2048], jl[:2048], jw[:2048]
    _, loss_t, _, d, loss_j, _ = _grad_distances(
        jt, jt.load(SEG_CKPT), tt, tt.load(SEG_CKPT), x, lab, w)
    assert abs(float(loss_t) - loss_j) <= 1e-5 * abs(loss_j)
    assert min(d["port_64"], d["port_32"]) <= GRAD_TOL, d
