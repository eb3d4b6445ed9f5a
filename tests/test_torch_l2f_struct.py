"""The port's struct-path learned early fixing (``train/l2f_struct.py``)
and its mega driver against the JAX package (CPU), at the size of
``tests/test_mega_l2f.py`` (one CA instance of 50 items x 300 bids).

Tolerances: the window decisions and margins equal (the same scorer on
both sides); ``host_fix_compact`` from the same carried state: the
reduced E, b, f_eff, masks, kept rows, the fixing snapshot and the
n-side state equal, the m-side state and ex to 1e-6, the Schur blocks to
1e-5 of max |ref| (one float64 host build each, its dense products in
another order); ``report_full`` equal.  The whole ``l2f_solve_struct``
at a short depth (two 25-iteration windows scored by the last iterate,
a 50-iteration tail) equal to the JAX package's, report for report.  At
mega_l2f's defaults with ``ca500_mha`` carried across, where 300 policy
iterations and the tail are chaotic (iterates 1e-3 apart after 100
iterations, O(1) after 300): both sides decide most variables and within
5% of n of one another's count, 0 infeasible rows, and objectives within
7% of one another.  Readings behind those two bounds (seeds 5-10,
``PYTHONPATH=. python tests/test_torch_l2f_struct.py``, PERF.md §6):
the JAX package against itself, and the port against itself, with b
scaled by 1 + 2^-21 (a few ulps), and the two packages against each
other, differ by at most 3.0% of n in decided count and 6.63% in
objective; a planted fault of fix_windows 3 moves the count by 10-15%
of n.  At this size the converged objective does not separate sound
rounding from a faulty tail (no tail at all lands 0-17.7% worse, past
7% on three of the six seeds), so the short run is the exact check and
the 7% bound a guard against gross faults.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpbox_admm_tpu.adapters import ca as jca
from lpbox_admm_tpu.config import LP_CONFIG as JLP, PolicyConfig as JPC
from lpbox_admm_tpu.core import lp as jlp
from lpbox_admm_tpu.train import l2f_struct as jls
from lpbox_admm_tpu_torch.config import LP_CONFIG as TLP
from lpbox_admm_tpu_torch.core import lp as tlp
from lpbox_admm_tpu_torch.scripts import mega_l2f as tmega
from lpbox_admm_tpu_torch.train import l2f_struct as tls

from torch_port_util import CKPT, flax_variables_from_npz, np_of, torch_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import mega_l2f as jmega  # noqa: E402  (the JAX package's driver)

CFG_J = JLP.replace(linsolve="woodbury")
CFG_T = TLP.replace(linsolve="woodbury")


@pytest.fixture(scope="module")
def inst():
    return jca.generate_cauction(np.random.RandomState(5), n_items=50,
                                 n_bids=300, return_coo=True)


@pytest.fixture(scope="module")
def carried(inst):
    """The JAX struct problem after 30 iterations, and the port's
    problem with that state carried across."""
    jp, jg, jrm = jmega.build_struct(inst, width_cap=12)
    js = jlp.init_state(jp, CFG_J, ginv=jg)
    js, _ = jlp.solve_window(js, jp, CFG_J, 30, record=False, skip_cvg_at=0)
    tp, tg, trm = tmega.build_struct(inst, device="cpu")
    return jp, js, jrm, tp, torch_state(js), trm


def _vec(x, n_valid, lo=0.1, hi=0.9):
    v = np.full(x.shape[-1], -1.0, np.float32)
    xv = np_of(x)[0, :n_valid]
    v[:n_valid] = np.where(xv > hi, 1.0, np.where(xv < lo, 0.0, -1.0))
    return v


def _last(rows):
    return np.clip(np_of(rows)[:, -1], 0.0, 1.0)


def test_window_decisions_and_margins_match_jax():
    rng = np.random.RandomState(0)
    traj = rng.rand(400, 300).astype(np.float32)
    # half the variables settle near 0 or 1 (within 0.03)
    near = np.where(rng.rand(200, 1) < 0.5, 1.0 - 0.03 * traj[:200],
                    0.03 * traj[:200])
    traj[:200] = near.astype(np.float32)
    b = -rng.rand(400) * 100
    for dg in (0.0, 0.25):
        mj = jls.gate_margins(b, 0.98, dg)
        mt = tls.gate_margins(b, 0.98, dg)
        np.testing.assert_array_equal(mt, mj)
        vj, sj = jls.window_decisions(
            traj, lambda r: jnp.clip(r[:, -1], 0.0, 1.0), 100, 0.9, 2, 3,
            margins=mj)
        vt, st = tls.window_decisions(
            traj, lambda r: torch.clamp(r[:, -1], 0.0, 1.0), 100, 0.9, 2, 3,
            margins=mt, device="cpu")
        np.testing.assert_array_equal(vt, vj)
        for a, c in zip(st, sj):
            np.testing.assert_array_equal(a, np.asarray(c))
        assert (vt >= 0).sum() > 0
    with pytest.raises(ValueError, match="recorded iterations"):
        tls.window_decisions(traj, _last, 100, 0.9, 2, 4, device="cpu")


@pytest.mark.parametrize("schur", [False, True])
def test_host_fix_compact_matches_jax(inst, carried, schur):
    jp, js, jrm, tp, ts, trm = carried
    n_valid = len(inst[0])
    vec = _vec(js.x, n_valid)
    kw = dict(align=128, e_dtype="float32")
    rj, pj, cj = jls.host_fix_compact(
        js, jp, inst, jrm[0], vec, CFG_J,
        m1_full=jp.E.m1 if schur else None, **kw)
    rt, pt, ct = tls.host_fix_compact(
        ts, tp, inst, trm[0], vec, CFG_T,
        m1_full=tp.E.m1 if schur else None, **kw)
    for f in ("b", "E", "f", "row_mask", "var_mask"):
        np.testing.assert_array_equal(np_of(getattr(pt, f)),
                                      np.asarray(getattr(pj, f)))
    for k in ("free_cols", "fixed_vals", "free_new", "b_orig", "n_valid"):
        np.testing.assert_array_equal(ct[k], cj[k])
    assert (ct["C"] != cj["C"]).nnz == 0
    for f in ("x", "y1", "y2", "z1", "z2", "free", "fixed_val", "f_eff",
              "best_sol", "x_prev", "obj_count", "done", "sum_fix_obj",
              "fix_count"):
        np.testing.assert_array_equal(np_of(getattr(rt, f)),
                                      np.asarray(getattr(rj, f)), err_msg=f)
    for f in ("y3", "z4", "ex", "et_next"):
        a, b = np_of(getattr(rt, f)), np.asarray(getattr(rj, f))
        assert np.abs(a - b).max() <= 1e-6 * max(1.0, np.abs(b).max()), f
    assert rt.it == int(rj.it) == 30
    if schur:
        for a, b in zip((rt.ginv.sinv, rt.ginv.b12, rt.ginv.dinv), rj.ginv):
            b = np.asarray(b)
            assert np.abs(np_of(a) - b).max() <= 1e-5 * np.abs(b).max()
    else:
        b = np.asarray(rj.ginv)
        assert np.abs(np_of(rt.ginv) - b).max() <= 1e-5 * np.abs(b).max()
    # the same reduced problem solved on: report_full equal on equal states
    assert tls.report_full(rt, ct, oracle=-1.0) == \
        jls.report_full(rj, cj, oracle=-1.0)


def test_report_full_matches_jax_after_windows(inst, carried):
    """``report_full`` of the JAX package's own reduced state after 200
    tail iterations, carried across, equals the JAX package's."""
    jp, js, jrm, tp, ts, trm = carried
    vec = _vec(js.x, len(inst[0]), 0.05, 0.95)
    rj, pj, cj = jls.host_fix_compact(js, jp, inst, jrm[0], vec, CFG_J,
                                      align=128, e_dtype="float32",
                                      m1_full=jp.E.m1)
    rj, _ = jlp.solve_window(rj, pj, CFG_J, 200, record=False)
    _, _, ct = tls.host_fix_compact(ts, tp, inst, trm[0], vec, CFG_T,
                                    align=128, e_dtype="float32",
                                    m1_full=tp.E.m1)
    oracle = -3800.0
    got = tls.report_full(torch_state(rj), ct, oracle=oracle)
    assert got == jls.report_full(rj, cj, oracle=oracle)
    assert got["n_fixed"] == int((vec >= 0).sum())


def test_l2f_solve_struct_short_run_matches_jax(inst, monkeypatch):
    """The whole solve at a short depth, where the iterates stay close
    enough for every rounding to agree: two recorded windows of 25
    iterations scored by their last iterate, one host fix and compaction,
    two 25-iteration tail windows at the tail rho; the report (objective,
    infeasible rows, fixes, reduced size, iterations) equal to the JAX
    package's.  Planted faults that must show: the tail at the policy
    phase's rho, and one more free bid fixed to 0."""
    kw = dict(conf=0.8, ws=25, policy_windows=2, cap=100, window=25)
    keys = ("obj", "infeasible", "n_fixed", "decided", "n_red",
            "iterations", "red_shape")
    jp, jg, jrm = jmega.build_struct(inst, width_cap=12)
    oj = jls.l2f_solve_struct(jp, jg, inst, jrm[0],
                              lambda r: jnp.clip(r[:, -1], 0.0, 1.0),
                              CFG_J, **kw)
    tp, tg, trm = tmega.build_struct(inst, device="cpu")

    def run(**extra):
        out = tls.l2f_solve_struct(tp, tg, inst, trm[0],
                                   lambda r: torch.clamp(r[:, -1], 0.0, 1.0),
                                   CFG_T, **kw, **extra)
        return {k: out[k] for k in keys}

    want = {k: oj[k] for k in keys}
    want["red_shape"] = tuple(want["red_shape"])
    assert run() == want
    assert want["decided"] > 0.5 * len(inst[0]) and want["iterations"] == 100
    assert run(tail_rho=None)["obj"] != want["obj"]
    decide = tls.deter_fix_2

    def one_more_fixed(*a):
        vec = decide(*a)
        vec[np.flatnonzero(vec[:len(inst[0])] < 0)[0]] = 0.0
        return vec

    monkeypatch.setattr(tls, "deter_fix_2", one_more_fixed)
    assert run() != want


def test_l2f_solve_struct_matches_jax(inst):
    """The whole solve with ``ca500_mha`` on both sides (the JAX policy's
    flax forward, the port's module forward on the CPU) at mega_l2f's
    defaults, the tail capped at 4000 iterations as
    ``tests/test_mega_l2f.py`` caps it (bounds: the module docstring)."""
    from lpbox_admm_tpu.models.policy import build_policy
    from lpbox_admm_tpu.train import l2f as jl2f
    variables = flax_variables_from_npz(CKPT["mha"])
    model, pcfg = build_policy("mha"), JPC(net="mha")
    jscore = jax.jit(lambda r: jl2f.policy_scores(model, variables, r, pcfg))
    jp, jg, jrm = jmega.build_struct(inst, width_cap=12)
    oj = jls.l2f_solve_struct(jp, jg, inst, jrm[0], jscore, CFG_J, cap=4000)
    tp, tg, trm = tmega.build_struct(inst, device="cpu")
    ot = tls.l2f_solve_struct(tp, tg, inst, trm[0],
                              tmega.make_scorer(CKPT["mha"], 100, "cpu"),
                              CFG_T, cap=4000)
    assert ot["infeasible"] == oj["infeasible"] == 0
    assert ot["decided"] > 0.5 * ot["n_valid"]
    assert abs(ot["decided"] - oj["decided"]) <= 0.05 * ot["n_valid"]
    assert ot["red_shape"] == tuple(oj["red_shape"])
    assert abs(ot["obj"] - oj["obj"]) <= 0.07 * abs(oj["obj"])
    assert ot["iterations"] <= 4000 + 500


def test_mega_driver_phases_on_cpu(tmp_path, inst):
    """``python -m lpbox_admm_tpu_torch.scripts.mega_l2f``'s phases on
    the CPU at 50 x 300: gen caches the instance the generator makes,
    labels writes a dataset, transfer scores it, l2f solves it."""
    common = ["--rung", "50x300", "--seeds", "5", "--cache", str(tmp_path),
              "--device", "cpu"]
    tmega.main(["--phase", "gen"] + common)
    got = tmega.get_instance(50, 300, "5", str(tmp_path))
    np.testing.assert_array_equal(got[0], inst[0])
    for a, b in zip(got[1][:3], inst[1][:3]):
        np.testing.assert_array_equal(a, b)
    tmega.main(["--phase", "labels", "--cap", "1500", "--record", "300",
                "--rho-step", "12"] + common)
    with np.load(tmega.ds_path(50, 300, "5", str(tmp_path))) as z:
        assert z["traj"].shape == (300, 300) and int(z["infeas"]) == 0
    tmega.main(["--phase", "transfer", "--conf-grid", "0.98"] + common)
    out = tmega.main(["--phase", "l2f", "--cap", "1500"] + common)
    assert out["infeasible"] == 0 and out["decided"] > 0


def spread_readings(seeds=(5, 6, 7, 8, 9, 10), cap=4000):
    """The readings behind the bounds of ``test_l2f_solve_struct_matches_
    jax``: per seed, decided count and objective of the JAX package and
    of the port, each as is and with b scaled by 1 + 2^-21, and of the
    port with two planted faults (fix_windows 3; no tail)."""
    import dataclasses
    from lpbox_admm_tpu.models.policy import build_policy
    from lpbox_admm_tpu.train import l2f as jl2f
    variables = flax_variables_from_npz(CKPT["mha"])
    model, pcfg = build_policy("mha"), JPC(net="mha")
    jscore = jax.jit(lambda r: jl2f.policy_scores(model, variables, r, pcfg))
    tscore = tmega.make_scorer(CKPT["mha"], 100, "cpu")
    eps = 1.0 + 2.0 ** -21
    for seed in seeds:
        inst = jca.generate_cauction(np.random.RandomState(seed), n_items=50,
                                     n_bids=300, return_coo=True)
        jp, jg, jrm = jmega.build_struct(inst, width_cap=12)
        tp, tg, trm = tmega.build_struct(inst, device="cpu")
        runs = {
            "jax": lambda: jls.l2f_solve_struct(jp, jg, inst, jrm[0], jscore,
                                                CFG_J, cap=cap),
            "jax, b perturbed": lambda: jls.l2f_solve_struct(
                jp._replace(b=jp.b * eps), jg, inst, jrm[0], jscore, CFG_J,
                cap=cap)}
        for name, p, kw in (
                ("port", tp, {}),
                ("port, b perturbed", dataclasses.replace(tp, b=tp.b * eps),
                 {}),
                ("port, planted fix_windows 3", tp, {"fix_windows": 3}),
                ("port, planted no tail", tp, {"cap": 300})):
            runs[name] = lambda p=p, kw=kw: tls.l2f_solve_struct(
                p, tg, inst, trm[0], tscore, CFG_T, **{"cap": cap, **kw})
        for name, run in runs.items():
            out = run()
            print(f"seed {seed} {name}: decided {out['decided']} of "
                  f"{out['n_valid']}, obj {out['obj']:.4f}, infeasible "
                  f"{out['infeasible']}", flush=True)


if __name__ == "__main__":
    spread_readings()


def test_mega_train_phase_matches_jax(tmp_path, monkeypatch):
    """``--phase train`` at 50 x 300 on two seeds (5 trains, 6 is held
    out), one epoch from ``ca500_mha``: the port's held-out proxy equals
    the JAX package's ``phase_train``'s (its ``transfer_report`` on the
    same datasets) to 1e-6, and the best checkpoint the port writes loads
    in the JAX package and scores as the port's module does."""
    import argparse
    from lpbox_admm_tpu.config import LP_CONFIG as JLP_
    from lpbox_admm_tpu.models.policy import build_policy as jbuild
    from lpbox_admm_tpu.train import l2f as jl2f
    from lpbox_admm_tpu.train.imitation import PolicyTrainer as JTrainer
    from lpbox_admm_tpu_torch.config import PolicyConfig as TPC
    from lpbox_admm_tpu_torch.train import l2f as tl2f
    from lpbox_admm_tpu_torch.utils.checkpoint import load_policy
    cache = str(tmp_path)
    common = ["--rung", "50x300", "--seeds", "5,6", "--cache", cache,
              "--device", "cpu"]
    tmega.main(["--phase", "labels", "--cap", "1500", "--record", "300",
                "--rho-step", "12"] + common)
    # conf 0.9 and a target fraction above the fixed one, so that both
    # terms of the proxy are live
    train = ["--epochs", "1", "--init-ckpt", CKPT["mha"], "--conf", "0.9",
             "--target-frac", "0.95"]
    out = tmega.main(["--phase", "train", "--save-dir",
                      str(tmp_path / "port")] + train + common)
    reports = []
    real = jmega.transfer_report

    def record(*a, **k):
        reports.append(real(*a, **k))
        return reports[-1]

    monkeypatch.setattr(jmega, "transfer_report", record)
    monkeypatch.setattr(jmega, "ds_path",
                        lambda i, b, s: tmega.ds_path(i, b, s, cache))
    args = argparse.Namespace(
        holdout="6", lr=1e-4, ws=100, save_dir=str(tmp_path / "jax"),
        n_items=50, n_bids=300, episodes=5, init_ckpt=CKPT["mha"],
        seed_rng=0, conf=0.9, fix_windows=2, policy_windows=3,
        target_frac=0.95, epochs=1)
    jmega.phase_train(args, ["5", "6"])
    nf, _, mass = reports[-1]
    with np.load(tmega.ds_path(50, 300, "6", cache)) as z:
        n, obj = len(z["labels"]), float(z["obj"])
    proxy_jax = mass / abs(obj) + 0.05 * max(0.0, 0.95 - nf / n)
    assert out["best_epoch"] == 0 and 0 < nf < 0.95 * n
    assert abs(out["best_proxy"] - proxy_jax) <= 1e-6
    path = str(tmp_path / "port" / "checkpoint" / "best_checkpoint.npz")
    jt = JTrainer(jbuild("mha"), JPC(net="mha", node_size=20), JLP_, ws=100)
    jvars = jt.variables(jt.load(path))
    rows = np.random.RandomState(0).rand(64, 100).astype(np.float32)
    got = np_of(tl2f.policy_scores(load_policy(path, device="cpu"),
                                   torch.from_numpy(rows), TPC(net="mha")))
    want = np.asarray(jl2f.policy_scores(jbuild("mha"), jvars,
                                         jnp.asarray(rows), JPC(net="mha")))
    assert np.abs(got - want).max() <= 1e-5


def test_l2f_solve_struct_stage_spans(inst):
    """The struct solve's stage times are the tracer's spans: every
    ``timings`` key that ``scripts/mega_l2f.py`` prints, the policy
    windows and their scoring inside ``policy_s``, the compaction's six
    stages inside ``compact_s``."""
    tp, tg, trm = tmega.build_struct(inst, device="cpu")
    tm = {}
    out = tls.l2f_solve_struct(tp, tg, inst, trm[0],
                               lambda r: torch.clamp(r[:, -1], 0.0, 1.0),
                               CFG_T, conf=0.8, ws=25, policy_windows=2,
                               cap=100, window=25, timings=tm)
    assert set(tm) == {"win_s", "score_s", "fetch_s", "scipy_s",
                       "assemble_s", "ginv_s", "upload_s", "refresh_s"}
    assert 0 < tm["win_s"] + tm["score_s"] <= out["policy_s"]
    stages = sum(tm[k] for k in ("fetch_s", "scipy_s", "assemble_s",
                                 "ginv_s", "upload_s", "refresh_s"))
    assert 0 < stages <= out["compact_s"]
    assert out["tail_s"] > 0 and out["iterations"] == 100
