"""The port's LP solver against the JAX package on the same inputs (CPU).

* ``init_state`` and the Woodbury factors: 1e-4 relative (independent
  f32 Cholesky factorizations).
* One ``step`` from the same state: 1e-5 relative to the size of the
  terms each field is computed from -- x = (rhs - E^T u) / c cancels
  O(1e3) terms to an O(1) iterate, so x and E x are measured against
  max|rhs|/c and max|E rhs|/c, the duals against gamma*rho times those,
  the objective ring against max sum|b| times max|rhs|/c.
* ``lp_window_plain`` (K1's plain version) against
  ``lp_window_fused(interpret=True)``: 1e-3 after 20 iterations in every
  mode, as ``tests/test_pallas_lp.py`` holds the kernel.
* ``apply_fix``, ``compact``, ``scatter_solution``, ``select_solution``
  with eviction, refill and swap repair: binary/index outputs exactly,
  float outputs to f32 rounding (ties resolve to the lowest index in
  both packages).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpbox_admm_tpu.config import LP_CONFIG as JLP
from lpbox_admm_tpu.core import lp as jlp
from lpbox_admm_tpu.ops import pallas_lp, woodbury as jwb
from lpbox_admm_tpu_torch.config import LP_CONFIG as TLP
from lpbox_admm_tpu_torch.core import lp as tlp
from lpbox_admm_tpu_torch.ops import fused_lp, woodbury as twb

from torch_port_util import (ca_instances, np_of, problems, rel,
                             step_scales, torch_state)

CFG_J = JLP.replace(linsolve="woodbury")
CFG_T = TLP.replace(linsolve="woodbury")


@pytest.fixture(scope="module")
def probs():
    return problems(ca_instances(7, 4))


def test_init_state_and_factors(probs):
    jp, tp = probs
    js, ts = jlp.init_state(jp, CFG_J), tlp.init_state(tp, CFG_T)
    assert ts.it == 0
    for f in ("x", "y1", "y2", "y3", "z4", "f_eff", "ex", "et_next",
              "cur_obj", "best_bin_obj", "best_sol", "obj_ring"):
        assert rel(getattr(ts, f), getattr(js, f)) <= 1e-6, f
    for f in ("free", "done", "obj_count"):
        np.testing.assert_array_equal(np_of(getattr(ts, f)),
                                      np.asarray(getattr(js, f)))
    g_j = np.asarray(js.ginv)
    assert np.abs(np_of(ts.ginv) - g_j).max() <= 1e-4 * np.abs(g_j).max()
    nj = jwb.factorize_nside(jp.E, js.free, 2.0)
    nt = twb.factorize_nside(tp.E, ts.free, 2.0)
    for a, b in ((nt.hinv, nj.hinv), (nt.ete, nj.ete)):
        b = np.asarray(b)
        assert np.abs(np_of(a) - b).max() <= 1e-4 * np.abs(b).max()


@pytest.mark.parametrize("n_steps", [1, 2])
def test_step_matches_jax(probs, n_steps):
    jp, tp = probs
    js = jlp.init_state(jp, CFG_J)
    for _ in range(n_steps - 1):
        js = jlp.step(js, jp, CFG_J, skip_cvg_at=0)
    js1 = jlp.step(js, jp, CFG_J, skip_cvg_at=0)
    ts1 = tlp.step(torch_state(js), tp, CFG_T, skip_cvg_at=0)
    scales = step_scales(js, js1, jp, CFG_J)
    assert ts1.it == int(js1.it)
    for f in ("x", "y1", "y2", "y3", "z1", "z2", "z4", "ex", "et_next",
              "obj_ring", "cur_obj", "best_bin_obj", "best_sol", "x_prev"):
        err = rel(getattr(ts1, f), getattr(js1, f), scales.get(f, 0.0))
        assert err <= 1e-5, (f, err)
    for f in ("done", "obj_count"):
        np.testing.assert_array_equal(np_of(getattr(ts1, f)),
                                      np.asarray(getattr(js1, f)))


def test_solve_window_records_like_jax(probs):
    jp, tp = probs
    js = jlp.init_state(jp, CFG_J)
    jw, jtraj = jlp.solve_window(js, jp, CFG_J, 20, record=True,
                                 skip_cvg_at=0)
    tw, ttraj = tlp.solve_window(torch_state(js), tp, CFG_T, 20,
                                 record=True, skip_cvg_at=0)
    assert tuple(ttraj.shape) == jtraj.shape
    assert rel(ttraj, jtraj) <= 1e-3
    for f in ("x", "z1", "z4", "best_sol"):
        assert rel(getattr(tw, f), getattr(jw, f)) <= 1e-3, f


def _window_case(mode, jp, tp):
    """(JAX state, cfg pair, window kwargs) of one fused-window mode."""
    if mode == "done-freezing":
        js = jlp.solve(jp, CFG_J, max_iters=20000, window=50)
        assert bool(np.all(np.asarray(js.done)))
    else:
        js = jlp.init_state(jp, CFG_J)
    cj, ct = CFG_J, CFG_T
    if mode == "stride8":
        cj, ct = CFG_J.replace(incumbent_stride=8), \
            CFG_T.replace(incumbent_stride=8)
    kw = {"skip_cvg_at": 0} if mode != "done-freezing" else {}
    if mode == "record":
        kw["record"] = True
    return js, cj, ct, kw


@pytest.mark.parametrize("mode", ["mside", "nside", "record", "stride8",
                                  "done-freezing"])
def test_window_plain_matches_pallas(probs, mode):
    jp, tp = probs
    js, cj, ct, kw = _window_case(mode, jp, tp)
    ts = torch_state(js)
    jkw, tkw = dict(kw), dict(kw)
    if mode == "nside":
        nf = jwb.factorize_nside(jp.E, js.free, 2.0)
        jkw["nfactor"] = (nf.hinv, nf.ete)
        tkw["nfactor"] = (torch.from_numpy(np.array(nf.hinv)),
                          torch.from_numpy(np.array(nf.ete)))
    jout = pallas_lp.lp_window_fused(js, jp, cj, 20, bt=2, interpret=True,
                                     **jkw)
    tout = fused_lp.lp_window_fused(ts, tp, ct, 20, **tkw)
    if mode == "record":
        (jout, jtraj), (tout, ttraj) = jout, tout
        assert tuple(ttraj.shape) == jtraj.shape == (4, tp.n, 20)
        assert rel(ttraj, jtraj) <= 1e-3
    assert tout.it == int(jout.it)
    for f in ("x", "y1", "y2", "y3", "z1", "z2", "z4", "ex", "obj_ring",
              "cur_obj", "best_bin_obj", "best_sol", "et_next"):
        assert rel(getattr(tout, f), getattr(jout, f)) <= 1e-3, f
    for f in ("done", "obj_count"):
        np.testing.assert_array_equal(np_of(getattr(tout, f)),
                                      np.asarray(getattr(jout, f)))


def test_window_plain_is_the_wrapper_on_cpu(probs):
    _, tp = probs
    ts = tlp.init_state(tp, CFG_T)
    a = fused_lp.lp_window_fused(ts, tp, CFG_T, 5, skip_cvg_at=0)
    b = fused_lp.lp_window_plain(ts, tp, CFG_T, 5, skip_cvg_at=0)
    for f in ("x", "z1", "z4", "best_sol"):
        torch.testing.assert_close(getattr(a, f), getattr(b, f), rtol=0,
                                   atol=0)


def _fixed_state(jp, tp, seed=0):
    js = jlp.init_state(jp, CFG_J)
    js, _ = jlp.solve_window(js, jp, CFG_J, 30, record=False,
                             skip_cvg_at=0)
    rng = np.random.RandomState(seed)
    vec = rng.choice([-1.0, 0.0, 1.0], size=js.x.shape,
                     p=[0.6, 0.3, 0.1]).astype(np.float32)
    return js, vec


def test_apply_fix_matches_jax(probs):
    jp, tp = probs
    js, vec = _fixed_state(jp, tp)
    jf = jlp.apply_fix(js, jp, vec, CFG_J)
    tf = tlp.apply_fix(torch_state(js), tp, torch.from_numpy(vec), CFG_T)
    for f in ("free", "fixed_val", "done", "f_eff"):
        np.testing.assert_array_equal(np_of(getattr(tf, f)),
                                      np.asarray(getattr(jf, f)), err_msg=f)
    for f in ("sum_fix_obj", "ex", "x_prev", "et_next"):
        assert rel(getattr(tf, f), getattr(jf, f)) <= 1e-6, f
    g = np.asarray(jf.ginv)
    assert np.abs(np_of(tf.ginv) - g).max() <= 1e-4 * np.abs(g).max()


def test_compact_and_scatter_match_jax(probs):
    jp, tp = probs
    js, vec = _fixed_state(jp, tp, seed=1)
    js = jlp.apply_fix(js, jp, vec, CFG_J)
    ts = torch_state(js)
    n_new = 64
    assert int(np.asarray(js.free).sum(-1).max()) <= n_new
    js2, jp2, jidx = jlp.compact(js, jp, CFG_J, n_new, m_new=64)
    ts2, tp2, tidx = tlp.compact(ts, tp, CFG_T, n_new, m_new=64)
    np.testing.assert_array_equal(np_of(tidx), np.asarray(jidx))
    for f in ("b", "E", "f", "row_mask", "var_mask"):
        np.testing.assert_array_equal(np_of(getattr(tp2, f)),
                                      np.asarray(getattr(jp2, f)), err_msg=f)
    for f in ("x", "y3", "z4", "f_eff", "fixed_val", "best_sol", "ex",
              "et_next"):
        assert rel(getattr(ts2, f), getattr(js2, f)) <= 1e-5, f
    g = np.asarray(js2.ginv)
    assert np.abs(np_of(ts2.ginv) - g).max() <= 1e-4 * np.abs(g).max()
    # a few windows on the compacted problem, then scatter back
    js3, _ = jlp.solve_window(js2, jp2, CFG_J, 10, record=False)
    ts3 = torch_state(js3)
    jsol = jlp.scatter_solution(js3, jidx, js.fixed_val, js.free)
    tsol = tlp.scatter_solution(ts3, tidx, ts.fixed_val, ts.free)
    np.testing.assert_array_equal(np_of(tsol), np.asarray(jsol))


@pytest.mark.parametrize("repair,swap,drop", [(0, 0, 0), (16, 4, 0),
                                              (4, 2, 8)])
def test_select_solution_matches_jax(probs, repair, swap, drop):
    jp, tp = probs
    js = jlp.init_state(jp, CFG_J)
    js, _ = jlp.solve_window(js, jp, CFG_J, 200, record=False,
                             skip_cvg_at=0)
    last, best = jlp.solution(js), jlp.solution_best(js)
    jsol, jobj, jinf = jlp.select_solution(jp, last, best, repair, swap,
                                           drop)
    tsol, tobj, tinf = tlp.select_solution(
        tp, torch.from_numpy(np.array(last)),
        torch.from_numpy(np.array(best)), repair, swap, drop)
    np.testing.assert_array_equal(np_of(tsol), np.asarray(jsol))
    np.testing.assert_array_equal(np_of(tinf), np.asarray(jinf))
    np.testing.assert_allclose(np_of(tobj), np.asarray(jobj), rtol=1e-6)


def test_repairs_on_an_infeasible_rounding(probs):
    """Eviction, refill and swap from a deliberately infeasible start."""
    from lpbox_admm_tpu.ops import repair as jrep
    from lpbox_admm_tpu_torch.ops import repair as trep
    jp, tp = probs
    rng = np.random.RandomState(5)
    sol = (rng.rand(*np.asarray(jp.b).shape) < 0.3).astype(np.float32)
    sol *= np.asarray(jp.var_mask)
    ts = torch.from_numpy(sol)
    j1 = jrep.drop_to_feasible(jp, sol, rounds=64)
    t1 = trep.drop_to_feasible(tp, ts, rounds=64)
    np.testing.assert_array_equal(np_of(t1), np.asarray(j1))
    j2 = jrep.greedy_repair(jp, j1, rounds=16)
    t2 = trep.greedy_repair(tp, t1, rounds=16)
    np.testing.assert_array_equal(np_of(t2), np.asarray(j2))
    j3 = jrep.swap_repair(jp, j2, rounds=4)
    t3 = trep.swap_repair(tp, t2, rounds=4)
    np.testing.assert_array_equal(np_of(t3), np.asarray(j3))


def test_solve_fused_converges_like_jax(probs):
    """The port's plain fused solve (K1's plain version on the CPU)
    reaches the JAX package's converged objectives within 5% (the
    JAX suite's own bar for fused vs XLA) and stays feasible."""
    jp, tp = probs
    ref = jlp.solve(jp, CFG_J, max_iters=20000, window=50)
    st = fused_lp.solve_fused(tp, CFG_T, max_iters=20000, window=50)
    assert bool(st.done.all())
    o_ref = np.asarray(jlp.objective(ref))
    o = np_of(tlp.objective(st))
    assert np.all(np.abs(o - o_ref) / np.abs(o_ref) < 0.05), (o, o_ref)
    np.testing.assert_array_equal(np_of(tlp.infeasible_rows(st, tp)), 0)
    assert np.all(np_of(tlp.objective_best(st)) <= o + 1e-3)


def test_woodbury_refuses_other_modes(probs):
    """The Woodbury-only paths (K1's window, a rho cap that would make
    the cached factor solve the wrong system) refuse other modes;
    ``core.lp`` takes ``linsolve="cg"`` since the CG port."""
    _, tp = probs
    s = tlp.init_state(tp, TLP)                      # linsolve="cg"
    assert tuple(s.ginv.shape) == (tp.batch, 1, 1)
    with pytest.raises(ValueError, match="woodbury' only"):
        fused_lp.window_inputs(s, tp, TLP)
    with pytest.raises(ValueError):
        tlp.init_state(tp, CFG_T.replace(rho_upper_limit=100.0))
    with pytest.raises(ValueError, match="unknown linsolve"):
        tlp.init_state(tp, TLP.replace(linsolve="lu"))


@pytest.mark.parametrize("n_steps", [1, 2])
def test_cg_step_matches_jax(probs, n_steps):
    """One step with the PCG x-update from the same state, against JAX
    ``linsolve="cg"``: 1e-5 relative to the terms each field is
    computed from (``step_scales``; the carried E^T w against the z4
    scale times E's largest column count)."""
    jp, tp = probs
    js = jlp.init_state(jp, JLP)
    for _ in range(n_steps - 1):
        js = jlp.step(js, jp, JLP, skip_cvg_at=0)
    js1 = jlp.step(js, jp, JLP, skip_cvg_at=0)
    ts1 = tlp.step(torch_state(js), tp, TLP, skip_cvg_at=0)
    scales = step_scales(js, js1, jp, JLP)
    scales["et_next"] = scales["z4"] * float(
        np.abs(np.asarray(jp.E)).sum(1).max())
    assert ts1.it == int(js1.it)
    for f in ("x", "y1", "y2", "y3", "z1", "z2", "z4", "ex", "et_next",
              "obj_ring", "cur_obj", "best_bin_obj", "best_sol", "x_prev"):
        err = rel(getattr(ts1, f), getattr(js1, f), scales.get(f, 0.0))
        assert err <= 1e-5, (f, err)
    for f in ("done", "obj_count", "cg_fail"):
        np.testing.assert_array_equal(np_of(getattr(ts1, f)),
                                      np.asarray(getattr(js1, f)))


def test_cg_window_matches_jax(probs):
    """20 CG iterations recorded, held as the Woodbury window is (1e-3).
    At ``LP_CONFIG``'s pcg_tol = 1e-3 two float32 CGs stop a row one CG
    iteration apart wherever its residual lands within rounding of the
    threshold, and the iterates then differ by the solve's own tolerance
    (3e-3 after 20 steps on these instances); so the window is held at
    pcg_tol = 1e-5, where the x-update is exact well below the bound."""
    jp, tp = probs
    cj, ct = JLP.replace(pcg_tol=1e-5), TLP.replace(pcg_tol=1e-5)
    js = jlp.init_state(jp, cj)
    jw, jtraj = jlp.solve_window(js, jp, cj, 20, record=True,
                                 skip_cvg_at=0)
    tw, ttraj = tlp.solve_window(tlp.init_state(tp, ct), tp, ct, 20,
                                 record=True, skip_cvg_at=0)
    assert rel(ttraj, jtraj) <= 1e-3
    for f in ("x", "z1", "z4", "best_sol"):
        assert rel(getattr(tw, f), getattr(jw, f)) <= 1e-3, f


def test_cg_failure_matches_jax(probs):
    """A negative rho makes the CG operator negative definite: the first
    CG iteration finds p^T A p < 0, the instance keeps its iterate and
    is done, in both packages; and ``pcg`` itself on a matrix that is
    indefinite in one row only."""
    from lpbox_admm_tpu.ops import cg as jcg
    from lpbox_admm_tpu_torch.ops import cg as tcg
    jp, tp = probs
    bad_j, bad_t = JLP.replace(initial_rho=-1.0), TLP.replace(initial_rho=-1.0)
    js = jlp.init_state(jp, bad_j)
    js1 = jlp.step(js, jp, bad_j)
    ts1 = tlp.step(torch_state(js), tp, bad_t)
    for f in ("cg_fail", "done"):
        np.testing.assert_array_equal(np_of(getattr(ts1, f)),
                                      np.asarray(getattr(js1, f)))
    assert bool(ts1.cg_fail.all())
    np.testing.assert_array_equal(np_of(ts1.x), np.asarray(js1.x))
    rng = np.random.RandomState(0)
    A = rng.randn(3, 12, 12).astype(np.float32)
    A = A @ A.transpose(0, 2, 1) + 12 * np.eye(12, dtype=np.float32)
    A[1] = -A[1]                                      # row 1 indefinite
    rhs = rng.randn(3, 12).astype(np.float32)
    rhs[2] = 0.0                                      # a zero rhs
    x0 = rng.randn(3, 12).astype(np.float32)
    diag = np.abs(np.einsum("bii->bi", A)).astype(np.float32)
    active = np.array([True, True, True])
    rj = jcg.pcg(lambda p: jnp.einsum("bij,bj->bi", jnp.asarray(A), p),
                 jnp.asarray(rhs), jnp.asarray(x0), jnp.asarray(diag),
                 1e-6, 50, active=jnp.asarray(active))
    rt = tcg.pcg(lambda p: torch.einsum("bij,bj->bi", torch.from_numpy(A), p),
                 torch.from_numpy(rhs), torch.from_numpy(x0),
                 torch.from_numpy(diag), 1e-6, 50,
                 active=torch.from_numpy(active))
    np.testing.assert_array_equal(np_of(rt.failed), np.asarray(rj.failed))
    np.testing.assert_array_equal(np_of(rt.failed), [False, True, False])
    np.testing.assert_array_equal(np_of(rt.iters), np.asarray(rj.iters))
    assert rel(rt.x, rj.x) <= 1e-5


def test_ginv_dtype_bf16_is_refused_where_jax_stores_it(probs):
    """The JAX package stores G^-1 in bfloat16 under ginv_dtype, and so
    does the port wherever it factors (init_state, apply_fix, compact):
    the same dtype and the same values to one bfloat16 rounding of the
    float32 factor (the two factorizations differ in f32 rounding)."""
    jp, tp = probs
    bf_j, bf_t = (CFG_J.replace(ginv_dtype="bfloat16"),
                  CFG_T.replace(ginv_dtype="bfloat16"))
    js, ts = jlp.init_state(jp, bf_j), tlp.init_state(tp, bf_t)
    vec_t = torch.where(torch.arange(tp.n) < 8, 0.0, -1.0).expand(tp.batch,
                                                                 tp.n)
    pairs = [(js.ginv, ts.ginv),
             (jlp.apply_fix(js, jp, jnp.asarray(vec_t.numpy()), bf_j,
                            min_fix=0).ginv,
              tlp.apply_fix(ts, tp, vec_t, bf_t, min_fix=0).ginv),
             (jlp.compact(js, jp, bf_j, tp.n)[0].ginv,
              tlp.compact(ts, tp, bf_t, tp.n)[0].ginv)]
    for gj, gt in pairs:
        assert gj.dtype == jnp.bfloat16 and gt.dtype == torch.bfloat16
        a = np.asarray(gj.astype(jnp.float32))
        assert np.abs(gt.float().numpy() - a).max() \
            <= 2.0 ** -8 * np.abs(a).max()
    with pytest.raises(ValueError, match="ginv_dtype"):
        tlp.init_state(tp, CFG_T.replace(ginv_dtype="float16"))


def test_init_state_precomputed_factors_match_jax(probs):
    """``init_state(gram=...)`` and ``init_state(ginv=...)`` as in the JAX
    package: the same state as factoring in place."""
    jp, tp = probs
    E = np.asarray(jp.E, np.float64) * np.asarray(jp.var_mask)[:, None, :]
    gram = np.einsum("bmn,bkn->bmk", E, E).astype(np.float32)
    ginv = np.linalg.inv(gram.astype(np.float64)
                         + 2.0 * np.eye(gram.shape[-1])).astype(np.float32)
    base = tlp.init_state(tp, CFG_T)
    for kw in ({"gram": gram}, {"ginv": ginv}):
        js = jlp.init_state(jp, CFG_J, **{k: jnp.asarray(v)
                                          for k, v in kw.items()})
        ts = tlp.init_state(tp, CFG_T, **{k: torch.from_numpy(v)
                                          for k, v in kw.items()})
        assert ts.ginv.dtype == torch.float32
        g = np.asarray(js.ginv)
        assert np.abs(np_of(ts.ginv) - g).max() <= 1e-4 * np.abs(g).max()
        assert np.abs(np_of(ts.ginv - base.ginv)).max() \
            <= 1e-4 * np.abs(g).max()
        for f in ("x", "y3", "ex", "et_next", "best_bin_obj"):
            assert rel(getattr(ts, f), getattr(js, f)) <= 1e-6, f
