"""The port's sparse and structured E (``ops/sparse``, ``ops/mxu_sparse``,
``ops/ca_sparse``), the Schur inverse (``ops/struct_ginv``), the sparse
branches of ``core/lp`` and the CA adapter's sparse forms against the
JAX package (CPU, CA 20x60 batches of 3 as ``tests/test_ca_sparse.py``
uses).

Tolerances: products, Gram and squared norms 1e-6 of max |ref| (float32
sums of the same terms in another order); layouts, row maps, dense forms,
masks, fix decisions and integer outputs equal; the Schur apply 1e-5 of
max |ref| against the JAX package's and against the dense inverse
(float32 blocks of one float64 host build, products reordered); the
first struct window 1e-3 in the units of x after 20 iterations (the
bound of every 20-iteration comparison here).  No JAX struct solve runs
to convergence in this file.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpbox_admm_tpu.adapters import ca as jca
from lpbox_admm_tpu.config import LP_CONFIG as JLP
from lpbox_admm_tpu.core import lp as jlp
from lpbox_admm_tpu.ops import ca_sparse as jcs, sparse as jsp
from lpbox_admm_tpu.ops.struct_ginv import build_struct_ginv as jbuild
from lpbox_admm_tpu_torch.adapters import ca as tca
from lpbox_admm_tpu_torch.config import LP_CONFIG as TLP
from lpbox_admm_tpu_torch.core import lp as tlp
from lpbox_admm_tpu_torch.ops import (ca_sparse as tcs, mxu_sparse,
                                      sparse as tsp)
from lpbox_admm_tpu_torch.ops.struct_ginv import build_struct_ginv as tbuild

from torch_port_util import np_of, rel, state_errors, torch_state

CFG_J = JLP.replace(linsolve="woodbury")
CFG_T = TLP.replace(linsolve="woodbury")
TOL = 1e-6


def _coo_insts(seed=0, B=3, n_items=20, n_bids=60):
    rng = np.random.RandomState(seed)
    return [jca.generate_cauction(rng, n_items=n_items, n_bids=n_bids,
                                  return_coo=True) for _ in range(B)]


def _rel(a, b):
    a, b = np_of(a).astype(np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _struct(insts):
    jp, jrm = jca.make_struct_problem(insts)
    tp, trm = tca.make_struct_problem(insts, device="cpu")
    return jp, jrm, tp, trm


def _ginvs(insts, jp, jrm, tp, free=None):
    coos = [(r, c, v) for _, (r, c, v, _) in insts]
    shapes = [s for _, (_, _, _, s) in insts]
    E = tp.E
    return (jbuild(coos, shapes, jrm, E.m1, E.m2, tp.n, 2.0, free=free),
            tbuild(coos, shapes, jrm, E.m1, E.m2, tp.n, 2.0, free=free,
                   device="cpu"))


@pytest.mark.parametrize("n_items,n_bids", [(20, 60), (50, 300)])
def test_generator_coo_matches_jax(n_items, n_bids):
    """``generate_cauction(return_coo=True)``: the JAX package's triplet
    and prices, and the port's dense form of the same draw."""
    a = _coo_insts(4, 2, n_items, n_bids)
    rng = np.random.RandomState(4)
    b = [tca.generate_cauction(rng, n_items=n_items, n_bids=n_bids,
                               return_coo=True) for _ in range(2)]
    rng = np.random.RandomState(4)
    d = [tca.generate_cauction(rng, n_items=n_items, n_bids=n_bids)
         for _ in range(2)]
    for (pj, cj), (pt, ct), (_, C) in zip(a, b, d):
        np.testing.assert_array_equal(pt, pj)
        for x, y in zip(ct[:3], cj[:3]):
            np.testing.assert_array_equal(x, np.asarray(y))
        assert tuple(ct[3]) == tuple(cj[3]) == C.shape
        D = np.zeros(C.shape)
        D[ct[0], ct[1]] = ct[2]
        np.testing.assert_array_equal(D, C)


def test_sparse_ell_matches_jax():
    """``from_coo``/``from_dense``, ``to_dense``, ``colsq``, ``rowsq``,
    ``diag``, ``gram`` and the four products (the JAX package's CPU
    gather route), and ``mxu_sparse``'s API on the same route."""
    insts = _coo_insts(1)
    coos = [(r, c, v) for _, (r, c, v, _) in insts]
    shape = (128, 64)
    Sj = jsp.from_coo(coos, shape)
    St = tsp.from_coo(coos, shape, device="cpu")
    for f in ("row_idx", "row_val", "col_idx", "col_val"):
        np.testing.assert_array_equal(np_of(getattr(St, f)),
                                      np.asarray(getattr(Sj, f)))
    D = np.asarray(jsp.to_dense(Sj))
    np.testing.assert_array_equal(tsp.to_dense(St).numpy(), D)
    Sd = tsp.from_dense(D, device="cpu")
    np.testing.assert_array_equal(tsp.to_dense(Sd).numpy(), D)
    assert _rel(tsp.colsq(St), jsp.colsq(Sj)) <= TOL
    assert _rel(tsp.rowsq(St), jsp.rowsq(Sj)) <= TOL
    free = np.random.RandomState(2).rand(3, 64) > 0.3
    assert _rel(tsp.gram(St, torch.from_numpy(free)),
                jsp.gram(Sj, jnp.asarray(free))) <= TOL
    sq = jsp.from_dense(D[:, :64, :64])
    np.testing.assert_array_equal(
        tsp.diag(tsp.from_dense(D[:, :64, :64], device="cpu")).numpy(),
        np.asarray(jsp.diag(sq)))
    rng = np.random.RandomState(3)
    v = rng.randn(3, 64).astype(np.float32)
    w = rng.randn(3, 128).astype(np.float32)
    V = rng.randn(3, 4, 64).astype(np.float32)
    W = rng.randn(3, 2, 128).astype(np.float32)
    t = torch.from_numpy
    for mod in (tsp, mxu_sparse):
        assert _rel(mod.mv(St, t(v)), jsp.mv(Sj, jnp.asarray(v))) <= TOL
        assert _rel(mod.mtv(St, t(w)), jsp.mtv(Sj, jnp.asarray(w))) <= TOL
        assert _rel(mod.mv_many(St, t(V)),
                    jsp.mv_many(Sj, jnp.asarray(V))) <= TOL
        assert _rel(mod.mtv_many(St, t(W)),
                    jsp.mtv_many(Sj, jnp.asarray(W))) <= TOL
    E0 = tsp.empty(3, 0, 64, device="cpu")
    assert tuple(tsp.mv(E0, t(v)).shape) == (3, 0)
    assert tsp.is_sparse(St) and not tsp.is_sparse(t(D.copy()))


def test_detect_interval_suffix_matches_jax():
    cases = [(np.array([0, 0, 1, 1, 2, 2, 2, 3, 3, 4]),
              np.array([0, 5, 2, 3, 0, 1, 2, 3, 4, 6]), 5),
             (np.array([0, 1, 1, 2, 2]), np.array([0, 1, 2, 2, 3]), 3),
             (np.array([0, 0, 1, 1, 1]), np.array([0, 1, 2, 3, 4]), 2),
             (np.array([0, 0, 1, 1, 1]), np.array([3, 4, 0, 1, 2]), 2)]
    for _, (r, c, _, s) in _coo_insts(6, 3, 30, 120):
        cases.append((np.asarray(r), np.asarray(c), s[0]))
    got = [tcs.detect_interval_suffix(r, c, m) for r, c, m in cases]
    assert got == [jcs.detect_interval_suffix(r, c, m) for r, c, m in cases]
    assert got[:4] == [2, 2, 0, 1]


@pytest.mark.parametrize("cap", [2, 4, 12])
def test_struct_build_matches_jax(cap):
    """``build``'s row maps and dense form, and the struct products,
    ``colsq`` and the adapter's b/f/masks, against the JAX package."""
    insts = _coo_insts(0)
    coos = [(r, c, v) for _, (r, c, v, _) in insts]
    shapes = [s for _, (_, _, _, s) in insts]
    Sj, rmj = jcs.build(coos, shapes, 64, width_cap=cap, td=32)
    St, rmt = tcs.build(coos, shapes, 64, width_cap=cap, device="cpu")
    assert St.shape == Sj.shape and (St.m1, St.m2) == (Sj.m1, Sj.m2)
    for a, b in zip(rmt, rmj):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tcs.to_dense(St).numpy(),
                                  np.asarray(jcs.to_dense(Sj)))
    rng = np.random.RandomState(1)
    V = rng.randn(3, 3, 64).astype(np.float32)
    W = rng.randn(3, 2, St.m).astype(np.float32)
    assert _rel(tsp.mv_many(St, torch.from_numpy(V)),
                jsp.mv_many(Sj, jnp.asarray(V))) <= TOL
    assert _rel(tsp.mtv_many(St, torch.from_numpy(W)),
                jsp.mtv_many(Sj, jnp.asarray(W))) <= TOL
    assert _rel(tsp.colsq(St), jsp.colsq(Sj)) <= TOL
    jp, jrm, tp, trm = _struct(insts)
    for f in ("b", "f", "row_mask", "var_mask"):
        np.testing.assert_array_equal(np_of(getattr(tp, f)),
                                      np.asarray(getattr(jp, f)))


def test_sparse_and_dense_bf16_problems_match_jax():
    insts = _coo_insts(2)
    jp, tp = (jca.make_sparse_problem(insts),
              tca.make_sparse_problem(insts, device="cpu"))
    np.testing.assert_array_equal(tsp.to_dense(tp.E).numpy(),
                                  np.asarray(jsp.to_dense(jp.E)))
    jd = jca.make_dense_bf16_problem(insts)
    td = tca.make_dense_bf16_problem(insts, device="cpu")
    assert td.E.dtype == torch.bfloat16
    np.testing.assert_array_equal(td.E.float().numpy(),
                                  np.asarray(jd.E.astype(jnp.float32)))
    for q, r in ((tp, jp), (td, jd)):
        for f in ("b", "f", "row_mask", "var_mask"):
            np.testing.assert_array_equal(np_of(getattr(q, f)),
                                          np.asarray(getattr(r, f)))


def test_struct_ginv_matches_jax_and_dense_inverse():
    insts = _coo_insts(3, 2)
    jp, jrm, tp, _ = _struct(insts)
    free = np.random.RandomState(3).rand(2, tp.n) > 0.4
    for fr in (None, free):
        gj, gt = _ginvs(insts, jp, jrm, tp, free=fr)
        r = np.random.RandomState(0).randn(2, tp.m).astype(np.float32)
        z = gt.apply(torch.from_numpy(r)).numpy()
        assert _rel(z, gj.apply(jnp.asarray(r))) <= 1e-5
        # the dense inverse of ratio I + C_f C_f^T in the struct layout
        D = tcs.to_dense(tp.E).numpy().astype(np.float64)
        if fr is not None:
            D = D * fr[:, None, :]
        G = D @ D.transpose(0, 2, 1) + 2.0 * np.eye(tp.m)
        assert _rel(z, np.linalg.solve(G, r[..., None])[..., 0]) <= 1e-5


def test_fix_decision_host_and_apply_fix_with_ginv_match_jax():
    """The host mirror of the fix decision and ``apply_fix(ginv=
    StructGinv)`` from the same state: masks, fixed values, f_eff and
    the merged inverse's blocks equal (per the skip decision)."""
    insts = _coo_insts(9, 2)
    jp, jrm, tp, _ = _struct(insts)
    cfg_j, cfg_t = CFG_J.replace(min_fix=0), CFG_T.replace(min_fix=0)
    gj, gt = _ginvs(insts, jp, jrm, tp)
    js = jlp.init_state(jp, cfg_j, ginv=gj)
    js, _ = jlp.solve_window(js, jp, cfg_j, 30, record=False, skip_cvg_at=0)
    x = np.asarray(js.x)
    vec = np.where(x > 0.95, 1.0, np.where(x < 0.05, 0.0, -1.0))
    vec = np.where(np.asarray(jp.var_mask), vec, -1.0).astype(np.float32)
    vec[1] = -1.0                      # instance 1 skips the round
    ts = torch_state(js)
    do_j, free_j = jlp.fix_decision_host(js, vec, cfg_j)
    do_t, free_t = tlp.fix_decision_host(ts, torch.from_numpy(vec), cfg_t)
    np.testing.assert_array_equal(do_t, do_j)
    np.testing.assert_array_equal(free_t, free_j)
    assert do_t.tolist() == [True, False]
    gj2, gt2 = _ginvs(insts, jp, jrm, tp, free=free_j)
    js2 = jlp.apply_fix(js, jp, jnp.asarray(vec), cfg_j, ginv=gj2)
    ts2 = tlp.apply_fix(ts, tp, torch.from_numpy(vec), cfg_t, ginv=gt2)
    for f in ("free", "fixed_val", "done"):
        np.testing.assert_array_equal(np_of(getattr(ts2, f)),
                                      np.asarray(getattr(js2, f)))
    for f in ("f_eff", "sum_fix_obj", "ex", "et_next"):
        assert rel(getattr(ts2, f), getattr(js2, f)) <= 1e-5, f
    for f in dataclasses.fields(gt2):
        got = np_of(getattr(ts2.ginv, f.name))
        np.testing.assert_array_equal(got[0], np_of(getattr(gt2, f.name))[0])
        np.testing.assert_array_equal(got[1], np_of(getattr(gt, f.name))[1])
    with pytest.raises(NotImplementedError, match="caller-refactorized"):
        tlp.apply_fix(ts, tp, torch.from_numpy(vec), cfg_t)


def test_first_struct_window_matches_jax():
    """20 iterations on the struct problem with the Schur inverse from
    the same initial state, and on the sparse (ELL) problem with its
    sparse Gram: 1e-3 of x; infeasible_rows and select_solution of the
    result equal the JAX package's."""
    insts = _coo_insts(11, 2)
    jp, jrm, tp, _ = _struct(insts)
    gj, gt = _ginvs(insts, jp, jrm, tp)
    js0 = jlp.init_state(jp, CFG_J, ginv=gj)
    ts0 = tlp.init_state(tp, CFG_T, ginv=gt)
    assert rel(ts0.et_next, js0.et_next) <= 1e-5
    js, _ = jlp.solve_window(js0, jp, CFG_J, 20, record=False, skip_cvg_at=0)
    ts, _ = tlp.solve_window(torch_state(js0), tp, CFG_T,
                             20, record=False, skip_cvg_at=0)
    assert max(state_errors(ts, js, CFG_T).values()) <= 1e-3
    np.testing.assert_array_equal(np_of(tlp.infeasible_rows(ts, tp)),
                                  np.asarray(jlp.infeasible_rows(js, jp)))
    _, obj_t, inf_t = tlp.select_solution(tp, tlp.solution(ts),
                                          tlp.solution_best(ts))
    _, obj_j, inf_j = jlp.select_solution(jp, jlp.solution(js),
                                          jlp.solution_best(js))
    np.testing.assert_array_equal(np_of(inf_t), np.asarray(inf_j))
    assert rel(obj_t, obj_j) <= 1e-5
    with pytest.raises(ValueError, match="dense E"):
        tlp.compact(ts, tp, CFG_T, 32)
    # the ELL problem: the Gram assembled sparsely, the CG x-update's
    # squared column norms (CG at pcg_tol 1e-5, as test_torch_lp.py's
    # CG window: at 1e-3 two float32 CGs stop a row one CG iteration
    # apart and differ by the solve's own tolerance)
    sj, st = (jca.make_sparse_problem(insts),
              tca.make_sparse_problem(insts, device="cpu"))
    for cfg_j, cfg_t in ((CFG_J, CFG_T), (JLP.replace(pcg_tol=1e-5),
                                          TLP.replace(pcg_tol=1e-5))):
        a = jlp.init_state(sj, cfg_j)
        b, _ = tlp.solve_window(torch_state(a), st, cfg_t, 20,
                                record=False, skip_cvg_at=0)
        a, _ = jlp.solve_window(a, sj, cfg_j, 20, record=False,
                                skip_cvg_at=0)
        assert max(state_errors(b, a, cfg_t).values()) <= 1e-3


def test_solve_auto_paths_on_cpu():
    """``solve_auto``'s route tags on the CPU (no K1 there): dense E on
    ``core.lp`` windows over the whole batch, sparse and struct E on the
    sparse windows (with the JAX package's rule, ``xla``, ``xla-sparse``
    and ``blocked-sparse`` there); a struct solve with its Schur inverse
    converges feasibly."""
    insts = _coo_insts(5, 2)
    _, jrm, tp, _ = _struct(insts)
    coos = [(r, c, v) for _, (r, c, v, _) in insts]
    shapes = [s for _, (_, _, _, s) in insts]
    g = tbuild(coos, shapes, jrm, tp.E.m1, tp.E.m2, tp.n, 2.0, device="cpu")
    st, path = tlp.solve_auto(tp, CFG_T.replace(rho_change_step=12),
                              max_iters=3000, ginv=g)
    assert path == "windows-sparse"
    _, _, inf = tlp.select_solution(tp, tlp.solution(st),
                                    tlp.solution_best(st))
    assert int(inf.sum()) == 0
    insts8 = _coo_insts(5, 8)
    sp8 = tca.make_sparse_problem(insts8, device="cpu")
    st, path = tlp.solve_auto(sp8, CFG_T, max_iters=2)
    assert path == "windows-sparse" and st.it == 100
    dense = [(p, tsp.to_dense(tsp.from_coo([(r, c, v)], s, "cpu"))[0].numpy())
             for p, (r, c, v, s) in insts8]
    dp = tca.make_problem(dense, device="cpu")
    st, path = tlp.solve_auto(dp, CFG_T, max_iters=2)
    assert path == "windows" and st.it == 100
