"""The port's general eq/ineq binary-QP solver (``core/general.py``)
against exhaustive optima (the cases of ``tests/test_general.py``) and
against the JAX package's solver on the CPU: one step on dense, sparse
and grid problems, ``compact_sparse`` and ``constraint_violation``."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpbox_admm_tpu.config import SolverConfig as JSolverConfig
from lpbox_admm_tpu.core import general as jgeneral
from lpbox_admm_tpu_torch.config import SolverConfig
from lpbox_admm_tpu_torch.core import general
from lpbox_admm_tpu_torch.ops import stencil as tstencil

from torch_port_util import np_of

_KW = dict(initial_rho=5.0, learning_fact=1.03, rho_change_step=5,
           stop_threshold=1e-3, std_threshold=1e-7, history_size=5,
           gamma0=1.0, gamma_factor=0.99, max_iters=4000)
CFG = SolverConfig(**_KW)
JCFG = JSolverConfig(**_KW)


def brute_force(A, b, C=None, d=None, E=None, f=None):
    """Exhaustive optimum over feasible binary vectors (n <= 14)."""
    best = np.inf
    for bits in itertools.product([0.0, 1.0], repeat=b.shape[0]):
        x = np.array(bits)
        if C is not None and not np.allclose(C @ x, d):
            continue
        if E is not None and np.any(E @ x > f + 1e-9):
            continue
        best = min(best, x @ A @ x + b @ x)
    return best


def random_qp(rng, n):
    M = rng.randn(n, n) * 0.5
    return (M + M.T) / 2, rng.randn(n) * 2


def dense(**kw):
    return general.make_general(device="cpu", **kw)


def solution0(st):
    return general.solution(st)[0].numpy()


def test_unconstrained_matches_brute_force(rng):
    A, b = random_qp(rng, 10)
    prob = dense(A=A[None], b=b[None])
    st = general.solve(prob, CFG, window=50)
    obj = general.objective(st, prob)[0].item()
    opt = brute_force(A, b)
    assert opt - 1e-4 <= obj <= opt + 0.5 * (abs(opt) + 1.0), (obj, opt)


def test_equality_constraint_satisfied(rng):
    n = 12
    A, b = random_qp(rng, n)
    prob = dense(A=A[None], b=b[None], C=np.ones((1, 1, n)),
                 d=np.array([[4.0]]))
    st = general.solve(prob, CFG, window=50)
    eq, _ = general.constraint_violation(st, prob)
    assert solution0(st).sum() == pytest.approx(4.0)
    assert eq[0].item() < 1e-6


def test_inequality_constraint_satisfied(rng):
    n = 12
    A, b = random_qp(rng, n)
    prob = dense(A=A[None], b=(b - 2.0)[None], E=np.ones((1, 1, n)),
                 f=np.array([[5.0]]))
    st = general.solve(prob, CFG, window=50)
    _, ineq = general.constraint_violation(st, prob)
    assert ineq[0].item() == 0
    assert solution0(st).sum() <= 5


def test_both_constraints(rng):
    n = 12
    A, b = random_qp(rng, n)
    C = np.zeros((1, 1, n))
    C[0, 0, :6] = 1.0
    prob = dense(A=A[None], b=b[None], C=C, d=np.array([[2.0]]),
                 E=np.ones((1, 1, n)), f=np.array([[6.0]]))
    st = general.solve(prob, CFG, window=50)
    eq, ineq = general.constraint_violation(st, prob)
    assert eq[0].item() < 1e-6 and ineq[0].item() == 0
    assert solution0(st)[:6].sum() == pytest.approx(2.0)


def test_equality_quality_vs_brute_force(rng):
    n = 12
    gaps = []
    for _ in range(4):
        A, b = random_qp(rng, n)
        C, d = np.ones((1, n)), np.array([4.0])
        prob = dense(A=A[None], b=b[None], C=C[None], d=d[None])
        st = general.solve(prob, CFG, window=50)
        if solution0(st).sum() != 4.0:
            continue
        obj = general.objective(st, prob)[0].item()
        gaps.append((obj - brute_force(A, b, C, d)) / (abs(brute_force(
            A, b, C, d)) + 1.0))
    assert len(gaps) >= 2
    assert np.mean(gaps) < 0.35, gaps


def test_rule_fixing_path(rng):
    A, b = random_qp(rng, 12)
    prob = dense(A=A[None], b=b[None])
    st = general.solve(prob, CFG, window=50, rule_fixing=True)
    assert set(np.unique(solution0(st))) <= {0.0, 1.0}


def test_apply_fix_fold_in(rng):
    """Fixing half the variables leaves the conditional problem: the
    remainder's solution is near the conditional exhaustive optimum."""
    n = 10
    A, b = random_qp(rng, n)
    prob = dense(A=A[None], b=b[None])
    st = general.init_state(prob, CFG)
    st, _ = general.solve_window(st, prob, CFG, 3, record=False)
    assert not bool(st.done[0])
    vec = torch.full((1, n), -1.0)
    vec[0, :5] = torch.tensor([1.0, 0, 1, 0, 1])
    st = general.apply_fix(st, prob, vec, CFG, min_fix=0)
    st, _ = general.solve_window(st, prob, CFG, 2000, record=False)
    x = solution0(st)
    np.testing.assert_allclose(x[:5], [1, 0, 1, 0, 1])
    obj = general.objective(st, prob)[0].item()
    best = min(xx @ A @ xx + b @ xx for xx in (
        np.concatenate([[1, 0, 1, 0, 1], bits])
        for bits in itertools.product([0.0, 1.0], repeat=5)))
    assert best - 1e-4 <= obj <= best + 0.5 * (abs(best) + 1.0)


def _coo_of(M, tol=1e-12):
    rows, cols = np.nonzero(np.abs(M) > tol)
    return rows, cols, M[rows, cols].astype(np.float32)


def _eq_ineq_batch(rng, B=2, n=12):
    As, bs = [], []
    for _ in range(B):
        A, b = random_qp(rng, n)
        A[np.abs(A) < 0.4] = 0.0
        As.append(A)
        bs.append(b)
    A, b = np.stack(As), np.stack(bs).astype(np.float32)
    C = np.ones((B, 1, n), np.float32)
    d = np.full((B, 1), 4.0, np.float32)
    E = np.zeros((B, 1, n), np.float32)
    E[:, 0, :n // 2] = 1.0
    f = np.full((B, 1), 3.0, np.float32)
    return A, b, C, d, E, f


def _sparse_kw(A, b, C, d, E, f):
    B = A.shape[0]
    return dict(b=b, A_coo=[_coo_of(A[i]) for i in range(B)],
                C_coo=[_coo_of(C[i]) for i in range(B)], d=d,
                E_coo=[_coo_of(E[i]) for i in range(B)], f=f)


def test_sparse_general_matches_dense(rng):
    A, b, C, d, E, f = _eq_ineq_batch(rng)
    dprob = dense(A=A, b=b, C=C, d=d, E=E, f=f)
    sprob = general.make_sparse_general(device="cpu",
                                        **_sparse_kw(A, b, C, d, E, f))
    dst = general.solve(dprob, CFG, window=50)
    sst = general.solve(sprob, CFG, window=50)
    dobj = general.objective(dst, dprob).numpy()
    sobj = general.objective(sst, sprob).numpy()
    seq, sineq = general.constraint_violation(sst, sprob)
    assert (sineq == 0).all() and (seq < 1.0).all()
    assert np.all(np.abs(sobj - dobj) / (np.abs(dobj) + 1.0) < 0.1)


def test_sparse_general_brute_force(rng):
    n = 10
    A, b = random_qp(rng, n)
    A[np.abs(A) < 0.3] = 0.0
    C = np.ones((1, n))
    d = np.array([4.0])
    prob = general.make_sparse_general(
        b[None].astype(np.float32), A_coo=[_coo_of(A)], C_coo=[_coo_of(C)],
        d=d[None], device="cpu")
    st = general.solve(prob, CFG, window=50)
    assert solution0(st).sum() == pytest.approx(4.0)
    obj = general.objective(st, prob)[0].item()
    opt = brute_force(A, b, C, d)
    assert opt - 1e-4 <= obj <= opt + 0.5 * (abs(opt) + 1.0)


def grid_weights(rng, B, H, W):
    """Random nonnegative symmetric 8-neighbour planes of an (H, W) grid
    (tests/test_general.py's construction)."""
    OFF = tstencil.OFFSETS
    w = np.zeros((B, 8, H, W), np.float32)
    base = rng.rand(B, 8, H, W).astype(np.float32)
    for d, (dr, dc) in enumerate(OFF):
        if d < OFF.index((-dr, -dc)):
            w[:, d] = base[:, d]
    for d, (dr, dc) in enumerate(OFF):
        opp = OFF.index((-dr, -dc))
        if d > opp:
            w[:, d] = np.roll(w[:, opp], shift=(dr, dc), axis=(-2, -1))
    for d, (dr, dc) in enumerate(OFF):
        if dr == -1:
            w[:, d, 0, :] = 0
        if dr == 1:
            w[:, d, H - 1, :] = 0
        if dc == -1:
            w[:, d, :, 0] = 0
        if dc == 1:
            w[:, d, :, W - 1] = 0
    return w


def dense_of_grid(w):
    _, H, W = w.shape
    A = np.zeros((H * W, H * W))
    for d, (dr, dc) in enumerate(tstencil.OFFSETS):
        for i in range(H):
            for j in range(W):
                if 0 <= i + dr < H and 0 <= j + dc < W:
                    A[i * W + j, (i + dr) * W + j + dc] -= w[d, i, j]
    np.fill_diagonal(A, w.sum(axis=0).reshape(-1))
    return A


def test_grid_general_matches_dense(rng):
    B, H, W = 2, 4, 5
    n = H * W
    w = grid_weights(rng, B, H, W)
    b = rng.randn(B, n).astype(np.float32) * 2
    C = np.ones((B, 1, n), np.float32)
    d = np.full((B, 1), 6.0, np.float32)
    E = np.zeros((B, 1, n), np.float32)
    E[:, 0, :n // 2] = 1.0
    f = np.full((B, 1), 4.0, np.float32)
    gprob = general.make_grid_general(w, b, C=C, d=d, E=E, f=f,
                                      device="cpu")
    Ad = np.stack([dense_of_grid(w[i]) for i in range(B)])
    dprob = dense(A=Ad, b=b, C=C, d=d, E=E, f=f)
    gst = general.solve(gprob, CFG, window=50)
    dst = general.solve(dprob, CFG, window=50)
    gobj = general.objective(gst, gprob).numpy()
    dobj = general.objective(dst, dprob).numpy()
    geq, gineq = general.constraint_violation(gst, gprob)
    assert (gineq == 0).all() and (geq < 1.0).all()
    assert np.all(np.abs(gobj - dobj) / (np.abs(dobj) + 1.0) < 0.1)


def _problems(kind, rng):
    """The same eq + ineq problem in both packages: dense, sparse or
    grid."""
    if kind == "grid":
        B, H, W = 2, 4, 5
        n = H * W
        w = grid_weights(rng, B, H, W)
        b = rng.randn(B, n).astype(np.float32) * 2
        C = np.ones((B, 1, n), np.float32)
        d = np.full((B, 1), 6.0, np.float32)
        E = np.zeros((B, 1, n), np.float32)
        E[:, 0, :n // 2] = 1.0
        f = np.full((B, 1), 4.0, np.float32)
        return (jgeneral.make_grid_general(w, b, C=C, d=d, E=E, f=f),
                general.make_grid_general(w, b, C=C, d=d, E=E, f=f,
                                          device="cpu"))
    A, b, C, d, E, f = _eq_ineq_batch(rng)
    if kind == "dense":
        return (jgeneral.make_general(A=A, b=b, C=C, d=d, E=E, f=f),
                dense(A=A, b=b, C=C, d=d, E=E, f=f))
    kw = _sparse_kw(A, b, C, d, E, f)
    return (jgeneral.make_sparse_general(**kw),
            general.make_sparse_general(device="cpu", **kw))


def torch_general_state(js):
    kw = {f: (int(getattr(js, f)) if f == "it"
              else torch.from_numpy(np.array(getattr(js, f))))
          for f in general.GeneralState.__dataclass_fields__}
    return general.GeneralState(**kw)


FIELDS = ("x", "y1", "y2", "y3", "z1", "z2", "z3", "z4", "cur_obj",
          "best_bin_obj", "obj_ring")
DUALS = ("z1", "z2", "z3", "z4")


@pytest.mark.parametrize("kind", ["dense", "sparse", "grid"])
def test_step_matches_jax(kind, rng):
    jp, tp = _problems(kind, rng)
    js = jgeneral.init_state(jp, JCFG)
    js, _ = jgeneral.solve_window(js, jp, JCFG, 6, record=False)
    ts = torch_general_state(js)
    js1 = jgeneral.step(js, jp, JCFG)
    ts1 = general.step(ts, tp, CFG)
    # in the units of x: a dual step scales an error of x by gamma * rho
    from lpbox_admm_tpu_torch.ops.schedule import gamma_at, rho_at
    unit = gamma_at(ts.it, CFG) * rho_at(ts.it, CFG)
    for f in FIELDS:
        ref = np.asarray(getattr(js1, f), np.float64)
        got = np_of(getattr(ts1, f)).astype(np.float64)
        err = np.abs(got - ref).max() / (unit if f in DUALS else 1.0)
        assert err <= 1e-5 * max(1.0, np.abs(ref).max()), (f, err)
    for f in ("done", "cg_fail", "obj_count"):
        np.testing.assert_array_equal(np_of(getattr(ts1, f)),
                                      np.asarray(getattr(js1, f)), f)
    assert ts1.it == int(js1.it)


@pytest.mark.parametrize("kind", ["dense", "sparse", "grid"])
def test_fix_and_constraint_violation_match_jax(kind, rng):
    jp, tp = _problems(kind, rng)
    js = jgeneral.solve(jp, JCFG, max_iters=300, window=50)
    ts = torch_general_state(js)
    for got, ref in zip(general.constraint_violation(ts, tp),
                        jgeneral.constraint_violation(js, jp)):
        np.testing.assert_allclose(np_of(got), np.asarray(ref), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(general.objective(ts, tp).numpy(),
                               np.asarray(jgeneral.objective(js, jp)),
                               rtol=1e-6)
    vec = np.where(np.random.RandomState(2).rand(*js.x.shape) < 0.5,
                   np.asarray(js.x >= 0.5, np.float32), -1.0)
    js2 = jgeneral.apply_fix(js, jp, jnp.asarray(vec, jnp.float32), JCFG,
                             min_fix=0)
    ts2 = general.apply_fix(ts, tp, torch.from_numpy(vec.astype(np.float32)),
                            CFG, min_fix=0)
    for f in ("free", "fixed_val", "b_eff", "d_eff", "f_eff", "done"):
        np.testing.assert_allclose(np_of(getattr(ts2, f)).astype(float),
                                   np.asarray(getattr(js2, f), float),
                                   rtol=1e-6, atol=1e-6, err_msg=f)


def test_compact_sparse_matches_jax(rng):
    """compact_sparse of an unconstrained SparseEll-A problem: the same
    slots, remapped ELL rows, gathered b and state as the JAX package."""
    B, n = 2, 24
    coos, bs = [], []
    for _ in range(B):
        A, b = random_qp(rng, n)
        A[np.abs(A) < 0.5] = 0.0
        coos.append(_coo_of(A))
        bs.append(b)
    b = np.stack(bs).astype(np.float32)
    jp = jgeneral.make_sparse_general(b, A_coo=coos)
    tp = general.make_sparse_general(b, A_coo=coos, device="cpu")
    js = jgeneral.init_state(jp, JCFG)
    js, _ = jgeneral.solve_window(js, jp, JCFG, 5, record=False)
    vec = np.where(np.random.RandomState(5).rand(B, n) < 0.6,
                   np.asarray(js.x >= 0.5, np.float32), -1.0)
    js = jgeneral.apply_fix(js, jp, jnp.asarray(vec, jnp.float32), JCFG,
                            min_fix=0)
    ts = torch_general_state(js)
    n_new = 16
    assert int(np.asarray(js.free.sum(-1)).max()) <= n_new
    js2, jp2, jidx = jgeneral.compact_sparse(js, jp, n_new)
    ts2, tp2, tidx = general.compact_sparse(ts, tp, n_new)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tp2.A.row_idx.numpy(),
                                  np.asarray(jp2.A.row_idx))
    np.testing.assert_array_equal(tp2.A.row_val.numpy(),
                                  np.asarray(jp2.A.row_val))
    np.testing.assert_array_equal(tp2.b.numpy(), np.asarray(jp2.b))
    for f in ("x", "y1", "z2", "free", "fixed_val", "b_eff", "best_sol"):
        np.testing.assert_array_equal(np_of(getattr(ts2, f)),
                                      np.asarray(getattr(js2, f)), f)
    with pytest.raises(ValueError, match="unconstrained"):
        _, tq = _problems("sparse", rng)
        general.compact_sparse(general.init_state(tq, CFG), tq, 8)
