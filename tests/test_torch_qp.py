"""The port's grid QP solver (``ops/stencil.py``, ``core/qp.py``, the seg
half of ``ops/repair.py``) against the JAX package's on the CPU, on
synthetic images of the smoke's recipe at 24 x 32 and 40 x 40 (non-square,
so that H and W cannot be swapped unnoticed)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpbox_admm_tpu.adapters import segmentation as jseg
from lpbox_admm_tpu.config import SEG_CONFIG as JCFG
from lpbox_admm_tpu.core import general as jgeneral
from lpbox_admm_tpu.core import qp as jqp
from lpbox_admm_tpu.ops import repair as jrepair
from lpbox_admm_tpu.ops import stencil as jstencil
from lpbox_admm_tpu_torch.adapters import segmentation as tseg
from lpbox_admm_tpu_torch.config import SEG_CONFIG as TCFG
from lpbox_admm_tpu_torch.core import general as tgeneral
from lpbox_admm_tpu_torch.core import qp as tqp
from lpbox_admm_tpu_torch.ops import repair as trepair
from lpbox_admm_tpu_torch.ops import sparse as tsparse
from lpbox_admm_tpu_torch.ops import stencil as tstencil

from torch_port_util import np_of, seg_images

GRIDS = [(24, 32), (40, 40)]


def problems(H, W, seed=3, count=3):
    ims = seg_images(seed, count, H, W)
    return jseg.make_problem(ims), tseg.make_problem(ims, device="cpu")


def torch_qp_state(js):
    kw = {f: (int(getattr(js, f)) if f == "it"
              else torch.from_numpy(np.array(getattr(js, f))))
          for f in tqp.QpState.__dataclass_fields__}
    return tqp.QpState(**kw)


def dense_A(weights):
    """(D - W) of one image's (8, H, W) planes, float64."""
    _, H, W = weights.shape
    n = H * W
    M = np.zeros((n, n))
    for d, (dr, dc) in enumerate(tstencil.OFFSETS):
        for i in range(H):
            for j in range(W):
                r, c = i + dr, j + dc
                if 0 <= r < H and 0 <= c < W:
                    M[i * W + j, r * W + c] = weights[d, i, j]
    return np.diag(M.sum(1)) - M


def state_close(got, ref, tol, fields=("x", "y1", "y2", "z1", "z2",
                                       "best_sol", "x_prev")):
    """max |got - ref| over the iterate fields, over max(1, |ref|)."""
    out = {}
    for f in fields:
        a = np_of(getattr(got, f)).astype(np.float64)
        b = np_of(getattr(ref, f)).astype(np.float64)
        out[f] = np.abs(a - b).max() / max(1.0, np.abs(b).max())
    assert max(out.values()) <= tol, out
    return out


@pytest.mark.parametrize("H,W", GRIDS)
def test_stencil_ops_match_jax_and_dense(H, W):
    jp, tp = problems(H, W)
    rng = np.random.RandomState(0)
    x = rng.rand(3, H, W).astype(np.float32)
    xt = torch.from_numpy(x)
    for dr, dc in tstencil.OFFSETS + ((0, 0),):
        np.testing.assert_array_equal(
            tstencil.shift(xt, dr, dc).numpy(),
            np.asarray(jstencil.shift(jnp.asarray(x), dr, dc)))
    st = tp.stencil
    for name in ("w_matvec", "a_matvec"):
        got = getattr(st, name)(xt).numpy()
        ref = np.asarray(getattr(jp.stencil, name)(jnp.asarray(x)))
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(
            ref).max())
    np.testing.assert_allclose(
        tstencil.quad_form(st, xt).numpy(),
        np.asarray(jstencil.quad_form(jp.stencil, jnp.asarray(x))),
        rtol=1e-5)
    np.testing.assert_array_equal(st.a_diag().numpy(),
                                  np.asarray(jp.stencil.a_diag()))
    for b in range(2):
        A = dense_A(st.weights[b].numpy().astype(np.float64))
        ref = (A @ x[b].reshape(-1).astype(np.float64)).reshape(H, W)
        np.testing.assert_allclose(st.a_matvec(xt)[b].numpy(), ref,
                                   rtol=0, atol=1e-5 * np.abs(ref).max())
        qf = x[b].reshape(-1) @ A @ x[b].reshape(-1)
        assert abs(tstencil.quad_form(st, xt)[b].item() - qf) \
            <= 1e-5 * abs(qf)


def test_shift_builds_no_wraparound():
    x = torch.arange(12.0).reshape(1, 3, 4)
    got = tstencil.shift(x, 1, -1)
    assert got[0, 2].abs().sum() == 0 and got[0, :, 0].abs().sum() == 0
    assert got[0, 0, 1] == x[0, 1, 0]


@pytest.mark.parametrize("H,W", GRIDS)
def test_qp_step_matches_jax(H, W):
    jp, tp = problems(H, W)
    js = jqp.init_state(jp, JCFG)
    ts = tqp.init_state(tp, TCFG)
    js, _ = jqp.solve_window(js, jp, JCFG, 1, record=False)
    ts, _ = tqp.solve_window(ts, tp, TCFG, 1, record=False)
    state_close(ts, js, 1e-5)
    # 20 iterations: the ADMM is chaotic, held to 1e-3 (ROADMAP's rule)
    js, jt = jqp.solve_window(js, jp, JCFG, 19, record=True)
    ts, tt = tqp.solve_window(ts, tp, TCFG, 19, record=True)
    assert ts.it == int(js.it) == 20
    state_close(ts, js, 1e-3)
    assert tt.shape == (3, H, W, 19)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(ts.best_bin_obj.numpy(),
                               np.asarray(js.best_bin_obj), rtol=1e-3)


@pytest.mark.parametrize("H,W", GRIDS)
def test_qp_fix_and_compact_match_jax(H, W):
    """apply_fix, rule_fix_vec and compact's ELL rows and gathered b
    equal the JAX package's from the same state."""
    jp, tp = problems(H, W)
    js = jqp.init_state(jp, JCFG)
    js, _ = jqp.solve_window(js, jp, JCFG, 12, record=False,
                             rule_fixing=True)
    ts = torch_qp_state(js)
    np.testing.assert_array_equal(tqp.rule_fix_vec(ts, TCFG).numpy(),
                                  np.asarray(jqp.rule_fix_vec(js, JCFG)))
    rng = np.random.RandomState(1)
    vec = np.where(rng.rand(3, H, W) < 0.6,
                   (np.asarray(js.x) >= 0.5).astype(np.float32),
                   -1.0).astype(np.float32)
    js2 = jqp.apply_fix(js, jp, jnp.asarray(vec), JCFG, min_fix=0)
    ts2 = tqp.apply_fix(ts, tp, torch.from_numpy(vec), TCFG, min_fix=0)
    for f in ("free", "fixed_val", "b_eff", "done", "x_prev"):
        np.testing.assert_array_equal(np_of(getattr(ts2, f)),
                                      np.asarray(getattr(js2, f)), f)
    n_free = int(np.asarray(js2.free.sum(axis=(-2, -1))).max())
    n_new = 1 << (n_free - 1).bit_length()
    jg, jgp, jidx = jqp.compact(js2, jp, JCFG, n_new)
    tg, tgp, tidx = tqp.compact(ts2, tp, TCFG, n_new)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tgp.A.row_idx.numpy(),
                                  np.asarray(jgp.A.row_idx))
    np.testing.assert_array_equal(tgp.A.row_val.numpy(),
                                  np.asarray(jgp.A.row_val))
    np.testing.assert_array_equal(tgp.b.numpy(), np.asarray(jgp.b))
    np.testing.assert_array_equal(tgp.var_mask.numpy(),
                                  np.asarray(jgp.var_mask))
    for f in ("x", "y1", "z1", "fixed_val", "best_sol", "fix_count"):
        np.testing.assert_array_equal(np_of(getattr(tg, f)),
                                      np.asarray(getattr(jg, f)), f)
    # the ELL A is D - W restricted to free-free pairs
    Ac = tsparse.to_dense(tgp.A).numpy()
    A = dense_A(tp.stencil.weights[0].numpy().astype(np.float64))
    ii = tidx[0].numpy()
    fc = tgp.var_mask[0].numpy()
    np.testing.assert_allclose(Ac[0], A[np.ix_(ii, ii)] * fc[:, None]
                               * fc[None, :], rtol=0, atol=1e-6)


@pytest.mark.parametrize("H,W", GRIDS)
def test_compacted_general_window_matches_masked_grid(H, W):
    """One core.general window on the compacted problem follows the
    masked grid window pointwise (to 5e-3, the JAX package's own bound)
    and the JAX package's compacted window."""
    _, tp = problems(H, W)
    jp, _ = problems(H, W)
    ts = tqp.init_state(tp, TCFG)
    ts, _ = tqp.solve_window(ts, tp, TCFG, 10, record=False)
    rng = np.random.RandomState(4)
    vec = np.where(rng.rand(3, H, W) < 0.5,
                   (ts.x.numpy() >= 0.5).astype(np.float32), -1.0)
    ts = tqp.apply_fix(ts, tp, torch.from_numpy(vec.astype(np.float32)),
                       TCFG, min_fix=0)
    n_free = int(ts.free.sum((-2, -1)).max())
    n_new = 1 << (n_free - 1).bit_length()
    tg, tgp, idx = tqp.compact(ts, tp, TCFG, n_new)
    ref, _ = tqp.solve_window(ts, tp, TCFG, 8, record=False)
    got, _ = tgeneral.solve_window(tg, tgp, TCFG, 8, record=False)
    for b in range(3):
        ii = idx[b].numpy()
        fc = tg.free[b].numpy()
        np.testing.assert_allclose(got.x[b].numpy()[fc],
                                   ref.x[b].numpy().reshape(-1)[ii][fc],
                                   rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(got.best_bin_obj.numpy(),
                               ref.best_bin_obj.numpy(), rtol=5e-2, atol=5e-2)
    js = jqp.init_state(jp, JCFG)
    js, _ = jqp.solve_window(js, jp, JCFG, 10, record=False)
    js = jqp.apply_fix(js, jp, jnp.asarray(vec.astype(np.float32)), JCFG,
                       min_fix=0)
    jg, jgp, _ = jqp.compact(js, jp, JCFG, n_new)
    jgot, _ = jgeneral.solve_window(jg, jgp, JCFG, 8, record=False)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(jgot.x), rtol=0,
                               atol=5e-3)


def _rounded(H, W, iters=15):
    """A rounding of an unconverged iterate (room for both descents)."""
    jp, tp = problems(H, W)
    js = jqp.init_state(jp, JCFG)
    js, _ = jqp.solve_window(js, jp, JCFG, iters, record=False)
    sol = np.asarray(jqp.solution(js)) * np.asarray(jp.mask)
    return jp, tp, js, sol.astype(np.float32)


@pytest.mark.parametrize("H,W", GRIDS)
def test_descents_bit_for_bit(H, W):
    jp, tp, _, sol = _rounded(H, W)
    for fn, sweeps in (("icm_descent", 8), ("pair_descent", 4)):
        ref = np.asarray(getattr(jrepair, fn)(jp.stencil, jp.b, jp.mask,
                                              jnp.asarray(sol), sweeps))
        got = getattr(trepair, fn)(tp.stencil, tp.b, tp.mask,
                                   torch.from_numpy(sol), sweeps).numpy()
        np.testing.assert_array_equal(got, ref, fn)
        assert (got != sol).any(), f"{fn} moved nothing"


@pytest.mark.parametrize("H,W", GRIDS)
def test_select_solution_bit_for_bit(H, W):
    jp, tp, js, _ = _rounded(H, W)
    ts = torch_qp_state(js)
    jsol, je = jqp.select_solution(js, jp, repair_sweeps=8, pair_sweeps=4)
    tsol, te = tqp.select_solution(ts, tp, repair_sweeps=8, pair_sweeps=4)
    np.testing.assert_array_equal(tsol.numpy(), np.asarray(jsol))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    e0 = tqp.energy(ts, tp)
    assert (te <= e0).all()
    np.testing.assert_array_equal(e0.numpy(), np.asarray(jqp.energy(js, jp)))


def test_plain_solve_matches_jax_and_scatter():
    jp, tp = problems(24, 32)
    js = jqp.solve(jp, JCFG, max_iters=2000, window=50)
    ts = tqp.solve(tp, TCFG, max_iters=2000, window=50)
    assert ts.it == int(js.it)
    np.testing.assert_array_equal(tqp.solution(ts).numpy(),
                                  np.asarray(jqp.solution(js)))
    np.testing.assert_array_equal(tqp.energy(ts, tp).numpy(),
                                  np.asarray(jqp.energy(js, jp)))
    # scatter_solution restores the grid from the flat slots
    free = ts.free.clone()
    free[:, ::2] = False
    fixed = torch.where(free, torch.zeros_like(ts.x), torch.ones_like(ts.x))
    st = ts.replace(free=free, fixed_val=fixed)
    n_free = int(free.sum((-2, -1)).max())
    n_new = 1 << (n_free - 1).bit_length()
    g, _, idx = tqp.compact(st, tp, TCFG, n_new)
    back = tqp.scatter_solution(tgeneral.solution(g), idx, fixed, free)
    np.testing.assert_array_equal(back.numpy(), tqp.solution(st).numpy())


def test_rule_fixing_solve_matches_jax():
    jp, tp = problems(24, 32)
    js = jqp.solve(jp, JCFG, max_iters=400, window=50, rule_fixing=True)
    ts = tqp.solve(tp, TCFG, max_iters=400, window=50, rule_fixing=True)
    assert ts.it == int(js.it)
    np.testing.assert_array_equal(ts.free.numpy(), np.asarray(js.free))
    np.testing.assert_array_equal(tqp.solution(ts).numpy(),
                                  np.asarray(jqp.solution(js)))
