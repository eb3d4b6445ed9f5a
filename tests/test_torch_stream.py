"""The port's single-stream sweep (K3's plain version), stream window and
blocked solve against the JAX package's ``ops/pallas_stream.py`` (the
Pallas kernel in interpret mode) and ``core/lp.solve``, on CA 20x60
batches padded to (m, n) = (128, 128).

Tolerances: one sweep 1e-5 relative to max(1, |ref|) elementwise (the
same formulas; only f32 sums over m and n are reordered).  Windows:
after one iteration 1e-5 of the magnitude of the terms each field is
computed from (``torch_port_util.step_scales``: x = (rhs - E^T u) / 2 rho
cancels terms about 100x larger than x); after 20, 1e-3 in the units of
x (``torch_port_util.state_errors``), as ADMM amplifies f32 reordering
differences from iteration to iteration.  The converged solve: 0 infeasible, the
mean selected objective within 5% and iterations within 15% of the JAX
solve (the bounds of ``test_pallas_stream.py::test_stream_solve_quality``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpbox_admm_tpu.config import LP_CONFIG as JLP_CONFIG
from lpbox_admm_tpu.core import lp as jlp
from lpbox_admm_tpu.ops import pallas_stream
from lpbox_admm_tpu_torch.config import LP_CONFIG
from lpbox_admm_tpu_torch.core import lp as tlp
from lpbox_admm_tpu_torch.ops import fused_stream

from torch_port_util import (ca_instances, np_of, problems, rel,
                             state_errors, step_scales, torch_carry,
                             torch_state)

CFG = LP_CONFIG.replace(linsolve="woodbury")
JCFG = JLP_CONFIG.replace(linsolve="woodbury")


def _close(got, ref, tol, what):
    got, ref = np_of(got).astype(np.float64), np_of(ref).astype(np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref) / np.maximum(1.0, np.abs(ref))
    assert err.max() <= tol, (what, float(err.max()))


@pytest.mark.parametrize("e_dtype", ["float32", "bfloat16"])
def test_sweep_plain_matches_pallas_sweep(e_dtype):
    """One sweep from a carry the JAX bootstrap built, at iteration 24
    (the schedule steps rho at the next iteration, so rho and rho_next
    differ), on all 14 outputs."""
    jp, tp = problems(ca_instances(41, 4))
    assert tuple(tp.E.shape) == (4, 128, 128)
    js = jlp.init_state(jp, JCFG)
    js, _ = jlp.solve_window(js, jp, JCFG, 24, record=False, skip_cvg_at=0)
    jc = pallas_stream._bootstrap(js, jp, JCFG)
    E_j = jp.E.astype(jnp.bfloat16) if e_dtype == "bfloat16" else jp.E
    outs = pallas_stream._run_sweep_ops(jc, E_j, jp, JCFG, 128,
                                        interpret=True)
    tc = torch_carry(jc)
    E_t = fused_stream.stream_operand(tp.E, CFG.replace(matvec_dtype=e_dtype))
    assert E_t.dtype == getattr(torch, e_dtype)
    got = fused_stream.sweep_plain(*fused_stream._sweep_args(
        tc, E_t, tp, tc.state.free.float(), CFG))
    B, n = tp.b.shape
    for k in range(12):
        _close(got.V[:, k], np.asarray(outs[k]).reshape(B, n), 1e-5,
               f"V[{k}]")
    _close(got.F, outs[12], 1e-5, "F")
    _close(got.acc, np.asarray(outs[13]).reshape(B, 16), 1e-5, "acc")


@pytest.mark.parametrize("iters,e_dtype", [(1, "float32"), (1, "bfloat16"),
                                           (20, "float32")])
def test_stream_window_matches_jax(iters, e_dtype):
    """After one iteration each field is held to 1e-5 of the magnitude
    of the terms it is computed from (as ``test_torch_lp.py::
    test_step_matches_jax`` holds one step), and the carried E^T w that
    the window refreshes at its end to 1e-5 of max |ref| (the port's f32
    product against the JAX package's f32 einsum, or its 3-limb bf16
    split with bf16 E); after 20 iterations, to 1e-3 in the units of x."""
    jp, tp = problems(ca_instances(21, 4))
    js0 = jlp.init_state(jp, JCFG)
    ref = pallas_stream.lp_window_stream(
        js0, jp, JCFG.replace(matvec_dtype=e_dtype), iters, skip_cvg_at=0,
        interpret=True)
    got = fused_stream.lp_window_stream(
        torch_state(js0), tp, CFG.replace(matvec_dtype=e_dtype), iters,
        skip_cvg_at=0)
    if iters == 1:
        scales = step_scales(js0, ref, jp, JCFG)
        errs = {f: rel(getattr(got, f), getattr(ref, f),
                       scales.get(f, 0.0)) for f in (
            "x", "y1", "y2", "y3", "z1", "z2", "z4", "ex", "cur_obj",
            "best_bin_obj", "et_next")}
        assert max(errs.values()) <= 1e-5, errs
    else:
        errs = state_errors(got, ref, CFG)
        assert max(errs.values()) <= 1e-3, errs
    assert got.it == int(ref.it) == iters
    np.testing.assert_array_equal(np_of(got.done), np.asarray(ref.done))


def test_stream_window_exits():
    """An all-done state runs no iteration; with one live instance the
    others stay exactly frozen while it runs the whole window."""
    jp, tp = problems(ca_instances(21, 4))
    js0 = jlp.init_state(jp, JCFG)
    ts0 = torch_state(js0)
    all_done = ts0.replace(done=torch.ones(4, dtype=torch.bool))
    out = fused_stream.lp_window_stream(all_done, tp, CFG, 20)
    jout = pallas_stream.lp_window_stream(js0._replace(
        done=jnp.ones(4, bool)), jp, JCFG, 20, interpret=True)
    assert out.it == int(jout.it) == 0
    assert torch.equal(out.x, ts0.x) and torch.equal(out.z4, ts0.z4)

    live = torch.arange(4) == 1
    one = ts0.replace(done=~live)
    out = fused_stream.lp_window_stream(one, tp, CFG, 20, skip_cvg_at=0)
    assert out.it == 20
    frozen = ~live
    for f in ("x", "y1", "y2", "y3", "z1", "z2", "z4", "ex", "obj_ring",
              "obj_count", "cur_obj", "best_bin_obj", "best_sol", "x_prev"):
        assert torch.equal(getattr(out, f)[frozen],
                           getattr(one, f)[frozen]), f
    assert not torch.equal(out.x[live], one.x[live])
    jout = pallas_stream.lp_window_stream(
        js0._replace(done=jnp.asarray(np_of(~live))), jp, JCFG, 20,
        skip_cvg_at=0, interpret=True)
    errs = state_errors(out, jout, CFG)
    assert max(errs.values()) <= 1e-3, errs


def test_solve_blocked_stream_converges_like_jax():
    jp, tp = problems(ca_instances(22, 8))
    ref = jlp.solve(jp, JCFG, window=100, max_iters=20000)
    _, robj, _ = jlp.select_solution(jp, jlp.solution(ref),
                                     jlp.solution_best(ref))
    st, iters = tlp.solve_blocked(tp, CFG, block=4, max_iters=20000,
                                  window=500, stream=True)
    assert len(iters) == 2 and st.it == max(iters)
    assert bool(st.done.all())
    _, sobj, sinf = tlp.select_solution(tp, tlp.solution(st),
                                        tlp.solution_best(st))
    assert int(sinf.max()) == 0
    robj, sobj = np.asarray(robj), np_of(sobj)
    assert abs(sobj.mean() - robj.mean()) / (abs(robj.mean()) + 1.0) \
        < 0.05, (sobj, robj)
    assert abs(st.it - int(ref.it)) <= 0.15 * int(ref.it), (iters,
                                                            int(ref.it))


def test_solve_blocked_plain_runs_solve_window():
    """``stream=False`` is the same round-robin over ``solve_window``,
    the first round skipping the iteration-0 stop."""
    _, tp = problems(ca_instances(23, 4))
    st, iters = tlp.solve_blocked(tp, CFG, block=2, max_iters=40, window=20)
    assert iters == [40, 40] and st.it == 40
    for k, lo in enumerate((0, 2)):
        p = tp.replace(**{f: getattr(tp, f)[lo:lo + 2] for f in
                          ("b", "E", "f", "row_mask", "var_mask")})
        s = tlp.init_state(p, CFG)
        s, _ = tlp.solve_window(s, p, CFG, 20, record=False, skip_cvg_at=0)
        s, _ = tlp.solve_window(s, p, CFG, 20, record=False)
        for f in ("x", "z1", "z4", "best_sol", "ginv"):
            assert torch.equal(getattr(st, f)[lo:lo + 2], getattr(s, f)), f
    assert torch.equal(tlp.solve(tp, CFG, max_iters=40, window=20).x,
                       tlp.solve_blocked(tp, CFG, block=4, max_iters=40,
                                         window=20)[0].x)


def test_stream_refuses_what_it_does_not_port():
    _, tp = problems(ca_instances(23, 2))
    s0 = tlp.init_state(tp, CFG)
    with pytest.raises(ValueError, match="woodbury"):
        fused_stream.lp_window_stream(s0, tp, LP_CONFIG, 2)
    # bfloat16 G^-1 storage is ported (the JAX package's stream window
    # takes it too); test_torch_lp_options.py holds its products
    bcfg = CFG.replace(ginv_dtype="bfloat16")
    sb = fused_stream.lp_window_stream(tlp.init_state(tp, bcfg), tp, bcfg, 2)
    assert sb.ginv.dtype == torch.bfloat16 and sb.it == 2
    assert bool(torch.isfinite(sb.x).all())
    with pytest.raises(ValueError, match="m <= 4096"):
        fused_stream._plan(8, 4224, 4096, 2, 132)
    with pytest.raises(ValueError, match="multiple of 128"):
        fused_stream._plan(8, 1664, 4000, 2, 132)
    plan = lambda m, e: fused_stream._plan(8, m, 4096, e, 132)[:3]
    assert plan(1664, 2) == (2, 3, 16)
    assert plan(1664, 4) == (2, 3, 8)
    assert plan(4096, 2) == (1, 2, 8)
    assert plan(4096, 4) == (1, 2, 4)


# m -> (16-byte chunks per staged row, ring stages, shared memory bytes):
# M as float4 rows 16 m, the 16 warps' sums 2048 and A of two tiles
# 1024, then per stage m rows of 16 cpr bytes and 7 x 16 staged vector
# floats (448 bytes)
K3_PLAN = {256: (2, 4, 4096 + 3072 + 4 * (8192 + 448)),
           1664: (2, 3, 26624 + 3072 + 3 * (53248 + 448)),
           2036: (2, 3, 32576 + 3072 + 3 * (65152 + 448)),
           2037: (1, 4, 32592 + 3072 + 4 * (32592 + 448)),
           4096: (1, 2, 65536 + 3072 + 2 * (65536 + 448))}


@pytest.mark.parametrize("m", sorted(K3_PLAN))
def test_sweep_plan_closed_form(m):
    """K3's shared memory and ring sizing in closed form (the kernel
    refuses any other plan): two chunks per row up to m = 2036, where
    three stages of 32-byte rows (the tiles transposed and forwarded, one
    in flight) still fit 232 448 bytes, one beyond; at most four stages;
    tiles of 32 bytes a row (16 bf16 or 8 f32 columns) or 16; one block
    per SM, at most one per 32-column unit."""
    cpr, stages, smem = K3_PLAN[m]
    for e_bytes in (2, 4):
        p = fused_stream._plan(8, m, 4096, e_bytes, 132)
        assert (p.cpr, p.stages, p.smem) == (cpr, stages, smem)
        assert p.nb == 16 * cpr // e_bytes and p.smem <= 232448
        assert p.grid == 132
    assert fused_stream._plan(2, m, 512, 2, 132).grid == 32   # 2 * 512 / 32


@pytest.mark.parametrize("B, n, G", [(8, 4096, 132), (2, 512, 32),
                                     (3, 640, 7), (1, 128, 4)])
def test_sweep_units_cover_each_instance_once(B, n, G):
    """The persistent sweep's split of the B * n / 32 column units over G
    blocks, as csrc/stream_sweep.cu computes it: block g walks units
    [g NU / G, (g+1) NU / G) and writes one F partial per instance it
    touches, into slot g + b; the finish launch adds, for instance b, the
    slots of blocks g_lo(b) .. g_hi(b).  Every slot is written once, each
    instance's units are covered once, and the workspace holds
    G + B - 1 slots."""
    upi = n // 32
    NU = B * upi
    slots, writer = {}, {}
    for g in range(G):
        for u in range(g * NU // G, (g + 1) * NU // G):
            slots.setdefault(g + u // upi, set()).add(u)
            assert writer.setdefault(g + u // upi, g) == g   # one block
    assert max(slots) < G + B - 1
    for b in range(B):
        g_lo = ((b * upi + 1) * G - 1) // NU
        g_hi = (((b + 1) * upi) * G - 1) // NU
        units = [slots[g + b] for g in range(g_lo, g_hi + 1)]
        assert sorted(u for s in units for u in s) == \
            list(range(b * upi, (b + 1) * upi))
