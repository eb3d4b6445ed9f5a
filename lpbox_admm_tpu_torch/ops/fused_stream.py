"""K3: the single-stream LP sweep (``csrc/stream_sweep.cu``), its plain
PyTorch version, and the stream window around it.

Port of the JAX package's ``ops/pallas_stream.py``.  At the large CA
rungs the Woodbury iteration is bound by its passes over E.  The
single-stream scheme reads E once per iteration: a column-blocked sweep
finishes iteration t for every column (the transpose products M E) and
at once pays iteration t+1's forward products (A E^T).  Two global
couplings are deferred to the plain-tensor glue after the sweep: the
PCG warm-start keep test (the sweep computes both the keep and the exact
branch for every column) and the sphere projection's norm (the forward
products carry a base and a shift part that the glue combines once the
scale ``s`` is known).

``lp_window_stream`` runs a window of Woodbury-mode iterations: the
bootstrap (two E products and one G^{-1} product), then per iteration
one sweep (the kernel on a CUDA tensor, counted in ``LAUNCHES``;
``sweep_plain`` on a CPU tensor) and the glue, which applies G^{-1} to
the next rhs densely or, with ``ginv_apply="packed-sym"`` or
``LPBOX_SYMM=1``, through K4's triangular read (``ops.symm``).  It
stops before an iteration once every instance is done, as the JAX
package's while loop does.  Rule-fixing counters are not updated.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import NamedTuple, Optional

import torch

from ..config import SolverConfig
from ..core import lp as lp_core
from ..core.problem import LpProblem
from . import symm
from .schedule import gamma_at, rho_at

_EPS = 2.2204e-16
#: per-instance sums of the sweep: 0 r0sq  1 rhssq  then per branch
#: (keep, exact) 2/3 shiftsq  4/5 c1sq  6/7 c2sq  8/9 xnsq  10/11 obj
#: 12/13 objbin; 14/15 are 0
_NACC = 16
#: forward-product rows per branch: base, shift, y1 (= next x0), rounded
_NF = 4
#: the kernel's shared memory per thread block, and its largest m
_SMEM_MAX = 232448
_M_MAX = 4096

#: kernel launches made by ``sweep_cuda`` in this process
LAUNCHES = 0

_w_vec = lp_core._w_vec


class StreamCarry(NamedTuple):
    state: lp_core.LpState
    rhs: torch.Tensor      # (B, n) the current iteration's rhs
    x0: torch.Tensor       # (B, n) warm start = free * y1
    shift: torch.Tensor    # (B, n) masked sphere shift (for y2)
    s: torch.Tensor        # (B,) sphere scale of the current iteration
    M: torch.Tensor        # (B, 4, m) transpose stack [u, E x0, w_k, w_e]
    exk: torch.Tensor      # (B, m) E x0 (keep-branch ex)
    exe: torch.Tensor      # (B, m) E x_exact (exact-branch ex)


class SweepOut(NamedTuple):
    V: torch.Tensor        # (B, 12, n) [x, z1, z2, y1, base, shift] x (k, e)
    F: torch.Tensor        # (B, 8, m) forward products, keep rows first
    acc: torch.Tensor      # (B, 16) per-instance sums


def _rho_gamma(it: int, cfg: SolverConfig):
    return rho_at(it, cfg), gamma_at(it, cfg)


def _sphere_scale(shift_sq, n_act, p: int):
    nrm = torch.clamp_min(torch.sqrt(shift_sq), _EPS)
    return (n_act ** (1.0 / p)) / (2.0 * nrm)


#: the kernel's warps per block, columns per unit of work, widest tile,
#: vectors staged per tile and ring depth limit (``NWARP``, ``UNIT``,
#: ``NB_MAX``, ``NVEC``, ``MAX_STAGES`` in csrc/stream_sweep.cu)
_NWARP, _UNIT, _NB_MAX, _NVEC, _MAX_STAGES = 16, 32, 16, 7, 4


def _smem_bytes(m: int, cpr: int, stages: int) -> int:
    """``smem_bytes`` of csrc/stream_sweep.cu: M as float4 rows, the
    warps' transpose sums and A of two tiles, then ``stages`` ring stages
    of m rows of ``cpr`` 16-byte chunks and the 7 staged column-vector
    slices."""
    fixed = m * 16 + _NWARP * 32 * 4 + 2 * _NB_MAX * 8 * 4
    return fixed + stages * (m * 16 * cpr + _NVEC * _NB_MAX * 4)


@functools.cache
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


class SweepPlan(NamedTuple):
    """How K3 cuts a sweep at (m, n): 16-byte chunks per staged row, ring
    stages, tile columns, blocks of the persistent grid, and the shared
    memory of one block."""
    cpr: int
    stages: int
    nb: int
    grid: int
    smem: int


def _plan(B: int, m: int, n: int, e_bytes: int, sms: int) -> SweepPlan:
    """The kernel's plan (``plan_cpr``/``plan_stages`` of
    csrc/stream_sweep.cu, which refuses any other): two chunks per row
    where three such stages fit a block's shared memory (the tiles being
    transposed and forwarded, and one in flight), else one; then as many
    stages as fit, at most four; one block per SM, at most one per unit
    of 32 columns.  cpr and the stages depend on m alone, so bf16 and f32
    E take the same row parts and the same units."""
    if m > _M_MAX:
        raise ValueError(f"the stream sweep takes m <= {_M_MAX}, got {m}")
    if n % 128:
        raise ValueError(f"the stream sweep needs n a multiple of 128, "
                         f"got {n}")
    cpr = 2 if _smem_bytes(m, 2, 3) <= _SMEM_MAX else 1
    fixed = _smem_bytes(m, cpr, 0)
    stages = min(_MAX_STAGES, (_SMEM_MAX - fixed) //
                 (_smem_bytes(m, cpr, 1) - fixed))
    grid = min(sms, B * n // _UNIT)
    return SweepPlan(cpr=cpr, stages=stages, nb=cpr * 16 // e_bytes,
                     grid=grid, smem=_smem_bytes(m, cpr, stages))


def stream_operand(E: torch.Tensor, cfg: SolverConfig) -> torch.Tensor:
    """E as the sweep reads it: bfloat16 under ``matvec_dtype=
    "bfloat16"`` (exact for 0/1 entries, half the bytes), else as
    stored."""
    if cfg.matvec_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"matvec_dtype {cfg.matvec_dtype!r}")
    if cfg.matvec_dtype == "bfloat16" and E.dtype != torch.bfloat16:
        E = E.to(torch.bfloat16)
    return E.contiguous()


def _bootstrap(state: lp_core.LpState, prob: LpProblem,
               cfg: SolverConfig) -> StreamCarry:
    """The pipeline operands of the state's current iteration (the front
    half of ``core.lp.step``: two E products and one G^{-1} product, paid
    once per window)."""
    dt = state.x.dtype
    free_f = state.free.to(dt)
    it = state.it
    rho, gamma = _rho_gamma(it, cfg)
    c = rho + rho
    y1 = torch.clamp(state.x + state.z1 / rho, 0.0, 1.0)
    shift = free_f * (state.x + state.z2 / rho - 0.5)
    n_act = free_f.sum(-1)
    s = _sphere_scale((shift * shift).sum(-1), n_act, cfg.projection_lp)
    y2 = 0.5 + s[:, None] * shift
    rhs = free_f * (rho * y1 + rho * y2
                    - (prob.b + state.z1 + state.z2) + state.et_next)
    x0 = free_f * y1
    fw = torch.bmm(prob.E.float(), torch.stack([rhs, x0], dim=2))
    Erhs, Ex0 = fw[..., 0], fw[..., 1]
    u = lp_core._ginv_apply(state.ginv, Erhs)
    Ex_exact = (lp_core._wb_ratio(cfg) / c) * u
    rho_nx, _ = _rho_gamma(it + 1, cfg)
    y3 = torch.clamp_min(state.f_eff - state.ex - state.z4 / rho, 0.0)
    z4_k = state.z4 + gamma * rho * (Ex0 + y3 - state.f_eff)
    z4_e = state.z4 + gamma * rho * (Ex_exact + y3 - state.f_eff)
    w_k = _w_vec(state.f_eff, Ex0, z4_k, rho_nx)
    w_e = _w_vec(state.f_eff, Ex_exact, z4_e, rho_nx)
    M = torch.stack([u, Ex0, w_k, w_e], dim=1)
    return StreamCarry(state=state, rhs=rhs, x0=x0, shift=shift, s=s, M=M,
                       exk=Ex0, exe=Ex_exact)


def sweep_plain(E, M, rhs, x0, shift, z1, z2, b, free_f, s,
                rho: float, gamma: float, rho_nx: float) -> SweepOut:
    """The sweep's arithmetic in PyTorch (pallas_stream.py
    ``_sweep_kernel``, line 75-163), batched over instances: the same
    elementwise formulas; the sums over m and n in another order."""
    E32 = E.float()
    T = torch.bmm(M, E32)                                   # (B, 4, n)
    etu, etex0 = T[:, 0], T[:, 1]
    c = rho + rho
    fr = free_f[:, None]                                    # (B, 1, n)
    y2 = 0.5 + s[:, None] * shift
    r0 = rhs - free_f * (c * x0 + rho * etex0)
    # both branches at once along dim 1: keep (x = x0), exact
    x_b = torch.stack([x0, free_f * (rhs - etu) / c], dim=1)
    x0_, y2_, b_ = x0[:, None], y2[:, None], b[:, None]
    z1n = z1[:, None] + gamma * rho * fr * (x_b - x0_)
    z2n = z2[:, None] + gamma * rho * fr * (x_b - y2_)
    y1n = torch.clamp(x_b + z1n / rho_nx, 0.0, 1.0)
    shfn = fr * (x_b + z2n / rho_nx - 0.5)
    base = fr * (rho_nx * y1n + rho_nx * 0.5 - (b_ + z1n + z2n)
                 + T[:, 2:4])
    rounded = fr * (x_b >= 0.5).to(fr.dtype)
    d1 = fr * (x_b - x0_)
    d2 = fr * (x_b - y2_)
    B, n = rhs.shape
    V = torch.stack([x_b, z1n, z2n, y1n, base, shfn], dim=1) \
        .reshape(B, 12, n)
    per = torch.stack([shfn * shfn, d1 * d1, d2 * d2, fr * x_b * x_b,
                       b_ * fr * x_b, b_ * rounded], dim=1).sum(-1)
    acc = torch.cat([(r0 * r0).sum(-1, keepdim=True),
                     (rhs * rhs).sum(-1, keepdim=True), per.reshape(B, 12),
                     rhs.new_zeros(B, _NACC - 14)], dim=1)
    A = torch.stack([base, shfn, fr * y1n, rounded], dim=2) \
        .reshape(B, 2 * _NF, n)
    F = torch.bmm(A, E32.transpose(1, 2))                   # (B, 8, m)
    return SweepOut(V=V, F=F, acc=acc)


class _Args(ctypes.Structure):
    """ctypes mirror of ``StreamSweepArgs`` in csrc/stream_sweep.cu."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "E", "M", "rhs", "x0", "shift", "z1", "z2", "b", "free_f", "s",
        "V", "F", "acc", "f_part", "s_part")] + [
        (name, ctypes.c_int) for name in (
            "B", "m", "n", "nb", "cpr", "stages", "grid",
            "e_bf16")] + [
        (name, ctypes.c_float) for name in ("rho", "gamma", "rho_nx")]


def sweep_cuda(E, M, rhs, x0, shift, z1, z2, b, free_f, s,
               rho: float, gamma: float, rho_nx: float) -> SweepOut:
    """Launch the CUDA kernel on PyTorch's current stream."""
    global LAUNCHES
    from ..kernels import build

    B, m, n = E.shape
    dev = E.device
    if not E.is_cuda:
        raise ValueError(f"E: expected a CUDA tensor, got device {dev}")
    if E.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"E must be float32 or bfloat16, got {E.dtype}")
    vecs = dict(M=(M, (B, 4, m)), rhs=(rhs, (B, n)), x0=(x0, (B, n)),
                shift=(shift, (B, n)), z1=(z1, (B, n)), z2=(z2, (B, n)),
                b=(b, (B, n)), free_f=(free_f, (B, n)), s=(s, (B,)))
    for name, (t, shape) in dict(vecs, E=(E, (B, m, n))).items():
        if t.device != dev or tuple(t.shape) != shape or \
                not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous {shape} tensor "
                             f"on {dev}, got {tuple(t.shape)} on {t.device}")
        if name != "E" and t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
    for name, t in (("E", E), *((k, v[0]) for k, v in vecs.items()
                                  if k not in ("M", "s"))):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the sweep copies 16-byte pieces; its "
                             "data pointer is not 16-byte aligned")
    e_bytes = E.element_size()
    plan = _plan(B, m, n, e_bytes, _sm_count(dev))
    f32 = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    out = SweepOut(V=f32(B, 12, n), F=f32(B, 2 * _NF, m), acc=f32(B, _NACC))
    f_part = f32(plan.grid + B - 1, 2 * _NF, m)
    s_part = f32(B, 14, n)
    p = build.ptr
    args = _Args(p(E), p(M), p(rhs), p(x0), p(shift), p(z1), p(z2), p(b),
                 p(free_f), p(s), p(out.V), p(out.F), p(out.acc), p(f_part),
                 p(s_part), B, m, n, plan.nb, plan.cpr, plan.stages,
                 plan.grid, int(e_bytes == 2), rho, gamma, rho_nx)
    lib = build.library()
    build.check_struct(lib, "lpbox_stream_sweep_args_size", _Args)
    if lib.lpbox_stream_sweep_smem(m, plan.cpr, plan.stages) != plan.smem:
        raise RuntimeError("stream sweep: shared-memory size differs "
                           "between the wrapper and the kernel")
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(lib, lib.lpbox_stream_sweep(ctypes.addressof(args), stream),
                "stream sweep kernel")
    LAUNCHES += 1
    return out


def _sweep_args(carry: StreamCarry, E_op, prob: LpProblem, free_f,
                cfg: SolverConfig):
    """The sweep's operands and scalars for the carry's iteration."""
    st = carry.state
    rho, gamma = _rho_gamma(st.it, cfg)
    rho_nx, _ = _rho_gamma(st.it + 1, cfg)
    return (E_op, carry.M, carry.rhs, carry.x0, carry.shift, st.z1, st.z2,
            prob.b, free_f, carry.s, rho, gamma, rho_nx)


def sweep(*args) -> SweepOut:
    """The kernel on a CUDA tensor, the plain version on a CPU tensor."""
    E = args[0]
    if E.is_cuda:
        return sweep_cuda(*args)
    if E.device.type == "cpu":
        return sweep_plain(*args)
    raise ValueError(f"no stream sweep for device {E.device}")


def _glue(carry: StreamCarry, outs: SweepOut, prob: LpProblem,
          cfg: SolverConfig, skip_cvg_at: Optional[int], Gp=None,
          symv=symm.symm_matvec) -> StreamCarry:
    """Resolve the sweep: pick the keep or exact branch, finish iteration
    t's convergence and incumbent bookkeeping, and prepare iteration
    t+1's operands (O(n) and O(m) tensor work and one G^{-1} product)."""
    st = carry.state
    it = st.it
    rho, gamma = _rho_gamma(it, cfg)
    rho_nx, gamma_nx = _rho_gamma(it + 1, cfg)
    rho_n2, _ = _rho_gamma(it + 2, cfg)
    ratio = lp_core._wb_ratio(cfg)
    active = ~st.done
    act = active[:, None]
    acc = outs.acc

    keep = acc[:, 0] < acc[:, 1] * (cfg.pcg_tol ** 2)
    kp = keep[:, None]
    sel = torch.where(kp[..., None], outs.V[:, 0::2], outs.V[:, 1::2])
    x_new, z1_new, z2_new, y1_next, base_n, shift_n = sel.unbind(1)
    sums = torch.where(kp, acc[:, 2:14:2], acc[:, 3:14:2])
    shift_sq, c1sq, c2sq, xnsq, obj_val, obj_bin = sums.unbind(1)
    ex_new = torch.where(kp, carry.exk, carry.exe)
    Fsel = torch.where(kp[..., None], outs.F[:, :_NF], outs.F[:, _NF:])
    E_base, E_shift, E_y1n, E_round = Fsel.unbind(1)

    # --- convergence of iteration t (as core.lp.step) -------------------
    xn = torch.clamp_min(torch.sqrt(xnsq), _EPS)
    c1 = torch.sqrt(c1sq) / xn
    c2 = torch.sqrt(c2sq) / xn
    cvg = (c1 <= cfg.stop_threshold) & (c2 <= cfg.stop_threshold)
    if skip_cvg_at is not None and it == skip_cvg_at:
        cvg = torch.zeros_like(cvg)
    push = active & ~cvg
    H = cfg.history_size
    slot = torch.remainder(st.obj_count, H)
    onehot = slot[:, None] == torch.arange(H, device=slot.device)[None, :]
    obj_ring = torch.where(push[:, None] & onehot, obj_val[:, None],
                           st.obj_ring)
    obj_count = st.obj_count + push.to(torch.int32)
    mean = obj_ring.mean(-1, keepdim=True)
    var = ((obj_ring - mean) ** 2).sum(-1) / (H - 1)
    rel = torch.sqrt(var) / torch.clamp_min(obj_val.abs(), _EPS)
    rel = torch.where(obj_count >= H, rel, torch.ones_like(rel))
    std_stop = push & (rel <= cfg.std_threshold)
    newly_done = active & (cvg | std_stop)

    # --- incumbent ------------------------------------------------------
    cur_obj, best_bin_obj, best_sol = st.cur_obj, st.best_bin_obj, \
        st.best_sol
    if cfg.incumbent_stride <= 1 or it % cfg.incumbent_stride == 0:
        track = active & ~newly_done
        cur_obj = torch.where(track, obj_bin, st.cur_obj)
        better = track & (st.best_bin_obj >= obj_bin)
        if cfg.feasible_incumbent:
            feas = ((E_round <= st.f_eff + 1e-6) | ~prob.row_mask).all(-1)
            better = better & feas
        best_bin_obj = torch.where(better, obj_bin, st.best_bin_obj)
        best_sol = torch.where(better[:, None], x_new, st.best_sol)

    # --- dual z4 and the state after iteration t ------------------------
    y3 = torch.clamp_min(st.f_eff - st.ex - st.z4 / rho, 0.0)
    z4_new = st.z4 + gamma * rho * (ex_new + y3 - st.f_eff)
    upd = lambda new, old: torch.where(act, new, old)
    ns = st.replace(
        x=upd(x_new, st.x), z1=upd(z1_new, st.z1), z2=upd(z2_new, st.z2),
        z4=upd(z4_new, st.z4), y1=upd(carry.x0, st.y1),
        y2=upd(0.5 + carry.s[:, None] * carry.shift, st.y2),
        y3=upd(y3, st.y3), ex=upd(ex_new, st.ex),
        obj_ring=obj_ring, obj_count=obj_count, it=it + 1,
        done=st.done | newly_done, cur_obj=cur_obj,
        best_bin_obj=best_bin_obj, best_sol=best_sol,
        x_prev=upd(x_new, st.x_prev))

    # --- iteration t+1's operands -----------------------------------------
    n_act = st.free.sum(-1).to(torch.float32)
    s_n = _sphere_scale(shift_sq, n_act, cfg.projection_lp)
    rhs_n = base_n + rho_nx * s_n[:, None] * shift_n
    Erhs_n = E_base + rho_nx * s_n[:, None] * E_shift
    if Gp is not None:
        u_n = symv(Gp, Erhs_n)
    else:
        u_n = lp_core._ginv_apply(st.ginv, Erhs_n)
    Ex_exact_n = (ratio / (rho_nx + rho_nx)) * u_n
    Ex0_n = E_y1n
    y3_n = torch.clamp_min(st.f_eff - ex_new - z4_new / rho_nx, 0.0)
    z4k_n = z4_new + gamma_nx * rho_nx * (Ex0_n + y3_n - st.f_eff)
    z4e_n = z4_new + gamma_nx * rho_nx * (Ex_exact_n + y3_n - st.f_eff)
    w_k = _w_vec(st.f_eff, Ex0_n, z4k_n, rho_n2)
    w_e = _w_vec(st.f_eff, Ex_exact_n, z4e_n, rho_n2)
    M_n = torch.stack([u_n, Ex0_n, w_k, w_e], dim=1)
    return StreamCarry(state=ns, rhs=rhs_n, x0=y1_next.contiguous(),
                       shift=shift_n.contiguous(), s=s_n, M=M_n, exk=Ex0_n,
                       exe=Ex_exact_n)


def _window(state, prob, cfg, window, skip_cvg_at, symm_apply, E_op,
            sweep_fn, symv):
    lp_core._wb_ratio(cfg)   # woodbury mode only
    if cfg.ginv_apply == "packed-sym" and cfg.ginv_dtype == "bfloat16":
        # the packed layout is f32, so the packed read would be larger
        # than a bf16 dense apply: the two byte cuts cancel
        raise ValueError(
            "ginv_apply='packed-sym' with ginv_dtype='bfloat16' reads more "
            "bytes than the bf16 dense apply (the packed layout is f32); "
            "pick one byte cut, not both")
    if prob.E.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no stream window for device {prob.E.device}")
    m = prob.m
    if E_op is None:
        E_op = stream_operand(prob.E, cfg)
    carry = _bootstrap(state, prob, cfg)
    Gp = None
    if symm_apply is None:
        symm_apply = bool(os.environ.get("LPBOX_SYMM"))
    if cfg.ginv_apply == "packed-sym":
        if symm.packable(m):
            Gp = symm.pack_tril(state.ginv)
    elif m % symm.BM == 0 and symm_apply:
        Gp = symm.pack_tril(state.ginv)
    free_f = state.free.float()
    for _ in range(window):
        if bool(carry.state.done.all()):
            break
        outs = sweep_fn(*_sweep_args(carry, E_op, prob, free_f, cfg))
        carry = _glue(carry, outs, prob, cfg, skip_cvg_at, Gp=Gp, symv=symv)
    # the carried E^T w product for a core.lp step afterwards
    return lp_core.refresh_et_next(carry.state, prob, cfg)


def lp_window_stream(state: lp_core.LpState, prob: LpProblem,
                     cfg: SolverConfig, window: int,
                     skip_cvg_at: Optional[int] = None,
                     symm_apply: Optional[bool] = None,
                     E_op: Optional[torch.Tensor] = None
                     ) -> lp_core.LpState:
    """Run up to ``window`` Woodbury-mode iterations at one pass over E
    each (the counterpart of ``core.lp.solve_window(record=False)`` for
    the large rungs); stops before an iteration once every instance is
    done.  A CUDA problem launches K3 (and K4 on the triangular route),
    a CPU problem runs the plain versions.

    ``symm_apply``: apply G^{-1} through the triangular read when m is a
    multiple of 128; ``None`` reads ``LPBOX_SYMM`` (set and non-empty
    means on).  ``ginv_apply="packed-sym"`` takes that route whenever m
    is a multiple of 128 with at least two blocks.  ``E_op``: E as the
    sweep reads it (``stream_operand``), to cast once per solve."""
    return _window(state, prob, cfg, window, skip_cvg_at, symm_apply, E_op,
                   sweep, symm.symm_matvec)


def lp_window_stream_plain(state: lp_core.LpState, prob: LpProblem,
                           cfg: SolverConfig, window: int,
                           skip_cvg_at: Optional[int] = None,
                           symm_apply: Optional[bool] = None,
                           E_op: Optional[torch.Tensor] = None
                           ) -> lp_core.LpState:
    """``lp_window_stream`` through the plain versions on any device."""
    return _window(state, prob, cfg, window, skip_cvg_at, symm_apply, E_op,
                   sweep_plain, symm.symm_matvec_plain)
