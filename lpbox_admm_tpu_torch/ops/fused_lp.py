"""K1: the fused LP ADMM window (``csrc/lp_window.cuh``, launched from
``lp_window.cu`` and ``lp_window_cluster.cu``) and its plain PyTorch
version.

Port of the JAX package's ``ops/pallas_lp.py``.  ``lp_window_fused``
runs ``window`` Woodbury-mode iterations of the whole batch in one
launch -- m side (G^{-1}) or, with ``nfactor``, n side (H^{-1} and
E^T E) -- with per-instance freezing, strided feasible-incumbent
tracking and an optional (B, n, window) trajectory record.  On a CUDA
tensor it launches the CUDA kernel (one thread block per instance) and
counts the launch in ``LAUNCHES``; on a CPU tensor it runs
``window_plain``, the same arithmetic in the same order in PyTorch.
One thread block holds one instance's vectors in shared memory, so the
kernel takes an (m, n) only where ``fits``; ``window_cuda`` refuses any
other shape before it launches.

E reaches the kernel by one of four routes (``E_ROUTES``), decided by
E's data and shape, never by a setting: where every entry of E is an
integer in [-127, 127] (CA's 0/1 incidence matrix), ``window_operand``
gives the kernel an exact one-byte (int8) copy of E; the kernel then
holds it in shared memory for the whole window where it fits beside the
vectors (``resident_fits``: ``int8-resident``, CA-500) and streams it
otherwise (``int8-stream``).  Any other E streams as float32 or, under
``matvec_dtype="bfloat16"``, as bfloat16.  All four give the same bits
where E is exact in one byte: the products and the order of the sums do
not change.  A solve makes the operand once, where it owns E
(``solve_fused_from``, the l2f phases), and hands it to every window
(``E_op``).  ``LAUNCHES`` counts the launches per route.

Where few instances are live, a launch on a one-byte route spreads
each instance over a thread-block cluster of C blocks (``CLUSTERS``),
which split the matrix rows between them (csrc/lp_window.cuh).
``solve_fused_from`` reads the live count at each window (the one host
read it makes there) and ``split_plan`` decides C from it, the shape
and the card alone: the largest C with live * C blocks on the card's
SMs, every cluster resident at once and at least ``MIN_SHARE_ROWS``
rows a block.  A launch without
a count (a recorded window, ``window_cuda`` called directly) runs C = 1,
one block an instance, and gives the bits it always has; C > 1 adds the
transpose products' partials in another order.  The active tracer notes
each launch's live count, C and share of the card's SMs
(``k1.split``).

The TPU kernel's instance blocking (``bt``/``auto_bt``), its rank-3
vector layout, VMEM chunking and unrolling are TPU concerns and are not
carried over; the policy phase records a whole window in one launch
where the TPU split it in two halves for VMEM (same trajectory).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..config import SolverConfig
from ..core import lp as lp_core
from ..core.problem import LpProblem
from ..utils import profiling
from .fused_stream import _SMEM_MAX, stream_operand

_EPS = 2.2204e-16
#: the kernel's threads per block and warps (``NT``, ``NW`` in
#: csrc/lp_window.cuh)
_NT = 512
_NW = _NT // 32

#: E's routes into the kernel, in the order of ``ERoute`` in
#: csrc/lp_window.cuh
E_ROUTES = ("f32-stream", "bf16-stream", "int8-stream", "int8-resident")
#: kernel launches made by ``lp_window_fused`` in this process, per E route
LAUNCHES: Dict[str, int] = dict.fromkeys(E_ROUTES, 0)
#: blocks an instance may take (thread-block cluster sizes)
CLUSTERS = (1, 2, 4, 8)
#: the E routes with a cluster kernel (every CA instance takes one; the
#: others run one block an instance)
CLUSTER_ROUTES = ("int8-stream", "int8-resident")
#: rows of each split matrix that a block of a cluster keeps at least
MIN_SHARE_ROWS = 32


class WindowIn(NamedTuple):
    """Operands of one window, batch-major, as both versions take them."""
    E: torch.Tensor          # (B, m, n) float32, bfloat16 or exact int8
    fac: torch.Tensor        # (B, m, m) G^{-1} or (B, n, n) H^{-1}
    ete: Optional[torch.Tensor]  # (B, n, n) E_f^T E_f in n-side mode
    b: torch.Tensor          # (B, n)
    rmask: torch.Tensor      # (B, m) float 0/1
    x: torch.Tensor
    z1: torch.Tensor
    z2: torch.Tensor
    z4: torch.Tensor
    f_eff: torch.Tensor
    free: torch.Tensor       # (B, n) float 0/1
    ring: torch.Tensor       # (B, H)
    count: torch.Tensor      # (B,) int32
    done: torch.Tensor       # (B,) int32 0/1
    cur_obj: torch.Tensor
    best_obj: torch.Tensor
    best_sol: torch.Tensor
    cluster: int = 1         # blocks an instance (``split_plan``)


class WindowOut(NamedTuple):
    x: torch.Tensor
    z1: torch.Tensor
    z2: torch.Tensor
    z4: torch.Tensor
    ring: torch.Tensor
    count: torch.Tensor
    done: torch.Tensor       # (B,) int32 0/1
    cur_obj: torch.Tensor
    best_obj: torch.Tensor
    best_sol: torch.Tensor
    y1: torch.Tensor
    y2: torch.Tensor
    y3: torch.Tensor
    ex: torch.Tensor
    traj: Optional[torch.Tensor]   # (B, window, n) when recording


def smem_bytes(m: int, n: int) -> int:
    """Shared memory one K1 thread block needs at (m, n): the vectors of
    one instance, the column partial sums and the reduction scratch.
    The launch takes this size (``LpWindowArgs.smem_bytes``) and the
    kernel refuses one that differs from its carve-up."""
    nq = n // 4
    col_groups = 1 if nq >= _NT else _NT // nq
    return 4 * (13 * n + 9 * m + 2 * col_groups * n + 4 * _NW + 4)


def fits(m: int, n: int) -> bool:
    """Whether K1 can hold one (m, n) instance on this card."""
    return smem_bytes(m, n) <= _SMEM_MAX


def resident_bytes(m: int, n: int) -> int:
    """Shared memory of a K1 block on the ``int8-resident`` route: the
    carve-up of ``smem_bytes`` and, after it, the instance's one-byte E
    (m n bytes, rounded up to 16).  The kernel refuses a launch of that
    route with any other size."""
    return smem_bytes(m, n) + (m * n + 15) // 16 * 16


def resident_fits(m: int, n: int) -> bool:
    """Whether one instance's one-byte E fits a K1 block beside the
    vectors (CA-500's (256, 512) does, the xl tail's (1664, 2048) not)."""
    return resident_bytes(m, n) <= _SMEM_MAX


def one_byte_exact(E: torch.Tensor) -> Optional[torch.Tensor]:
    """E as int8 where every entry is an integer in [-127, 127] (then the
    copy is exact), else None.  One pass over E and one host read
    (``fused_lp.one_byte_exact``)."""
    copy = E.to(torch.int8)
    if not profiling.read("fused_lp.one_byte_exact", bool,
                          ((copy.to(E.dtype) == E) & (copy != -128)).all()):
        return None
    return copy.contiguous()


def window_operand(E: torch.Tensor, cfg: SolverConfig) -> torch.Tensor:
    """E as K1 reads it: the exact one-byte copy where there is one
    (``one_byte_exact``), else as the f32 or bf16 stream reads it
    (``fused_stream.stream_operand``: bfloat16 under
    ``matvec_dtype="bfloat16"``, else as stored).  One pass over E: make
    it once per solve and pass it to each window as ``E_op``."""
    if cfg.matvec_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"matvec_dtype {cfg.matvec_dtype!r}")
    E8 = one_byte_exact(E)
    return stream_operand(E, cfg) if E8 is None else E8


def e_route(E_op: torch.Tensor) -> str:
    """The route of a kernel operand (``window_operand``) into K1."""
    B, m, n = E_op.shape
    if E_op.dtype == torch.int8:
        return "int8-resident" if resident_fits(m, n) else "int8-stream"
    if E_op.dtype == torch.bfloat16:
        return "bf16-stream"
    if E_op.dtype == torch.float32:
        return "f32-stream"
    raise TypeError(f"E must be float32, bfloat16 or int8, got {E_op.dtype}")


def share_rows(rows: int, cluster: int) -> int:
    """Rows of a split matrix that one block of a ``cluster``-block
    cluster takes (a multiple of 4; the last block's share may be
    shorter)."""
    return -(-rows // (4 * cluster)) * 4


def window_bytes(m: int, n: int, route: str, cluster: int = 1,
                 fac_resident: bool = False, nside: bool = False) -> int:
    """Shared memory of a K1 block (``smem_need`` in csrc/lp_window.cu):
    the carve-up of ``smem_bytes``; in a cluster, the cluster sum's slot
    and the block sums' buffers (4 + 7 * 16 floats), E^T u's exchange (m
    side: two n-vectors) and, with ``fac_resident``, the block's rows of
    the factor (m side: G^{-1}; n side: H^{-1} and E_f^T E_f); on the
    ``int8-resident`` route the block's rows of the one-byte E (rounded
    up to 16 bytes).  At ``cluster=1`` it is ``smem_bytes``, or
    ``resident_bytes`` on the resident route."""
    floats = smem_bytes(m, n) // 4
    if cluster > 1:
        floats += 4 + 7 * _NW + (0 if nside else 2 * n)
        if fac_resident:
            floats += 2 * share_rows(n, cluster) * n if nside \
                else share_rows(m, cluster) * m
    e_rows = share_rows(m, cluster)
    return 4 * floats + ((e_rows * n + 15) // 16 * 16
                         if route == "int8-resident" else 0)


def factor_resident(m: int, n: int, route: str, cluster: int,
                    nside: bool) -> bool:
    """Whether a cluster's block holds its rows of the factor in shared
    memory (they fit beside the rest), or streams them."""
    return cluster > 1 and \
        window_bytes(m, n, route, cluster, True, nside) <= _SMEM_MAX


def split_plan(live: Optional[int], m: int, n: int, nside: bool,
               route: str, sms: int,
               max_active: Callable[[str, int, int], int]) -> int:
    """C, the blocks an instance of a K1 launch at (m, n) with ``live``
    live instances takes: the largest of ``CLUSTERS`` whose ``live * C``
    blocks fit the card's ``sms`` SMs, whose ``live`` clusters the card
    holds at once (``max_active(route, shared_bytes, C)``, so that the
    launch runs in one wave) and whose blocks keep at least
    ``MIN_SHARE_ROWS`` rows of each split matrix (E's m rows; on the n
    side also the factors' n rows).  No count (None), none live or a
    route without a cluster kernel (``CLUSTER_ROUTES``): 1, the
    one-block launch."""
    if not live or route not in CLUSTER_ROUTES:
        return 1
    rows = min(m, n) if nside else m
    for c in sorted(CLUSTERS[1:], reverse=True):
        if live * c > sms or rows < MIN_SHARE_ROWS * c:
            continue
        need = window_bytes(m, n, route, c,
                            factor_resident(m, n, route, c, nside), nside)
        if need <= _SMEM_MAX and live <= max_active(route, need, c):
            return c
    return 1


class Card(NamedTuple):
    """What ``split_plan`` asks of the card: its SM count and how many
    clusters of a K1 launch it holds at once (the cluster kernel takes
    more than half an SM's shared memory a block, so no two of its
    blocks share an SM)."""
    sms: int
    max_active: Callable[[str, int, int], int]


@functools.lru_cache(maxsize=None)
def max_clusters(idx: int, route: str, smem: int, c: int) -> int:
    """``cudaOccupancyMaxActiveClusters`` of the route's cluster kernel
    on CUDA device ``idx`` at ``smem`` bytes a block and C = ``c``."""
    from ..kernels import build
    lib = build.library()
    with torch.cuda.device(idx):
        got = lib.lpbox_lp_window_max_clusters(E_ROUTES.index(route), smem,
                                               c)
    if got < 0:
        build.check(lib, -got, "lp_window cluster occupancy")
    return got


def card(device: torch.device) -> Optional[Card]:
    """The CUDA card of ``device`` (None for any other device)."""
    if device.type != "cuda":
        return None
    idx = torch.cuda.current_device() if device.index is None \
        else device.index
    return Card(torch.cuda.get_device_properties(idx).multi_processor_count,
                functools.partial(max_clusters, idx))


def sm_pct(live: int, cluster: int, sms: int) -> float:
    """The share of the card's ``sms`` SMs that a launch of ``live``
    instances on ``cluster`` blocks each takes, in %."""
    return 100.0 * min(sms, live * cluster) / sms


def check_fits(m: int, n: int) -> None:
    """Refuse, before any launch, a shape K1 cannot hold."""
    if not fits(m, n):
        raise ValueError(
            f"fused window at (m, n) = ({m}, {n}) needs "
            f"{smem_bytes(m, n)} bytes of shared memory per thread block; "
            f"the limit is {_SMEM_MAX} bytes")


def _f32(v: float) -> float:
    return float(np.float32(v))


def window_plain(a: WindowIn, cfg: SolverConfig, it0: int, window: int,
                 skip_cvg_at: Optional[int] = None,
                 record: bool = False) -> WindowOut:
    """The kernel's arithmetic in PyTorch, batched over instances with
    masks (pallas_lp.py ``_window_kernel`` ``body``, line 163-306)."""
    nside = a.ete is not None
    E = a.E.float()
    B, m, n = E.shape
    mv = lambda M, v: torch.bmm(M, v[..., None])[..., 0]
    mtv = lambda M, w: torch.bmm(w[:, None, :], M)[:, 0]
    free_f = a.free
    free = free_f > 0.5
    rmask = a.rmask > 0.5
    f_eff = a.f_eff
    b = a.b
    H = cfg.history_size
    sqrt_n = torch.sqrt(free_f.sum(-1, keepdim=True))
    tol2 = _f32(cfg.pcg_tol * cfg.pcg_tol)
    log_lf = np.float32(math.log(cfg.learning_fact))
    log_gf = np.float32(math.log(cfg.gamma_factor))
    zeros = torch.zeros_like

    x, z1, z2, z4 = a.x, a.z1, a.z2, a.z4
    ring, count, done = a.ring, a.count, a.done > 0
    cur_obj, best_obj, best_sol = a.cur_obj, a.best_obj, a.best_sol
    y1c, y2c, y3c = x, x, f_eff
    ex = mv(E, free_f * x)
    traj = torch.empty((B, window, n), dtype=x.dtype, device=x.device) \
        if record else None
    onehot_k = torch.arange(H, device=x.device)[None, :]
    for t in range(window):
        if not record and bool(done.all()):
            break                  # a done instance's iteration is a no-op
        it = it0 + t
        kf = np.float32(it // cfg.rho_change_step)
        rho = _f32(np.float32(cfg.initial_rho) * np.exp(kf * log_lf))
        gamma = _f32(max(np.float32(cfg.gamma0) * np.exp(kf * log_gf),
                         np.float32(1.0)))
        c = _f32(rho + rho)
        active = ~done
        act = active[:, None]

        y1 = torch.clamp(x + z1 / rho, 0.0, 1.0)
        shift = torch.where(free, x + z2 / rho - 0.5, zeros(x))
        nrm = torch.sqrt((shift * shift).sum(-1, keepdim=True))
        y2 = shift * sqrt_n / (2.0 * torch.clamp_min(nrm, _EPS)) + 0.5
        y2 = torch.where(free, y2, x)
        y3 = torch.clamp_min(f_eff - ex - z4 / rho, 0.0)

        et_term = mtv(E, rho * (f_eff - y3) - z4)
        rhs = free_f * (rho * y1 + rho * y2 - (b + z1 + z2) + et_term)
        x0 = free_f * y1
        if nside:
            x_exact = free_f * mv(a.fac, rhs) / rho
            EtEx0 = mv(a.ete, x0)
        else:
            Erhs = mv(E, rhs)
            u = mv(a.fac, Erhs)
            ex_exact = u / rho
            EtU = mtv(E, u)
            Ex0 = mv(E, x0)
            EtEx0 = mtv(E, Ex0)
            x_exact = free_f * (rhs - EtU) / c
        Mx0 = free_f * (c * x0 + rho * EtEx0)
        r0 = rhs - Mx0
        keep = (r0 * r0).sum(-1) < tol2 * (rhs * rhs).sum(-1)
        x_new = torch.where(keep[:, None], x0, x_exact)
        x_new = torch.where(act, x_new, x)
        if nside:
            ex_new = mv(E, x_new)
        else:
            ex_new = torch.where(keep[:, None], Ex0, ex_exact)
        ex_new = torch.where(act, ex_new, ex)

        z1n = z1 + gamma * rho * free_f * (x_new - y1)
        z2n = z2 + gamma * rho * free_f * (x_new - y2)
        z4n = z4 + gamma * rho * (ex_new + y3 - f_eff)

        xn = torch.clamp_min(torch.sqrt(
            torch.where(free, x_new * x_new, zeros(x)).sum(-1)), _EPS)
        d1 = torch.where(free, x_new - y1, zeros(x))
        d2 = torch.where(free, x_new - y2, zeros(x))
        c1 = torch.sqrt((d1 * d1).sum(-1)) / xn
        c2 = torch.sqrt((d2 * d2).sum(-1)) / xn
        cvg = (c1 <= cfg.stop_threshold) & (c2 <= cfg.stop_threshold)
        if skip_cvg_at is not None and it == skip_cvg_at:
            cvg = torch.zeros_like(cvg)
        obj_val = (b * free_f * x_new).sum(-1)
        push = active & ~cvg
        slot = torch.remainder(count, H)
        onehot = slot[:, None] == onehot_k
        ring_n = torch.where(push[:, None] & onehot, obj_val[:, None], ring)
        count_n = count + push.to(torch.int32)
        mean = ring_n.mean(-1, keepdim=True)
        var = ((ring_n - mean) ** 2).sum(-1) / (H - 1)
        rel = torch.sqrt(var) / torch.clamp_min(obj_val.abs(), _EPS)
        rel = torch.where(count_n >= H, rel, torch.ones_like(rel))
        std_stop = push & (rel <= cfg.std_threshold)
        newly_done = active & (cvg | std_stop)

        if cfg.incumbent_stride <= 1 or it % cfg.incumbent_stride == 0:
            track = active & ~newly_done
            rounded = free_f * (x_new >= 0.5).to(x.dtype)
            obj_bin = (b * rounded).sum(-1)
            cur_obj = torch.where(track, obj_bin, cur_obj)
            better = track & (best_obj >= obj_bin)
            if cfg.feasible_incumbent:
                exr = mv(E, rounded)
                feas = ((exr <= f_eff + 1e-6) | ~rmask).all(-1)
                better = better & feas
            best_obj = torch.where(better, obj_bin, best_obj)
            best_sol = torch.where(better[:, None], x_new, best_sol)

        if record:
            traj[:, t] = x_new
        x = x_new
        z1 = torch.where(act, z1n, z1)
        z2 = torch.where(act, z2n, z2)
        z4 = torch.where(act, z4n, z4)
        ring, count = ring_n, count_n
        done = done | newly_done
        y1c = torch.where(act, y1, y1c)
        y2c = torch.where(act, y2, y2c)
        y3c = torch.where(act, y3, y3c)
        ex = ex_new
    return WindowOut(x=x, z1=z1, z2=z2, z4=z4, ring=ring, count=count,
                     done=done.to(torch.int32), cur_obj=cur_obj,
                     best_obj=best_obj, best_sol=best_sol, y1=y1c, y2=y2c,
                     y3=y3c, ex=ex, traj=traj)


class _Args(ctypes.Structure):
    """ctypes mirror of ``LpWindowArgs`` in csrc/lp_window.cuh."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "E", "fac", "ete", "b", "rmask", "x_in", "z1_in", "z2_in", "z4_in",
        "feff", "free_in", "ring_in", "count_in", "done_in", "curobj_in",
        "bestobj_in", "bestsol_in", "x_out", "z1_out", "z2_out", "z4_out",
        "ring_out", "count_out", "done_out", "curobj_out", "bestobj_out",
        "bestsol_out", "y1_out", "y2_out", "y3_out", "ex_out", "traj")] + [
        (name, ctypes.c_int) for name in (
            "B", "m", "n", "H", "window", "it0", "skip_cvg_at", "record",
            "nside", "e_route", "rho_change_step", "incumbent_stride",
            "feasible_incumbent", "smem_bytes", "cluster",
            "fac_resident")] + [
        (name, ctypes.c_float) for name in (
            "initial_rho", "log_learning_fact", "gamma0",
            "log_gamma_factor", "stop_threshold", "std_threshold",
            "pcg_tol2")]


def window_cuda(a: WindowIn, cfg: SolverConfig, it0: int, window: int,
                skip_cvg_at: Optional[int] = None,
                record: bool = False) -> WindowOut:
    """Launch the CUDA kernel on PyTorch's current stream, each instance
    on ``a.cluster`` blocks (``split_plan``; a recorded window on one),
    their factor rows in shared memory where ``factor_resident``."""
    from ..kernels import build

    B, m, n = a.E.shape
    nside = a.ete is not None
    dev = a.E.device
    route = e_route(a.E)
    if n % 4 or m % 4:
        raise ValueError(f"fused window needs m, n multiples of 4: {(m, n)}")
    check_fits(m, n)
    if a.cluster not in CLUSTERS:
        raise ValueError(f"cluster {a.cluster}: one of {CLUSTERS}")
    if a.cluster > 1 and route not in CLUSTER_ROUTES:
        raise ValueError(f"{route}: no cluster kernel (one of "
                         f"{CLUSTER_ROUTES})")
    if a.cluster > 1 and record:
        raise ValueError("a recorded window runs one block an instance")
    res = factor_resident(m, n, route, a.cluster, nside)
    smem = window_bytes(m, n, route, a.cluster, res, nside)
    if smem > _SMEM_MAX:
        raise ValueError(f"cluster {a.cluster} at (m, n) = ({m}, {n}) needs "
                         f"{smem} bytes of shared memory per thread block; "
                         f"the limit is {_SMEM_MAX} bytes")
    H = cfg.history_size
    fac_shape = (B, n, n) if nside else (B, m, m)
    want = dict(fac=fac_shape, ete=(B, n, n) if nside else None,
                b=(B, n), rmask=(B, m), x=(B, n), z1=(B, n), z2=(B, n),
                z4=(B, m), f_eff=(B, m), free=(B, n), ring=(B, H),
                count=(B,), done=(B,), cur_obj=(B,), best_obj=(B,),
                best_sol=(B, n))
    for name, shape in want.items():
        t = getattr(a, name)
        if t is None:
            continue
        if t.device != dev or tuple(t.shape) != shape or \
                not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous {shape} tensor "
                             f"on {dev}, got {tuple(t.shape)} on {t.device}")
        want_dt = torch.int32 if name in ("count", "done") else torch.float32
        if t.dtype != want_dt:
            raise TypeError(f"{name}: expected {want_dt}, got {t.dtype}")
    if not a.E.is_contiguous():
        raise ValueError("E must be contiguous")
    if route == "int8-resident" and a.E.data_ptr() % 16:
        raise ValueError("E: the resident copy reads 16-byte pieces; its "
                         "data pointer is not 16-byte aligned")

    f32 = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
    i32 = lambda *s: torch.empty(s, dtype=torch.int32, device=dev)
    out = WindowOut(x=f32(B, n), z1=f32(B, n), z2=f32(B, n), z4=f32(B, m),
                    ring=f32(B, H), count=i32(B), done=i32(B),
                    cur_obj=f32(B), best_obj=f32(B), best_sol=f32(B, n),
                    y1=f32(B, n), y2=f32(B, n), y3=f32(B, m), ex=f32(B, m),
                    traj=f32(B, window, n) if record else None)
    p = build.ptr
    args = _Args(
        p(a.E), p(a.fac), p(a.ete), p(a.b), p(a.rmask), p(a.x), p(a.z1),
        p(a.z2), p(a.z4), p(a.f_eff), p(a.free), p(a.ring), p(a.count),
        p(a.done), p(a.cur_obj), p(a.best_obj), p(a.best_sol),
        p(out.x), p(out.z1), p(out.z2), p(out.z4), p(out.ring),
        p(out.count), p(out.done), p(out.cur_obj), p(out.best_obj),
        p(out.best_sol), p(out.y1), p(out.y2), p(out.y3), p(out.ex),
        p(out.traj),
        B, m, n, H, window, it0, -1 if skip_cvg_at is None else skip_cvg_at,
        int(record), int(nside), E_ROUTES.index(route),
        cfg.rho_change_step, cfg.incumbent_stride,
        int(cfg.feasible_incumbent), smem, a.cluster, int(res),
        cfg.initial_rho, math.log(cfg.learning_fact), cfg.gamma0,
        math.log(cfg.gamma_factor), cfg.stop_threshold, cfg.std_threshold,
        cfg.pcg_tol * cfg.pcg_tol)
    lib = build.library()
    build.check_struct(lib, "lpbox_lp_window_args_size", _Args)
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(lib, lib.lpbox_lp_window(ctypes.addressof(args), stream),
                "lp_window kernel")
    return out


def window_inputs(state: lp_core.LpState, prob: LpProblem,
                  cfg: SolverConfig, nfactor=None,
                  E_op: Optional[torch.Tensor] = None) -> WindowIn:
    """Gather one window's operands from a solver state; E as the kernel
    reads it, ``E_op`` or else ``window_operand(prob.E, cfg)``."""
    lp_core._wb_ratio(cfg)   # woodbury mode only
    f = lambda t: t.float().contiguous()
    return WindowIn(
        E=window_operand(prob.E, cfg) if E_op is None else E_op,
        fac=f(nfactor[0] if nfactor else state.ginv),
        ete=f(nfactor[1]) if nfactor else None, b=f(prob.b),
        rmask=f(prob.row_mask), x=f(state.x), z1=f(state.z1),
        z2=f(state.z2), z4=f(state.z4), f_eff=f(state.f_eff),
        free=f(state.free), ring=f(state.obj_ring),
        count=state.obj_count.to(torch.int32).contiguous(),
        done=state.done.to(torch.int32).contiguous(),
        cur_obj=f(state.cur_obj), best_obj=f(state.best_bin_obj),
        best_sol=f(state.best_sol))


def window_state(state: lp_core.LpState, prob: LpProblem, cfg: SolverConfig,
                 window: int, out: WindowOut, record: bool):
    """The state after a window (as ``lp_window_fused`` returns it)."""
    new_state = state.replace(
        x=out.x, y1=out.y1, y2=out.y2, y3=out.y3, z1=out.z1, z2=out.z2,
        z4=out.z4, obj_ring=out.ring, obj_count=out.count,
        it=state.it + window, done=out.done > 0, cur_obj=out.cur_obj,
        best_bin_obj=out.best_obj, best_sol=out.best_sol, ex=out.ex)
    # keep the carried E^T w product right for a core.lp step afterwards
    new_state = lp_core.refresh_et_next(new_state, prob, cfg)
    if record:
        return new_state, out.traj.transpose(1, 2)     # (B, n, W)
    return new_state


def lp_window_fused(state: lp_core.LpState, prob: LpProblem,
                    cfg: SolverConfig, window: int,
                    skip_cvg_at: Optional[int] = None, record: bool = False,
                    nfactor=None, E_op: Optional[torch.Tensor] = None,
                    live: Optional[int] = None):
    """Run ``window`` Woodbury-mode ADMM iterations in one kernel launch.

    ``record=True`` also returns the (B, n, window) trajectory.
    ``nfactor``: ``(hinv, ete)`` from ``woodbury.factorize_nside`` for
    the direct n-side x-update (``state.ginv`` is then unused).
    ``E_op``: ``window_operand(prob.E, cfg)``, made by the caller once
    per solve (else here).  ``live``: the instances not done, as the
    caller has read them; an unrecorded launch with a count spreads each
    instance over the cluster ``split_plan`` gives on this card, one
    without runs one block an instance.  A CUDA problem launches the
    kernel on the route of that operand (``e_route``); a CPU problem runs
    ``window_plain``.  The active tracer notes (live, C, the share of
    the card's SMs in %, ``sm_pct``; None off a card) under ``k1.split``
    (live: the batch where no count was given)."""
    if prob.E.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no fused window for device {prob.E.device}")
    a = window_inputs(state, prob, cfg, nfactor, E_op)
    hw = card(prob.E.device)
    if hw is not None and not record and live is not None:
        _, m, n = a.E.shape
        a = a._replace(cluster=split_plan(live, m, n, a.ete is not None,
                                          e_route(a.E), hw.sms,
                                          hw.max_active))
    if live is None:
        live = state.x.shape[0]
    profiling.note("k1.split", (live, a.cluster, None if hw is None
                                else sm_pct(live, a.cluster, hw.sms)))
    if prob.E.is_cuda:
        out = window_cuda(a, cfg, state.it, window, skip_cvg_at, record)
        LAUNCHES[e_route(a.E)] += 1
    else:
        out = window_plain(a, cfg, state.it, window, skip_cvg_at, record)
    return window_state(state, prob, cfg, window, out, record)


def lp_window_plain(state: lp_core.LpState, prob: LpProblem,
                    cfg: SolverConfig, window: int,
                    skip_cvg_at: Optional[int] = None, record: bool = False,
                    nfactor=None):
    """``lp_window_fused`` through the plain version on any device, on E
    as stored (bfloat16 under ``matvec_dtype="bfloat16"``), not on its
    one-byte copy, so a fault in the copy cannot hide from the
    comparison."""
    a = window_inputs(state, prob, cfg, nfactor,
                      E_op=stream_operand(prob.E, cfg))
    out = window_plain(a, cfg, state.it, window, skip_cvg_at, record)
    return window_state(state, prob, cfg, window, out, record)


def solve_fused_from(state: lp_core.LpState, prob: LpProblem,
                     cfg: SolverConfig, max_iters: Optional[int] = None,
                     window: int = 100, nfactor=None,
                     skip_cvg_at: Optional[int] = None,
                     E_op: Optional[torch.Tensor] = None
                     ) -> lp_core.LpState:
    """Continue a solve with fused windows until every instance is done
    or ``max_iters`` is reached: one host read per window (``fused_lp.
    done``), the live count, which also sets the window's clusters
    (``split_plan``).  E's kernel operand is ``E_op`` or made here, once
    for all the windows."""
    if max_iters is None:
        max_iters = cfg.max_iters
    if E_op is None:
        E_op = window_operand(prob.E, cfg)
    while state.it < max_iters:
        live = profiling.read("fused_lp.done", int, (~state.done).sum())
        if not live:
            break
        state = lp_window_fused(state, prob, cfg, window,
                                skip_cvg_at=skip_cvg_at, nfactor=nfactor,
                                E_op=E_op, live=live)
    return state


def solve_fused(prob: LpProblem, cfg: SolverConfig,
                max_iters: Optional[int] = None,
                window: int = 100) -> lp_core.LpState:
    """Plain full solve with the fused window (the first iteration's
    y1/y2 stop is skipped, as the reference does)."""
    state = lp_core.init_state(prob, cfg)
    return solve_fused_from(state, prob, cfg, max_iters, window,
                            skip_cvg_at=0)
