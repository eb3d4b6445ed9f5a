"""Batched Lp-Box ADMM for unconstrained binary grid QPs (segmentation).

The port of the JAX package's ``core/qp.py`` (reference
Segmentation/Segmentation/cython/src/LPboxADMMsolver.cpp):

* ``init_state``     ~ ADMM_bqp_unconstrained_init state setup (:658-810)
* ``step``           ~ one iteration of ADMM_bqp_unconstrained_{legacy,l2f}
                       (:1067-1195, :1200-1380)
* ``apply_fix``      ~ the quadratic early-fix reduction Ma/Mb (:927-1062),
                       mask-based: b_eff = b + 2 A'((1 - free) * v)
* ``energy``         ~ get_final_obj (:868-893)
* ``compact``        ~ the Ma/Mb physical shrink (:1048-1057): free pixels
                       gathered into a flat ``core.general`` problem

The problem is ``min x^T A' x + b^T x`` with ``A' = D - W`` a grid
``ops.stencil.Stencil``; the x-update solves ``2 A' + (rho1 + rho2) I``
by Jacobi PCG (``ops/cg.py``, warm-started at y1) with a 9-point stencil
matvec.  State tensors live on the (B, H, W) grid; ``it`` is a host
integer, so the rho schedule costs no device round trip.  Every
instance freezes through ``done``, and a PCG that loses positive
definiteness keeps the previous iterate and ends its instance
(``res.failed``), as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..config import SolverConfig
from ..ops import cg as cg_ops
from ..ops.projections import project_box
from ..ops.schedule import gamma_at, rho_at
from ..ops.stats import rel_std_obj
from ..ops.stencil import OFFSETS, Stencil
from ..utils import profiling

_EPS = 2.2204e-16


@dataclasses.dataclass(frozen=True)
class QpProblem:
    """Batched grid BQP: min x.A'x + b.x, A' = degree - W (stencil)."""

    stencil: Stencil        # (B, 8, H, W) weights + (B, H, W) degree
    b: torch.Tensor         # (B, H, W) linear cost
    const: torch.Tensor     # (B,) additive constant (Seg's sum of U1)
    mask: torch.Tensor      # (B, H, W) bool: valid (in-image) pixels

    @property
    def batch(self) -> int:
        return self.b.shape[0]

    @property
    def grid(self) -> Tuple[int, int]:
        return self.b.shape[-2], self.b.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.b.device


@dataclasses.dataclass(frozen=True)
class QpState:
    x: torch.Tensor          # (B, H, W)
    y1: torch.Tensor
    y2: torch.Tensor
    z1: torch.Tensor
    z2: torch.Tensor
    free: torch.Tensor       # (B, H, W) bool
    fixed_val: torch.Tensor  # (B, H, W)
    b_eff: torch.Tensor      # (B, H, W): b + 2 A'(fixed contribution)
    obj_ring: torch.Tensor   # (B, history)
    obj_count: torch.Tensor  # (B,) int32
    it: int                  # global iteration counter
    done: torch.Tensor       # (B,) bool
    cur_obj: torch.Tensor    # (B,) binary objective on the reduced problem
    best_bin_obj: torch.Tensor
    best_sol: torch.Tensor
    x_prev: torch.Tensor
    fix_count: torch.Tensor  # (B, H, W) int32

    def replace(self, **kw) -> "QpState":
        return dataclasses.replace(self, **kw)


def _msum(x: torch.Tensor) -> torch.Tensor:
    return x.sum((-2, -1))


def _mnorm(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    x = torch.where(mask, x, torch.zeros_like(x))
    return torch.sqrt(_msum(x * x))


def _sphere(x: torch.Tensor, free: torch.Tensor, p: int) -> torch.Tensor:
    """Projection onto the shifted Lp sphere over the free pixels."""
    sh = torch.where(free, x - 0.5, torch.zeros_like(x))
    n_act = _msum(free).to(x.dtype)[:, None, None]
    norm = torch.sqrt(_msum(sh * sh))[:, None, None]
    norm = torch.clamp_min(norm, _EPS)
    y = sh * (n_act ** (1.0 / p)) / (2.0 * norm) + 0.5
    return torch.where(free, y, x)


def reduced_cost(state: QpState, prob: QpProblem, x: torch.Tensor
                 ) -> torch.Tensor:
    """compute_cost on the reduced (free) problem: x.Ma x + b_eff.x with
    x masked to the free pixels (reference compute_cost, Seg :497-510)."""
    free_f = state.free.to(x.dtype)
    xf = free_f * x
    ax = prob.stencil.a_matvec(xf)
    return _msum(xf * (free_f * ax)) + _msum(state.b_eff * xf)


def init_state(prob: QpProblem, cfg: SolverConfig) -> QpState:
    """x0 = 0, duals 0 (Seg init :762-800); best_bin_obj = cost(x0) = 0."""
    B = prob.batch
    H, W = prob.grid
    dt, dev = prob.b.dtype, prob.device
    zeros = torch.zeros((B, H, W), dtype=dt, device=dev)
    zb = torch.zeros((B,), dtype=dt, device=dev)
    return QpState(
        x=zeros, y1=zeros, y2=zeros, z1=zeros, z2=zeros,
        free=prob.mask, fixed_val=zeros, b_eff=prob.b,
        obj_ring=torch.zeros((B, cfg.history_size), dtype=dt, device=dev),
        obj_count=torch.zeros((B,), dtype=torch.int32, device=dev),
        it=0, done=torch.zeros((B,), dtype=torch.bool, device=dev),
        cur_obj=zb, best_bin_obj=zb, best_sol=zeros, x_prev=zeros,
        fix_count=torch.zeros((B, H, W), dtype=torch.int32, device=dev))


def step(state: QpState, prob: QpProblem, cfg: SolverConfig,
         rule_fixing: bool = False) -> QpState:
    """One ADMM iteration (Seg :1067-1195)."""
    dt = state.x.dtype
    it = state.it
    active = ~state.done
    act = active[:, None, None]
    free = state.free
    free_f = free.to(dt)

    rho1 = rho_at(it, cfg)
    rho2 = rho1
    gamma = gamma_at(it, cfg)
    c = rho1 + rho2

    y1 = project_box(state.x + state.z1 / rho1)
    y2 = _sphere(state.x + state.z2 / rho2, free, cfg.projection_lp)

    rhs = free_f * (rho1 * y1 + rho2 * y2
                    - (state.b_eff + state.z1 + state.z2))

    B = prob.batch
    H, W = prob.grid

    def matvec(p):
        p = p.reshape(B, H, W)
        ap = prob.stencil.a_matvec(free_f * p)
        return (free_f * (2.0 * ap + c * p)).reshape(B, H * W)

    diag = torch.where(free, 2.0 * prob.stencil.a_diag() + c,
                       torch.ones_like(state.x))
    res = cg_ops.pcg(matvec, rhs.reshape(B, H * W),
                     (free_f * y1).reshape(B, H * W),
                     diag.reshape(B, H * W), cfg.pcg_tol, cfg.pcg_maxiters,
                     active=active)
    x = torch.where(act & ~res.failed[:, None, None],
                    free_f * res.x.reshape(B, H, W), state.x)

    z1 = state.z1 + gamma * rho1 * free_f * (x - y1)
    z2 = state.z2 + gamma * rho2 * free_f * (x - y2)

    xnorm = torch.clamp_min(_mnorm(x, free), _EPS)
    c1 = _mnorm(x - y1, free) / xnorm
    c2 = _mnorm(x - y2, free) / xnorm
    cvg = ((c1 <= cfg.stop_threshold) & (c2 <= cfg.stop_threshold)) \
        | res.failed

    obj_val = reduced_cost(state, prob, x)
    push = active & ~cvg
    Hs = cfg.history_size
    slot = torch.remainder(state.obj_count, Hs)
    onehot = slot[:, None] == torch.arange(Hs, device=x.device)[None, :]
    obj_ring = torch.where(push[:, None] & onehot, obj_val[:, None],
                           state.obj_ring)
    obj_count = state.obj_count + push.to(torch.int32)
    std = rel_std_obj(obj_ring, obj_count, obj_val)
    std_stop = push & (std <= cfg.std_threshold)
    newly_done = active & (cvg | std_stop)

    track = active & ~newly_done
    rounded = free_f * (x >= 0.5).to(dt)
    obj_bin = reduced_cost(state, prob, rounded)
    cur_obj = torch.where(track, obj_bin, state.cur_obj)
    better = track & (state.best_bin_obj >= obj_bin)
    best_bin_obj = torch.where(better, obj_bin, state.best_bin_obj)
    best_sol = torch.where(better[:, None, None], x, state.best_sol)

    fix_count = state.fix_count
    if rule_fixing:
        live = act & free
        det = (x - state.x_prev).abs() <= cfg.fix_threshold
        fix_count = torch.where(live & det, fix_count + 1,
                                torch.where(live, torch.zeros_like(fix_count),
                                            fix_count))

    upd = lambda new, old: torch.where(act, new, old)
    return state.replace(
        x=upd(x, state.x), y1=upd(y1, state.y1), y2=upd(y2, state.y2),
        z1=upd(z1, state.z1), z2=upd(z2, state.z2),
        obj_ring=obj_ring, obj_count=obj_count,
        it=it + 1, done=state.done | newly_done,
        cur_obj=cur_obj, best_bin_obj=best_bin_obj, best_sol=best_sol,
        x_prev=upd(x, state.x_prev), fix_count=fix_count)


def solve_window(state: QpState, prob: QpProblem, cfg: SolverConfig,
                 window: int, record: bool = True,
                 rule_fixing: bool = False
                 ) -> Tuple[QpState, Optional[torch.Tensor]]:
    """Run ``window`` iterations; with ``record`` also the (B, H, W,
    window) x trajectory, so ``traj.reshape(-1, window)`` gives one
    contiguous row per pixel."""
    traj = []
    for _ in range(window):
        state = step(state, prob, cfg, rule_fixing=rule_fixing)
        if record:
            traj.append(state.x)
    return state, (torch.stack(traj, dim=-1) if record else None)


def apply_fix(state: QpState, prob: QpProblem, vec: torch.Tensor,
              cfg: SolverConfig, min_fix: Optional[int] = None) -> QpState:
    """Quadratic early-fix reduction, mask-based (Seg :927-1062).

    ``vec`` is (B, H, W) in the +1/0/-1 convention; an instance takes its
    fixes only when more than ``min_fix`` pixels want fixing.  The
    reduced linear term b' = 2 Mb x2 + b1 becomes ``b_eff = b + 2 A'
    ((1 - free) * fixed_val)``: the off-diagonal block times the fixed
    values, folded into b."""
    if min_fix is None:
        min_fix = cfg.min_fix
    dt = state.x.dtype
    active = ~state.done
    want = state.free & (vec >= 0.0) & active[:, None, None]
    do = _msum(want) > min_fix
    d3 = do[:, None, None]
    newly = want & d3

    val = torch.clamp(vec, 0.0, 1.0).to(dt)
    fixed_val = torch.where(newly, val, state.fixed_val)
    free = state.free & ~newly

    contrib = prob.stencil.a_matvec((~free).to(dt) * fixed_val)
    b_eff = torch.where(d3, prob.b + 2.0 * contrib, state.b_eff)

    empty = _msum(free) == 0
    return state.replace(
        free=free, fixed_val=fixed_val, b_eff=b_eff,
        done=state.done | (do & empty),
        x_prev=torch.where(d3, state.x, state.x_prev))


def rule_fix_vec(state: QpState, cfg: SolverConfig) -> torch.Tensor:
    """The consistency counters' decisions: round(x) where a free pixel
    held still for ``cfg.consistency`` iterations, else -1."""
    flag = state.free & (state.fix_count >= cfg.consistency)
    val = (state.x >= 0.5).to(state.x.dtype)
    return torch.where(flag, val, torch.full_like(val, -1.0))


def solution(state: QpState) -> torch.Tensor:
    """Full restored binary solution (Seg get_x_sol :895-915)."""
    rounded = (state.x >= 0.5).to(state.x.dtype)
    return torch.where(state.free, rounded, state.fixed_val)


def _energy(prob: QpProblem, x: torch.Tensor) -> torch.Tensor:
    return _msum(x * prob.stencil.a_matvec(x)) + _msum(prob.b * x) \
        + prob.const


def energy(state: QpState, prob: QpProblem) -> torch.Tensor:
    """Segmentation energy of the restored solution on the ORIGINAL
    problem plus the constant c (get_final_obj, Seg :868-893)."""
    return _energy(prob, solution(state) * prob.mask.to(state.x.dtype))


def solution_best(state: QpState) -> torch.Tensor:
    """Full restored rounding of the best incumbent iterate."""
    rounded = (state.best_sol >= 0.5).to(state.x.dtype)
    return torch.where(state.free, rounded, state.fixed_val)


def select_solution(state: QpState, prob: QpProblem,
                    repair_sweeps: int = 0, pair_sweeps: int = 0):
    """Per instance, the lower-energy of the final rounding and the best
    incumbent rounding (every rounding of the unconstrained BQP is
    feasible; the reference reports only the last, Seg :1376), polished
    by ``repair_sweeps`` one-flip sweeps and ``pair_sweeps`` domino
    sweeps (``ops.repair``).  Returns (sol, energy).  The tracer's span
    ``qp.select``."""
    with profiling.span("qp.select"):
        return select_from_sols(prob, solution(state), solution_best(state),
                                repair_sweeps=repair_sweeps,
                                pair_sweeps=pair_sweeps)


def select_from_sols(prob: QpProblem, sol_last: torch.Tensor,
                     sol_best: torch.Tensor, repair_sweeps: int = 0,
                     pair_sweeps: int = 0):
    """``select_solution`` on full-grid candidate solutions; a polish
    replaces an instance's solution only where it lowers the energy."""
    from ..ops.repair import icm_descent, pair_descent

    mask = prob.mask.to(sol_last.dtype)
    sols = torch.stack([sol_last * mask, sol_best * mask], dim=1)
    e = torch.stack([_energy(prob, sols[:, 0]), _energy(prob, sols[:, 1])],
                    dim=1)                                     # (B, 2)
    k = torch.argmin(e, dim=1)
    sol = torch.gather(sols, 1, k[:, None, None, None].expand(
        -1, 1, *sols.shape[2:]))[:, 0]
    energy_sel = torch.gather(e, 1, k[:, None])[:, 0]

    def keep_better(cand, sol, energy_sel):
        e_c = _energy(prob, cand)
        better = (e_c < energy_sel)[:, None, None]
        return torch.where(better, cand, sol), torch.minimum(e_c, energy_sel)

    if repair_sweeps > 0:
        cand = icm_descent(prob.stencil, prob.b, prob.mask, sol,
                           sweeps=repair_sweeps)
        sol, energy_sel = keep_better(cand, sol, energy_sel)
    if pair_sweeps > 0:
        # domino flips reach moves one-flip descent cannot; a final
        # one-flip pass cleans up what the pairs opened up
        cand = pair_descent(prob.stencil, prob.b, prob.mask, sol,
                            sweeps=pair_sweeps)
        cand = icm_descent(prob.stencil, prob.b, prob.mask, cand,
                           sweeps=max(1, repair_sweeps // 2))
        sol, energy_sel = keep_better(cand, sol, energy_sel)
    return sol, energy_sel


def solve(prob: QpProblem, cfg: SolverConfig,
          max_iters: Optional[int] = None, window: int = 100,
          rule_fixing: bool = False) -> QpState:
    """Plain full solve (ADMM_bqp_unconstrained_legacy, Seg :1200-1380),
    window-quantized: one host check of ``done`` per window (the
    tracer's read site ``qp.done``); with ``rule_fixing`` each window
    ends with the counters' fixes."""
    if max_iters is None:
        max_iters = cfg.max_iters
    state = init_state(prob, cfg)
    while state.it < max_iters and not profiling.read(
            "qp.done", bool, state.done.all()):
        state, _ = solve_window(state, prob, cfg, window, record=False,
                                rule_fixing=rule_fixing)
        if rule_fixing:
            state = apply_fix(state, prob, rule_fix_vec(state, cfg), cfg)
    return state


def compact(state: QpState, prob: QpProblem, cfg: SolverConfig, n_new: int):
    """Gather the free pixels into a flat unconstrained QP whose A is a
    9-nnz-per-row ``ops.sparse.SparseEll``, for ``core.general``.

    The free pixels come first in grid order, then fixed ones as padding
    up to ``n_new`` (every instance must have at most ``n_new`` free
    pixels).  ELL row entries are the diagonal and the 8 neighbours;
    an entry pointing at a fixed pixel is zeroed, as its contribution is
    already in the gathered ``b_eff`` (the same invariant as
    ``core.lp.compact``).  A is symmetric, so the row layout is also the
    column layout.  Returns ``(gstate, gprob, idx)``, ``idx`` (B, n_new)
    mapping compacted slots to flat grid positions
    (``scatter_solution``)."""
    from . import general
    from ..ops.sparse import SparseEll

    B, H, W = state.x.shape
    n = H * W
    dt, dev = state.x.dtype, state.x.device
    free_flat = state.free.reshape(B, n)
    order = torch.argsort((~free_flat).to(torch.uint8), dim=-1, stable=True)
    idx = order[:, :n_new]                          # slot -> grid position
    slots = torch.arange(n_new, device=dev)[None].expand(B, n_new)
    inv = torch.zeros((B, n), dtype=torch.long, device=dev).scatter(
        1, idx, slots)                              # grid position -> slot

    def take(a):                                    # (B, H, W) -> (B, n_new)
        return torch.gather(a.reshape(B, n), 1, idx)

    free_c = take(state.free)
    r, c = idx // W, idx % W
    zero_v = torch.zeros((B, n_new), dtype=torch.float32, device=dev)
    row_i = [slots]
    row_v = [torch.where(free_c, take(prob.stencil.degree).float(), zero_v)]
    for d, (dr, dc) in enumerate(OFFSETS):
        qr, qc = r + dr, c + dc
        inb = (qr >= 0) & (qr < H) & (qc >= 0) & (qc < W)
        q = qr.clamp(0, H - 1) * W + qc.clamp(0, W - 1)
        valid = free_c & torch.gather(free_flat, 1, q) & inb
        row_i.append(torch.where(valid, torch.gather(inv, 1, q),
                                 torch.zeros_like(q)))
        row_v.append(torch.where(valid,
                                 -take(prob.stencil.weights[:, d]).float(),
                                 zero_v))
    ri = torch.stack(row_i, dim=-1)                 # (B, n_new, 9)
    rv = torch.stack(row_v, dim=-1)
    A = SparseEll(row_idx=ri, row_val=rv, col_idx=ri, col_val=rv)

    b_c = take(state.b_eff)
    zr = torch.zeros((B, 0), dtype=dt, device=dev)
    zm = torch.zeros((B, 0, n_new), dtype=torch.float32, device=dev)
    gprob = general.GeneralProblem(A=A, b=b_c, C=zm, d=zr, E=zm, f=zr,
                                   var_mask=free_c)
    gstate = general.GeneralState(
        x=take(state.x), y1=take(state.y1), y2=take(state.y2), y3=zr,
        z1=take(state.z1), z2=take(state.z2), z3=zr, z4=zr,
        free=free_c, fixed_val=take(state.fixed_val), b_eff=b_c,
        d_eff=zr, f_eff=zr,
        obj_ring=state.obj_ring, obj_count=state.obj_count,
        it=state.it, done=state.done,
        cg_fail=torch.zeros((B,), dtype=torch.bool, device=dev),
        cur_obj=state.cur_obj, best_bin_obj=state.best_bin_obj,
        best_sol=take(state.best_sol), x_prev=take(state.x_prev),
        fix_count=take(state.fix_count))
    return gstate, gprob, idx


def scatter_solution(sol_c: torch.Tensor, idx: torch.Tensor,
                     fixed_val_full: torch.Tensor,
                     free_full: torch.Tensor) -> torch.Tensor:
    """Reassemble the (B, H, W) solution after compaction from the
    full-grid fixing snapshot taken at compaction time; the compacted
    slots overwrite their grid positions (Seg get_x_sol, :895-915)."""
    B, H, W = free_full.shape
    base = torch.where(free_full, torch.zeros_like(fixed_val_full),
                       fixed_val_full).reshape(B, -1)
    return base.scatter(1, idx, sol_c.to(base.dtype)).reshape(B, H, W)
