"""Generic constrained binary-QP Lp-Box ADMM (the port of the JAX
package's ``core/general.py``; reference Segmentation/.../
LPboxADMMsolver.cpp ``ADMM_bqp`` :1384-1834 and the eq/ineq entry points
:1834-2109):

    min x^T A x + b^T x   s.t.  C x = d,  E x <= f,  x in {0,1}^n

Splitting: y1 (box), y2 (shifted Lp sphere), y3 = f - Ex slack
(inequality), duals z1, z2, z3 (equality), z4 (inequality).  The
x-update solves

    (2A + (rho1+rho2) I + rho3 C^T C + rho4 E^T E) x =
        rho1 y1 + rho2 y2 + rho3 C^T d_eff + rho4 E^T (f_eff - y3)
        - (b_eff + z1 + z2 + C^T z3 + E^T z4)

by masked batched PCG with chained matvecs (C^T C and E^T E are never
formed; reference calculate_mat_expr_multiplication, LP cpp:115-162).

Absent constraint blocks are zero-row tensors (mc = 0 or mi = 0): their
products vanish structurally and one code path serves all four problem
types.  Early fixing is mask-based: fixed variables fold into ``b_eff =
b + 2 A (fixed)``, ``d_eff = d - C (fixed)``, ``f_eff = f - E (fixed)``.
A, C and E may each be dense (B, rows, n) or an ``ops.sparse.SparseEll``;
``GridGeneralProblem`` carries A as a grid stencil (``ops/stencil.py``).
Dense products are broadcast multiplies and sums in float32, whatever
the TF32 settings.  ``it`` is a host integer.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import SolverConfig
from ..ops import cg as cg_ops
from ..ops import sparse as sparse_ops
from ..ops.projections import (project_box, project_nonneg,
                               project_shifted_lp_ball)
from ..ops.schedule import gamma_at, rho_at
from ..ops.stats import dual_residuals, rel_std_obj
from ..ops.stencil import Stencil, build_stencil
from ..utils import profiling
from .problem import Device, as_device


@dataclasses.dataclass(frozen=True)
class GeneralProblem:
    """min x.Ax + b.x s.t. Cx = d, Ex <= f.  Any block may be empty: A
    all zeros for a linear objective, C/d or E/f with 0 rows."""

    A: object               # (B, n, n) symmetric, or a SparseEll
    b: torch.Tensor         # (B, n)
    C: object               # (B, mc, n) or a SparseEll
    d: torch.Tensor         # (B, mc)
    E: object               # (B, mi, n) or a SparseEll
    f: torch.Tensor         # (B, mi)
    var_mask: torch.Tensor  # (B, n)

    @property
    def batch(self) -> int:
        return self.b.shape[0]

    @property
    def n(self) -> int:
        return self.b.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.b.device


@dataclasses.dataclass(frozen=True)
class GridGeneralProblem:
    """Constrained binary QP whose A is a grid stencil (A = diag(W 1) -
    W, ``ops/stencil.py``) with dense constraint blocks: eq/ineq systems
    on grids have few rows (cardinality, region budgets).  n = H * W; x
    is carried flat."""

    weights: torch.Tensor   # (B, 8, H, W) stencil neighbour weights
    degree: torch.Tensor    # (B, H, W) = diag(A)
    b: torch.Tensor         # (B, n)
    C: torch.Tensor         # (B, mc, n)
    d: torch.Tensor         # (B, mc)
    E: torch.Tensor         # (B, mi, n)
    f: torch.Tensor         # (B, mi)
    var_mask: torch.Tensor  # (B, n)

    @property
    def batch(self) -> int:
        return self.b.shape[0]

    @property
    def n(self) -> int:
        return self.b.shape[-1]

    @property
    def grid(self) -> Tuple[int, int]:
        return self.degree.shape[-2], self.degree.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.b.device


def _blocks(B, n, C, d, E, f):
    """Dense constraint blocks as float32 numpy, absent ones zero-row."""
    if C is None:
        C, d = np.zeros((B, 0, n), np.float32), np.zeros((B, 0), np.float32)
    else:
        C = np.asarray(C, np.float32).reshape(B, -1, n)
        d = np.asarray(d, np.float32).reshape(B, -1)
    if E is None:
        E, f = np.zeros((B, 0, n), np.float32), np.zeros((B, 0), np.float32)
    else:
        E = np.asarray(E, np.float32).reshape(B, -1, n)
        f = np.asarray(f, np.float32).reshape(B, -1)
    return C, d, E, f


def _mask(var_mask, B, n) -> np.ndarray:
    return np.ones((B, n), bool) if var_mask is None \
        else np.asarray(var_mask, bool).reshape(B, n)


def make_general(A=None, b=None, C=None, d=None, E=None, f=None,
                 var_mask=None, device: Device = "cuda") -> GeneralProblem:
    """Dense problem, absent blocks filled with zeros / zero rows (the
    four problem_t variants of LPboxADMMsolver.h:42), on ``device``."""
    dev = as_device(device)
    b = np.asarray(b, np.float32)
    if b.ndim == 1:
        b = b[None]
    B, n = b.shape
    A = (np.zeros((B, n, n), np.float32) if A is None
         else np.asarray(A, np.float32).reshape(B, n, n))
    C, d, E, f = _blocks(B, n, C, d, E, f)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return GeneralProblem(A=t(A), b=t(b), C=t(C), d=t(d), E=t(E), f=t(f),
                          var_mask=t(_mask(var_mask, B, n)))


def make_sparse_general(b, A_coo=None, C_coo=None, d=None, E_coo=None,
                        f=None, var_mask=None,
                        device: Device = "cuda") -> GeneralProblem:
    """Problem with ``SparseEll`` A / C / E blocks from per-instance COO
    triplets ``(rows, cols, vals)`` (numpy, 0-indexed), one per batch
    element, all of one block shape: O(nnz) storage and products, so
    1e5+-variable problems fit (the reference's Eigen-sparse ADMM_bqp).
    A must be symmetric (the solver never transposes it).  Normalize
    wide constraint rows to about unit norm (row and rhs together): an
    unnormalized n-wide cardinality row makes rho3 z3 dwarf b and the
    ADMM oscillates."""
    dev = as_device(device)
    b = np.asarray(b, np.float32)
    if b.ndim == 1:
        b = b[None]
    B, n = b.shape
    A = (sparse_ops.empty(B, n, n, device=dev) if A_coo is None
         else sparse_ops.from_coo(A_coo, (n, n), device=dev))
    if C_coo is None:
        C = sparse_ops.empty(B, 0, n, device=dev)
        d = np.zeros((B, 0), np.float32)
    else:
        d = np.asarray(d, np.float32).reshape(B, -1)
        C = sparse_ops.from_coo(C_coo, (d.shape[-1], n), device=dev)
    if E_coo is None:
        E = sparse_ops.empty(B, 0, n, device=dev)
        f = np.zeros((B, 0), np.float32)
    else:
        f = np.asarray(f, np.float32).reshape(B, -1)
        E = sparse_ops.from_coo(E_coo, (f.shape[-1], n), device=dev)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return GeneralProblem(A=A, b=t(b), C=C, d=t(d), E=E, f=t(f),
                          var_mask=t(_mask(var_mask, B, n)))


def make_grid_general(weights, b, C=None, d=None, E=None, f=None,
                      var_mask=None,
                      device: Device = "cuda") -> GridGeneralProblem:
    """A ``GridGeneralProblem`` from (B, 8, H, W) stencil weights and
    optional dense constraint blocks, on ``device``."""
    dev = as_device(device)
    weights = np.asarray(weights, np.float32)
    B, _, H, W = weights.shape
    n = H * W
    st = build_stencil(torch.from_numpy(weights).to(dev))
    C, d, E, f = _blocks(B, n, C, d, E, f)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return GridGeneralProblem(
        weights=st.weights, degree=st.degree,
        b=t(np.asarray(b, np.float32).reshape(B, n)), C=t(C), d=t(d),
        E=t(E), f=t(f), var_mask=t(_mask(var_mask, B, n)))


def _mv(M, v: torch.Tensor) -> torch.Tensor:
    """M @ v for a dense (B, m, n) tensor or a SparseEll."""
    if sparse_ops.is_sparse(M):
        return sparse_ops.mv(M, v)
    return (M * v[:, None, :]).sum(-1)


def _mtv(M, v: torch.Tensor) -> torch.Tensor:
    """M^T @ v for a dense (B, m, n) tensor or a SparseEll."""
    if sparse_ops.is_sparse(M):
        return sparse_ops.mtv(M, v)
    return (M * v[:, :, None]).sum(1)


def _colsq(M) -> torch.Tensor:
    """diag(M^T M) per column -> (B, n)."""
    if sparse_ops.is_sparse(M):
        return sparse_ops.colsq(M)
    return (M * M).sum(1)


def _A_mv(prob, xf: torch.Tensor) -> torch.Tensor:
    """A @ xf for any problem representation."""
    if isinstance(prob, GridGeneralProblem):
        B, n = xf.shape
        H, W = prob.grid
        st = Stencil(weights=prob.weights, degree=prob.degree)
        return st.a_matvec(xf.reshape(B, H, W)).reshape(B, n)
    return _mv(prob.A, xf)


def _A_diag(prob) -> torch.Tensor:
    if isinstance(prob, GridGeneralProblem):
        return prob.degree.reshape(prob.batch, prob.n)
    if sparse_ops.is_sparse(prob.A):
        return sparse_ops.diag(prob.A)
    return torch.diagonal(prob.A, dim1=1, dim2=2)


@dataclasses.dataclass(frozen=True)
class GeneralState:
    x: torch.Tensor
    y1: torch.Tensor
    y2: torch.Tensor
    y3: torch.Tensor         # (B, mi)
    z1: torch.Tensor
    z2: torch.Tensor
    z3: torch.Tensor         # (B, mc)
    z4: torch.Tensor         # (B, mi)
    free: torch.Tensor
    fixed_val: torch.Tensor
    b_eff: torch.Tensor
    d_eff: torch.Tensor
    f_eff: torch.Tensor
    obj_ring: torch.Tensor
    obj_count: torch.Tensor
    it: int
    done: torch.Tensor
    cg_fail: torch.Tensor
    cur_obj: torch.Tensor
    best_bin_obj: torch.Tensor
    best_sol: torch.Tensor
    x_prev: torch.Tensor
    fix_count: torch.Tensor

    def replace(self, **kw) -> "GeneralState":
        return dataclasses.replace(self, **kw)


def reduced_cost(prob, state: GeneralState, x: torch.Tensor) -> torch.Tensor:
    free_f = state.free.to(x.dtype)
    xf = free_f * x
    ax = free_f * _A_mv(prob, xf)
    return (xf * ax).sum(-1) + (state.b_eff * xf).sum(-1)


def init_state(prob, cfg: SolverConfig,
               x0: Optional[torch.Tensor] = None) -> GeneralState:
    """x0 = 0 unless given (the generic path's convention, Seg :762)."""
    B, n = prob.batch, prob.n
    mc, mi = prob.d.shape[-1], prob.f.shape[-1]
    dt, dev = prob.b.dtype, prob.device
    free = prob.var_mask
    x = torch.zeros((B, n), dtype=dt, device=dev) if x0 is None \
        else x0 * free.to(dt)
    zeros_n = torch.zeros((B, n), dtype=dt, device=dev)
    cur = (prob.b * (x >= 0.5) * free).sum(-1)
    return GeneralState(
        x=x, y1=x, y2=x, y3=project_nonneg(prob.f - _mv(prob.E, x)),
        z1=zeros_n, z2=zeros_n,
        z3=torch.zeros((B, mc), dtype=dt, device=dev),
        z4=torch.zeros((B, mi), dtype=dt, device=dev),
        free=free, fixed_val=zeros_n, b_eff=prob.b, d_eff=prob.d,
        f_eff=prob.f,
        obj_ring=torch.zeros((B, cfg.history_size), dtype=dt, device=dev),
        obj_count=torch.zeros((B,), dtype=torch.int32, device=dev),
        it=0, done=torch.zeros((B,), dtype=torch.bool, device=dev),
        cg_fail=torch.zeros((B,), dtype=torch.bool, device=dev),
        cur_obj=cur, best_bin_obj=cur, best_sol=x, x_prev=zeros_n,
        fix_count=torch.zeros((B, n), dtype=torch.int32, device=dev))


def step(state: GeneralState, prob, cfg: SolverConfig,
         rule_fixing: bool = False) -> GeneralState:
    """One iteration (Seg ADMM_bqp :1384-1834): box, shifted-Lp and
    slack projections, the chained-matvec PCG x-update, dual ascent,
    the stop tests, incumbent tracking."""
    dt = state.x.dtype
    it = state.it
    active = ~state.done
    act = active[:, None]
    free = state.free
    free_f = free.to(dt)

    rho = rho_at(it, cfg)
    rho1 = rho2 = rho3 = rho4 = rho
    gamma = gamma_at(it, cfg)

    y1 = project_box(state.x + state.z1 / rho1)
    y2 = project_shifted_lp_ball(state.x + state.z2 / rho2,
                                 cfg.projection_lp, mask=free)
    ex = _mv(prob.E, free_f * state.x)
    y3 = project_nonneg(state.f_eff - ex - state.z4 / rho4)

    rhs = free_f * (
        rho1 * y1 + rho2 * y2
        - (state.b_eff + state.z1 + state.z2)
        + _mtv(prob.C, rho3 * state.d_eff - state.z3)
        + _mtv(prob.E, rho4 * (state.f_eff - y3) - state.z4))
    c = rho1 + rho2

    def matvec(p):
        pf = free_f * p
        out = 2.0 * _A_mv(prob, pf) + c * pf
        out = out + rho3 * _mtv(prob.C, _mv(prob.C, pf))
        out = out + rho4 * _mtv(prob.E, _mv(prob.E, pf))
        return free_f * out

    diag = (2.0 * _A_diag(prob) + c + rho3 * _colsq(prob.C)
            + rho4 * _colsq(prob.E))
    diag = torch.where(free, diag, torch.ones_like(diag))
    res = cg_ops.pcg(matvec, rhs, free_f * y1, diag, cfg.pcg_tol,
                     cfg.pcg_maxiters, active=active)
    x = torch.where(act & ~res.failed[:, None], free_f * res.x, state.x)

    z1 = state.z1 + gamma * rho1 * free_f * (x - y1)
    z2 = state.z2 + gamma * rho2 * free_f * (x - y2)
    z3 = state.z3 + gamma * rho3 * (_mv(prob.C, free_f * x) - state.d_eff)
    z4 = state.z4 + gamma * rho4 * (_mv(prob.E, free_f * x) + y3
                                    - state.f_eff)

    c1, c2 = dual_residuals(x, y1, y2, free)
    cvg = ((c1 <= cfg.stop_threshold) & (c2 <= cfg.stop_threshold)) \
        | res.failed

    obj_val = reduced_cost(prob, state, x)
    push = active & ~cvg
    H = cfg.history_size
    slot = torch.remainder(state.obj_count, H)
    onehot = slot[:, None] == torch.arange(H, device=x.device)[None, :]
    obj_ring = torch.where(push[:, None] & onehot, obj_val[:, None],
                           state.obj_ring)
    obj_count = state.obj_count + push.to(torch.int32)
    std = rel_std_obj(obj_ring, obj_count, obj_val)
    newly_done = active & (cvg | (push & (std <= cfg.std_threshold)))

    track = active & ~newly_done
    rounded = free_f * (x >= 0.5).to(dt)
    obj_bin = reduced_cost(prob, state, rounded)
    cur_obj = torch.where(track, obj_bin, state.cur_obj)
    better = track & (state.best_bin_obj >= obj_bin)
    best_bin_obj = torch.where(better, obj_bin, state.best_bin_obj)
    best_sol = torch.where(better[:, None], x, state.best_sol)

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
        y3=upd(y3, state.y3),
        z1=upd(z1, state.z1), z2=upd(z2, state.z2),
        z3=upd(z3, state.z3), z4=upd(z4, state.z4),
        obj_ring=obj_ring, obj_count=obj_count, it=it + 1,
        done=state.done | newly_done, cg_fail=state.cg_fail | res.failed,
        cur_obj=cur_obj, best_bin_obj=best_bin_obj, best_sol=best_sol,
        x_prev=upd(x, state.x_prev), fix_count=fix_count)


def solve_window(state: GeneralState, prob, cfg: SolverConfig, window: int,
                 record: bool = True, rule_fixing: bool = False):
    """``window`` iterations; with ``record`` the (B, n, window) x
    trajectory."""
    traj = []
    for _ in range(window):
        state = step(state, prob, cfg, rule_fixing=rule_fixing)
        if record:
            traj.append(state.x)
    return state, (torch.stack(traj, dim=-1) if record else None)


def apply_fix(state: GeneralState, prob, vec: torch.Tensor,
              cfg: SolverConfig, min_fix: Optional[int] = None
              ) -> GeneralState:
    """Mask-based reduction folding the fixed values into b, d and f
    (the general analogue of LP N5 + Seg N10)."""
    if min_fix is None:
        min_fix = cfg.min_fix
    dt = state.x.dtype
    active = ~state.done
    want = state.free & (vec >= 0.0) & active[:, None]
    do = want.sum(-1) > min_fix
    d2 = do[:, None]
    newly = want & d2

    val = torch.clamp(vec, 0.0, 1.0).to(dt)
    fixed_val = torch.where(newly, val, state.fixed_val)
    free = state.free & ~newly
    fixed_f = (~free).to(dt) * fixed_val

    b_eff = torch.where(d2, prob.b + 2.0 * _A_mv(prob, fixed_f), state.b_eff)
    d_eff = torch.where(d2, prob.d - _mv(prob.C, fixed_f), state.d_eff)
    f_eff = torch.where(d2, prob.f - _mv(prob.E, fixed_f), state.f_eff)

    empty = free.sum(-1) == 0
    return state.replace(free=free, fixed_val=fixed_val, b_eff=b_eff,
                         d_eff=d_eff, f_eff=f_eff,
                         done=state.done | (do & empty),
                         x_prev=torch.where(d2, state.x, state.x_prev))


def rule_fix_vec(state: GeneralState, cfg: SolverConfig) -> torch.Tensor:
    flag = state.free & (state.fix_count >= cfg.consistency)
    val = (state.x >= 0.5).to(state.x.dtype)
    return torch.where(flag, val, torch.full_like(val, -1.0))


def solution(state: GeneralState) -> torch.Tensor:
    rounded = (state.x >= 0.5).to(state.x.dtype)
    return torch.where(state.free, rounded, state.fixed_val)


def objective(state: GeneralState, prob) -> torch.Tensor:
    """Objective of the restored solution on the original A, b."""
    x = solution(state) * prob.var_mask.to(state.x.dtype)
    return (x * _A_mv(prob, x)).sum(-1) + (prob.b * x).sum(-1)


def constraint_violation(state: GeneralState, prob
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(||Cx - d||, number of violated inequality rows) of the restored
    solution (the reference's iteration log + check_infeasible)."""
    x = solution(state) * prob.var_mask.to(state.x.dtype)
    eq = torch.sqrt(((_mv(prob.C, x) - prob.d) ** 2).sum(-1))
    ineq = (_mv(prob.E, x) > prob.f + 1e-6).sum(-1)
    return eq, ineq


def solve(prob, cfg: SolverConfig, max_iters: Optional[int] = None,
          window: int = 100, rule_fixing: bool = False) -> GeneralState:
    """Windows of ``window`` iterations until every instance is done or
    ``max_iters`` (one host check per window, the tracer's read site
    ``general.done``); with ``rule_fixing`` each window ends with the
    consistency counters' fixes."""
    if max_iters is None:
        max_iters = cfg.max_iters
    state = init_state(prob, cfg)
    while state.it < max_iters and not profiling.read(
            "general.done", bool, state.done.all()):
        state, _ = solve_window(state, prob, cfg, window, record=False,
                                rule_fixing=rule_fixing)
        if rule_fixing:
            state = apply_fix(state, prob, rule_fix_vec(state, cfg), cfg)
    return state


def compact_sparse(state: GeneralState, prob: GeneralProblem, n_new: int):
    """Re-compact a flat unconstrained SparseEll-A problem to ``n_new``
    columns, free variables first (then fixed padding).

    The compacted segmentation l2f path shrinks again with it as later
    windows fix more pixels (``core.qp.compact`` makes the first
    grid -> flat compaction).  ELL rows are gathered and their column
    indices remapped through the inverse permutation; entries pointing
    at fixed variables are zeroed, their contribution being in
    ``b_eff``, which becomes the compacted problem's b.  Returns
    ``(state', prob', idx)``, ``idx`` (B, n_new) mapping new slots to
    OLD slots."""
    if prob.d.shape[-1] != 0 or prob.f.shape[-1] != 0:
        raise ValueError("compact_sparse supports unconstrained "
                         "problems only (C/E zero-row)")
    if not isinstance(prob.A, sparse_ops.SparseEll):
        raise ValueError("compact_sparse requires a SparseEll A")
    B, n = state.x.shape
    dev = state.x.device
    order = torch.argsort((~state.free).to(torch.uint8), dim=-1, stable=True)
    idx = order[:, :n_new]
    slots = torch.arange(n_new, device=dev)[None].expand(B, n_new)
    inv = torch.zeros((B, n), dtype=torch.long, device=dev).scatter(
        1, idx, slots)

    def take(a):
        return torch.gather(a, 1, idx)

    free_c = take(state.free)
    A = prob.A
    K = A.row_idx.shape[-1]
    ix3 = idx[:, :, None].expand(B, n_new, K)
    ri_old = torch.gather(A.row_idx, 1, ix3)               # (B, n_new, K)
    rv_old = torch.gather(A.row_val, 1, ix3)
    flat = ri_old.reshape(B, -1)
    tgt_free = torch.gather(state.free, 1, flat).reshape(ri_old.shape)
    valid = free_c[:, :, None] & tgt_free
    ri = torch.where(valid, torch.gather(inv, 1, flat).reshape(ri_old.shape),
                     torch.zeros_like(ri_old))
    rv = torch.where(valid, rv_old, torch.zeros_like(rv_old))
    A2 = sparse_ops.SparseEll(row_idx=ri, row_val=rv, col_idx=ri, col_val=rv)

    b_c = take(state.b_eff)
    zr = torch.zeros((B, 0), dtype=b_c.dtype, device=dev)
    zm = torch.zeros((B, 0, n_new), dtype=torch.float32, device=dev)
    prob2 = GeneralProblem(A=A2, b=b_c, C=zm, d=zr, E=zm, f=zr,
                           var_mask=free_c)
    state2 = state.replace(
        x=take(state.x), y1=take(state.y1), y2=take(state.y2),
        z1=take(state.z1), z2=take(state.z2),
        free=free_c, fixed_val=take(state.fixed_val), b_eff=b_c,
        best_sol=take(state.best_sol), x_prev=take(state.x_prev),
        fix_count=take(state.fix_count))
    return state2, prob2, idx


def solution_best(state: GeneralState) -> torch.Tensor:
    """Rounding of the best incumbent iterate, fixed values restored."""
    rounded = (state.best_sol >= 0.5).to(state.x.dtype)
    return torch.where(state.free, rounded, state.fixed_val)
