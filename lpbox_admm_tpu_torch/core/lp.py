"""Batched Lp-Box ADMM for binary LPs (combinatorial auctions et al.).

The port of the JAX package's ``core/lp.py``, with both of its
x-updates: the exact Woodbury solve (``linsolve="woodbury"``) and
Jacobi-preconditioned CG (``linsolve="cg"``, ``ops/cg.py``), on E dense
in float32 or bfloat16 (three-limb products, ``_mv``), sparse
(``ops.sparse.SparseEll``) or structured (``ops.ca_sparse.CaStructE``),
and G^{-1} dense in float32 or bfloat16 (``cfg.ginv_dtype``) or
Schur-structured (``ops.struct_ginv.StructGinv``)
(reference LinerProgramming/LinearProgramming/cython_solver/
LPboxADMMsolver.cpp):

* ``init_state``        ~ ADMM_lp_iters_init        (:489-763)
* ``step``              ~ one iteration of ADMM_lp_iters (:796-1068)
* ``solve_window``      ~ an ADMM_lp_iters_l2f window with trajectory capture
* ``solve``             ~ ADMM_lp_iters(0, max_iters) (:766), window-quantized;
                          with ``rule_fixing``, ADMM_lp_iters_fix (:1689)
* ``solve_blocked``     ~ the same per block of instances, each block
                          dropped once done (host round-robin; the
                          large CA rungs' single-stream sweep with
                          ``stream=True``)
* ``solve_auto``        ~ the plain solve through the route measured best
                          on the card for the problem's shape
* ``apply_fix``         ~ the early-fix problem reduction (:1124-1335)
* ``rule_fix_vec``      ~ the rule-based fixing counters of ADMM_lp_iters_fix
                          (:1856-1950)
* ``solution`` / ``objective`` / ``infeasible_rows``
                        ~ get_x_sol (:1648), cal_obj (:1630), check_infeasible_l2f (:1593)

The instance batch is the leading axis; early fixing keeps static shapes
through a ``free`` mask and ``fixed_val`` vector, fixed columns being
zeroed out of every product and folded into ``f_eff``/``sum_fix_obj``.
Instances freeze individually through ``done``.  ``it`` is a host
integer, so the schedule costs no device round trip.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import SolverConfig
from ..ops import cg as cg_ops
from ..ops import sparse as sparse_ops
from ..ops import woodbury
from ..ops.mxu_sparse import _limbs3
from ..ops.projections import (project_box, project_nonneg,
                               project_shifted_lp_ball)
from ..ops.schedule import gamma_at, rho_at
from ..ops.stats import dual_residuals, rel_std_obj
from ..utils import profiling
from .problem import LpProblem

_BEST_INIT = 1e30     # "no feasible incumbent yet" sentinel


@dataclasses.dataclass(frozen=True)
class LpState:
    # ADMM variables
    x: torch.Tensor            # (B, n) relaxed iterate
    y1: torch.Tensor           # (B, n) box copy
    y2: torch.Tensor           # (B, n) sphere copy
    y3: torch.Tensor           # (B, m) slack copy
    z1: torch.Tensor           # (B, n) dual for y1
    z2: torch.Tensor           # (B, n) dual for y2
    z4: torch.Tensor           # (B, m) dual for the inequality
    # Early fixing (mask-based problem reduction)
    free: torch.Tensor         # (B, n) bool: not yet fixed
    fixed_val: torch.Tensor    # (B, n) value of fixed vars (0/1), 0 elsewhere
    f_eff: torch.Tensor        # (B, m) f - E @ (fixed contribution)
    sum_fix_obj: torch.Tensor  # (B,) objective of the fixed vars
    # Convergence machinery
    obj_ring: torch.Tensor     # (B, H) objective history ring
    obj_count: torch.Tensor    # (B,) int32 objectives pushed
    it: int                    # global iteration counter
    done: torch.Tensor         # (B,) bool
    cg_fail: torch.Tensor      # (B,) bool: CG lost positive definiteness
    # Incumbent tracking
    cur_obj: torch.Tensor      # (B,) binary objective of the current rounding
    best_bin_obj: torch.Tensor # (B,)
    best_sol: torch.Tensor     # (B, n)
    # Rule-based fixing counters
    x_prev: torch.Tensor       # (B, n)
    fix_count: torch.Tensor    # (B, n) int32 consistency counters
    # E @ (free * x), carried so the y3 update reuses the last product
    ex: torch.Tensor           # (B, m)
    ginv: object               # (B, m, m) Woodbury G^{-1} (float32 or
                               # bfloat16, cfg.ginv_dtype), a StructGinv,
                               # or (B, 1, 1) zeros under linsolve="cg"
    # E^T w for the next iteration's rhs, w = rho4 (f_eff - y3) - z4;
    # refresh_et_next after any out-of-step change of f_eff/ex/z4/it
    et_next: torch.Tensor      # (B, n)

    def replace(self, **kw) -> "LpState":
        return dataclasses.replace(self, **kw)


def _wb_ratio(cfg: SolverConfig) -> float:
    """(rho1 + rho2) / rho4, constant = 2 under the shared uncapped LP
    schedule; anything else would make the cached factor solve the
    wrong system, so refuse it.  Also the guard of the Woodbury-only
    paths (the fused windows): ``linsolve="cg"`` is refused there."""
    if cfg.linsolve != "woodbury":
        raise ValueError(f"linsolve={cfg.linsolve!r}: this path "
                         "implements linsolve='woodbury' only")
    if cfg.rho_upper_limit is not None:
        raise ValueError(
            "linsolve='woodbury' requires an uncapped shared rho schedule")
    return 2.0


def _check_linsolve(cfg: SolverConfig) -> None:
    if cfg.linsolve not in ("cg", "woodbury"):
        raise ValueError(f"unknown linsolve {cfg.linsolve!r}; "
                         "expected 'cg' or 'woodbury'")


def _is_struct_ginv(ginv) -> bool:
    return getattr(ginv, "is_struct_ginv", False)


def _ginv_store(ginv, cfg: SolverConfig):
    """The stored copy of a freshly factored G^{-1}: the factorization is
    always float32, the copy the iteration reads is bfloat16 under
    ``cfg.ginv_dtype="bfloat16"`` (the JAX package's large-rung option;
    products with it go through ``_mv``'s three limbs).  A StructGinv
    passes through."""
    if cfg.ginv_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"ginv_dtype {cfg.ginv_dtype!r}: expected "
                         "'float32' or 'bfloat16'")
    if _is_struct_ginv(ginv) or cfg.ginv_dtype == "float32":
        return ginv
    return ginv.to(torch.bfloat16)


def _E32(E):
    """E for the Gram factorization: sparse and bfloat16 E pass through
    (bfloat16 storage asserts bf16-exact entries, and
    ``woodbury.factorize`` sums in float32), float32 otherwise."""
    if sparse_ops.is_sparse(E) or E.dtype == torch.bfloat16:
        return E
    return E.float()


def _bf16_bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b batched, bfloat16 operands, float32 products and sums and a
    float32 result: no bfloat16 rounding of the output (a plain bf16
    ``torch.bmm`` returns bfloat16).  On the card cuBLAS's bf16 GEMM with
    an f32 output (``out_dtype``); on the CPU the same values in f32."""
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _mv_many(M, V: torch.Tensor) -> torch.Tensor:
    """Per-instance M @ v for a stack: (B, I, J) x (B, k, J) -> (B, k, I),
    float32.  ``M``: dense float32 or bfloat16 (``V`` then in three
    bfloat16 limbs contracted in one product, f32-equivalent), or
    sparse (``ops/sparse``: gathers)."""
    if sparse_ops.is_sparse(M):
        return sparse_ops.mv_many(M, V)
    if M.dtype == torch.bfloat16:
        B, k, J = V.shape
        L = _limbs3(V).permute(0, 2, 1, 3).reshape(B, J, 3 * k)
        r = _bf16_bmm(M, L).view(B, M.shape[1], k, 3)
        return (r[..., 0] + r[..., 1] + r[..., 2]).transpose(1, 2)
    return torch.bmm(M.float(), V.transpose(1, 2).contiguous()).transpose(1, 2)


def _mtv_many(M, W: torch.Tensor) -> torch.Tensor:
    """Per-instance M^T @ w for a stack: (B, I, J) x (B, k, I) -> (B, k, J),
    float32 (the same three cases as ``_mv_many``)."""
    if sparse_ops.is_sparse(M):
        return sparse_ops.mtv_many(M, W)
    if M.dtype == torch.bfloat16:
        B, k, I = W.shape
        L = _limbs3(W).permute(0, 1, 3, 2).reshape(B, 3 * k, I)
        r = _bf16_bmm(L, M).view(B, k, 3, M.shape[2])
        return r[:, :, 0] + r[:, :, 1] + r[:, :, 2]
    return torch.bmm(W, M.float())


def _mv(M, v: torch.Tensor) -> torch.Tensor:
    """Per-instance M @ v: (B, I, J) x (B, J) -> (B, I), float32, M as
    stored (the JAX package's ``_emv("bmn,bn->bm")``): float32 E or
    G^{-1} exactly, bfloat16 in three limbs of v with float32 products
    and sums (one limb's 4e-3 rounding enters the dual ascent scaled by
    rho and diverges at high rho), sparse E by gathers."""
    if sparse_ops.is_sparse(M) or M.dtype == torch.bfloat16:
        return _mv_many(M, v[:, None])[:, 0]
    return torch.bmm(M.float(), v[..., None])[..., 0]


def _mtv(M, w: torch.Tensor) -> torch.Tensor:
    """Per-instance M^T @ w: (B, I, J) x (B, I) -> (B, J), float32."""
    return _mtv_many(M, w[:, None])[:, 0]


def _ginv_apply(ginv, r: torch.Tensor) -> torch.Tensor:
    """``G^{-1} r`` for either representation: dense (float32, or
    bfloat16 through the limbs) or the Schur block elimination."""
    if _is_struct_ginv(ginv):
        return ginv.apply(r)
    return _mv(ginv, r)


def _esq_diag(E, free_f: torch.Tensor) -> torch.Tensor:
    """diag(E_f^T E_f): squared column norms over the free columns."""
    if sparse_ops.is_sparse(E):
        return sparse_ops.colsq(E) * free_f
    return (E.float() * E.float()).sum(1) * free_f


def _mv_problem(prob: LpProblem, cfg: SolverConfig) -> LpProblem:
    """The problem as the solve loop reads it: dense E cast to bfloat16
    once under ``matvec_dtype="bfloat16"``; sparse E as stored."""
    if cfg.matvec_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"matvec_dtype {cfg.matvec_dtype!r}")
    if sparse_ops.is_sparse(prob.E):
        return prob
    if cfg.matvec_dtype == "bfloat16" and prob.E.dtype != torch.bfloat16:
        return prob.replace(E=prob.E.to(torch.bfloat16))
    return prob


def _w_vec(f_eff, ex, z4, rho4):
    # w(it) = rho4 (f_eff - y3) - z4 with y3 = max(f_eff - ex - z4/rho4, 0)
    y3 = project_nonneg(f_eff - ex - z4 / rho4)
    return rho4 * (f_eff - y3) - z4


def refresh_et_next(state: LpState, prob: LpProblem,
                    cfg: SolverConfig) -> LpState:
    """Recompute the carried E^T w product for the state's current
    (f_eff, ex, z4, it)."""
    w = _w_vec(state.f_eff, state.ex, state.z4, rho_at(state.it, cfg))
    return state.replace(et_next=_mtv(_mv_problem(prob, cfg).E, w))


def init_state(prob: LpProblem, cfg: SolverConfig,
               gram: Optional[torch.Tensor] = None,
               ginv=None) -> LpState:
    """Initial state: x=1, z=0, y3 = f - E x (reference :550-727).

    ``gram``: optional precomputed (B, m, m) unshifted Gram ``E E^T``
    (all columns free) for the Woodbury factorization; ``ginv``: an
    optional fully precomputed inverse of ``ratio I + E E^T``, dense
    (B, m, m) or a ``StructGinv`` (the struct problems' Schur form, built
    on the host by ``ops.struct_ginv.build_struct_ginv``)."""
    B, n, m = prob.batch, prob.n, prob.m
    dt, dev = prob.b.dtype, prob.device
    free = prob.var_mask
    x = free.to(dt)                       # x0 = 1 on valid vars
    zeros_n = torch.zeros((B, n), dtype=dt, device=dev)
    z4 = torch.zeros((B, m), dtype=dt, device=dev)
    ex = _mv(prob.E, x)
    y3 = prob.f - ex
    cur_obj = (prob.b * x).sum(-1)
    # feasible-incumbent tracking starts from +inf (x0 = 1 minimises b.x)
    best0 = torch.full((B,), _BEST_INIT, dtype=dt, device=dev) \
        if cfg.feasible_incumbent else cur_obj
    _check_linsolve(cfg)
    if cfg.linsolve == "cg":
        ginv = torch.zeros((B, 1, 1), dtype=dt, device=dev)
    else:
        ratio = _wb_ratio(cfg)
        if ginv is not None:
            ginv = ginv if _is_struct_ginv(ginv) else ginv.float()
        elif gram is not None:
            ginv = woodbury.factorize_from_gram(gram, ratio).ginv
        else:
            ginv = woodbury.factorize(_E32(prob.E), free, ratio).ginv
        ginv = _ginv_store(ginv, cfg)
    return LpState(
        x=x, y1=x, y2=x, y3=y3, z1=zeros_n, z2=zeros_n, z4=z4,
        free=free, fixed_val=torch.zeros((B, n), dtype=dt, device=dev),
        f_eff=prob.f, sum_fix_obj=torch.zeros((B,), dtype=dt, device=dev),
        obj_ring=torch.zeros((B, cfg.history_size), dtype=dt, device=dev),
        obj_count=torch.zeros((B,), dtype=torch.int32, device=dev),
        it=0, done=torch.zeros((B,), dtype=torch.bool, device=dev),
        cg_fail=torch.zeros((B,), dtype=torch.bool, device=dev),
        cur_obj=cur_obj, best_bin_obj=best0, best_sol=x,
        x_prev=torch.zeros((B, n), dtype=dt, device=dev),
        fix_count=torch.zeros((B, n), dtype=torch.int32, device=dev),
        ex=ex, ginv=ginv,
        et_next=_mtv(prob.E, _w_vec(prob.f, ex, z4, rho_at(0, cfg))))


def step(state: LpState, prob: LpProblem, cfg: SolverConfig,
         skip_cvg_at: Optional[int] = None,
         rule_fixing: bool = False) -> LpState:
    """One ADMM iteration over the whole batch (reference :796-1068):
    the x-update by Woodbury with the PCG warm-start keep test, or by
    Jacobi PCG (``cfg.linsolve``).

    ``skip_cvg_at``: global iteration at which the y1/y2 stop is not
    checked (the plain solver skips its first iteration).
    ``rule_fixing`` also updates the |x - x_prev| consistency counters of
    ADMM_lp_iters_fix (:1856-1871); the caller turns them into fixes."""
    _check_linsolve(cfg)
    dt = state.x.dtype
    it = state.it
    active = ~state.done
    act_n = active[:, None]
    free_f = state.free.to(dt)

    rho1 = rho_at(it, cfg)
    rho2 = rho4 = rho1
    gamma = gamma_at(it, cfg)

    # --- y updates (:806-828) --------------------------------------------
    y1 = project_box(state.x + state.z1 / rho1)
    y2 = project_shifted_lp_ball(state.x + state.z2 / rho2,
                                 cfg.projection_lp, mask=state.free)
    y3 = project_nonneg(state.f_eff - state.ex - state.z4 / rho4)

    # --- x update (:872-895) ----------------------------------------------
    rhs = free_f * (rho1 * y1 + rho2 * y2
                    - (prob.b + state.z1 + state.z2) + state.et_next)
    x0 = free_f * y1
    c = rho1 + rho2
    failed = None                         # (B,) bool, CG only
    if cfg.linsolve == "woodbury":
        ratio = _wb_ratio(cfg)
        fw = _mv_many(prob.E, torch.stack([rhs, x0], dim=1))   # (B, 2, m)
        Erhs, Ex0 = fw[:, 0], fw[:, 1]
        u = _ginv_apply(state.ginv, Erhs)
        # E_f E_f^T u = (G - ratio I) u, so E x_exact = ratio u / c
        Ex_exact = (ratio / c) * u
        rho4n = rho_at(it + 1, cfg)
        z4_keep = state.z4 + gamma * rho4 * (Ex0 + y3 - state.f_eff)
        z4_exact = state.z4 + gamma * rho4 * (Ex_exact + y3 - state.f_eff)
        w_keep = _w_vec(state.f_eff, Ex0, z4_keep, rho4n)
        w_exact = _w_vec(state.f_eff, Ex_exact, z4_exact, rho4n)
        tv = _mtv_many(prob.E, torch.stack([u, Ex0, w_keep, w_exact],
                                           dim=1))         # (B, 4, n)
        EtU, EtEx0, et_keep, et_exact = (tv[:, 0], tv[:, 1], tv[:, 2],
                                         tv[:, 3])
        x_exact = free_f * (rhs - EtU) / c
        # PCG's warm-start early exit (reference :204-209): if y1 already
        # solves the system to pcg_tol the iterate is y1
        Mx0 = free_f * (c * x0 + rho4 * EtEx0)
        r0 = rhs - Mx0
        keep = (r0 * r0).sum(-1) < (cfg.pcg_tol ** 2) * (rhs * rhs).sum(-1)
        kp = keep[:, None]
        x_new = torch.where(kp, x0, x_exact)
        ex_branch = torch.where(kp, Ex0, Ex_exact)
        et_next = torch.where(kp, et_keep, et_exact)
    else:
        def matvec(p):
            return free_f * (c * p + rho4 * _mtv(prob.E, _mv(prob.E,
                                                             free_f * p)))

        diag = torch.where(state.free, c + rho4 * _esq_diag(prob.E, free_f),
                           torch.ones_like(x0))
        res = cg_ops.pcg(matvec, rhs, x0, diag, cfg.pcg_tol,
                         cfg.pcg_maxiters, active=active)
        x_new, failed = res.x, res.failed
    # a CG failure keeps the previous iterate and ends the instance's
    # solve (reference :1450-1454)
    keep_x = act_n if failed is None else act_n & ~failed[:, None]
    x = torch.where(keep_x, free_f * x_new, state.x)

    # --- dual ascent (:917-924) ------------------------------------------
    z1 = state.z1 + gamma * rho1 * free_f * (x - y1)
    z2 = state.z2 + gamma * rho2 * free_f * (x - y2)
    if cfg.linsolve == "woodbury":
        ex_new = torch.where(act_n, ex_branch, state.ex)
    else:
        ex_new = _mv(prob.E, free_f * x)
    z4 = state.z4 + gamma * rho4 * (ex_new + y3 - state.f_eff)
    if cfg.linsolve != "woodbury":
        # the next iteration's rhs E^T term (the Woodbury branch folds
        # it into its stacked transpose product)
        et_next = _mtv(prob.E, _w_vec(state.f_eff, ex_new, z4,
                                      rho_at(it + 1, cfg)))

    # --- convergence (:931-977) ------------------------------------------
    c1, c2 = dual_residuals(x, y1, y2, state.free)
    cvg = (c1 <= cfg.stop_threshold) & (c2 <= cfg.stop_threshold)
    if skip_cvg_at is not None and it == skip_cvg_at:
        cvg = torch.zeros_like(cvg)
    if failed is not None:
        cvg = cvg | failed
    obj_val = (prob.b * free_f * x).sum(-1)
    push = active & ~cvg
    H = cfg.history_size
    slot = torch.remainder(state.obj_count, H)
    onehot = slot[:, None] == torch.arange(H, device=x.device)[None, :]
    obj_ring = torch.where(push[:, None] & onehot, obj_val[:, None],
                           state.obj_ring)
    obj_count = state.obj_count + push.to(torch.int32)
    std = rel_std_obj(obj_ring, obj_count, obj_val)
    std_stop = push & (std <= cfg.std_threshold)
    newly_done = active & (cvg | std_stop)

    # --- incumbent (skipped on the break iteration, :1001-1011) ----------
    sample = cfg.incumbent_stride <= 1 or it % cfg.incumbent_stride == 0
    track = active & ~newly_done & sample
    cur_idx = free_f * (x >= 0.5).to(dt)
    obj_bin = (prob.b * cur_idx).sum(-1)
    cur_obj = torch.where(track, obj_bin, state.cur_obj)
    better = track & (state.best_bin_obj >= obj_bin)
    if cfg.feasible_incumbent:
        if sample:
            exr = _mv(prob.E, cur_idx)
            feas = ((exr <= state.f_eff + 1e-6) | ~prob.row_mask).all(-1)
        else:
            feas = torch.zeros_like(better)
        better = better & feas
    best_bin_obj = torch.where(better, obj_bin, state.best_bin_obj)
    best_sol = torch.where(better[:, None], x, state.best_sol)

    # --- rule-based fixing counters (:1856-1871) -------------------------
    fix_count = state.fix_count
    if rule_fixing:
        live = act_n & state.free
        det = (x - state.x_prev).abs() <= cfg.fix_threshold
        fix_count = torch.where(live & det, fix_count + 1,
                                torch.where(live, torch.zeros_like(fix_count),
                                            fix_count))

    upd = lambda new, old: torch.where(act_n, new, old)
    return state.replace(
        x=upd(x, state.x), y1=upd(y1, state.y1), y2=upd(y2, state.y2),
        y3=upd(y3, state.y3),
        z1=upd(z1, state.z1), z2=upd(z2, state.z2), z4=upd(z4, state.z4),
        ex=upd(ex_new, state.ex), et_next=upd(et_next, state.et_next),
        obj_ring=obj_ring, obj_count=obj_count, it=it + 1,
        done=state.done | newly_done,
        cg_fail=state.cg_fail if failed is None else state.cg_fail | failed,
        cur_obj=cur_obj, best_bin_obj=best_bin_obj, best_sol=best_sol,
        x_prev=upd(x, state.x_prev), fix_count=fix_count)


def solve_window(state: LpState, prob: LpProblem, cfg: SolverConfig,
                 window: int, record: bool = True,
                 skip_cvg_at: Optional[int] = None,
                 rule_fixing: bool = False
                 ) -> Tuple[LpState, Optional[torch.Tensor]]:
    """Run ``window`` iterations, optionally capturing the (B, n, window)
    x trajectory (reference x_iters, :1472-1475); the tracer's span
    ``lp.window``."""
    with profiling.span("lp.window"):
        prob = _mv_problem(prob, cfg)
        traj = []
        for _ in range(window):
            state = step(state, prob, cfg, skip_cvg_at=skip_cvg_at,
                         rule_fixing=rule_fixing)
            if record:
                traj.append(state.x)
        return state, (torch.stack(traj, dim=-1) if record else None)


def solve(prob: LpProblem, cfg: SolverConfig,
          max_iters: Optional[int] = None, window: int = 100,
          rule_fixing: bool = False, ginv=None) -> LpState:
    """Plain (or rule-fixing) full solve: windows of ``window`` iterations
    until every instance is done or ``max_iters`` is reached (one host
    check per window; the first iteration's y1/y2 stop is skipped, as in
    the reference's ADMM_lp_iters(0, max_iters), :766).  With
    ``rule_fixing``, each window ends with ``apply_fix`` of the
    consistency counters' decisions (ADMM_lp_iters_fix, :1689).
    ``ginv``: a precomputed inverse for ``init_state``."""
    if max_iters is None:
        max_iters = cfg.max_iters
    state = init_state(prob, cfg, ginv=ginv)
    wprob = _mv_problem(prob, cfg)          # E cast once, not per window
    while state.it < max_iters and not bool(state.done.all()):
        state, _ = solve_window(state, wprob, cfg, window, record=False,
                                skip_cvg_at=0, rule_fixing=rule_fixing)
        if rule_fixing:
            state = apply_fix(state, prob, rule_fix_vec(state, cfg), cfg)
    return state


def _rows(v, lo: int, hi: int):
    """Instances [lo, hi) of a batched tensor or structured operand."""
    if isinstance(v, torch.Tensor):
        return v[lo:hi]
    return v.map(lambda t: t[lo:hi])


def _cat(vals: list):
    """Concatenate batched tensors, or structured operands field by field."""
    v0 = vals[0]
    if isinstance(v0, torch.Tensor):
        return torch.cat(vals)
    return type(v0)(*(_cat([getattr(v, f.name) for v in vals])
                      for f in dataclasses.fields(v0)))


def solve_blocked(prob: LpProblem, cfg: SolverConfig, block: int = 8,
                  max_iters: Optional[int] = None, window: int = 500,
                  stream: bool = False,
                  gram: Optional[torch.Tensor] = None,
                  ginv=None) -> Tuple[LpState, list]:
    """Host-driven blocked solve with per-block early exit.

    The batch is split into blocks of ``block`` instances that run
    windows round-robin; a block is dropped once all its instances are
    done or it reaches ``max_iters``, so finished blocks stop paying for
    stragglers elsewhere.  ``stream=True`` runs each window through the
    single-stream sweep (``ops.fused_stream.lp_window_stream``, K3), the
    large CA rungs' path on dense E; otherwise ``solve_window``.  With
    ``matvec_dtype="bfloat16"`` dense E is cast to bfloat16 once per
    solve.  Block slices are views of the batch (no copy of E); sparse E
    and a ``StructGinv`` are sliced field by field.

    Returns the merged state (``it`` = the largest over blocks) and the
    per-block iteration counts.
    """
    if max_iters is None:
        max_iters = cfg.max_iters
    B = prob.batch
    if B % block:
        raise ValueError(f"batch {B} is not a multiple of block {block}")
    E_op = None
    if stream:
        if sparse_ops.is_sparse(prob.E):
            raise ValueError("stream=True sweeps a dense E; sparse E runs "
                             "core.lp windows")
        from ..ops import fused_stream
        E_op = fused_stream.stream_operand(prob.E, cfg)
    los = range(0, B, block)
    fields = [f.name for f in dataclasses.fields(LpProblem)]
    cut = lambda t, lo: None if t is None else _rows(t, lo, lo + block)
    sliced = lambda p: [p.replace(**{f: cut(getattr(p, f), lo)
                                     for f in fields}) for lo in los]
    states = [init_state(p, cfg, gram=cut(gram, lo), ginv=cut(ginv, lo))
              for p, lo in zip(sliced(prob), los)]
    # the windows' view: E cast once per solve (the sweep reads E_op)
    probs = sliced(prob if stream else _mv_problem(prob, cfg))
    iters = [0] * len(probs)
    live = set(range(len(probs)))
    first = True
    while live:
        skip = 0 if first else None
        for k in sorted(live):
            if stream:
                states[k] = fused_stream.lp_window_stream(
                    states[k], probs[k], cfg, window, skip_cvg_at=skip,
                    E_op=E_op[los[k]:los[k] + block])
            else:
                states[k], _ = solve_window(states[k], probs[k], cfg, window,
                                            record=False, skip_cvg_at=skip)
        first = False
        for k in sorted(live):
            iters[k] = states[k].it
            if states[k].it >= max_iters or bool(states[k].done.all()):
                live.discard(k)
    merged = {f: (max(iters) if f == "it" else
                  _cat([getattr(s, f) for s in states]))
              for f in LpState.__dataclass_fields__}
    return LpState(**merged), iters


def solve_auto(prob: LpProblem, cfg: SolverConfig,
               max_iters: Optional[int] = None,
               ginv=None) -> Tuple[LpState, str]:
    """Plain solve through the route measured best on the card for the
    problem; returns ``(state, path)``, ``path`` naming the route:

    - ``"k1"``: the fused window (``ops.fused_lp.solve_fused``) where K1
      holds one instance (``fused_lp.fits``), the x-update is Woodbury's
      and no inverse is given; a CUDA problem only, as K1 is a card
      kernel;
    - ``"windows"``: ``core.lp`` windows on the whole batch (``solve``);
    - ``"windows-sparse"``: the same on sparse or structured E (the
      very-large rungs), ``ginv`` (a ``StructGinv`` there) passed to
      ``init_state``.

    The rule is the card's, measured end to end at two shapes
    (``scripts/auto_rule.py --end-to-end``, PERF.md §5, an H100 80GB HBM3
    at 700 W): at CA-500 x 128, K1 0.64 s against 32.9 s on ``core.lp``
    windows; at the xl rung x 32, where K1 does not fit, ``core.lp``
    windows over the whole batch 20.0-21.4 s against 61.9 s on the K3
    stream in blocks of 8 (every block ran to the 9000-iteration cap, so
    per-block early exit saved nothing).  Other dense shapes follow by
    extrapolation, not measurement: a ``core.lp`` iteration is bound by
    its host launches (about 2 ms), which blocks pay once a block.  The
    JAX package's rule (its lp.py:786-851) is the TPU's VMEM budget and
    its gather cost (ROADMAP C)."""
    if max_iters is None:
        max_iters = cfg.max_iters
    if sparse_ops.is_sparse(prob.E):
        return solve(prob, cfg, max_iters=max_iters, ginv=ginv), \
            "windows-sparse"
    from ..ops import fused_lp
    if prob.device.type == "cuda" and ginv is None \
            and cfg.linsolve == "woodbury" and cfg.rho_upper_limit is None \
            and fused_lp.fits(prob.m, prob.n):
        st = fused_lp.solve_fused(prob, cfg, max_iters=max_iters, window=100)
        return st, "k1"
    return solve(prob, cfg, max_iters=max_iters, ginv=ginv), "windows"


def apply_fix(state: LpState, prob: LpProblem, vec: torch.Tensor,
              cfg: SolverConfig, min_fix: Optional[int] = None,
              ginv=None) -> LpState:
    """Fix variables per decision vector ``vec`` (B, n): +1 fix to 1,
    0 fix to 0, -1 leave free.  Per instance, a round that would fix
    ``min_fix`` or fewer variables is skipped.  The reduced problem is
    reproduced by masking products to the free columns and
    ``f_eff = f - E ((1 - free) * fixed_val)``.

    ``ginv``: a caller-refactorized inverse for the post-fix free mask,
    dense (B, m, m) or a ``StructGinv``, merged per instance by the skip
    decision; required where the state's G^{-1} is a StructGinv (the
    host mirrors the decision with ``fix_decision_host`` and rebuilds
    with ``ops.struct_ginv.build_struct_ginv(free=...)``)."""
    if min_fix is None:
        min_fix = cfg.min_fix
    dt = state.x.dtype
    active = ~state.done
    want = state.free & (vec >= 0.0) & active[:, None]
    do = want.sum(-1) > min_fix
    newly = want & do[:, None]

    val = torch.clamp(vec, 0.0, 1.0)
    fixed_val = torch.where(newly, val, state.fixed_val)
    free = state.free & ~newly
    free_f = free.to(dt)
    sum_fix_obj = state.sum_fix_obj + (prob.b * val * newly.to(dt)).sum(-1)

    fixed_contrib = _mv(prob.E, (~free).to(dt) * fixed_val)
    f_eff = torch.where(do[:, None], prob.f - fixed_contrib, state.f_eff)

    # all-fixed or vanishing remaining iterate => converged (:1212-1223)
    x_free_norm = torch.sqrt(((free_f * state.x) ** 2).sum(-1))
    empty = free.sum(-1) == 0
    done = state.done | (do & (empty | (x_free_norm < 1e-3)))

    ex = torch.where(do[:, None], _mv(prob.E, free_f * state.x), state.ex)
    if ginv is not None:
        ginv = ginv.where(do, state.ginv) if _is_struct_ginv(ginv) \
            else torch.where(do[:, None, None], ginv, state.ginv)
    elif cfg.linsolve == "woodbury":
        if _is_struct_ginv(state.ginv):
            raise NotImplementedError(
                "early fixing with a Schur-structured G^-1 needs a "
                "caller-refactorized inverse: mirror the decision on the "
                "host (fix_decision_host), rebuild with ops.struct_ginv."
                "build_struct_ginv(free=...), and pass it as "
                "apply_fix(..., ginv=new_ginv)")
        factor = woodbury.factorize(_E32(prob.E), free, _wb_ratio(cfg))
        ginv = torch.where(do[:, None, None], _ginv_store(factor.ginv, cfg),
                           state.ginv)
    else:
        ginv = state.ginv
    ns = state.replace(
        free=free, fixed_val=fixed_val, f_eff=f_eff,
        sum_fix_obj=sum_fix_obj, done=done,
        x_prev=torch.where(do[:, None], state.x, state.x_prev),
        ex=ex, ginv=ginv)
    return refresh_et_next(ns, prob, cfg)


def fix_decision_host(state: LpState, vec, cfg: SolverConfig,
                      min_fix: Optional[int] = None):
    """Host mirror of ``apply_fix``'s decision: numpy ``(do, new_free)``,
    the instances that fix this round and the post-fix free mask, which
    a host refactorization (``build_struct_ginv(free=...)``) needs before
    ``apply_fix(..., ginv=...)``."""
    if min_fix is None:
        min_fix = cfg.min_fix
    as_np = lambda t: t.detach().cpu().numpy() \
        if isinstance(t, torch.Tensor) else np.asarray(t)
    free = as_np(state.free)
    done = as_np(state.done)
    want = free & (as_np(vec) >= 0.0) & ~done[:, None]
    do = want.sum(-1) > min_fix
    return do, free & ~(want & do[:, None])


def rule_fix_vec(state: LpState, cfg: SolverConfig) -> torch.Tensor:
    """Decision vector from the consistency counters (ADMM_lp_iters_fix):
    variables whose iterate moved at most ``fix_threshold`` for
    ``consistency`` consecutive iterations are fixed to round(x)
    (:1861-1870, :2012); +1/0/-1 as ``apply_fix`` takes it."""
    flag = state.free & (state.fix_count >= cfg.consistency)
    val = (state.x >= 0.5).to(state.x.dtype)
    return torch.where(flag, val, torch.full_like(val, -1.0))


def solution(state: LpState) -> torch.Tensor:
    """Full-width binary solution: free vars rounded at 0.5, fixed vars
    keep their value (reference get_x_sol, :1648-1665)."""
    rounded = (state.x >= 0.5).to(state.x.dtype)
    return torch.where(state.free, rounded, state.fixed_val)


def objective(state: LpState) -> torch.Tensor:
    """sum_fix_obj + cur_obj (cal_obj, :1630-1642)."""
    any_free = state.free.any(-1)
    return torch.where(any_free, state.sum_fix_obj + state.cur_obj,
                       state.sum_fix_obj)


def infeasible_rows(state: LpState, prob: LpProblem) -> torch.Tensor:
    """Rows violated by the restored full solution (:1593-1612)."""
    ex = _mv(prob.E, solution(state))
    return ((ex > prob.f) & prob.row_mask).sum(-1)


def objective_best(state: LpState) -> torch.Tensor:
    """Objective of the best incumbent rounding (the last rounding while
    no feasible incumbent has been recorded)."""
    any_free = state.free.any(-1)
    best = torch.where(state.best_bin_obj >= _BEST_INIT, state.cur_obj,
                       state.best_bin_obj)
    return torch.where(any_free, state.sum_fix_obj + best,
                       state.sum_fix_obj)


def solution_best(state: LpState) -> torch.Tensor:
    """Full-width rounding of the best incumbent iterate."""
    src = torch.where((state.best_bin_obj >= _BEST_INIT)[:, None],
                      state.x, state.best_sol)
    rounded = (src >= 0.5).to(state.x.dtype)
    return torch.where(state.free, rounded, state.fixed_val)


def compact(state: LpState, prob: LpProblem, cfg: SolverConfig,
            n_new: int, m_new: Optional[int] = None
            ) -> Tuple[LpState, LpProblem, torch.Tensor]:
    """Physically shrink the problem to ``n_new`` columns (free ones
    first, in order, then fixed ones as padding) and optionally to the
    ``m_new`` rows that still have free support.  Returns
    ``(state', prob', orig_idx)``, ``orig_idx`` (B, n_new) mapping the
    compacted columns to original ones (``scatter_solution``).  Dense E
    only: sparse problems iterate mask-based."""
    if sparse_ops.is_sparse(prob.E):
        raise ValueError("compact requires a dense E (column gather); "
                         "sparse problems iterate mask-based")
    B = state.x.shape[0]
    order = torch.argsort((~state.free).to(torch.uint8), dim=-1,
                          stable=True)
    idx = order[:, :n_new]

    def take(a):
        return torch.gather(a, 1, idx)

    E2 = torch.gather(prob.E, 2, idx[:, None, :].expand(B, prob.m, n_new))
    free2 = take(state.free)
    # fixed (padding) columns are zeroed: their contribution is in f_eff
    E2 = E2 * free2[:, None, :].to(E2.dtype)
    f2, rmask2, y3_2, z4_2 = state.f_eff, prob.row_mask, state.y3, state.z4
    if m_new is not None and m_new < prob.m:
        support = ((E2.abs() > 0) & free2[:, None, :]).any(-1) \
            & prob.row_mask
        rorder = torch.argsort((~support).to(torch.uint8), dim=-1,
                               stable=True)
        ridx = rorder[:, :m_new]

        def rtake(a):
            return torch.gather(a, 1, ridx)

        E2 = torch.gather(E2, 1, ridx[:, :, None].expand(B, m_new, n_new))
        f2, rmask2 = rtake(f2), rtake(support)
        y3_2, z4_2 = rtake(y3_2), rtake(z4_2)
    prob2 = LpProblem(b=take(prob.b), E=E2, f=f2, row_mask=rmask2,
                      var_mask=free2)
    ginv2 = state.ginv
    if cfg.linsolve == "woodbury":
        ginv2 = _ginv_store(woodbury.factorize(_E32(E2), free2,
                                               _wb_ratio(cfg)).ginv, cfg)
    x2 = take(state.x)
    state2 = state.replace(
        x=x2, y1=take(state.y1), y2=take(state.y2), y3=y3_2, z4=z4_2,
        f_eff=f2, z1=take(state.z1), z2=take(state.z2),
        free=free2, fixed_val=take(state.fixed_val),
        best_sol=take(state.best_sol), x_prev=take(state.x_prev),
        fix_count=take(state.fix_count),
        ex=_mv(E2, free2.to(x2.dtype) * x2), ginv=ginv2,
        et_next=torch.zeros_like(x2))
    return refresh_et_next(state2, prob2, cfg), prob2, idx


def scatter_solution(state_c: LpState, idx: torch.Tensor,
                     fixed_val_full: torch.Tensor,
                     free_full: torch.Tensor) -> torch.Tensor:
    """Reassemble the full-width binary solution after compaction from
    the full-width fixing snapshot taken at compaction time."""
    base = torch.where(free_full, torch.zeros_like(fixed_val_full),
                       fixed_val_full)
    return base.scatter(1, idx, solution(state_c))


def select_solution(prob: LpProblem, sol_last: torch.Tensor,
                    sol_best: torch.Tensor, repair_rounds: int = 0,
                    swap_rounds: int = 0, drop_rounds: int = 0):
    """Per instance, the better of the final rounding and the best
    feasible incumbent rounding (both full width): the incumbent wins
    when it is feasible on the original problem and improves the
    objective or the final rounding is infeasible.  Optionally polished
    by eviction (``drop_rounds``), greedy refill (``repair_rounds``) and
    1-for-1 swaps (``swap_rounds``), on dense E only.  Returns
    (sol, obj, infeasible_rows).  The tracer's span ``lp.select``.
    """
    with profiling.span("lp.select"):
        sols = torch.stack([sol_last, sol_best], dim=1)      # (B, 2, n)
        ex = _mv_many(prob.E, sols)                           # (B, 2, m)
        viol = (ex > prob.f[:, None]) & prob.row_mask[:, None]
        infeas = viol.sum(-1)                                 # (B, 2)
        obj = (prob.b[:, None, :] * sols).sum(-1)             # (B, 2)
        use_best = (infeas[:, 1] == 0) \
            & ((obj[:, 1] <= obj[:, 0]) | (infeas[:, 0] > 0))
        k = use_best.long()
        sol = torch.gather(sols, 1, k[:, None, None].expand(
            -1, 1, sols.shape[-1]))[:, 0]
        obj_sel = torch.gather(obj, 1, k[:, None])[:, 0]
        inf_sel = torch.gather(infeas, 1, k[:, None])[:, 0]
        if repair_rounds or swap_rounds or drop_rounds:
            if sparse_ops.is_sparse(prob.E):
                raise ValueError(
                    "greedy/swap repair needs a dense E (per-column slack "
                    "comparisons); call select_solution without repair on "
                    "sparse problems")
            from ..ops.repair import (drop_to_feasible, greedy_repair,
                                      swap_repair)
            rprob = prob.replace(E=prob.E.float())
            if drop_rounds:
                sol = drop_to_feasible(rprob, sol, rounds=drop_rounds)
            if repair_rounds:
                sol = greedy_repair(rprob, sol, rounds=repair_rounds)
            if swap_rounds:
                sol = swap_repair(rprob, sol, rounds=swap_rounds)
            obj_sel = (prob.b * sol).sum(-1)
            exr = _mv(rprob.E, sol)
            inf_sel = ((exr > prob.f) & prob.row_mask).sum(-1)
        return sol, obj_sel, inf_sel
