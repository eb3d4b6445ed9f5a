"""Learned early fixing (the port of the JAX package's ``train/l2f.py``).

``l2f_solve`` is the mask-based loop of the JAX package's
``l2f_solve`` (its l2f.py:165-243), as the trainer's in-loop
evaluation runs it: solver windows of ``ws`` recorded iterations, the
policy's score of every variable's window, a fix wherever a score
clears its margin (optionally with the value taken from ``fix_values``),
until ``max_iter`` or every instance is done.  It dispatches on the
problem type as the JAX package's ``_core_of`` does: ``LpProblem`` ->
``core.lp``, ``GeneralProblem``/``GridGeneralProblem`` ->
``core.general``, the grid ``core.qp.QpProblem`` -> ``core.qp``, where
the boundary gate (``qp_boundary_margins``, every window) and the
trajectory-extremity fixes (``traj_fix_*``) also act.

The segmentation half: ``l2f_solve_seg`` is the whole solve that
``run_seg -phase test`` runs, from the first window to the selected
labelling, traced when given ``timings``.  Inside it
``l2f_solve_compact_qp`` runs the first window on the grid, gathers the
free pixels into a flat ``core.general`` problem (``core.qp.compact``),
shrinks it again as more pixels fix (``core.general.compact_sparse``)
and scatters the result back into a grid ``QpState``;
``qp_refine_boundary`` re-frees fixed pixels on the label boundary for
a few more iterations; ``l2f_metrics_qp`` reports the energy gap and
pixel agreement.  As in the JAX package, the compact
path applies the boundary gate to its grid window only and ignores the
``traj_fix_*`` flags (it warns when given them).

``l2f_solve_compact`` runs in two phases with one host read between
them:

1. policy phase: up to ``policy_windows`` windows of [``ws`` solver
   iterations recorded -> policy scores of every variable's trajectory
   -> damage-gated confidence margins, the optional ensemble veto of a
   second policy and trajectory gates, consecutive-window streaks ->
   ``apply_fix``];
2. tail phase: the free columns and the rows they still touch are
   gathered into power-of-two buckets (``core.lp.compact``), rho is
   optionally fast-forwarded, the residual runs to convergence (n-side
   factor when compaction leaves n <= m), and the result is scattered
   back and selected/repaired on the original problem.

Each phase routes its solver windows on the shape alone, before any
launch: through K1 (``ops.fused_lp.lp_window_fused``) where one
instance fits K1's thread block (``ops.fused_lp.fits``) and the
x-update is Woodbury's, else through ``core.lp.solve_window``, as the
JAX package's unfused branch does.  Every scoring of a CUDA tensor goes
through K2 (``models.fused_policy.policy_scores_fused``); on CPU
tensors ``l2f_solve_compact`` scores with K2's plain version and
``l2f_solve`` and the segmentation paths with the module's own forward,
as the JAX package's ``l2f_solve`` applies the model (its seg paths
score with the module in XLA too; the port's K2 takes their sliding
windows, stride 1).  The JAX package's scorer
retry/fallback chain and fused-tail -> XLA fallback answered an
unreliable remote TPU compiler and are not ported: nothing here catches
a launch error and retries.
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch
from torch import nn

from ..config import PolicyConfig, SolverConfig
from ..core import general, lp, qp
from ..core.problem import LpProblem
from ..models.fused_policy import pack_policy_weights, policy_operand, \
    policy_scores_fused
from ..ops import woodbury
from ..ops.fused_lp import e_route, fits, lp_window_fused, \
    solve_fused_from, window_operand
from ..utils import profiling

#: ``l2f_solve_compact``'s ``timings`` keys of the tracer's spans
#: (``utils.profiling``): seconds per batch, each span summed over the
#: solve
SPAN_KEYS = {"l2f.policy": "policy_s", "l2f.tail": "tail_s",
             "l2f.compact": "compact_s", "lp.window": "lp_window_s",
             "woodbury.factor": "factor_s", "lp.select": "select_s"}


def traj_to_tokens(rows: torch.Tensor, pcfg: PolicyConfig) -> torch.Tensor:
    """(R, ws) trajectory rows -> (R, node_size, chunk_dim) tokens:
    ``chunk`` is a contiguous reshape (ws = node_size * chunk_dim),
    ``sliding`` takes node_size overlapping windows row[j : j+chunk]."""
    R, ws = rows.shape
    node, chunk = pcfg.node_size, pcfg.chunk_dim
    if pcfg.window_mode == "chunk":
        if ws != node * chunk:
            raise ValueError(f"ws={ws} != node_size*chunk_dim")
        return rows.reshape(R, node, chunk)
    if pcfg.window_mode == "sliding":
        if node + chunk - 1 > ws:
            raise ValueError(f"ws={ws} too short for sliding windows")
        return torch.stack([rows[:, j:j + chunk] for j in range(node)], 1)
    raise ValueError(f"unknown window_mode {pcfg.window_mode!r}")


@torch.no_grad()
def policy_scores(model: nn.Module, rows: torch.Tensor, pcfg: PolicyConfig,
                  row_chunk: int = 8192) -> torch.Tensor:
    """Sigmoids (R,) of the policy module itself (the reference forward
    that K2 is held against), in evaluation mode."""
    if model.training:
        raise ValueError("policy_scores needs the module in evaluation "
                         "mode (training-mode BatchNorm uses batch "
                         "statistics)")
    x = traj_to_tokens(rows, pcfg)
    return torch.cat([model(x[i:i + row_chunk])[1][:, 0]
                      for i in range(0, x.shape[0], row_chunk)])


def scores_to_vec(sig: torch.Tensor, confidence: float) -> torch.Tensor:
    """``deter_fix_2``: sigma > C -> 1; sigma < 1-C -> 0; else -1
    (reference trainer.py:101-135)."""
    one, zero, none = (torch.full_like(sig, v) for v in (1.0, 0.0, -1.0))
    return torch.where(sig > confidence, one,
                       torch.where(sig < 1.0 - confidence, zero, none))


def fix_margins(b: torch.Tensor, var_mask: torch.Tensor,
                pcfg: PolicyConfig) -> torch.Tensor:
    """Per-variable confidence margins (B, n): ``1 - C`` shrinking
    linearly with the variable's within-instance |b| rank above
    ``damage_rank_floor`` (``PolicyConfig.damage_gate``)."""
    base = 1.0 - pcfg.fix_confidence
    if pcfg.damage_gate <= 0:
        return torch.full(b.shape, base, dtype=torch.float32,
                          device=b.device)
    absb = b.abs()
    order2 = torch.argsort(torch.argsort(absb, dim=-1, stable=True),
                           dim=-1, stable=True)
    cnt = torch.clamp_min(var_mask.sum(-1, keepdim=True), 2)
    rank = torch.clamp(order2.float() / (cnt.float() - 1.0), 0.0, 1.0)
    q = pcfg.damage_rank_floor
    if q > 0:
        rank = torch.clamp((rank - q) / max(1.0 - q, 1e-6), 0.0, 1.0)
    return base * (1.0 - pcfg.damage_gate * rank)


def _route(m: int, n: int, cfg: SolverConfig) -> str:
    """The solver route for (m, n) instances under ``cfg``: ``"k1"``
    where K1 holds one instance and the x-update is Woodbury's (the only
    one K1 runs), else ``"windows"`` (``core.lp`` windows).  The
    JAX package fuses only when ``n * ws <= 65536`` (its l2f.py:795-796);
    that rule is the TPU's VMEM budget, so the port routes on K1's own
    shared-memory need on this card instead."""
    if cfg.linsolve != "woodbury":
        return "windows"
    return "k1" if fits(m, n) else "windows"


def _policy_window(state, prob, packed, cfg, pcfg, ws, route, margins,
                   streak1, streak0, E_op=None, policy_op=None, veto=None):
    """One recorded window, its policy scores, the optional ensemble
    veto and trajectory gates, the streak update and the fix.
    ``E_op``: E as K1 reads it (``window_operand``) on the K1 route;
    ``policy_op``: the weights as K2 reads them (``policy_operand``);
    ``veto``: ``(packed, operand)`` of a second policy that must not
    contradict a fix (``pcfg.ensemble_veto``).  Returns the state, the
    fix vector (B, n) in {-1, 0, 1} and the streaks."""
    if route == "k1":
        state, traj = lp_window_fused(state, prob, cfg, ws, record=True,
                                      E_op=E_op)
    else:
        state, traj = lp.solve_window(state, prob, cfg, ws, record=True)
    rows = traj.reshape(-1, ws)
    sig = policy_scores_fused(packed, rows, pcfg,
                              policy_op).reshape(state.x.shape)
    conf1 = sig > 1.0 - margins
    conf0 = sig < margins
    if veto is not None:
        # ensemble veto: an independently trained net must not
        # contradict the fix (its l2f.py:604-610)
        sig2 = policy_scores_fused(veto[0], rows, pcfg,
                                   veto[1]).reshape(state.x.shape)
        v = pcfg.ensemble_veto
        conf1 = conf1 & (sig2 > 1.0 - v)
        conf0 = conf0 & (sig2 < v)
    if pcfg.fix_agree_gate:
        # a fix must agree with the window's last iterate, and with
        # gate 2 the window must be stable (its l2f.py:611-621)
        end = traj[:, :, -1]
        conf1 = conf1 & (end > 0.5)
        conf0 = conf0 & (end < 0.5)
        if pcfg.fix_agree_gate >= 2:
            stable = (traj.amax(-1) - traj.amin(-1)) < 0.25
            conf1 = conf1 & stable
            conf0 = conf0 & stable
    streak1 = torch.where(conf1, streak1 + 1, torch.zeros_like(streak1))
    streak0 = torch.where(conf0, streak0 + 1, torch.zeros_like(streak0))
    k = pcfg.fix_windows
    vec = torch.where(streak1 >= k, 1.0,
                      torch.where(streak0 >= k, 0.0, -1.0)).float()
    return lp.apply_fix(state, prob, vec, cfg), vec, streak1, streak0


def _policy_phase(state, prob, packed, cfg, pcfg, ws, policy_windows,
                  max_iter, route, policy_op=None, veto=None):
    """Phase 1: recorded windows, policy scoring and streak fixing
    (``policy_op``: ``policy_operand(packed)``, made once per solve;
    ``veto``: the second policy's packed weights and operand).
    Returns the state, the largest free-column / supported-row counts
    over the batch (host integers, the reads ``l2f.bucket_n`` and
    ``l2f.bucket_m``) and, on the K1 route, E's route into K1 (else
    None).  Each window follows a host check of ``done``
    (``l2f.policy_done``)."""
    margins = fix_margins(prob.b, prob.var_mask, pcfg)
    E_op = window_operand(prob.E, cfg) if route == "k1" else None
    streak1 = torch.zeros(state.x.shape, dtype=torch.int32,
                          device=state.x.device)
    streak0 = torch.zeros_like(streak1)
    w = 0
    while (w < policy_windows and state.it < max_iter
           and not profiling.read("l2f.policy_done", bool,
                                  state.done.all())):
        state, _, streak1, streak0 = _policy_window(
            state, prob, packed, cfg, pcfg, ws, route, margins, streak1,
            streak0, E_op, policy_op, veto)
        w += 1
    support = ((prob.E.abs() > 0) & state.free[:, None, :]).any(-1) \
        & prob.row_mask
    return (state,
            profiling.read("l2f.bucket_n", int, state.free.sum(-1).max()),
            profiling.read("l2f.bucket_m", int, support.sum(-1).max()),
            None if E_op is None else e_route(E_op))


def _bucket(count: int, lo: int, hi: int) -> int:
    b = lo
    while b < count:
        b *= 2
    return min(b, hi)


def _finalize(state, idx_map, fixed_full, free_full, orig_prob,
              repair_rounds=0, swap_rounds=0):
    """Scatter the last rounding and the best feasible incumbent back to
    original indices and select per instance (core.lp.select_solution),
    optionally with greedy refill and swap repair."""
    sol_last = lp.scatter_solution(state, idx_map, fixed_full, free_full)
    state_b = state.replace(x=lp.solution_best(state))
    sol_best = lp.scatter_solution(state_b, idx_map, fixed_full, free_full)
    sol, obj, infeas = lp.select_solution(orig_prob, sol_last, sol_best,
                                          repair_rounds=repair_rounds,
                                          swap_rounds=swap_rounds)
    n_fixed = (~free_full & orig_prob.var_mask).sum(-1)
    return sol, obj, infeas, n_fixed


def _tail_phase(state, orig_prob, cfg, n_new, m_new, rho_boost, max_iter,
                ws, repair_rounds=0, swap_rounds=0,
                cfg_changed=False):
    """Phase 2: compaction, rho fast-forward, residual solve to
    convergence (K1, n-side factor when the bucket has n <= m, or
    ``core.lp`` windows of ``ws`` where K1 cannot hold the bucket),
    scatter + selection.  Compaction up to the residual solve (the rho
    fast-forward, K1's operand and the n-side factor too) is the span
    ``l2f.compact``.  Returns the results, the route and, on the K1
    route, E's route into K1 (else None)."""
    prob = orig_prob
    fixed_full, free_full = state.fixed_val, state.free
    B, n_full = state.x.shape
    with profiling.span("l2f.compact"):
        idx_map = torch.arange(n_full, device=state.x.device)[None].expand(
            B, n_full)
        if n_new < n_full or m_new < prob.m:
            state, prob, idx_map = lp.compact(state, prob, cfg, n_new,
                                              m_new=m_new)
        elif cfg_changed and not rho_boost:
            state = lp.refresh_et_next(state, prob, cfg)
        if rho_boost:
            # optional acceleration: the residual binarizes once rho is
            # large, so fast-forward the schedule (the carried E^T w
            # product depends on rho and is refreshed)
            state = lp.refresh_et_next(
                state.replace(it=state.it + rho_boost), prob, cfg)
        route = _route(prob.m, prob.n, cfg)
        k1_route = nfactor = None
        if route == "k1":
            E_op = window_operand(prob.E, cfg)
            k1_route = e_route(E_op)
            if prob.n <= prob.m:
                nf = woodbury.factorize_nside(prob.E, state.free,
                                             lp._wb_ratio(cfg))
                nfactor = (nf.hinv, nf.ete)
    if route == "k1":
        state = solve_fused_from(state, prob, cfg, max_iters=max_iter,
                                 window=max(ws, 1000), nfactor=nfactor,
                                 E_op=E_op)
    else:
        # the JAX package's _residual_phase_xla (its l2f.py:640-650)
        while state.it < max_iter and not profiling.read(
                "l2f.tail_done", bool, state.done.all()):
            state, _ = lp.solve_window(state, prob, cfg, ws, record=False)
    sol, obj, infeas, n_fixed = _finalize(state, idx_map, fixed_full,
                                          free_full, orig_prob,
                                          repair_rounds, swap_rounds)
    return (state, sol, obj, lp.objective(state), infeas, n_fixed, route,
            k1_route)


def l2f_solve_compact(prob: LpProblem, model: nn.Module, cfg: SolverConfig,
                      pcfg: PolicyConfig, ws: int = 100,
                      max_iter: Optional[int] = None,
                      policy_windows: int = 5, min_bucket: int = 128,
                      m_min_bucket: int = 64,
                      rho_boost_iters: int = 0, repair_rounds: int = 0,
                      swap_rounds: int = 0,
                      timings: Optional[dict] = None,
                      tail_rho_step: Optional[int] = None,
                      model2: Optional[nn.Module] = None):
    """LP l2f solve with bucketed physical compaction.

    ``model`` is a ``models.policy`` encoder (``utils.checkpoint.
    load_policy``); its weights are packed, and laid out as K2 reads
    them, once per solve.  ``model2``: an optional second policy whose
    scores veto contradicted fixes (``pcfg.ensemble_veto``; the JAX
    package's ``variables2``), scored by K2 on its own operand.
    ``tail_rho_step`` sets rho_change_step for the residual phase only.

    ``timings`` (a dict) turns the tracer on for the solve
    (``utils.profiling``; on the card CUDA events, read after one wait
    for the solve's last event) and receives, summed over the solve,
    the seconds of its spans (``SPAN_KEYS``: the policy phase
    ``policy_s``, the tail ``tail_s``, within it compaction
    ``compact_s`` and selection ``select_s``; the ``core.lp`` windows
    ``lp_window_s``, the Woodbury inverses ``factor_s``), its host
    reads (``host_reads``, per site ``host_read_sites``, the host's time
    in them ``host_read_wait_s``), the tail's buckets, whether its
    bucket has n <= m (K1's n-side mode on the K1 route), each phase's
    route, ``policy_route`` and ``tail_route``, ``"k1"`` or
    ``"windows"``, and on the K1 route E's route into K1,
    ``policy_e_route`` and ``tail_e_route`` (``ops.fused_lp.E_ROUTES``;
    None on the windows route), and K1's clusters: per launch (live, C,
    the share of the card's SMs that live * C blocks take, in %; None
    off a card) in ``k1_splits`` (``ops.fused_lp.split_plan``,
    ``sm_pct``), the launches with C > 1 in ``k1_split_launches`` and,
    on a card, the mean share over the launches, ``k1_sm_pct``.  Without
    it the solve creates no event and makes only the host reads it
    needs.  Returns ``(final_state,
    out)`` with the full-width binary solution, objective, iterations,
    infeasible rows and fixing information."""
    if max_iter is None:
        max_iter = cfg.max_iters
    tracer = None if timings is None else profiling.PhaseTimer(prob.device)
    with profiling.tracing(tracer):
        with profiling.span("l2f.policy"):
            state = lp.init_state(prob, cfg)
            packed = pack_policy_weights(model)
            policy_op = policy_operand(packed)
            veto = None
            if model2 is not None:
                packed2 = pack_policy_weights(model2)
                veto = (packed2, policy_operand(packed2))
            policy_route = _route(prob.m, prob.n, cfg)
            state, mf, mr, policy_e_route = _policy_phase(
                state, prob, packed, cfg, pcfg, ws, policy_windows,
                max_iter, policy_route, policy_op, veto)

        with profiling.span("l2f.tail"):
            fixed_full, free_full = state.fixed_val, state.free
            n_b = _bucket(mf, min_bucket, prob.n)
            m_b = _bucket(mr, m_min_bucket, prob.m)
            cfg_tail = cfg if tail_rho_step is None \
                else cfg.replace(rho_change_step=tail_rho_step)
            state, sol_full, obj, obj_last, infeas, n_fixed, tail_route, \
                tail_e_route = \
                _tail_phase(state, prob, cfg_tail, n_b, m_b,
                            rho_boost_iters, max_iter, ws, repair_rounds,
                            swap_rounds, cfg_changed=cfg_tail is not cfg)
    if timings is not None:
        profiling.reduce_timings(tracer, SPAN_KEYS, timings)
        timings.setdefault("k1_splits", [])
        timings.setdefault("k1_split_launches", 0)
        timings["buckets"] = (n_b, m_b)
        timings["nside"] = n_b <= m_b
        timings["policy_route"] = policy_route
        timings["tail_route"] = tail_route
        timings["policy_e_route"] = policy_e_route
        timings["tail_e_route"] = tail_e_route
    return state, {
        "solution": sol_full,
        "obj": obj,
        "obj_last": obj_last,
        "iterations": state.it,
        "infeasible": infeas,
        "n_fixed": n_fixed,
        "fixed_mask": ~free_full & prob.var_mask,
        "fixed_val": fixed_full,
    }


def l2f_metrics(state: lp.LpState, prob: LpProblem,
                oracle_obj: torch.Tensor,
                labels: Optional[torch.Tensor] = None) -> dict:
    """Objective gap against a plain oracle, infeasible rows and fix
    counts of a (mask-based, uncompacted) l2f state, selection-reported
    as the oracle is; with the oracle's ``labels`` also the fix errors
    and the solution's disagreements with them (reference
    trainer.py:431-453, 559-560)."""
    sol, obj, infeas = lp.select_solution(prob, lp.solution(state),
                                          lp.solution_best(state))
    fixed = (~state.free) & prob.var_mask
    out = {
        "obj": obj,
        "obj_gap": (obj - oracle_obj) / oracle_obj.abs(),
        "iterations": state.it,
        "infeasible": infeas,
        "n_fixed": fixed.sum(-1),
    }
    if labels is not None:
        vm = prob.var_mask
        out["fix_errors"] = (fixed & (state.fixed_val != labels)).sum(-1)
        out["sol_1_to_0"] = ((labels == 1) & (sol == 0) & vm).sum(-1)
        out["sol_0_to_1"] = ((labels == 0) & (sol == 1) & vm).sum(-1)
        out["sol_agree"] = ((sol == labels) & vm).sum(-1)
    return out


def _scorer(model: nn.Module, pcfg: PolicyConfig, device: torch.device,
            row_chunk: int):
    """The scorer of ``l2f_solve``: K2 on the card (weights packed and
    laid out once per solve), the module's forward on the CPU."""
    if device.type == "cuda":
        packed = pack_policy_weights(model)
        op = policy_operand(packed)
        return lambda rows: policy_scores_fused(packed, rows, pcfg, op)
    if device.type == "cpu":
        return lambda rows: policy_scores(model, rows, pcfg, row_chunk)
    raise ValueError(f"no policy scorer for device {device}")


def qp_boundary_margins(x: torch.Tensor, mask: torch.Tensor,
                        margins: torch.Tensor,
                        pcfg: PolicyConfig) -> torch.Tensor:
    """Boundary-distance damage gate of the seg QP: the confidence margin
    of every pixel within ``pcfg.boundary_band`` 8-neighbour hops of a
    label change of the rounding of ``x`` is scaled by ``1 -
    pcfg.boundary_gate`` (band 1 = the boundary pixels only; band <= 0
    disables the gate).  Recomputed every policy window from the live
    iterate, so the protected band follows the moving boundary."""
    if pcfg.boundary_band <= 0:
        return margins
    maskb = mask.to(torch.bool)
    sol = (x >= 0.5).to(x.dtype) * maskb.to(x.dtype)
    # restricted to in-mask pixels before dilating: an out-of-mask pixel
    # (implicit label 0) would otherwise flag against an in-mask label-1
    # neighbour and the dilation would carry that back inside
    band = _label_band(sol, maskb, pcfg.boundary_band, mask_first=True)
    return torch.where(band, margins * (1.0 - pcfg.boundary_gate), margins)


def _label_band(sol: torch.Tensor, maskb: torch.Tensor, band: int,
                mask_first: bool) -> torch.Tensor:
    """Pixels whose 8-neighbourhood holds an in-mask pixel of another
    label, dilated by ``band - 1`` hops (each hop kept inside the mask);
    ``mask_first`` keeps the undilated set inside the mask too."""
    from ..ops.stencil import OFFSETS, shift

    m_f = maskb.to(sol.dtype)
    differs = torch.zeros(sol.shape, dtype=torch.bool, device=sol.device)
    for dr, dc in OFFSETS:
        inb = shift(m_f, dr, dc) > 0.5
        differs = differs | (inb & (shift(sol, dr, dc) != sol))
    if mask_first:
        differs = differs & maskb
    for _ in range(band - 1):
        wide = differs
        d_f = differs.to(sol.dtype)
        for dr, dc in OFFSETS:
            wide = wide | (shift(d_f, dr, dc) > 0.5)
        differs = wide & maskb
    return differs


def _core_of(problem):
    if isinstance(problem, LpProblem):
        return lp
    if isinstance(problem, (general.GeneralProblem,
                            general.GridGeneralProblem)):
        return general
    if isinstance(problem, qp.QpProblem):
        return qp
    raise TypeError(f"l2f takes an LpProblem, a GeneralProblem, a "
                    f"GridGeneralProblem or a core.qp.QpProblem, not "
                    f"{type(problem).__name__}")


def _grid_margins(prob: qp.QpProblem, pcfg: PolicyConfig) -> torch.Tensor:
    """(B, H, W) confidence margins of a grid problem: ``fix_margins`` on
    the flattened grid (the |b|-rank gate) or the constant ``1 - C``."""
    B = prob.batch
    return fix_margins(prob.b.reshape(B, -1), prob.mask.reshape(B, -1),
                       pcfg).reshape(prob.b.shape)


def _fix_vec(sig: torch.Tensor, margins: torch.Tensor) -> torch.Tensor:
    """1 where sigma > 1 - margin, 0 where sigma < margin, else -1."""
    return torch.where(sig > 1.0 - margins, 1.0,
                       torch.where(sig < margins, 0.0, -1.0)).to(sig.dtype)


def l2f_solve(prob, model: nn.Module, cfg: SolverConfig,
              pcfg: PolicyConfig, ws: int = 100,
              max_iter: Optional[int] = None, row_chunk: int = 8192,
              fix_values: Optional[torch.Tensor] = None):
    """Windowed solve with the policy fixing variables between windows
    (mask-based, no compaction; the reference's ``_valid_2`` alternation,
    LP trainer.py:516-535, and ``_my_valid``, Seg trainer.py:707-737).
    Each round: ``ws`` recorded iterations of the problem's core, every
    variable's window scored, a fix to 1 where the score exceeds ``1 -
    margin`` and to 0 where it is below ``margin``, the core's
    ``apply_fix``; until ``max_iter`` iterations or every instance is
    done.  Margins: ``fix_margins`` (the |b|-rank gate) on LP and grid
    problems, the constant ``1 - C`` on general ones; on grid problems
    also the boundary gate every window and the trajectory-extremity
    fixes (``pcfg.traj_fix_thr``, ``traj_fix_only``,
    ``traj_fix_windows``).

    ``fix_values`` (same shape as the solution): the label-floor
    experiment -- the policy keeps its selection of decided variables,
    the value comes from ``fix_values``.  Returns the core's state."""
    core = _core_of(prob)
    if max_iter is None:
        max_iter = cfg.max_iters
    grid = core is qp
    score = _scorer(model, pcfg, prob.device, row_chunk)
    if isinstance(prob, LpProblem):
        margins = fix_margins(prob.b, prob.var_mask, pcfg)
    elif grid:
        margins = _grid_margins(prob, pcfg)
    else:
        margins = torch.full(prob.b.shape, 1.0 - pcfg.fix_confidence,
                             dtype=torch.float32, device=prob.device)
    state = core.init_state(prob, cfg)
    while state.it < max_iter and not bool(state.done.all()):
        state, traj = core.solve_window(state, prob, cfg, ws, record=True)
        sig = score(traj.reshape(-1, ws)).reshape(state.x.shape)
        m = margins
        if grid and pcfg.boundary_gate > 0:
            m = qp_boundary_margins(state.x, prob.mask, m, pcfg)
        if fix_values is not None:
            decided = (sig > 1.0 - m) | (sig < m)
            vec = torch.where(decided, fix_values.to(sig.dtype),
                              torch.full_like(sig, -1.0))
        else:
            vec = _fix_vec(sig, m)
        if grid and pcfg.traj_fix_thr > 0:
            # trajectory-extremity fixing: on the unconstrained grid QP a
            # pixel far from 0.5 fixes to round(x); never on LPs, where it
            # breaks feasibility (the JAX package's l2f.py:218-232)
            ext = ((state.x - 0.5).abs() > pcfg.traj_fix_thr) & prob.mask
            if pcfg.traj_fix_windows > 0 and \
                    state.it > pcfg.traj_fix_windows * ws:
                ext = torch.zeros_like(ext)
            xval = (state.x > 0.5).to(state.x.dtype)
            if pcfg.traj_fix_only:
                vec = torch.where(ext, xval, torch.full_like(xval, -1.0))
            else:
                vec = torch.where((vec < 0) & ext, xval, vec)
        state = core.apply_fix(state, prob, vec, cfg)
    return state


def _qp_policy_window(state, prob, score, cfg, pcfg, ws, margins):
    """One [grid solver window -> policy -> fix] round; returns the
    state, the batch's largest free count and whether all are done
    (tensors, read by the caller)."""
    state, traj = qp.solve_window(state, prob, cfg, ws, record=True)
    sig = score(traj.reshape(-1, ws)).reshape(state.x.shape)
    if pcfg.boundary_gate > 0:
        margins = qp_boundary_margins(state.x, prob.mask, margins, pcfg)
    state = qp.apply_fix(state, prob, _fix_vec(sig, margins), cfg)
    return state, state.free.sum((-2, -1)).max(), state.done.all()


def _flat_policy_window(gstate, gprob, score, cfg, ws, margins):
    """The same round on the compacted flat problem (``core.general``)."""
    gstate, traj = general.solve_window(gstate, gprob, cfg, ws, record=True)
    sig = score(traj.reshape(-1, ws)).reshape(gstate.x.shape)
    gstate = general.apply_fix(gstate, gprob, _fix_vec(sig, margins), cfg)
    return gstate, gstate.free.sum(-1).max(), gstate.done.all()


def _persist_fix_snapshot(gstate, idx, free_full, fixed_full):
    """Scatter the flat problem's current fixing state into the
    full-grid snapshot.  Must run before every re-compaction: slots
    fixed inside the flat problem may not be selected into the smaller
    bucket, and the final reassembly would otherwise fall back to the
    stale snapshot and silently zero their fixed values (the bug the
    JAX package's 1e5-px A/B found, its l2f.py:288-293)."""
    B = idx.shape[0]
    shp = free_full.shape
    free2 = free_full.reshape(B, -1).scatter(1, idx, gstate.free)
    fixed2 = fixed_full.reshape(B, -1).scatter(
        1, idx, gstate.fixed_val.to(fixed_full.dtype))
    return free2.reshape(shp), fixed2.reshape(shp)


def _qp_reassemble(gstate, idx, free_full, fixed_full, state0, prob):
    """Scatter the compacted flat state back into a full-grid
    ``QpState`` (the drop-in return value of ``l2f_solve``)."""
    B, H, W = free_full.shape
    n = H * W
    dt = gstate.x.dtype
    zeros = torch.zeros((B, n), dtype=dt, device=idx.device)

    def scat(vec_c, base_flat):
        return base_flat.scatter(1, idx, vec_c.to(base_flat.dtype)
                                 ).reshape(B, H, W)

    free_new = scat(gstate.free, torch.zeros((B, n), dtype=torch.bool,
                                             device=idx.device))
    fixed_new = scat(gstate.fixed_val, fixed_full.reshape(B, n))
    b_eff = prob.b + 2.0 * prob.stencil.a_matvec((~free_new).to(dt)
                                                 * fixed_new)
    return state0.replace(
        x=scat(gstate.x, zeros), y1=scat(gstate.y1, zeros),
        y2=scat(gstate.y2, zeros), z1=scat(gstate.z1, zeros),
        z2=scat(gstate.z2, zeros),
        free=free_new, fixed_val=fixed_new, b_eff=b_eff,
        obj_ring=gstate.obj_ring, obj_count=gstate.obj_count,
        it=gstate.it, done=gstate.done,
        cur_obj=gstate.cur_obj, best_bin_obj=gstate.best_bin_obj,
        best_sol=scat(gstate.best_sol, zeros),
        x_prev=scat(gstate.x_prev, zeros),
        fix_count=scat(gstate.fix_count.to(torch.int32),
                       torch.zeros((B, n), dtype=torch.int32,
                                   device=idx.device)))


#: the policy flags ``l2f_solve_compact_qp`` ignores, as the JAX package's
#: does (they act in ``l2f_solve``'s grid branch only)
_TRAJ_FLAGS = ("traj_fix_thr", "traj_fix_only", "traj_fix_windows")


def l2f_solve_compact_qp(prob: qp.QpProblem, model: nn.Module,
                         cfg: SolverConfig, pcfg: PolicyConfig,
                         ws: int = 10, max_iter: Optional[int] = None,
                         min_bucket: int = 1024, recompact: bool = True,
                         row_chunk: int = 8192):
    """Segmentation l2f solve with physical compaction between windows
    (the reference's Ma/Mb shrink, Seg LPboxADMMsolver.cpp:1048-1057):

    1. window 1 runs on the (B, H, W) grid (scoring, boundary gate,
       fixing);
    2. the free pixels are gathered into a flat power-of-two bucket of
       at least ``min_bucket`` with a 9-nnz-per-row SparseEll A
       (``core.qp.compact``) -- one host read decides the bucket;
    3. later windows run on the compacted problem through
       ``core.general`` (the same update math), re-compacted
       (``compact_sparse``) when the free count halves again, the
       fixing snapshot persisted first;
    4. the final state is scattered back into a full-grid ``QpState``,
       so reporting (``qp.select_solution``, ``l2f_metrics_qp``) is
       unchanged.

    The boundary gate applies to the grid window only (the flat problem
    has no grid to read the boundary from), and the ``traj_fix_*`` flags
    are ignored, as in the JAX package (a warning says so).

    Under an active tracer (``l2f_solve_seg``'s ``timings``): the spans
    ``seg.grid`` (a grid window: iterations, recording, scoring, the
    boundary gate and the fix), ``seg.compact`` (``qp.compact`` and each
    re-compaction) and ``seg.flat`` (a flat window), the counter
    ``seg.bucket`` (the first flat bucket's width) and the read sites
    ``seg.done`` (a window's all-done check), ``seg.bucket_n`` (the
    first bucket's decision) and ``seg.rebucket_n`` (each later one)."""
    given = [f for f in _TRAJ_FLAGS if getattr(pcfg, f)]
    if given:
        warnings.warn(f"l2f_solve_compact_qp ignores {', '.join(given)} "
                      "(trajectory-extremity fixing acts in l2f_solve's "
                      "masked grid path only)", stacklevel=2)
    if max_iter is None:
        max_iter = cfg.max_iters
    H, W = prob.grid
    n = H * W
    windows = max(1, max_iter // ws)
    score = _scorer(model, pcfg, prob.device, row_chunk)
    margins = _grid_margins(prob, pcfg)
    with profiling.span("seg.grid"):
        state = qp.init_state(prob, cfg)
        state, max_free, all_done = _qp_policy_window(
            state, prob, score, cfg, pcfg, ws, margins)
    if windows == 1 or profiling.read("seg.done", bool, all_done):
        return state
    n_b = _bucket(profiling.read("seg.bucket_n", int, max_free), min_bucket,
                  n)
    if n_b >= n:
        # nothing to gain: stay on the grid
        for _ in range(windows - 1):
            with profiling.span("seg.grid"):
                state, _, all_done = _qp_policy_window(
                    state, prob, score, cfg, pcfg, ws, margins)
            if profiling.read("seg.done", bool, all_done):
                break
        return state

    profiling.count("seg.bucket", n_b)
    state0 = state
    free_full, fixed_full = state.free, state.fixed_val
    with profiling.span("seg.compact"):
        gstate, gprob, idx = qp.compact(state, prob, cfg, n_b)
        margins_c = torch.gather(margins.reshape(prob.batch, -1), 1, idx)
    for w in range(1, windows):
        with profiling.span("seg.flat"):
            gstate, max_free, all_done = _flat_policy_window(
                gstate, gprob, score, cfg, ws, margins_c)
        if profiling.read("seg.done", bool, all_done):
            break
        if recompact and w < windows - 1:
            n_b2 = _bucket(profiling.read("seg.rebucket_n", int, max_free),
                           min_bucket, n_b)
            if n_b2 <= n_b // 2:
                with profiling.span("seg.compact"):
                    # persist the fixes made inside the current flat
                    # problem: their slots may be dropped by the smaller
                    # bucket
                    free_full, fixed_full = _persist_fix_snapshot(
                        gstate, idx, free_full, fixed_full)
                    gstate, gprob, idx2 = general.compact_sparse(
                        gstate, gprob, n_b2)
                    idx = torch.gather(idx, 1, idx2)
                    margins_c = torch.gather(margins_c, 1, idx2)
                n_b = n_b2
    return _qp_reassemble(gstate, idx, free_full, fixed_full, state0, prob)


#: ``l2f_solve_seg``'s ``timings`` keys of the tracer's spans, and of its
#: counters
SEG_SPAN_KEYS = {"seg.grid": "grid_s", "seg.compact": "seg_compact_s",
                 "seg.flat": "flat_s", "qp.select": "qp_select_s"}
SEG_COUNTER_KEYS = {"cg.iters": "cg_iters", "seg.bucket": "bucket"}


def l2f_solve_seg(prob: qp.QpProblem, model: nn.Module, cfg: SolverConfig,
                  pcfg: PolicyConfig, ws: int = 10,
                  max_iter: Optional[int] = None, compact: bool = True,
                  min_bucket: int = 1024, recompact: bool = True,
                  refine_iters: int = 0, refine_rounds: int = 1,
                  refine_band: int = 1, repair_sweeps: int = 0,
                  pair_sweeps: int = 0, row_chunk: int = 8192,
                  timings: Optional[dict] = None):
    """The segmentation l2f solve from the first grid window to the
    selected labelling (``run_seg -phase test``): the compacting solve
    (``l2f_solve_compact_qp``; with ``compact=False`` the masked
    ``l2f_solve``), the optional boundary refinement
    (``qp_refine_boundary`` with ``refine_iters`` > 0), then
    ``qp.select_solution`` with ``repair_sweeps`` one-flip and
    ``pair_sweeps`` domino sweeps.

    ``timings`` (a dict) turns the tracer on for the solve
    (``utils.profiling``; on the card CUDA events, one wait at the end)
    and receives the seconds of its spans (``SEG_SPAN_KEYS``: the grid
    windows ``grid_s``, the compactions ``seg_compact_s``, the flat
    windows ``flat_s``, the selection ``qp_select_s``), its counters
    (``SEG_COUNTER_KEYS``: the CG iterations of every x-update
    ``cg_iters``, the first flat bucket's width ``bucket``, 0 where the
    solve stayed on the grid), and its host reads (``host_reads``, per
    site ``host_read_sites``, the host's time in them
    ``host_read_wait_s``).  Without it the solve creates no event and
    makes only the host reads it needs.  Returns ``(state, out)``: the
    final ``QpState`` and the selected labelling (B, H, W) ``solution``,
    its ``energy`` (B,), the fixed valid pixels ``n_fixed`` (B,) and
    the ``iterations``."""
    tracer = None if timings is None else profiling.PhaseTimer(prob.device)
    with profiling.tracing(tracer):
        if compact:
            state = l2f_solve_compact_qp(prob, model, cfg, pcfg, ws=ws,
                                         max_iter=max_iter,
                                         min_bucket=min_bucket,
                                         recompact=recompact,
                                         row_chunk=row_chunk)
        else:
            state = l2f_solve(prob, model, cfg, pcfg, ws=ws,
                              max_iter=max_iter, row_chunk=row_chunk)
        if refine_iters > 0:
            state = qp_refine_boundary(state, prob, cfg, iters=refine_iters,
                                       rounds=refine_rounds,
                                       band=refine_band)
        sol, energy = qp.select_solution(state, prob,
                                         repair_sweeps=repair_sweeps,
                                         pair_sweeps=pair_sweeps)
    if timings is not None:
        profiling.reduce_timings(tracer, SEG_SPAN_KEYS, timings,
                                 counters=SEG_COUNTER_KEYS)
    return state, {"solution": sol, "energy": energy,
                   "n_fixed": ((~state.free) & prob.mask).sum((-2, -1)),
                   "iterations": state.it}


def qp_refine_boundary(state: qp.QpState, prob: qp.QpProblem,
                       cfg: SolverConfig, iters: int = 10, rounds: int = 1,
                       band: int = 1) -> qp.QpState:
    """Post-fix refinement of the seg l2f solve: re-free the fixed
    pixels on the current solution's boundary (an 8-neighbour of another
    label), dilated to ``band`` hops, with fresh duals at their fixed
    value, and run ``iters`` more iterations; ``rounds`` repeats the
    cycle on the moved boundary.  Interior pixels stay fixed, so this
    costs a few masked iterations, not a re-solve."""
    dt = state.x.dtype
    maskb = prob.mask.to(torch.bool)
    for _ in range(rounds):
        sol = qp.solution(state) * prob.mask.to(dt)
        differs = _label_band(sol, maskb, band, mask_first=False)
        refree = (~state.free) & maskb & differs
        free2 = state.free | refree
        fixed2 = torch.where(refree, torch.zeros_like(state.fixed_val),
                             state.fixed_val)
        b_eff2 = prob.b + 2.0 * prob.stencil.a_matvec((~free2).to(dt)
                                                      * fixed2)
        fv = state.fixed_val
        z0 = lambda z: torch.where(refree, torch.zeros_like(z), z)
        state = state.replace(
            x=torch.where(refree, fv, state.x),
            y1=torch.where(refree, fv, state.y1),
            y2=torch.where(refree, fv, state.y2),
            z1=z0(state.z1), z2=z0(state.z2),
            free=free2, fixed_val=fixed2, b_eff=b_eff2,
            done=torch.zeros_like(state.done))
        state, _ = qp.solve_window(state, prob, cfg, iters, record=False)
    return state


def l2f_metrics_qp(state: qp.QpState, prob: qp.QpProblem,
                   oracle_energy: torch.Tensor,
                   labels: Optional[torch.Tensor] = None,
                   repair_sweeps: int = 0, pair_sweeps: int = 0) -> dict:
    """Segmentation evaluation (Seg trainer.py:745-771): energy gap and,
    with the oracle's ``labels`` (B, H, W), per-pixel agreement and fix
    errors.  The energy is selection-reported and polished as the
    oracle's (pass the oracle's ``repair_sweeps``/``pair_sweeps``)."""
    sol, energy = qp.select_solution(state, prob, repair_sweeps=repair_sweeps,
                                     pair_sweeps=pair_sweeps)
    fixed = (~state.free) & prob.mask
    out = {
        "energy": energy,
        "energy_gap": (energy - oracle_energy) / oracle_energy.abs(),
        "iterations": state.it,
        "n_fixed": fixed.sum((-2, -1)),
    }
    if labels is not None:
        msk = prob.mask
        out["px_1_to_0"] = ((labels == 1) & (sol == 0) & msk).sum((-2, -1))
        out["px_0_to_1"] = ((labels == 0) & (sol == 1) & msk).sum((-2, -1))
        out["px_agree"] = ((sol == labels) & msk).sum((-2, -1))
        out["fix_errors"] = (fixed & (state.fixed_val != labels)
                             ).sum((-2, -1))
    return out
