"""Struct-path learned early fixing at the very-large CA rungs.

The port of the JAX package's ``train/l2f_struct.py``: the pipeline of
the reference's ``ADMM_lp_iters_l2f`` (cython_solver/
LPboxADMMsolver.cpp:1098-1574) on the struct problems of
``ops/ca_sparse`` with the Schur inverse of ``ops/struct_ginv``:

1. Policy phase: ``policy_windows`` recorded windows of ``ws``
   iterations on the full struct problem (``core.lp`` windows), each
   window's trajectories scored (K2 on the card), deter_fix_2 confidence
   streaks accumulated across windows, and no fix event in between.
2. One host-side fix and compaction (``host_fix_compact``): the
   reduction algebra of ``core.lp.compact`` (reference :1124-1335)
   restricted to the surviving free columns and live rows, as a reduced
   dense problem (bfloat16 E built on the card from its COO) whose
   Woodbury inverse keeps the [item | dummy] Schur structure (dummy
   supports stay disjoint under column restriction) or is dense.
3. The residual at the tail rho schedule, then ``report_full``: the
   last rounding and the incumbent scattered to full width and selected
   on the original problem (a host COO mirror of
   ``core.lp.select_solution``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.problem import Device, LpProblem, as_device
from ..utils import profiling

#: the ``timings`` keys of the tracer's spans in ``l2f_solve_struct``
#: (``win_s``, ``score_s``: the policy windows and their scoring; the
#: rest ``host_fix_compact``'s stages)
TIMING_SPANS = {"struct.window": "win_s", "struct.score": "score_s",
                "struct.fetch": "fetch_s", "struct.scipy": "scipy_s",
                "struct.assemble": "assemble_s", "struct.ginv": "ginv_s",
                "struct.upload": "upload_s", "struct.refresh": "refresh_s"}


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def deter_fix_2(sigs, margins, fix_windows):
    """The +1/0/-1 fix vector after deter_fix_2's confidence streaks over
    the windows' sigmoids ``sigs`` (an iterable, taken in order): a
    variable is fixed to 1 (0) once its sigmoid has been above
    ``1 - margins`` (below ``margins``) in ``fix_windows`` consecutive
    windows."""
    streak1 = np.zeros(len(margins), np.int32)
    streak0 = np.zeros(len(margins), np.int32)
    for sig in sigs:
        streak1 = np.where(sig > 1.0 - margins, streak1 + 1, 0)
        streak0 = np.where(sig < margins, streak0 + 1, 0)
    return np.where(streak1 >= fix_windows, 1.0,
                    np.where(streak0 >= fix_windows, 0.0,
                             -1.0)).astype(np.float32)


def window_decisions(traj, score, ws, conf, fix_windows, n_windows,
                     margins=None, device: Device = "cuda"):
    """Replay deter_fix_2 and the consistency streaks over trajectory
    windows: ``traj`` (n, T) on the host, each window's rows scored on
    ``device``.  Returns (vec, sigs): the +1/0/-1 fix vector after
    ``n_windows`` windows and the per-window sigmoids."""
    dev = as_device(device)
    n, T = traj.shape
    if n_windows * ws > T:
        raise ValueError(f"{n_windows} windows of {ws} need {n_windows * ws}"
                         f" recorded iterations, the trajectory has {T}")
    if margins is None:
        margins = np.full((n,), 1.0 - conf, np.float32)
    sigs = [_host(score(torch.from_numpy(np.ascontiguousarray(
        traj[:, w * ws:(w + 1) * ws], np.float32)).to(dev)))
        for w in range(n_windows)]
    return deter_fix_2(sigs, margins, fix_windows), sigs


def transfer_report(vec, labels, b, oracle_obj, tag=""):
    """Fix volume, errors and |b|-weighted error mass of a decision vec."""
    fixed = vec >= 0.0
    val = np.clip(vec, 0.0, 1.0)
    err = fixed & (val != labels)
    err_mass = float(np.abs(b[err]).sum())
    print(f"  {tag}: fixed {int(fixed.sum())}/{len(vec)} "
          f"errors {int(err.sum())} "
          f"(1->0 {int((err & (labels == 1)).sum())}, "
          f"0->1 {int((err & (labels == 0)).sum())}) "
          f"err |b| mass {err_mass:.1f} = "
          f"{err_mass / abs(oracle_obj):+.3%} of |oracle|", flush=True)
    return int(fixed.sum()), int(err.sum()), err_mass


def gate_margins(b, conf, damage_gate):
    """Risk-calibrated per-variable margins (``train.l2f.fix_margins`` on
    the host): the 1-C margin tightens with the bid's |b| rank."""
    n = len(b)
    margins = np.full((n,), 1.0 - conf, np.float32)
    if damage_gate > 0:
        rank = np.argsort(np.argsort(np.abs(b))) / max(n - 1, 1)
        margins *= (1.0 - damage_gate * rank.astype(np.float32))
    return margins


def _scatter_rows(rows, cols, vals, shape, dt, device):
    """The reduced dense E assembled on the device from its COO triplets
    (duplicate-free, so an indexed write): an upload of the nonzeros, not
    of the dense tensor."""
    E = torch.zeros(shape, dtype=dt, device=device)
    t = lambda a: torch.from_numpy(a).to(device)
    E[0, t(rows), t(cols)] = t(vals).to(dt)
    return E


def host_fix_compact(state, prob, inst, row_map, vec, cfg_tail,
                     align=512, e_dtype="bfloat16", m1_full=None):
    """Apply the fix vector and shrink to a dense problem (B = 1).

    The reduction algebra of ``core.lp.compact`` (the reference's
    physical shrink, :1124-1335): free columns gathered, rows with no
    free support dropped (their feasibility is checked again on the
    original problem by ``report_full``), f_eff = f - E @ (fixed * val),
    the fixed objective added to sum_fix_obj.  On the host, as the fix
    event is a host round trip anyway:

    * the reduced E is assembled dense (bfloat16 or float32, ``e_dtype``)
      from the restricted COO;
    * the reduced Woodbury inverse: with ``m1_full`` (the full struct
      E's item-block size) the dummy rows, still support-disjoint after
      dropping columns, give a diagonal dummy block, so the inverse is a
      ``StructGinv`` (an (m1, m1) Cholesky) with rows laid out
      [kept items | pad | kept dummies | pad]; without it, a dense
      float64 Cholesky of the whole reduced Gram;
    * m-side state (y3, z4) is gathered through ``row_map`` (the struct
      layout reorders rows).

    Its stages are the tracer's spans ``struct.fetch``, ``struct.scipy``,
    ``struct.assemble``, ``struct.ginv``, ``struct.upload`` and
    ``struct.refresh`` (``utils.profiling``).  Returns (state_red,
    prob_red, carry); ``carry`` holds the full-width fixing snapshot for
    ``report_full``."""
    import scipy.sparse as sp
    from scipy.linalg import cho_factor, cho_solve
    from ..core import lp
    from ..ops.struct_ginv import StructGinv, schur_blocks

    with profiling.span("struct.fetch"):
        dev = prob.device
        p, (r, c, v, shape) = inst
        m_orig, n_valid = int(shape[0]), int(shape[1])
        b_orig = -np.asarray(p, np.float64)  # prices negate (make_problem)

        keys = ("x", "y1", "y2", "y3", "z1", "z2", "z4", "free",
                "fixed_val", "sum_fix_obj", "obj_ring", "obj_count", "done",
                "cur_obj", "best_bin_obj", "best_sol", "x_prev")
        st = {k: _host(getattr(state, k)) for k in keys}
    with profiling.span("struct.scipy"):
        free_old = st["free"][0, :n_valid]
        vecv = vec[:n_valid]
        # a converged instance fixes nothing further (apply_fix's active
        # gate)
        newly = free_old & (vecv >= 0.0) & (not bool(st["done"][0]))
        val = np.clip(vecv, 0.0, 1.0)
        free_new = free_old & ~newly
        fixed_vals = np.where(newly, val, st["fixed_val"][0, :n_valid])
        fixed_vals = np.where(free_new, 0.0, fixed_vals)
        sum_fix = float(st["sum_fix_obj"][0]) \
            + float((b_orig * val * newly).sum())

        C = sp.csr_matrix((np.asarray(v, np.float64),
                           (np.asarray(r), np.asarray(c))),
                          shape=(m_orig, n_valid))
        f_eff = 1.0 - C @ fixed_vals
    with profiling.span("struct.assemble"):
        ratio = lp._wb_ratio(cfg_tail)
        free_cols = np.where(free_new)[0]
        Cc = C[:, free_cols].tocsr()
        kept_rows = np.where(Cc.getnnz(axis=1) > 0)[0]

        def rup(x):
            return max(align, -(-x // align) * align)

        if m1_full is not None:
            # [items | dummies], each block padded: the reduced G^-1 is a
            # StructGinv
            is_item = row_map[kept_rows] < m1_full
            kept_rows = np.concatenate([kept_rows[is_item],
                                        kept_rows[~is_item]])
            ik, dk = int(is_item.sum()), int((~is_item).sum())
            m1p, m2p = rup(ik), rup(dk)
            m_pad = m1p + m2p
            pos = np.concatenate([np.arange(ik), m1p + np.arange(dk)])
        else:
            m_pad = rup(len(kept_rows))
            pos = np.arange(len(kept_rows))

        Cr = Cc[kept_rows]
        m_v, n_v = Cr.shape
        n_pad = rup(n_v)
        if e_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"e_dtype {e_dtype!r}")
        edt = torch.bfloat16 if e_dtype == "bfloat16" else torch.float32
        coo_r = Cr.tocoo()
        E_dev = _scatter_rows(pos[coo_r.row], coo_r.col,
                              coo_r.data.astype(np.float32),
                              (1, m_pad, n_pad), edt, dev)
        b_red = np.zeros((1, n_pad), np.float32)
        b_red[0, :n_v] = b_orig[free_cols]
        f_red = np.ones((1, m_pad), np.float32)
        f_red[0, pos] = f_eff[kept_rows]
        vmask = np.zeros((1, n_pad), bool)
        vmask[0, :n_v] = True
        rmask = np.zeros((1, m_pad), bool)
        rmask[0, pos] = True
    with profiling.span("struct.ginv"):
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        if m1_full is not None:
            Cl = sp.csr_matrix((coo_r.data, (pos[coo_r.row], coo_r.col)),
                               shape=(m_pad, n_v))
            sinv, Bm, dinv = schur_blocks(Cl, m1p, m2p, ratio)
            ginv = StructGinv(sinv=t(sinv.astype(np.float32))[None],
                              b12=t(Bm.astype(np.float32))[None],
                              dinv=t(dinv.astype(np.float32))[None])
        else:
            G = (Cr @ Cr.T).toarray()
            gi = cho_solve(cho_factor(G + ratio * np.eye(m_v),
                                      lower=True), np.eye(m_v))
            gpad = np.zeros((1, m_pad, m_pad), np.float32)
            gpad[0, :m_v, :m_v] = gi
            ginv = t(gpad)
    with profiling.span("struct.upload"):
        prob_red = LpProblem(b=t(b_red), E=E_dev, f=t(f_red),
                             row_mask=t(rmask), var_mask=t(vmask))

        def gn(a):                              # n-side gather and pad
            out = np.zeros((1, n_pad), np.float32)
            out[0, :n_v] = a[0, free_cols]
            return t(out)

        srows = row_map[kept_rows]  # struct rows of the kept original rows

        def gm(a):
            out = np.zeros((1, m_pad), np.float32)
            out[0, pos] = a[0, srows]
            return t(out)

        # ex = E_red @ x_red from the COO on the host
        ex_np = np.zeros((1, m_pad), np.float32)
        ex_np[0, pos] = Cr @ st["x"][0, free_cols].astype(np.float64)
        f32 = lambda a: t(np.asarray(a, np.float32))
        state_red = lp.LpState(
            x=gn(st["x"]), y1=gn(st["y1"]), y2=gn(st["y2"]),
            y3=gm(st["y3"]), z1=gn(st["z1"]), z2=gn(st["z2"]),
            z4=gm(st["z4"]),
            free=t(vmask), fixed_val=f32(np.zeros((1, n_pad))),
            f_eff=t(f_red), sum_fix_obj=f32([sum_fix]),
            obj_ring=f32(st["obj_ring"]), obj_count=t(st["obj_count"]),
            it=state.it, done=t(st["done"]),   # sticky, as in core compact
            cg_fail=t(np.zeros((1,), bool)),
            cur_obj=f32(st["cur_obj"]),
            best_bin_obj=f32(st["best_bin_obj"]),
            best_sol=gn(st["best_sol"]), x_prev=gn(st["x_prev"]),
            fix_count=t(np.zeros((1, n_pad), np.int32)),
            ex=t(ex_np), ginv=ginv, et_next=f32(np.zeros((1, n_pad))))
    with profiling.span("struct.refresh"):
        state_red = lp.refresh_et_next(state_red, prob_red, cfg_tail)
    carry = {"free_cols": free_cols, "fixed_vals": fixed_vals,
             "free_new": free_new, "C": C, "b_orig": b_orig,
             "n_valid": n_valid}
    return state_red, prob_red, carry


def report_full(state_red, carry, oracle=None):
    """The last rounding and the incumbent scattered to full width and
    selected on the original problem (a host COO mirror of
    ``core.lp.select_solution``)."""
    from ..core import lp

    n_valid = carry["n_valid"]
    free_cols = carry["free_cols"]
    cands = []
    for sol_red in (_host(lp.solution(state_red))[0],
                    _host(lp.solution_best(state_red))[0]):
        full = carry["fixed_vals"].copy()
        full[free_cols] = sol_red[:len(free_cols)]
        cands.append(full[:n_valid])
    C, b = carry["C"], carry["b_orig"]
    objs = [float(b @ s) for s in cands]
    viol = [int(((C @ s) > 1.0 + 1e-6).sum()) for s in cands]
    use_best = viol[1] == 0 and (objs[1] <= objs[0] or viol[0] > 0)
    k = 1 if use_best else 0
    out = {"obj": objs[k], "infeasible": viol[k],
           "n_fixed": int((~carry["free_new"]).sum())}
    if oracle is not None:
        out["gap"] = (objs[k] - oracle) / abs(oracle)
    return out


def l2f_solve_struct(prob, ginv, inst, row_map, score, cfg, *,
                     conf: float = 0.98, fix_windows: int = 2,
                     policy_windows: int = 3, ws: int = 100,
                     tail_rho: Optional[int] = 12, cap: int = 20000,
                     window: Optional[int] = None,
                     damage_gate: float = 0.0,
                     e_dtype: str = "bfloat16",
                     reduced_ginv: str = "schur",
                     oracle_obj: Optional[float] = None,
                     timings: Optional[dict] = None):
    """The struct-path l2f solve (see the module docstring).

    ``prob``/``ginv``/``row_map`` come from ``adapters.ca.
    make_struct_problem`` and ``ops.struct_ginv.build_struct_ginv``
    (B = 1); ``inst`` is the raw (price, COO) instance; ``score`` maps
    (R, ws) trajectory rows to sigmoids (``train.l2f._scorer``: K2 on
    the card).  ``reduced_ginv`` picks the reduced problem's inverse
    (``"schur"`` or ``"dense"``, see ``host_fix_compact``); the tail
    runs ``core.lp`` windows either way.  Returns the ``report_full``
    dict with the stage times (``policy_s``, ``compact_s``, ``tail_s``)
    and the iteration count; ``timings`` (a dict) receives the finer
    spans (``TIMING_SPANS``).  The stages are the tracer's spans
    (``utils.profiling``: CUDA events on the card, read after one wait
    at the end)."""
    from ..core import lp

    if reduced_ginv not in ("schur", "dense"):
        raise ValueError(f"reduced_ginv {reduced_ginv!r}")
    cfg_tail = cfg if not tail_rho else cfg.replace(rho_change_step=tail_rho)
    n_valid = int(prob.var_mask.sum())
    if window is None:
        window = 100 if prob.n >= 400_000 else 500
    b_h = _host(prob.b)[0, :n_valid]
    margins = gate_margins(b_h, conf, damage_gate)

    tracer = profiling.PhaseTimer(prob.device)
    with tracer:
        with profiling.span("struct.policy"):
            state = lp.init_state(prob, cfg, ginv=ginv)

            def scored_windows():
                nonlocal state
                for w in range(policy_windows):
                    with profiling.span("struct.window"):
                        state, traj = lp.solve_window(
                            state, prob, cfg, ws, record=True,
                            skip_cvg_at=0 if w == 0 else None)
                    with profiling.span("struct.score"):
                        sig = _host(score(traj[0, :n_valid, :]))
                    yield sig

            vec = deter_fix_2(scored_windows(), margins, fix_windows)

        with profiling.span("struct.compact"):
            state_red, prob_red, carry = host_fix_compact(
                state, prob, inst, row_map, vec, cfg_tail, e_dtype=e_dtype,
                m1_full=prob.E.m1 if reduced_ginv == "schur" else None)

        with profiling.span("struct.tail"):
            while state_red.it < cap and not bool(state_red.done.all()):
                state_red, _ = lp.solve_window(state_red, prob_red, cfg_tail,
                                               window, record=False)
    sums = tracer.finish().sums()
    if timings is not None:
        for name, key in TIMING_SPANS.items():
            timings[key] = timings.get(key, 0.0) + sums.get(name, 0.0)

    out = report_full(state_red, carry, oracle=oracle_obj)
    out.update(policy_s=sums["struct.policy"],
               compact_s=sums["struct.compact"], tail_s=sums["struct.tail"],
               iterations=state_red.it, decided=int((vec >= 0).sum()),
               n_valid=n_valid, n_red=len(carry["free_cols"]),
               red_shape=tuple(prob_red.E.shape))
    return out
