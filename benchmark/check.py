"""The comparison that decides ``correct``.

After the window has closed, what the timed path produced is held
against the plain reference (``reference.py``), on the instances the
benchmark made itself:

* every instance solved in the window: its selected solution is binary,
  finite and feasible on the original instance (``infeasible`` counts
  those that are not: the run's ``failed``), its reported objective is
  the solution's (``obj_err``), and the window's mean objective is no
  worse than the greedy packing's by more than its limit
  (``gap_greedy``);
* in one batch drawn from the seed (the captured batch):
  - the selection and repair, rerun by the reference from the
    program's two roundings, gives the same solutions (``select_diff``);
  - each policy scoring (K2) against the reference's float64 forward
    (``k2_err``), and each fix decision against the reference's decision
    where its score is clear of the bar (``fix_diff``);
  - the chosen solver windows (K1's launches and ``core.lp``'s policy
    windows): their problem is the instance's, or its reduction by the
    captured fixes (``window_operand``), the E x they carry out is E
    times the iterate they return (``ex_err``), and their iterates
    follow the reference's float64 window run from the same state
    (``iter_err``); the l2f tail's first K1 window runs as many
    iterations as that reference and moves as far (``tail_iters``,
    ``tail_stall``; see ``window_numbers``).

``numbers(..., control=True)`` puts the reference in TF32 in the
program's place for K2 and K1: the control that must fail.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from . import reference as ref

#: a fix decision is judged only where the reference's score lies
#: further than this from the bar in each window that made it
FIX_CLEAR = 1e-4


class RefPool:
    """The reference's own copy of the pool, laid out from the
    generator's output: float32 prices (the values the solve was given),
    0/1 incidence, masks; greedy objectives on the host."""

    def __init__(self, instances, m_pad: int, n_pad: int, device):
        P = len(instances)
        self.instances = instances
        self.E = torch.zeros((P, m_pad, n_pad), dtype=torch.float32,
                             device=device)
        self.b = torch.zeros((P, n_pad), dtype=torch.float32, device=device)
        self.rmask = torch.zeros((P, m_pad), dtype=torch.bool, device=device)
        self.vmask = torch.zeros((P, n_pad), dtype=torch.bool, device=device)
        for i, (prices, rows, cols, (m, n)) in enumerate(instances):
            self.E[i] = ref.dense_E(rows, cols, (m, n), m_pad, n_pad, device)
            self.b[i, :n] = torch.as_tensor(-prices, dtype=torch.float32)
            self.rmask[i, :m] = True
            self.vmask[i, :n] = True
        self._greedy = None

    def greedy(self) -> np.ndarray:
        if self._greedy is None:
            self._greedy = np.array([
                ref.greedy_objective(p.astype(np.float32).astype(np.float64),
                                     r, c, s[0])
                for p, r, c, s in self.instances])
        return self._greedy


def instance_numbers(pool: RefPool, batches: List[dict]) -> dict:
    """``infeasible``, ``obj_err``, ``gap_greedy`` over every batch:
    each batch a dict with ``idx`` (host ints), ``sol`` (B, n) and
    ``obj`` (B,)."""
    bad, err, gap_sum, count = 0, 0.0, 0.0, 0
    greedy = pool.greedy()
    for bt in batches:
        idx = torch.as_tensor(bt["idx"], device=pool.E.device)
        ok, over, obj_ref = ref.evaluate(bt["sol"], pool.E[idx],
                                         pool.b[idx], pool.vmask[idx])
        bad += int((~ok | (over > 0)).sum())
        obj = bt["obj"].double()
        e = (obj - obj_ref).abs() / obj_ref.abs().clamp_min(1.0)
        e = torch.where(torch.isfinite(obj), e, torch.full_like(e, np.inf))
        err = max(err, float(e.max()))
        g = torch.as_tensor(greedy[bt["idx"]], dtype=torch.float64,
                            device=obj_ref.device)
        gap_sum += float(((obj_ref - g) / g.abs()).sum())
        count += len(bt["idx"])
    return {"infeasible": bad, "obj_err": err,
            "gap_greedy": gap_sum / max(count, 1)}


def select_numbers(pool: RefPool, idx, selects: List[dict]) -> dict:
    idx = torch.as_tensor(idx, device=pool.E.device)
    E, b, rm, vm = pool.E[idx], pool.b[idx], pool.rmask[idx], \
        pool.vmask[idx]
    f = torch.ones(rm.shape, dtype=torch.float32, device=E.device)
    diff = 0
    for s in selects:
        if s["shape"] != tuple(E.shape):
            diff += E.shape[0]          # the selection saw another batch
            continue
        r, sw, dr = s["rounds"]
        want = ref.select(b, E, f, rm, vm, s["sol_last"], s["sol_best"],
                          repair_rounds=r, swap_rounds=sw, drop_rounds=dr)
        diff += int((want != s["sol"].float()).any(-1).sum())
    return {"select_diff": diff}


def k2_numbers(policy_cfg: dict, ckpt: str, captures, fixes, b, vmask,
               control: bool) -> dict:
    """``k2_err`` over the captured scorings and ``fix_diff`` over the
    captured fix decisions (window w's scoring precedes its fix)."""
    if not captures:
        return {}
    dev = captures[0][0].device
    mk = lambda prec: ref.Policy(ckpt, policy_cfg["node_size"],
                                 policy_cfg["chunk_dim"],
                                 policy_cfg["pe_dim"], policy_cfg["n_heads"],
                                 dev, prec)
    truth = mk("float64")
    stand_in = mk("tf32") if control else None
    err = 0.0
    sigs = []
    for rows, sig in captures:
        want = truth.scores(rows)
        got = stand_in.scores(rows) if control else sig
        err = max(err, float((got.double() - want).abs().max()))
        sigs.append(want)
    out = {"k2_err": err}
    if fixes:
        margins = ref.fix_margins(b, vmask, policy_cfg["fix_confidence"],
                                  policy_cfg["damage_gate"])
        k = policy_cfg["fix_windows"]
        s1 = torch.zeros(b.shape, dtype=torch.int32, device=b.device)
        s0 = torch.zeros_like(s1)
        clear_hist = []
        diff = 0
        for (free, done, vec), sig in zip(fixes, sigs):
            if sig.numel() != b.numel() or vec.shape != b.shape:
                diff += int(vmask.sum())    # scored another batch
                continue
            sig = sig.reshape(b.shape)
            c1, c0 = sig > 1.0 - margins, sig < margins
            s1 = torch.where(c1, s1 + 1, torch.zeros_like(s1))
            s0 = torch.where(c0, s0 + 1, torch.zeros_like(s0))
            want = torch.where(s1 >= k, 1.0, torch.where(s0 >= k, 0.0, -1.0))
            clear_hist.append(((sig - (1.0 - margins)).abs() > FIX_CLEAR)
                              & ((sig - margins).abs() > FIX_CLEAR))
            clear = torch.stack(clear_hist[-k:]).all(0)
            live = free & ~done[:, None] & vmask
            diff += int(((vec.double() != want) & clear & live).sum())
        out["fix_diff"] = diff
    return out


def _expected_operand(pool: RefPool, idx, shape, compacts):
    """The E and b a window should see: the batch's own, or their
    reduction by the captured compaction whose shape it has.  Also the
    number of instances whose reduction's column choice differs."""
    idx = torch.as_tensor(idx, device=pool.E.device)
    E, b, rm = pool.E[idx], pool.b[idx], pool.rmask[idx]
    B, m, n = shape
    if B != E.shape[0]:
        return None, None, E.shape[0]
    if (m, n) == tuple(E.shape[1:]):
        return E, b, 0
    for c in compacts:
        if tuple(c["E"].shape) == tuple(shape):
            E2, cols = ref.compact_E(E, c["free"], rm, c["n_new"],
                                     c["m_new"])
            bad = int((cols != c["idx"]).any(-1).sum())
            return E2, torch.gather(b, 1, cols), bad
    return None, None, B


_STATE = ("x", "z1", "z2", "z4", "f_eff", "free", "rmask", "ring", "count",
          "done", "cur_obj", "best_obj", "best_sol")


def windows(rec) -> List[dict]:
    """The captured solver windows, K1's launches and ``core.lp``'s
    policy windows alike: state in, the window's E and b, and its end
    iterate, carried E x and recorded trajectory (B, steps, n)."""
    out = []
    for L in rec.k1:
        a, o = L["a"], L["out"]
        out.append(dict(kind="k1", index=L["index"], it0=L["it0"],
                        window=L["window"], skip=L["skip"],
                        nside=a.ete is not None,
                        st={k: getattr(a, k) for k in _STATE},
                        E=a.E, b=a.b, x=o.x, ex=o.ex, traj=o.traj,
                        count=o.count, done=o.done))
    for C in rec.core:
        s, o = C["state"], C["out"]
        st = dict(x=s.x, z1=s.z1, z2=s.z2, z4=s.z4, f_eff=s.f_eff,
                  free=s.free.float(), rmask=C["rmask"].float(),
                  ring=s.obj_ring, count=s.obj_count, done=s.done.int(),
                  cur_obj=s.cur_obj, best_obj=s.best_bin_obj,
                  best_sol=s.best_sol)
        traj = C["traj"].transpose(1, 2) if C["traj"] is not None else None
        out.append(dict(kind="core", index=C["index"], it0=C["it0"],
                        window=C["window"], skip=C["skip"], nside=False,
                        st=st, E=C["E"], b=C["b"], x=o.x, ex=o.ex,
                        traj=traj, count=o.obj_count, done=o.done))
    return out


def _inst_err(got, want, free):
    """Per instance: the largest |got - want| over its free entries
    (inf where got is not finite)."""
    e = torch.where(free, (got.double() - want.double()).abs(),
                    torch.zeros((), dtype=torch.float64,
                                device=got.device)).amax(-1)
    return torch.where(torch.isfinite(got).all(-1), e,
                       torch.full_like(e, np.inf))


def _traj_err(got, want, free):
    """Per instance: the largest |got - want| over the steps of two
    (B, steps, n) trajectories and the instance's free entries."""
    d = torch.where(free[:, None, :], (got.double() - want.double()).abs(),
                    torch.zeros((), dtype=torch.float64, device=got.device))
    e = d.amax((1, 2))
    return torch.where(torch.isfinite(got).all(-1).all(-1), e,
                       torch.full_like(e, np.inf))


def window_numbers(pool: RefPool, idx, wins: List[dict], compacts,
                   solver_cfg: dict, compare: dict, control: bool,
                   witness: bool = False) -> dict:
    """The solver windows' numbers:

    * ``window_operand``: instances whose window saw another problem
      than the instance's own or its reduction (exact);
    * ``ex_err``: the largest gap, over live instances and rows, between
      the E x a window carries out and E times the iterate it returns,
      in units of x: the products of the last iteration, precision
      included, whatever the trajectory before it;
    * ``iter_err``: over the windows ``compare`` names (``{"k1": [launch
      indices], "core": [window indices], "steps": S}``), the median over
      live instances of each one's largest iterate error against the
      float64 window run from the same state: over the first S recorded
      steps where the window records its trajectory, else at its end;
    * ``tail_iters`` and ``tail_stall``: over the K1 launches that
      ``compare["tail"]`` names, whose windows (a thousand iterations
      of the l2f tail) carry float32 rounding far enough that their end
      iterate says nothing, what rounding does not wash out, against the
      float64 window run from the same state: the share of the
      reference's iterations that the live instances did not run
      (``tail_iters``), and the median over live instances of how far
      the iterate moved short of the reference's move, as a share of
      that move (``tail_stall``).  A window that returns its state reads
      1 on both.

    ``witness`` adds per window (``windows``) the same median for the
    reference in float32."""
    if not wins:
        return {}
    S = compare.get("steps", 0)
    operand_bad, ex_err, errs, diag = 0, 0.0, [], []
    iters, stalls = [], []
    for W in wins:
        E, b, bad = _expected_operand(pool, idx, tuple(W["E"].shape),
                                      compacts)
        operand_bad += bad
        if E is None:
            continue
        operand_bad += int(((W["E"].float() != E).flatten(1).any(-1)
                            | (W["b"] != b).any(-1)).sum())
        st = dict(W["st"], b=b)
        free = st["free"] > 0.5
        live = st["done"] == 0
        if not bool(live.any()):
            continue
        named = W["index"] in compare.get(W["kind"], ())
        tail = W["kind"] == "k1" and W["index"] in compare.get("tail", ())
        recorded = W["traj"] is not None
        steps = S if recorded and S and named else W["window"]
        run = lambda prec: ref.window(
            st, E, solver_cfg, W["it0"], steps, W["skip"], W["nside"], prec,
            record=recorded and named)
        want = run("float64") if named or tail or witness else None
        got = run("tf32") if control else {
            "x": W["x"], "ex": W["ex"], "count": W["count"],
            "done": W["done"],
            "traj": W["traj"][:, :steps] if recorded else None}
        Ex = torch.bmm(E.double(), (free.double() * got["x"].double())
                       [..., None])[..., 0]
        gap = torch.where(torch.isfinite(got["ex"]),
                          (got["ex"].double() - Ex).abs(),
                          torch.full_like(Ex, np.inf)).amax(-1)
        ex_err = max(ex_err, float(gap[live].max()))
        if want is None:
            continue
        if tail:
            ran = lambda o: ((o["count"] - st["count"]).double()
                             + ((o["done"] > 0) & ~(st["done"] > 0))
                             .double())[live]
            iters.append((float(ran(got).sum()), float(ran(want).sum())))
            moved = lambda o: _inst_err(o["x"], st["x"], free)[live]
            mp, mr = moved(got), moved(want)
            stalls.append(torch.where(mr > 0, (1.0 - mp / mr).clamp(0, 1),
                                      torch.zeros_like(mr)))
        err = (lambda g: _traj_err(g["traj"], want["traj"], free)) \
            if recorded and named else \
            (lambda g: _inst_err(g["x"], want["x"], free))
        e = err(got)[live]
        if named:
            errs.append(e)
        if witness and tail:
            diag.append({"kind": W["kind"], "index": W["index"],
                         "tail": True, "iters": iters[-1],
                         "stall_median": float(stalls[-1].median()),
                         "moved_median": [float(mp.median()),
                                          float(mr.median())]})
        if witness:
            diag.append({"kind": W["kind"], "index": W["index"],
                         "it0": W["it0"], "steps": steps,
                         "nside": W["nside"], "shape": list(W["E"].shape),
                         "live": int(live.sum()), "named": named,
                         "median": float(e.median()),
                         "f32_median": float(err(run("float32"))[live]
                                             .median()),
                         "ex_gap": float(gap[live].max())})
    out = {"window_operand": operand_bad, "ex_err": ex_err}
    if compare.get("k1") or compare.get("core"):
        e_all = torch.cat(errs) if errs else torch.zeros(0)
        out["iter_err"] = float(e_all.median()) if e_all.numel() \
            else float("inf")
    if compare.get("tail"):
        ran, due = (sum(x) for x in zip(*iters)) if iters else (0.0, 0.0)
        out["tail_iters"] = 1.0 - ran / due if due > 0 else \
            (0.0 if iters else float("inf"))
        out["tail_stall"] = float(torch.cat(stalls).median()) \
            if stalls and torch.cat(stalls).numel() else \
            (0.0 if iters else float("inf"))
    if witness:
        out["windows"] = diag
    return out


def numbers(pool: RefPool, batches, captured: dict, rec, solver_cfg: dict,
            policy_cfg: Optional[dict], ckpt: Optional[str], compare: dict,
            control: bool = False, witness: bool = False
            ) -> Dict[str, float]:
    """Every compared number of a run; ``captured``: the captured batch's
    record (``idx``)."""
    out = instance_numbers(pool, batches)
    idx = captured["idx"]
    out.update(select_numbers(pool, idx, rec.selects))
    it = torch.as_tensor(idx, device=pool.E.device)
    if rec.k2:
        out.update(k2_numbers(policy_cfg, ckpt, rec.k2, rec.fixes,
                              pool.b[it], pool.vmask[it], control))
    out.update(window_numbers(pool, idx, windows(rec), rec.compacts,
                              solver_cfg, compare, control, witness))
    return out


def judge(nums: Dict[str, float], limits: Dict[str, float]):
    """(correct, rows): every limited number present and within its
    limit; rows of (name, value, limit)."""
    rows, ok = [], True
    for name, limit in limits.items():
        v = nums.get(name)
        good = v is not None and bool(np.isfinite(v)) and v <= limit
        ok = ok and good
        rows.append((name, v, limit))
    return ok, rows
