"""Combinatorial auctions (``instance.kind`` "cauction"): CATS-style
weighted set packing, ``min b.x  s.t.  E x <= 1,  x in {0, 1}^n`` with
b the negated bid prices and E the 0/1 item-bid incidence, solved by the
port's LP path (``core.lp``, K1 in ``ops.fused_lp``, ``train.l2f``).

The pool's instances come from ``gen.instance`` (the reference's
generator) as COO triples; the program is given float32 prices, the
dense incidence, f = 1 and the masks as an ``LpProblem``.

What decides ``correct`` (``numbers``), against the plain reference
(``reference.py``) on the instances the benchmark made itself:

* every instance solved in the window: its selected solution is binary,
  finite and feasible on the original instance (``infeasible`` counts
  those that are not: the run's ``failed``), its reported objective is
  the solution's (``obj_err``), and the window's mean objective is no
  worse than the greedy packing's by more than its limit
  (``gap_greedy``);
* in one batch drawn from the seed (the captured batch):
  - the selection and repair, rerun by the reference from the
    program's two roundings, gives the same solutions (``select_diff``);
  - each policy scoring (K2) and fix decision (``check.k2_numbers``:
    ``k2_err``, ``fix_diff``);
  - the chosen solver windows (K1's launches and ``core.lp``'s policy
    windows): their problem is the instance's, or its reduction by the
    captured fixes (``window_operand``), the E x they carry out is E
    times the iterate they return (``ex_err``), and their iterates
    follow the reference's float64 window run from the same state
    (``iter_err``), and so do K1's launches on clusters, a drawn one
    of each group the traffic names, each on its own
    (``iter_err_<group>``); the l2f tail's first K1 window runs as many
    iterations as that reference and moves as far (``tail_iters``,
    ``tail_stall``; see ``window_numbers``).

``numbers(..., control=True)`` puts the reference in TF32 in the
program's place for K2 and K1: the control that must fail.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from .. import check, faults, gen, work
from .. import reference as ref

#: pool instance ``index`` under ``seed``: (prices float64 (n,), rows
#: int32, cols int32, (m, n)), the incidence's nonzeros (all 1)
make = gen.instance


def save(path: str, instances) -> None:
    with open(path, "wb") as f:
        np.savez(f, prices=np.concatenate([p for p, _, _, _ in instances]),
                 rows=np.concatenate([r for _, r, _, _ in instances]),
                 cols=np.concatenate([c for _, _, c, _ in instances]),
                 nnz=np.array([len(r) for _, r, _, _ in instances]),
                 shapes=np.array([s for _, _, _, s in instances]))


def load(path: str):
    with np.load(path) as z:
        shapes = [tuple(int(d) for d in s) for s in z["shapes"]]
        cut_p = np.cumsum([n for _, n in shapes])[:-1]
        cut_e = np.cumsum(z["nnz"])[:-1]
        return [(p, r, c, s) for p, r, c, s in zip(
            np.split(z["prices"], cut_p), np.split(z["rows"], cut_e),
            np.split(z["cols"], cut_e), shapes)]


def variables(instance) -> int:
    """An instance's bids."""
    return instance[3][1]


def device_pool(instances, m_pad: int, n_pad: int, device) -> dict:
    """The pool as the program is given it: float32 prices (minimisation
    form), the dense 0/1 incidence, f = 1 and the masks, laid out on the
    device in a few large calls."""
    P = len(instances)
    b = np.zeros((P, n_pad), np.float32)
    rm = np.zeros((P, m_pad), bool)
    vm = np.zeros((P, n_pad), bool)
    nz = []
    for i, (prices, rows, cols, (m, n)) in enumerate(instances):
        if m > m_pad or n > n_pad:
            raise ValueError(f"instance {i} is ({m}, {n}), over the "
                             f"configuration's ({m_pad}, {n_pad})")
        b[i, :n] = -prices
        rm[i, :m] = True
        vm[i, :n] = True
        nz.append((i * m_pad + rows.astype(np.int64)) * n_pad + cols)
    E = torch.zeros(P * m_pad * n_pad, dtype=torch.float32, device=device)
    E[torch.from_numpy(np.concatenate(nz)).to(device)] = 1.0
    t = lambda a: torch.from_numpy(a).to(device)
    return dict(b=t(b), E=E.view(P, m_pad, n_pad),
                f=torch.ones((P, m_pad), dtype=torch.float32, device=device),
                row_mask=t(rm), var_mask=t(vm))


def upload(port, instances, instance_cfg: dict, device):
    """``gather(idx)``: the ``LpProblem`` of pool indices ``idx``."""
    from lpbox_admm_tpu_torch.core.problem import LpProblem
    dp = device_pool(instances, instance_cfg["m_pad"], instance_cfg["n_pad"],
                     device)

    def gather(idx):
        it = torch.as_tensor(idx, device=device)
        return LpProblem(**{k: v[it] for k, v in dp.items()})
    return gather


# --- what the recorder keeps ------------------------------------------------

class Capture:
    """What the recorder keeps of the LP path (module attributes of the
    program, wrapped in place by ``capture.Recorder``; it copies and
    synchronises nothing):

    * K1's launch (``ops.fused_lp.window_cuda``, or ``window_plain`` on a
      CPU tensor): in a captured batch, the launches the traffic's
      ``check.k1_launches`` names (and one drawn from ``k1_drawn``), with
      operands and outputs; in a traced run, every launch's sizes and
      iteration counts for the work count;
    * the ``core.lp`` windows of a policy phase (``core.lp.solve_window``,
      where K1 cannot hold the problem): state in and out and the
      recorded trajectory in a captured batch;
    * ``core.lp.apply_fix``, ``core.lp.compact`` and
      ``core.lp.select_solution`` in a captured batch: the fix
      decisions, the reduced problem and the selection's inputs and
      output.

    ``compare``: the windows whose iterates are held (``window_numbers``),
    from the traffic's ``check.iter``.

    The traffic's ``check.k1_cluster`` (``{group: {"clusters": [C, ...],
    "drawn": [lo, hi]}}``) holds K1's launches on clusters apart, one
    number a group: in the captured batch, the k-th launch whose C is in
    the group's list, k drawn from ``[lo, hi)``, or the group's last
    launch where the batch has fewer (``iter_err_<group>``)."""

    def __init__(self, rec, check_plan: dict, pick):
        self.rec = rec
        self.k1_keep = set(check_plan["k1_launches"])
        self.compare = {k: list(v) if isinstance(v, list) else v
                        for k, v in check_plan["iter"].items()}
        lo, hi = check_plan.get("k1_drawn", (0, 0))
        if hi > lo:
            drawn = int(pick.randint(lo, hi))
            self.k1_keep.add(drawn)
            self.compare["k1"].append(drawn)
        self.groups = {g: (set(p["clusters"]), int(pick.randint(*p["drawn"])))
                       for g, p in check_plan.get("k1_cluster", {}).items()}
        self.compare["groups"] = list(self.groups)
        self.k1: List[dict] = []
        self.k1_group: dict = {}
        self._seen: dict = {}
        self.core: List[dict] = []
        self.fixes: List[tuple] = []
        self.compacts: List[dict] = []
        self.selects: List[dict] = []
        self.k1_work: List[tuple] = []
        self._k1_i = 0

    def wraps(self):
        fl, lp = self.rec.port["fused_lp"], self.rec.port["lp"]
        return [(fl, "window_cuda", self._k1), (fl, "window_plain", self._k1),
                (lp, "solve_window", self._core),
                (lp, "apply_fix", self._fix), (lp, "compact", self._compact),
                (lp, "select_solution", self._select)]

    def batch(self):
        self._k1_i = 0
        self._seen = dict.fromkeys(self.groups, 0)

    def work(self) -> dict:
        """K1's work over the window, one entry a launch
        (``work.k1_launch``)."""
        out = []
        for (m_i, n_i, c_in, d_in, c_out, d_out, it0, window, nside, steps,
             stride) in self.k1_work:
            newly = (d_out.cpu().numpy() > 0) & (d_in.cpu().numpy() == 0)
            iters = (c_out.cpu().numpy() - c_in.cpu().numpy()) + newly
            out.append(work.k1_launch(
                m_i.cpu().numpy(), n_i.cpu().numpy(), iters,
                work.strided(it0, iters, stride), nside, steps))
        return {"k1": out}

    def _k1(self, fn):
        def window(a, cfg, it0, window, skip_cvg_at=None, record=False):
            out = fn(a, cfg, it0, window, skip_cvg_at, record)
            i = self._k1_i
            self._k1_i += 1
            if self.rec.trace and a.E.is_cuda:
                self.k1_work.append((
                    a.rmask.sum(-1), a.free.sum(-1), a.count, a.done,
                    out.count, out.done, it0, window, a.ete is not None,
                    window if record else 0, cfg.incumbent_stride))
            if not self.rec.capturing:
                return out
            L = dict(a=a, out=out, it0=it0, window=window, skip=skip_cvg_at,
                     record=record, cfg=cfg, index=i)
            if i in self.k1_keep:
                self.k1.append(L)
            for g, (cs, k) in self.groups.items():
                if a.cluster in cs:
                    if self._seen[g] <= k:
                        self.k1_group[g] = dict(L, group=g, nth=self._seen[g])
                    self._seen[g] += 1
            return out
        return window

    def _core(self, fn):
        def solve_window(state, prob, cfg, window, record=True,
                         skip_cvg_at=None, rule_fixing=False):
            res = fn(state, prob, cfg, window, record, skip_cvg_at,
                     rule_fixing)
            if self.rec.capturing:
                self.core.append(dict(state=state, E=prob.E, b=prob.b,
                                      rmask=prob.row_mask, out=res[0],
                                      traj=res[1], it0=state.it,
                                      window=window, skip=skip_cvg_at,
                                      record=record, cfg=cfg,
                                      index=len(self.core)))
            return res
        return solve_window

    def _fix(self, fn):
        def apply_fix(state, prob, vec, cfg, *args, **kw):
            if self.rec.capturing:
                self.fixes.append((state.free, state.done, vec))
            return fn(state, prob, vec, cfg, *args, **kw)
        return apply_fix

    def _compact(self, fn):
        def compact(state, prob, cfg, n_new, m_new=None):
            res = fn(state, prob, cfg, n_new, m_new)
            if self.rec.capturing:
                self.compacts.append(dict(free=state.free, n_new=n_new,
                                          m_new=m_new, E=res[1].E,
                                          b=res[1].b, idx=res[2]))
            return res
        return compact

    def _select(self, fn):
        def select_solution(prob, sol_last, sol_best, repair_rounds=0,
                            swap_rounds=0, drop_rounds=0):
            res = fn(prob, sol_last, sol_best, repair_rounds, swap_rounds,
                     drop_rounds)
            if self.rec.capturing:
                self.selects.append(dict(
                    sol_last=sol_last, sol_best=sol_best, rounds=(
                        repair_rounds, swap_rounds, drop_rounds),
                    sol=res[0], shape=tuple(prob.E.shape)))
            return res
        return select_solution


# --- faults ------------------------------------------------------------------

def _unchanged_window(fn, fl):
    """A K1 window that returns its state unchanged."""
    def window(a, cfg, it0, window, skip_cvg_at=None, record=False):
        x = a.x.clone()
        ex = torch.bmm(a.E.float(), (a.free * x)[..., None])[..., 0]
        return fl.WindowOut(
            x=x, z1=a.z1, z2=a.z2, z4=a.z4, ring=a.ring, count=a.count,
            done=a.done, cur_obj=a.cur_obj, best_obj=a.best_obj,
            best_sol=a.best_sol, y1=x, y2=x, y3=a.f_eff, ex=ex,
            traj=x[:, None, :].expand(-1, window, -1).contiguous()
            if record else None)
    return window


def _share_lost(fn, fl):
    """A K1 launch on clusters (C > 1) iterates as if its first block's
    rows of E were zero, as where that block's share of the cluster's
    sums is lost; the E x it returns is the true E's, so that only the
    iterates show it.  Launches on one block an instance are left
    sound."""
    def window(a, cfg, it0, window, skip_cvg_at=None, record=False):
        if a.cluster == 1:
            return fn(a, cfg, it0, window, skip_cvg_at, record)
        E = a.E.clone()
        E[:, :fl.share_rows(E.shape[1], a.cluster)] = 0
        out = fn(a._replace(E=E), cfg, it0, window, skip_cvg_at, record)
        ex = torch.bmm(a.E.float(), (a.free * out.x)[..., None])[..., 0]
        return out._replace(ex=ex)
    return window


def _half_batch(fn, mod):
    """The entry solves the first half of the batch; the rest of its
    answers are zeros (l2f) or the untouched start state (plain)."""
    def solve(prob, *args, **kw):
        h = prob.batch // 2
        part = dataclasses.replace(prob, **{f: getattr(prob, f)[:h] for f in
                                            ("b", "E", "f", "row_mask",
                                             "var_mask")})
        res = fn(part, *args, **kw)
        pad = lambda t: torch.cat([t, torch.zeros(
            (prob.batch - h,) + t.shape[1:], dtype=t.dtype, device=t.device)])
        if isinstance(res, tuple):          # l2f: (state, out)
            out = {k: pad(v) if torch.is_tensor(v) and v.shape[:1] == (h,)
                   else v for k, v in res[1].items()}
            return res[0], out
        full = mod.lp_core.init_state(prob, args[0])
        return full.replace(**{
            f: torch.cat([getattr(res, f), getattr(full, f)[h:]])
            for f in ("x", "best_sol", "best_bin_obj", "free",
                      "fixed_val")})
    return solve


def _flip_one_answer(fn, mod):
    """Selection flips one bid of its first instance's answer."""
    def select_solution(prob, *args, **kw):
        sol, obj, inf = fn(prob, *args, **kw)
        sol = sol.clone()
        j = int(torch.nonzero(prob.var_mask[0])[-1])
        sol[0, j] = 1.0 - sol[0, j]
        return sol, obj, inf
    return select_solution


#: fault -> [(module key of the port dict, attribute, wrapper maker)];
#: the K1 faults replace both of K1's launch paths, the half batch both
#: entries' solves
FAULTS = {
    "state-unchanged": [("fused_lp", "window_cuda", _unchanged_window),
                        ("fused_lp", "window_plain", _unchanged_window)],
    "share-lost": [("fused_lp", "window_cuda", _share_lost),
                   ("fused_lp", "window_plain", _share_lost)],
    "half-batch": [("l2f", "l2f_solve_compact", _half_batch),
                   ("fused_lp", "solve_fused", _half_batch)],
    "answer-altered": [("lp", "select_solution", _flip_one_answer)],
    "score-altered": faults.SCORE_ALTERED,
}


# --- the reference's pool and the compared numbers ---------------------------

class RefPool:
    """The reference's own copy of the pool, laid out from the
    generator's output: float32 prices (the values the solve was given),
    0/1 incidence, masks; greedy objectives on the host."""

    def __init__(self, instances, instance_cfg: dict, device):
        m_pad, n_pad = instance_cfg["m_pad"], instance_cfg["n_pad"]
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


def windows(cap: Capture) -> List[dict]:
    """The captured solver windows, K1's launches and ``core.lp``'s
    policy windows alike: state in, the window's E and b, and its end
    iterate, carried E x and recorded trajectory (B, steps, n)."""
    out = []
    kept = {L["index"] for L in cap.k1}
    for L in cap.k1 + list(cap.k1_group.values()):
        a, o = L["a"], L["out"]
        out.append(dict(kind="k1", index=L["index"], it0=L["it0"],
                        window=L["window"], skip=L["skip"],
                        nside=a.ete is not None,
                        st={k: getattr(a, k) for k in _STATE},
                        E=a.E, b=a.b, x=o.x, ex=o.ex, traj=o.traj,
                        count=o.count, done=o.done, group=L.get("group"),
                        cluster=a.cluster, nth=L.get("nth"),
                        again="group" in L and L["index"] in kept))
    for C in cap.core:
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
    * ``iter_err_<group>``: the same at the end of each group's K1 launch
      on clusters (``compare["groups"]``, ``Capture``), over its own live
      instances alone, so that the launches with few live instances are
      not outweighed by those with many (inf where the captured batch
      ran no launch of the group);
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
    operand_bad, ex_err, errs, diag, groups = 0, 0.0, [], [], {}
    iters, stalls = [], []
    for W in wins:
        E, b, bad = _expected_operand(pool, idx, tuple(W["E"].shape),
                                      compacts)
        again = W.get("again", False)       # a window counted already
        operand_bad += 0 if again else bad
        if E is None:
            continue
        operand_bad += 0 if again else int(
            ((W["E"].float() != E).flatten(1).any(-1)
             | (W["b"] != b).any(-1)).sum())
        st = dict(W["st"], b=b)
        free = st["free"] > 0.5
        live = st["done"] == 0
        if not bool(live.any()):
            continue
        group = W.get("group")
        named = group is None and W["index"] in compare.get(W["kind"], ())
        tail = group is None and W["kind"] == "k1" and \
            W["index"] in compare.get("tail", ())
        recorded = W["traj"] is not None
        steps = S if recorded and S and named else W["window"]
        run = lambda prec: ref.window(
            st, E, solver_cfg, W["it0"], steps, W["skip"], W["nside"], prec,
            record=recorded and named)
        want = run("float64") if named or group or tail or witness \
            else None
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
        if group:
            groups[group] = float(e.median())
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
                         "group": group, "cluster": W.get("cluster"),
                         "nth": W.get("nth"),
                         "median": float(e.median()),
                         "f32_median": float(err(run("float32"))[live]
                                             .median()),
                         "ex_gap": float(gap[live].max())})
    out = {"window_operand": operand_bad, "ex_err": ex_err}
    if compare.get("k1") or compare.get("core"):
        e_all = torch.cat(errs) if errs else torch.zeros(0)
        out["iter_err"] = float(e_all.median()) if e_all.numel() \
            else float("inf")
    for g in compare.get("groups", ()):
        out[f"iter_err_{g}"] = groups.get(g, float("inf"))
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


def numbers(pool: RefPool, batches, captured: dict, rec, cfg: dict,
            ckpt, control: bool = False, witness: bool = False) -> dict:
    """Every compared number of a run; ``captured``: the captured batch's
    record (``idx``); ``rec``: the run's ``capture.Recorder``."""
    cap = rec.kind
    out = instance_numbers(pool, batches)
    idx = captured["idx"]
    out.update(select_numbers(pool, idx, cap.selects))
    it = torch.as_tensor(idx, device=pool.E.device)
    if rec.k2:
        out.update(check.k2_numbers(cfg["policy"], ckpt, rec.k2, cap.fixes,
                                    pool.b[it], pool.vmask[it], control))
    out.update(window_numbers(pool, idx, windows(cap), cap.compacts,
                              cfg["solver"], cap.compare, control, witness))
    return out
