"""Image segmentation (``instance.kind`` "seg"): per image the binary
grid QP ``min x^T A' x + b^T x + c`` over its pixels (A' = D - W of the
8-neighbour pair weights, b the unary cost difference), solved by the
port's learned early-fixing path (``train.l2f.l2f_solve_seg``: grid
windows of ``core.qp`` with the CG x-update, the policy K2 on sliding
windows, compaction to flat ``core.general`` windows, selection with
the descents).

The pool's images are synthetic, made from the seed by this module's
own copy of the port's image recipe (a smoothed Gaussian field plus
noise, quantised to 8 bits; the intensities are the levels over 263, as
the reference's loader scales them): ``height`` x ``width`` landscape,
or portrait (transposed) with probability ``portrait_share``, laid out
on a ``h_pad`` x ``w_pad`` grid with masks, as the program pads a mixed
batch.  The program builds its costs from the intensities itself
(``adapters.segmentation.make_problem``); the reference builds its own
(``reference_seg.costs``).

What decides ``correct`` (``numbers``), against the plain reference
(``reference_seg.py``, float64) on the images the benchmark made:

* every image solved in the window: its labelling is binary on the
  valid pixels, 0 on the padding and finite (``infeasible`` counts the
  images that are not: the run's ``failed``), and its reported energy is
  the labelling's (``obj_err``, relative; the costs are integers, so a
  sound float32 energy is exact); the mean energy against an ICM descent
  from the unary labelling (``gap_icm``, printed, not limited);
* in one batch drawn from the seed (the captured batch):
  - every policy scoring (K2) against the float64 policy on the
    unfolded rows (``k2_err``) and every fix decision against the
    reference's rule where its score is clear of the bar (``fix_diff``);
  - the problem each window saw: the grid window's costs, and each
    compaction's flat A, b_eff and slot order against the reference's
    restriction to the free pixels (``window_operand``, exact);
  - each window's first ``check.iter.steps`` iterations (at most the
    window's) from the program's own state against the float64
    iteration, each window held on its own number (the median over its
    live images of each one's largest error): the first window, on the
    grid, in ``iter_err_grid``, the largest of the later windows' (flat
    once compacted) in ``iter_err``;
  - the selection and the descents, rerun by the reference from the
    program's final state (``select_diff``).

``numbers(..., control=True)`` puts the reference in TF32 in the
program's place for K2 and the windows: the control that must fail.

Besides the faults of ``faults.NAMES``, ``FAULTS`` holds one of this
kind's own, ``grid-coupling-dropped``: the grid windows' x-update solves
without the stencil's neighbour couplings (``core.qp``'s CG on the
Jacobi diagonal alone), the flat windows stay sound;
``benchmark.control.readings(..., fault="grid-coupling-dropped")``
plants it.
"""

from __future__ import annotations

import dataclasses
import importlib
import types
from typing import List

import numpy as np
import torch

from .. import faults
from .. import reference as ref
from .. import reference_seg as rs

QP = "lpbox_admm_tpu_torch.core.qp"
GENERAL = "lpbox_admm_tpu_torch.core.general"
#: a fix decision is judged only where the reference's score lies
#: further than this from the bar
FIX_CLEAR = 1e-4
#: one-flip sweeps of the ICM descent behind ``gap_icm``
ICM_SWEEPS = 16


def image(rng, H: int, W: int) -> np.ndarray:
    """8-bit levels (H, W) of a synthetic image: a Gaussian random field
    smoothed at sigma H/12, scaled to [0, 1], plus noise of 0.05,
    clipped, times 255 rounded."""
    from scipy.ndimage import gaussian_filter
    f = gaussian_filter(rng.randn(H, W), sigma=H / 12)
    f = (f - f.min()) / (f.max() - f.min())
    f = np.clip(f + 0.05 * rng.randn(H, W), 0.0, 1.0)
    return np.round(255 * f).astype(np.uint8)


def make(seed: int, index: int, height: int, width: int,
         portrait_share: float, h_pad: int, w_pad: int) -> np.ndarray:
    """Pool image ``index`` under ``seed``: its levels, landscape
    (height, width) or, with probability ``portrait_share``, the same
    recipe transposed."""
    rng = np.random.RandomState(
        np.random.SeedSequence([seed, index]).generate_state(8))
    portrait = rng.rand() < portrait_share
    lv = image(rng, height, width)
    lv = np.ascontiguousarray(lv.T) if portrait else lv
    if lv.shape[0] > h_pad or lv.shape[1] > w_pad:
        raise ValueError(f"image {index} is {lv.shape}, over the grid "
                         f"({h_pad}, {w_pad})")
    return lv


def intensities(levels: np.ndarray) -> np.ndarray:
    """The intensities the solve is given: the levels over 263."""
    return levels.astype(np.float64) / 263.0


def save(path: str, instances) -> None:
    with open(path, "wb") as f:
        np.savez(f, levels=np.concatenate([lv.ravel() for lv in instances]),
                 shapes=np.array([lv.shape for lv in instances]))


def load(path: str):
    with np.load(path) as z:
        shapes = [tuple(int(d) for d in s) for s in z["shapes"]]
        cuts = np.cumsum([h * w for h, w in shapes])[:-1]
        return [a.reshape(s) for a, s in zip(np.split(z["levels"], cuts),
                                             shapes)]


def variables(instance) -> int:
    """An image's pixels."""
    return int(instance.size)


def upload(port, instances, instance_cfg: dict, device):
    """``gather(idx)``: the ``QpProblem`` of pool images ``idx``, from the
    program's own cost build of the whole pool on the device."""
    from lpbox_admm_tpu_torch.adapters import segmentation as seg
    from lpbox_admm_tpu_torch.core.qp import QpProblem
    from lpbox_admm_tpu_torch.ops.stencil import Stencil
    prob = seg.make_problem([intensities(lv) for lv in instances],
                            h_pad=instance_cfg["h_pad"],
                            w_pad=instance_cfg["w_pad"], device=device)

    def gather(idx):
        it = torch.as_tensor(idx, device=device)
        return QpProblem(stencil=Stencil(weights=prob.stencil.weights[it],
                                         degree=prob.stencil.degree[it]),
                         b=prob.b[it], const=prob.const[it],
                         mask=prob.mask[it])
    return gather


# --- what the recorder keeps ------------------------------------------------

class Capture:
    """What the recorder keeps of the segmentation path in the captured
    batch (module attributes of the program, wrapped in place by
    ``capture.Recorder``; it copies and synchronises nothing): each
    window (``core.qp.solve_window`` on the grid, ``core.general.
    solve_window`` on the flat problem) with its state in and out and
    its trajectory, each fix (``apply_fix`` of either) with the vector
    and the state it acts on, each compaction (``core.qp.compact``,
    ``core.general.compact_sparse``) with the state it reads and the
    problem it makes, and the selection (``core.qp.select_solution``).
    The scorer the CPU runs (``train.l2f.policy_scores``, the module's
    forward) is kept as K2's is, so that the check reads the same on
    either device.  ``steps``: the iterations compared a window
    (``check.iter.steps``)."""

    def __init__(self, rec, check_plan: dict, pick):
        self.rec = rec
        self.steps = int(check_plan["iter"]["steps"])
        self.windows: List[dict] = []
        self.fixes: List[dict] = []
        self.compacts: List[dict] = []
        self.selects: List[dict] = []

    def wraps(self):
        qp, general = (importlib.import_module(m) for m in (QP, GENERAL))
        return [(qp, "solve_window", self._window("grid")),
                (general, "solve_window", self._window("flat")),
                (qp, "apply_fix", self._fix("grid")),
                (general, "apply_fix", self._fix("flat")),
                (qp, "compact", self._compact("grid")),
                (general, "compact_sparse", self._compact("flat")),
                (qp, "select_solution", self._select),
                (self.rec.port["l2f"], "policy_scores", self._scores)]

    def batch(self):
        pass

    def work(self) -> dict:
        return {}

    def _level(self) -> int:
        return len(self.compacts) - 1

    def _window(self, kind):
        def wrap(fn):
            def solve_window(state, prob, cfg, window, record=True,
                             rule_fixing=False):
                res = fn(state, prob, cfg, window, record, rule_fixing)
                if self.rec.capturing:
                    self.windows.append(dict(
                        kind=kind, st=state, out=res[0], traj=res[1],
                        window=window, level=self._level(),
                        prob=prob if kind == "grid" else None))
                return res
            return solve_window
        return wrap

    def _fix(self, kind):
        def wrap(fn):
            def apply_fix(state, prob, vec, cfg, min_fix=None):
                if self.rec.capturing:
                    self.fixes.append(dict(kind=kind, free=state.free,
                                           done=state.done, vec=vec,
                                           x=state.x, level=self._level()))
                return fn(state, prob, vec, cfg, min_fix)
            return apply_fix
        return wrap

    def _compact(self, kind):
        def wrap(fn):
            def compact(state, prob, *args):
                res = fn(state, prob, *args)
                if self.rec.capturing:
                    gprob, idx = res[1], res[2]
                    self.compacts.append(dict(
                        kind=kind, free=state.free, fixed=state.fixed_val,
                        ri=gprob.A.row_idx, rv=gprob.A.row_val, b=gprob.b,
                        idx=idx))
                return res
            return compact
        return wrap

    def _select(self, fn):
        def select_solution(state, prob, repair_sweeps=0, pair_sweeps=0):
            res = fn(state, prob, repair_sweeps, pair_sweeps)
            if self.rec.capturing:
                self.selects.append(dict(state=state, sol=res[0],
                                         rounds=(repair_sweeps,
                                                 pair_sweeps)))
            return res
        return select_solution

    def _scores(self, fn):
        def policy_scores(model, rows, pcfg, row_chunk=8192):
            sig = fn(model, rows, pcfg, row_chunk)
            if self.rec.capturing:
                self.rec.k2.append((rows, sig))
            return sig
        return policy_scores


# --- faults ------------------------------------------------------------------

def _unchanged_window(fn, mod):
    """A window that returns its state unchanged (its trajectory the
    iterate it was given, repeated)."""
    def solve_window(state, prob, cfg, window, record=True,
                     rule_fixing=False):
        traj = state.x[..., None].expand(*state.x.shape, window) \
            .contiguous() if record else None
        return state, traj
    return solve_window


def _half_batch(fn, mod):
    """The entry solves the first half of the batch; the rest of its
    answers are zeros."""
    def solve(prob, *args, **kw):
        h = prob.batch // 2
        st = prob.stencil
        part = dataclasses.replace(
            prob, stencil=dataclasses.replace(st, weights=st.weights[:h],
                                              degree=st.degree[:h]),
            b=prob.b[:h], const=prob.const[:h], mask=prob.mask[:h])
        state, out = fn(part, *args, **kw)
        pad = lambda t: torch.cat([t, torch.zeros(
            (prob.batch - h,) + t.shape[1:], dtype=t.dtype, device=t.device)])
        return state, {k: pad(v) if torch.is_tensor(v) and v.shape[:1] == (h,)
                       else v for k, v in out.items()}
    return solve


def _flip_one_pixel(fn, mod):
    """Selection flips the last valid pixel of its first image's answer
    and reports the energy it had."""
    def select_solution(state, prob, *args, **kw):
        sol, e = fn(state, prob, *args, **kw)
        sol = sol.clone()
        j = int(torch.nonzero(prob.mask[0].reshape(-1))[-1])
        flat = sol[0].view(-1)
        flat[j] = 1.0 - flat[j]
        return sol, e
    return select_solution


def _coupling_dropped(cg, mod):
    """``core.qp``'s ``cg_ops`` with a ``pcg`` whose operator is its
    Jacobi diagonal alone (2 A'_ii + rho1 + rho2): the grid windows'
    x-update without the stencil's neighbour couplings (``core.qp``
    alone: the flat windows of ``core.general`` keep theirs)."""
    def pcg(matvec, rhs, x0, precond_diag, *args, **kw):
        return cg.pcg(lambda p: precond_diag * p, rhs, x0, precond_diag,
                      *args, **kw)
    return types.SimpleNamespace(pcg=pcg)


def _nudged_module_scores(fn, mod):
    """The module forward's scores (the CPU's scorer), each 1e-3 too
    high."""
    def policy_scores(model, rows, pcfg, row_chunk=8192):
        return fn(model, rows, pcfg, row_chunk) + 1e-3
    return policy_scores


#: fault -> [(module key of the port dict or module name, attribute,
#: wrapper maker)]
FAULTS = {
    "state-unchanged": [(QP, "solve_window", _unchanged_window),
                        (GENERAL, "solve_window", _unchanged_window)],
    "half-batch": [("l2f", "l2f_solve_seg", _half_batch)],
    "answer-altered": [(QP, "select_solution", _flip_one_pixel)],
    "score-altered": faults.SCORE_ALTERED + [
        ("l2f", "policy_scores", _nudged_module_scores)],
    "grid-coupling-dropped": [(QP, "cg_ops", _coupling_dropped)],
}


# --- the reference's pool and the compared numbers ---------------------------

class RefPool:
    """The reference's own costs of the pool, float64 on the device, laid
    out on the configuration's grid with masks; the ICM energies on
    demand."""

    def __init__(self, instances, instance_cfg: dict, device):
        Hp, Wp = instance_cfg["h_pad"], instance_cfg["w_pad"]
        P = len(instances)
        self.W = torch.zeros((P, 8, Hp, Wp), dtype=torch.float64,
                             device=device)
        self.b = torch.zeros((P, Hp, Wp), dtype=torch.float64, device=device)
        self.c = torch.zeros((P,), dtype=torch.float64, device=device)
        self.mask = torch.zeros((P, Hp, Wp), dtype=torch.bool, device=device)
        for i, lv in enumerate(instances):
            W, b, c = rs.costs(intensities(lv))
            h, w = lv.shape
            self.W[i, :, :h, :w] = W.to(device)
            self.b[i, :h, :w] = b.to(device)
            self.c[i] = c
            self.mask[i, :h, :w] = True
        self._icm = None

    def icm(self) -> torch.Tensor:
        """Per image the energy of ``ICM_SWEEPS`` one-flip sweeps from the
        unary labelling (1 where b < 0)."""
        if self._icm is None:
            x0 = ((self.b < 0) & self.mask).double()
            x = rs.one_flip(self.W, self.b, self.mask, x0, ICM_SWEEPS)
            self._icm = rs.energy(self.W, self.b, self.c, x)
        return self._icm

    def take(self, idx):
        it = torch.as_tensor(idx, device=self.b.device)
        return self.W[it], self.b[it], self.c[it], self.mask[it]


def instance_numbers(pool: RefPool, batches: List[dict]) -> dict:
    """``infeasible``, ``obj_err``, ``gap_icm`` over every batch (each a
    dict with ``idx``, ``sol`` (B, H, W) and ``obj`` (B,))."""
    bad, err, gap, count = 0, 0.0, 0.0, 0
    icm = pool.icm()
    for bt in batches:
        W, b, c, mask = pool.take(bt["idx"])
        s = bt["sol"].double()
        fin = torch.isfinite(s).all(-1).all(-1)
        binary = ((s == 0) | (s == 1) | ~mask).all(-1).all(-1)
        pad = ((s != 0) & ~mask).any(-1).any(-1)
        bad += int((~fin | ~binary | pad).sum())
        s0 = torch.where(torch.isfinite(s), s, torch.zeros_like(s))
        e_ref = rs.energy(W, b, c, s0)
        obj = bt["obj"].double()
        e = (obj - e_ref).abs() / e_ref.abs().clamp_min(1.0)
        e = torch.where(torch.isfinite(obj) & fin, e,
                        torch.full_like(e, np.inf))
        err = max(err, float(e.max()))
        i = icm[torch.as_tensor(bt["idx"], device=icm.device)]
        gap += float(((e_ref - i) / i.abs().clamp_min(1.0)).sum())
        count += len(bt["idx"])
    return {"infeasible": bad, "obj_err": err, "gap_icm": gap / max(count, 1)}


def select_numbers(pool: RefPool, idx, selects: List[dict]) -> dict:
    """``select_diff``: images whose selected labelling differs from the
    reference's selection and descents from the same final state."""
    W, b, c, mask = pool.take(idx)
    diff = 0
    for s in selects:
        st = s["state"]
        if st.x.shape != b.shape:
            diff += b.shape[0]          # the selection saw another batch
            continue
        rnd = lambda v: torch.where(st.free, (v >= 0.5).double(),
                                    st.fixed_val.double())
        want, _ = rs.select(W, b, c, mask, rnd(st.x), rnd(st.best_sol),
                            *s["rounds"])
        diff += int((want != s["sol"].double()).flatten(1).any(-1).sum())
    return {"select_diff": diff}


def _maps(cap: Capture):
    """Per compaction level: slot -> flat grid position (B, n_k), and the
    grid's free mask and fixed values (B, H W) as they stood when it
    was made (the fixes made inside the flat problems carried up)."""
    out = []
    for c in cap.compacts:
        B = c["idx"].shape[0]
        if c["kind"] == "grid":
            free = c["free"].reshape(B, -1)
            fixed = c["fixed"].reshape(B, -1).double()
            gidx = c["idx"]
        else:
            g0, free0, fixed0 = out[-1]
            free = free0.scatter(1, g0, c["free"])
            fixed = fixed0.scatter(1, g0, c["fixed"].double())
            gidx = torch.gather(g0, 1, c["idx"])
        out.append((gidx, free, fixed))
    return out


def _grid_of(maps, level: int, free_c, fixed_c):
    """The grid's free mask and fixed values (B, H W) of a flat state at
    compaction ``level``."""
    gidx, free, fixed = maps[level]
    return (free.scatter(1, gidx, free_c),
            fixed.scatter(1, gidx, fixed_c.double()))


def operand_numbers(pool: RefPool, idx, cap: Capture, maps) -> int:
    """Images whose windows saw another problem than the reference's:
    the grid windows' costs, and each compaction's free slots (in grid
    order), flat A'_ff and b_eff against ``reference_seg.restrict`` of
    the free pixels (exact: the weights and costs are small
    integers)."""
    W, b, c, mask = pool.take(idx)
    B, H, Wd = b.shape
    n = H * Wd
    bad = torch.zeros((B,), dtype=torch.bool, device=b.device)
    for w in cap.windows:
        if w["kind"] != "grid":
            continue
        p = w["prob"]
        if p.b.shape != b.shape:
            return B
        bad |= (p.stencil.weights.double() != W).flatten(1).any(-1) \
            | (p.b.double() != b).flatten(1).any(-1) \
            | (p.const.double() != c) | (p.mask != mask).flatten(1).any(-1)
    for k, cp in enumerate(cap.compacts):
        gidx, free, fixed = maps[k]
        if gidx.shape[0] != B:
            return B
        free3, fixed3 = free.reshape(B, H, Wd), fixed.reshape(B, H, Wd)
        rows, b_eff = rs.restrict(W, b, free3, fixed3)
        nf = free.sum(-1)
        for i in range(B):
            k_i = int(nf[i])
            if k_i > gidx.shape[1] or not torch.equal(gidx[i, :k_i],
                                                      rows[i][0]):
                bad[i] = True
                continue
            slots = torch.arange(k_i, device=b.device)
            on = torch.zeros(gidx.shape[1], dtype=torch.bool,
                             device=b.device)
            on[:k_i] = True
            ri, rv = cp["ri"][i], cp["rv"][i]
            r = slots[:, None].expand(k_i, ri.shape[-1])
            keys = gidx[i][r.reshape(-1)], gidx[i][ri[:k_i].reshape(-1)]
            got = rs.canonical(keys[0], keys[1], rv[:k_i].reshape(-1), n)
            want = rs.canonical(*rows[i][1], n)
            same = got[0].shape == want[0].shape and \
                torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            b_got = cp["b"][i, :k_i].double()
            b_want = b_eff[i].reshape(-1)[gidx[i, :k_i]]
            bad[i] |= not (same and torch.equal(b_got, b_want))
    return int(bad.sum())


def _grid_state(w, maps, pool_b, W):
    """A captured window's state in, on the grid, as the reference
    iterates it: x, z1, z2, the free mask, b_eff from the reference's
    costs and the fixed values, the objective ring, done, it."""
    st = w["st"]
    B, H, Wd = pool_b.shape
    if w["kind"] == "grid":
        free, fixed = st.free, st.fixed_val.double()
        x, z1, z2 = st.x, st.z1, st.z2
    else:
        gidx = maps[w["level"]][0]
        free, fixed = _grid_of(maps, w["level"], st.free, st.fixed_val)
        free, fixed = free.reshape(B, H, Wd), fixed.reshape(B, H, Wd)
        put = lambda v: torch.zeros((B, H * Wd), dtype=torch.float64,
                                    device=v.device).scatter(
            1, gidx, v.double()).reshape(B, H, Wd)
        x, z1, z2 = put(st.x), put(st.z1), put(st.z2)
    v = torch.where(free, torch.zeros_like(fixed), fixed)
    return {"x": x, "z1": z1, "z2": z2, "free": free,
            "b_eff": pool_b + 2.0 * rs.apply(W, v), "ring": st.obj_ring,
            "count": st.obj_count, "done": st.done, "it": st.it}


def window_numbers(pool: RefPool, idx, cap: Capture, maps, cfg: dict,
                   control: bool, witness: bool) -> dict:
    """Each captured window run by the reference in float64 from the
    program's state at its start for min(window, ``cap.steps``) steps,
    and held on its own number: the median over its live images of each
    one's largest trajectory error on its free pixels (inf where the
    window saw another batch or its trajectory is not finite).  A pooled
    median would let one window's fault hide under the others' images,
    so ``iter_err_grid`` is the first window's (on the grid: the stencil
    and its CG x-update) and ``iter_err`` the largest of the later
    windows' (each inf where none of its windows had a live image).
    ``witness`` adds each window's median for the reference in
    float32."""
    W, b, c, mask = pool.take(idx)
    B, H, Wd = b.shape
    meds, diag = [], []
    for w in cap.windows:
        if w["st"].x.shape[0] != B or w["traj"] is None:
            meds.append(np.inf)
            continue
        st = _grid_state(w, maps, b, W)
        steps = min(w["window"], cap.steps)
        run = lambda prec: rs.iterate(st, W, cfg["solver"], steps, prec,
                                      record=True)["traj"]
        want = run("float64")
        live = ~st["done"].bool()
        if w["kind"] == "grid":
            free = st["free"] & mask
            got = run("tf32") if control else w["traj"][..., :steps]
            pick = lambda t: t
        else:
            gidx = maps[w["level"]][0]
            free = w["st"].free
            pick = lambda t: torch.gather(
                t.reshape(B, H * Wd, steps), 1,
                gidx[..., None].expand(-1, -1, steps))
            got = pick(run("tf32")) if control else w["traj"][..., :steps]
            want = pick(want)
        err = lambda g: _traj_err(g, want, free)
        e = err(got)[live]
        meds.append(float(e.median()) if e.numel() else None)
        if witness and e.numel():
            diag.append({"kind": w["kind"], "level": w["level"],
                         "it0": int(w["st"].it), "steps": steps,
                         "live": int(live.sum()),
                         "median": float(e.median()),
                         "f32_median": float(err(pick(run("float32")))
                                             [live].median())})
    worst = lambda ms: max((m for m in ms if m is not None),
                           default=float("inf"))
    out = {"iter_err_grid": worst(meds[:1]), "iter_err": worst(meds[1:])}
    if witness:
        out["windows"] = diag
    return out


def _traj_err(got, want, free):
    """Per image: the largest |got - want| over the steps of two
    trajectories (..., steps) and the image's free entries (inf where
    got is not finite)."""
    d = torch.where(free[..., None], (got.double() - want.double()).abs(),
                    torch.zeros((), dtype=torch.float64, device=got.device))
    e = d.flatten(1).amax(-1)
    return torch.where(torch.isfinite(got).flatten(1).all(-1), e,
                       torch.full_like(e, np.inf))


def k2_numbers(pool: RefPool, idx, cap: Capture, captures, maps, cfg: dict,
               ckpt: str, control: bool) -> dict:
    """``k2_err`` over the captured scorings (sliding rows unfolded, the
    float64 policy; with ``control`` the TF32 one in the program's
    place) and ``fix_diff`` over the captured fix decisions (window w's
    scoring precedes its fix): the reference's rule on its own scores,
    margins ``1 - confidence`` shrunk by the |b|-rank damage gate, on
    the grid also by the boundary gate of the window's end iterate;
    judged on live free pixels where the score is clear of every bar."""
    if not captures:
        return {}
    pol = cfg["policy"]
    T, C = pol["node_size"], pol["chunk_dim"]
    dev = captures[0][0].device
    mk = lambda prec: ref.Policy(ckpt, T, C, pol["pe_dim"], pol["n_heads"],
                                 dev, prec)
    truth = mk("float64")
    stand_in = mk("tf32") if control else None
    err, sigs = 0.0, []
    for rows, sig in captures:
        u = rs.unfold(rows, T, C)
        want = truth.scores(u)
        got = stand_in.scores(u) if control else sig
        err = max(err, float((got.double() - want).abs().max()))
        sigs.append(want)
    out = {"k2_err": err}
    if not cap.fixes:
        return out
    W, b, c, mask = pool.take(idx)
    B = b.shape[0]
    if pol.get("damage_rank_floor", 0.0) > 0:
        raise ValueError("the reference's margins take no rank floor")
    base = ref.fix_margins(b.reshape(B, -1), mask.reshape(B, -1),
                           pol["fix_confidence"], pol["damage_gate"])
    diff = 0
    for f, sig in zip(cap.fixes, sigs):
        vec = f["vec"]
        if vec.shape[0] != B or sig.numel() != vec.numel():
            diff += int(mask.sum())         # scored another batch
            continue
        sig = sig.reshape(vec.shape)
        if f["kind"] == "grid":
            m = rs.gated_margins(base.reshape(b.shape), f["x"], mask,
                                 pol.get("boundary_gate", 0.0),
                                 pol.get("boundary_band", 0))
            live = f["free"] & mask & ~f["done"][:, None, None]
        else:
            m = torch.gather(base, 1, maps[f["level"]][0])
            live = f["free"] & ~f["done"][:, None]
        want = rs.fix_rule(sig, m)
        clear = ((sig - (1.0 - m)).abs() > FIX_CLEAR) & \
            ((sig - m).abs() > FIX_CLEAR)
        diff += int(((vec.double() != want) & clear & live).sum())
    out["fix_diff"] = diff
    return out


def numbers(pool: RefPool, batches, captured: dict, rec, cfg: dict,
            ckpt, control: bool = False, witness: bool = False) -> dict:
    """Every compared number of a run; ``captured``: the captured batch's
    record (``idx``); ``rec``: the run's ``capture.Recorder``."""
    cap = rec.kind
    idx = captured["idx"]
    maps = _maps(cap)
    out = instance_numbers(pool, batches)
    out.update(select_numbers(pool, idx, cap.selects))
    out.update(k2_numbers(pool, idx, cap, rec.k2, maps, cfg, ckpt, control))
    out["window_operand"] = operand_numbers(pool, idx, cap, maps)
    out.update(window_numbers(pool, idx, cap, maps, cfg, control, witness))
    return out
