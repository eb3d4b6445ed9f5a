"""Faults planted under the timed path, each of which the check has to
catch (``correct`` false): the tests plant them at toy size on the CPU,
``python3 -m benchmark.control --fault NAME`` at a cell's own size on
the card, where they give the readings the limits are set below."""

import dataclasses

import torch


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


def _nudged_scores(fn, mod):
    """The policy's scores, each 1e-3 too high."""
    def scores(pk, rows, pcfg, op=None):
        return fn(pk, rows, pcfg, op) + 1e-3
    return scores


#: fault -> (module key of the port dict, attribute, wrapper maker); the
#: K1 fault replaces both of K1's launch paths
FAULTS = {
    "state-unchanged": [("fused_lp", "window_cuda", _unchanged_window),
                        ("fused_lp", "window_plain", _unchanged_window)],
    "half-batch": [("l2f", "l2f_solve_compact", _half_batch),
                   ("fused_lp", "solve_fused", _half_batch)],
    "answer-altered": [("lp", "select_solution", _flip_one_answer)],
    "score-altered": [("l2f", "policy_scores_fused", _nudged_scores)],
}


def plant(name: str, port: dict, setattr_=setattr):
    """Plant fault ``name`` under the timed path: each listed function
    of the program replaced by its faulty wrapper (``setattr_``: e.g. a
    test's monkeypatch.setattr, which undoes it)."""
    for key, attr, make in FAULTS[name]:
        mod = port[key]
        setattr_(mod, attr, make(getattr(mod, attr), mod))
