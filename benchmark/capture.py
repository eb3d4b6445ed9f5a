"""What the benchmark reads from inside the program while it runs.

``Recorder`` wraps a few of the program's functions in place (module
attributes, restored by ``close``) and keeps references to their
operands and results; it copies nothing and synchronises nothing, so
the timed path runs as it would:

* K1's launch (``ops.fused_lp.window_cuda``, or ``window_plain`` on a
  CPU tensor): in a captured batch, the chosen launches' operands and
  outputs for the check; in a traced run, every launch's sizes and
  iteration counts for the work count;
* the ``core.lp`` windows of a policy phase (``core.lp.solve_window``,
  where K1 cannot hold the problem): state in and out and the recorded
  trajectory in a captured batch;
* the policy's scoring (``train.l2f.policy_scores_fused``): rows and
  scores in a captured batch, the row count in a traced run;
* ``core.lp.apply_fix``, ``core.lp.compact`` and
  ``core.lp.select_solution`` in a captured batch: the fix decisions,
  the reduced problem and the selection's inputs and output.
"""

from __future__ import annotations

from typing import Dict, List


class Recorder:
    def __init__(self, port: Dict[str, object], trace: bool,
                 k1_keep=frozenset({0, 1, 2, 3})):
        self.port = port
        self.trace = trace
        self.k1_keep = set(k1_keep)
        self.capturing = False
        self.k1: List[dict] = []
        self.core: List[dict] = []
        self.k2: List[tuple] = []
        self.fixes: List[tuple] = []
        self.compacts: List[dict] = []
        self.selects: List[dict] = []
        self.k1_work: List[tuple] = []
        self.k2_rows: List[tuple] = []
        self._k1_i = 0
        self._saved = []
        fl, l2f, lp = port["fused_lp"], port["l2f"], port["lp"]
        for mod, name, make in ((fl, "window_cuda", self._k1),
                                (fl, "window_plain", self._k1),
                                (lp, "solve_window", self._core),
                                (l2f, "policy_scores_fused", self._k2),
                                (lp, "apply_fix", self._fix),
                                (lp, "compact", self._compact),
                                (lp, "select_solution", self._select)):
            fn = getattr(mod, name)
            self._saved.append((mod, name, fn))
            setattr(mod, name, make(fn))

    def close(self):
        for mod, name, fn in reversed(self._saved):
            setattr(mod, name, fn)
        self._saved = []

    def batch(self, capture: bool):
        """Start a batch; ``capture``: keep this batch's operands."""
        self.capturing = capture
        self._k1_i = 0

    def _k1(self, fn):
        def window(a, cfg, it0, window, skip_cvg_at=None, record=False):
            out = fn(a, cfg, it0, window, skip_cvg_at, record)
            i = self._k1_i
            self._k1_i += 1
            if self.trace and a.E.is_cuda:
                self.k1_work.append((
                    a.rmask.sum(-1), a.free.sum(-1), a.count, a.done,
                    out.count, out.done, it0, window, a.ete is not None,
                    window if record else 0, cfg.incumbent_stride))
            if self.capturing and i in self.k1_keep:
                self.k1.append(dict(a=a, out=out, it0=it0, window=window,
                                    skip=skip_cvg_at, record=record,
                                    cfg=cfg, index=i))
            return out
        return window

    def _core(self, fn):
        def solve_window(state, prob, cfg, window, record=True,
                         skip_cvg_at=None, rule_fixing=False):
            res = fn(state, prob, cfg, window, record, skip_cvg_at,
                     rule_fixing)
            if self.capturing:
                self.core.append(dict(state=state, E=prob.E, b=prob.b,
                                      rmask=prob.row_mask, out=res[0],
                                      traj=res[1], it0=state.it,
                                      window=window, skip=skip_cvg_at,
                                      record=record, cfg=cfg,
                                      index=len(self.core)))
            return res
        return solve_window

    def _k2(self, fn):
        def scores(pk, rows, pcfg, op=None):
            sig = fn(pk, rows, pcfg, op)
            if self.trace and rows.is_cuda:
                self.k2_rows.append(tuple(rows.shape))
            if self.capturing:
                self.k2.append((rows, sig))
            return sig
        return scores

    def _fix(self, fn):
        def apply_fix(state, prob, vec, cfg, *args, **kw):
            if self.capturing:
                self.fixes.append((state.free, state.done, vec))
            return fn(state, prob, vec, cfg, *args, **kw)
        return apply_fix

    def _compact(self, fn):
        def compact(state, prob, cfg, n_new, m_new=None):
            res = fn(state, prob, cfg, n_new, m_new)
            if self.capturing:
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
            if self.capturing:
                self.selects.append(dict(
                    sol_last=sol_last, sol_best=sol_best, rounds=(
                        repair_rounds, swap_rounds, drop_rounds),
                    sol=res[0], shape=tuple(prob.E.shape)))
            return res
        return select_solution
