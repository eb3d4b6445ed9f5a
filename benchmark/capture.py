"""What the benchmark reads from inside the program while it runs.

``Recorder`` wraps a few of the program's functions in place (module
attributes, restored by ``close``) and keeps references to their
operands and results; it copies nothing and synchronises nothing, so
the timed path runs as it would.  It wraps the policy's scoring
(``train.l2f.policy_scores_fused``, K2), shared by every kind that
scores with K2: rows and scores in a captured batch, the row count in a
traced run.  The rest is the kind's (``kinds/<kind>.py``, ``Capture``):
the solver's windows, fixes and selection of its problem family, kept
under ``rec.kind``.
"""

from __future__ import annotations

from typing import Dict, List


class Recorder:
    def __init__(self, port: Dict[str, object], trace: bool, kind,
                 check: dict, pick):
        """``kind``: the kind module; ``check``: the traffic's plan of
        what to capture; ``pick``: the seed's stream the kind draws its
        captured launches from."""
        self.port = port
        self.trace = trace
        self.capturing = False
        self.k2: List[tuple] = []
        self.k2_rows: List[tuple] = []
        self.kind = kind.Capture(self, check, pick)
        self._saved = []
        for mod, name, make in [(port["l2f"], "policy_scores_fused",
                                 self._k2)] + self.kind.wraps():
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
        self.kind.batch()

    def _k2(self, fn):
        def scores(pk, rows, pcfg, op=None):
            sig = fn(pk, rows, pcfg, op)
            if self.trace and rows.is_cuda:
                self.k2_rows.append(tuple(rows.shape))
            if self.capturing:
                self.k2.append((rows, sig))
            return sig
        return scores
