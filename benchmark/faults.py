"""Faults planted under the timed path, each of which the check has to
catch (``correct`` false): the tests plant them at toy size on the CPU,
``python3 -m benchmark.control --fault NAME`` at a cell's own size on
the card, where they give the readings the limits are set below.

The faults (``NAMES``) are the same for every kind; each kind module
says which apply to it and which of its program functions each replaces
(its ``FAULTS``).  The policy's scores are shared by every kind that
scores with K2, so their fault is here (``SCORE_ALTERED``)."""

import importlib

#: fault -> what it breaks
NAMES = {
    "state-unchanged": "a solver window returns its state unchanged",
    "share-lost": "a launch that spreads an instance over several blocks "
                  "loses the first block's share of the matrix rows",
    "half-batch": "the entry solves half of the batch; the rest of its "
                  "answers are left at their start",
    "answer-altered": "an answer is altered where it is produced",
    "score-altered": "the policy's scores, each 1e-3 too high",
}


def _nudged_scores(fn, mod):
    """The policy's scores, each 1e-3 too high."""
    def scores(pk, rows, pcfg, op=None):
        return fn(pk, rows, pcfg, op) + 1e-3
    return scores


#: the K2 fault, for a kind's ``FAULTS``
SCORE_ALTERED = [("l2f", "policy_scores_fused", _nudged_scores)]


def plant(name: str, port: dict, kind, setattr_=setattr):
    """Plant fault ``name`` under the timed path of kind module ``kind``:
    each function of the program it lists (by a key of the port dict or
    a module's dotted name) replaced by its faulty wrapper (``setattr_``:
    e.g. a test's monkeypatch.setattr, which undoes it).  A fault the
    kind does not list is refused."""
    if name not in kind.FAULTS:
        raise ValueError(f"fault {name!r} does not apply to kind "
                         f"{kind.__name__.rsplit('.', 1)[-1]!r}; it has "
                         f"{sorted(kind.FAULTS)}")
    for key, attr, make in kind.FAULTS[name]:
        mod = port[key] if key in port else importlib.import_module(key)
        setattr_(mod, attr, make(getattr(mod, attr), mod))
