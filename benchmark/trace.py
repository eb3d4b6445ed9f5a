"""The device trace of a traced run: ``torch.profiler`` over the window,
reduced to the device's busy time, each kernel's time, the operations
that took most time and the longest idle stretches by what the host was
doing."""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Tuple

from . import stats

#: the name of the benchmark's own span around each batch
BATCH_SPAN = "bench.batch"


def _times(e) -> Tuple[int, int]:
    try:
        s, d = e.start_ns(), e.duration_ns()
    except AttributeError:             # older profilers: microseconds
        s, d = int(e.start_us() * 1000), int(e.duration_us() * 1000)
    return s, s + d


def reduce(prof, kernels: Dict[str, Tuple[str, ...]]) -> dict:
    """Busy and window seconds, seconds per kernel group of ``kernels``
    (name substrings), and the breakdown, from a finished profile."""
    dev: List[Tuple[int, int, str]] = []
    cpu: List[Tuple[int, int, str]] = []
    marks: List[Tuple[int, int]] = []
    for e in prof.profiler.kineto_results.events():
        s, t = _times(e)
        name = e.name()
        if e.device_type().name == "CUDA":
            # kernels, copies and fills; not the device-side copies of
            # the host's annotations
            if name != BATCH_SPAN and not e.is_user_annotation():
                dev.append((s, t, name))
        elif name == BATCH_SPAN:
            marks.append((s, t))
        else:
            cpu.append((s, t, name))
    if not marks:
        raise RuntimeError("the trace holds no batch span")
    lo, hi = min(m[0] for m in marks), max(m[1] for m in marks)
    inside = [(max(s, lo), min(t, hi), n) for s, t, n in dev
              if t > lo and s < hi]
    busy = stats.union_length(((s, t) for s, t, _ in inside), lo, hi)
    by_name: Dict[str, float] = defaultdict(float)
    for s, t, n in inside:
        by_name[n] += (t - s) / 1e9
    group_s = {g: sum(v for n, v in by_name.items()
                      if any(p in n for p in pats))
               for g, pats in kernels.items()}
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (hi - lo) / 1e9, "busy_s": busy / 1e9,
            "kernel_s": group_s,
            "device_ops": [[n, v] for n, v in top_ops],
            "idle_gaps": _idle_by_host(inside, cpu, marks, lo, hi)}


def _idle_by_host(dev, cpu, marks, lo, hi, longest=2000):
    """Idle seconds of the device by the innermost host operation under
    way when each idle stretch began (the ``longest`` stretches; "python"
    where only the batch span covers it, "between batches" where none
    does)."""
    idle = sorted(stats.gaps(((s, t) for s, t, _ in dev), lo, hi),
                  key=lambda g: g[0] - g[1])[:longest]
    cpu = sorted(cpu)
    starts = [c[0] for c in cpu]
    marks = sorted(marks)
    mark_starts = [m[0] for m in marks]
    out: Dict[str, float] = defaultdict(float)
    for g0, g1 in idle:
        label = None
        i = bisect.bisect_right(starts, g0)
        for j in range(i - 1, max(i - 4000, -1), -1):
            s, t, n = cpu[j]
            if t > g0:
                label = n
                break
        if label is None:
            k = bisect.bisect_right(mark_starts, g0) - 1
            label = "python" if k >= 0 and marks[k][1] > g0 \
                else "between batches"
        out[label] += (g1 - g0) / 1e9
    return [[n, v] for n, v in sorted(out.items(), key=lambda kv: -kv[1])
            [:10]]
