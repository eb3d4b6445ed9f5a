"""The port's tracer: spans, counters and counted host reads (the port
of the JAX package's ``utils/profiling.py``, extended).

``PhaseTimer`` accumulates time per named span.  A timer made for a
CUDA device times each span by a pair of CUDA events on the device's
current stream and never synchronises: the span's time runs from the
point where the host reached it to the last work it enqueued, and is
read once the last event has completed (``finish``).  On the CPU a
span's time is the host clock.  While ``torch.profiler`` records, each
span is also a ``record_function`` range under its own name, on the
clock of the device trace.

The program's instrumented sites call the module functions ``span``,
``read``, ``count`` and ``note``.  They act only while a timer is
active (``with timer:``); with none active a span is one shared no-op
context, a read is the plain read it stands for and a count or a note
nothing, at the cost of one ``None`` check:

    t = PhaseTimer(device)
    with t:                      # the solve's spans, counters and reads
        state = solve(prob)
    t.finish()                   # one wait, on the last event
    t.sums()                     # seconds per span name of the solve

``reduce_timings`` turns a finished solve's timer into the ``timings``
dict that the solve functions fill (``train.l2f``).

``phase`` is ``span`` on the timer itself, active or not, and ``sync``
the explicit device synchronise of the JAX package's API:

    t = PhaseTimer()
    with t.phase("solve"):
        state = solve(prob)
        t.sync(state.x)
    print(t.report())

The JAX package's ``enable_compile_cache`` (a persistent XLA cache) has
no counterpart: the port's kernels are built once into
``lpbox_admm_tpu_torch/_build`` and reused (``kernels/build.py``).
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import time
from typing import Callable, Dict, List, Optional, TypeVar

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

T = TypeVar("T")

#: the timer the instrumented sites report to (``with timer:``), or None;
#: a context variable, so a thread sees only the timer it activated
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "lpbox_admm_tpu_torch.tracer", default=None)
_NULL = contextlib.nullcontext()
_SOLVES = itertools.count(1)
#: the prefix of a host read's counter (``read``)
READ = "host.read:"


def sync(*tensors: torch.Tensor):
    """Wait for the card to finish the work behind ``tensors`` (a no-op
    for CPU tensors)."""
    for dev in {t.device for t in tensors if t.is_cuda}:
        torch.cuda.synchronize(dev)


def tracing(timer: Optional["PhaseTimer"]):
    """``with tracing(timer):`` activates ``timer``; with None, nothing."""
    return _NULL if timer is None else timer


def span(name: str):
    """A span of the active timer, or the shared no-op context."""
    t = _ACTIVE.get()
    return _NULL if t is None else t.span(name)


def read(site: str, fn: Callable[..., T], *args) -> T:
    """``fn(*args)``: a device-to-host read (``bool``, ``int``, or a
    library call that reads back or synchronises), counted under
    ``site`` by the active timer."""
    t = _ACTIVE.get()
    if t is None:
        return fn(*args)
    return t.read(site, fn, *args)


def count(name: str, k: int = 1) -> None:
    """Add ``k`` to the active timer's counter ``name`` (a host value the
    site already holds: no read)."""
    t = _ACTIVE.get()
    if t is not None:
        t.count(name, k)


def note(name: str, value) -> None:
    """Append ``value`` to the active timer's list ``notes[name]`` (a
    host value the site already holds: no read)."""
    t = _ACTIVE.get()
    if t is not None:
        t.notes.setdefault(name, []).append(value)


def _range(name: str):
    """A ``record_function`` range while the profiler records, else
    None."""
    if not _autograd_profiler._is_profiler_enabled:
        return None
    rf = _autograd_profiler.record_function(name)
    rf.__enter__()
    return rf


class Span:
    """One span: its name, the span it ran inside (``parent``), the solve
    it belongs to, host start and end (``time.perf_counter``), its CUDA
    events and, once resolved, its seconds."""

    __slots__ = ("timer", "name", "parent", "solve", "t0", "t1", "ev0",
                 "ev1", "seconds", "_rf")

    def __init__(self, timer: "PhaseTimer", name: str):
        self.timer, self.name = timer, name
        self.ev0 = self.ev1 = self.seconds = self._rf = None

    def __enter__(self):
        tm = self.timer
        self.parent = tm._stack[-1] if tm._stack else None
        self.solve = tm.solve
        tm._stack.append(self)
        if tm.device is not None:
            self.ev0 = tm._event()
        self._rf = _range(self.name)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        tm = self.timer
        if self.ev0 is not None:
            self.ev1 = tm._last = tm._event()
        tm._stack.pop()
        tm.counts[self.name] = tm.counts.get(self.name, 0) + 1
        tm.spans.append(self)
        if self.ev0 is None:
            tm._resolve(self, self.t1 - self.t0)
        else:
            tm._pending.append(self)
        return False


class PhaseTimer:
    """Accumulating span timer, counters and counted host reads.

    ``device``: a CUDA device times spans by events (else the host
    clock).  ``totals`` and ``counts``: seconds and spans per name over
    every resolved span; ``counters``: counts by name, host reads under
    ``"host.read:<site>"``; ``read_wait``: seconds the host spent in its
    counted reads; ``notes``: values by name (``note``); ``spans``:
    every span, kept in memory."""

    def __init__(self, device=None):
        dev = None if device is None else torch.device(device)
        self.device = dev if dev is not None and dev.type == "cuda" \
            else None
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.counters: Dict[str, int] = {}
        self.read_wait = 0.0
        self.notes: Dict[str, list] = {}
        self.spans: List[Span] = []
        self.solve = 0
        self._stack: List[Span] = []
        self._pending: List[Span] = []
        self._last = None
        self._tokens: List[contextvars.Token] = []

    def __enter__(self):
        """Make this the active timer for a new solve."""
        self.solve = next(_SOLVES)
        self._tokens.append(_ACTIVE.set(self))
        return self

    def __exit__(self, *exc):
        _ACTIVE.reset(self._tokens.pop())
        return False

    def _event(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def _resolve(self, s: Span, seconds: float) -> None:
        s.seconds = seconds
        self.totals[s.name] = self.totals.get(s.name, 0.0) + seconds

    def span(self, name: str) -> Span:
        return Span(self, name)

    phase = span

    def count(self, name: str, k: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + k

    def read(self, site: str, fn: Callable[..., T], *args) -> T:
        rf = _range(READ + site)
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            self.read_wait += time.perf_counter() - t0
            if rf is not None:
                rf.__exit__(None, None, None)
            self.count(READ + site)

    def reads(self) -> Dict[str, int]:
        """Host reads per site."""
        return {k[len(READ):]: v for k, v in self.counters.items()
                if k.startswith(READ)}

    def finish(self) -> "PhaseTimer":
        """Wait for the last event (the one synchronise) and resolve the
        event-timed spans."""
        if self._pending:
            self._last.synchronize()
            for s in self._pending:
                self._resolve(s, s.ev0.elapsed_time(s.ev1) / 1e3)
            self._pending = []
        return self

    def sums(self, solve: Optional[int] = None) -> Dict[str, float]:
        """Seconds per span name over the resolved spans of ``solve``
        (default: the latest)."""
        solve = self.solve if solve is None else solve
        out: Dict[str, float] = {}
        for s in self.spans:
            if s.solve == solve and s.seconds is not None:
                out[s.name] = out.get(s.name, 0.0) + s.seconds
        return out

    sync = staticmethod(sync)

    def report(self) -> str:
        self.finish()
        total = sum(self.totals.values())
        lines = []
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            pct = 100.0 * t / total if total else 0.0
            lines.append(f"{name:>20s}: {t:8.3f}s ({pct:5.1f}%) "
                         f"x{self.counts[name]}")
        lines.append(f"{'TOTAL':>20s}: {total:8.3f}s")
        for name, k in sorted(self.counters.items()):
            lines.append(f"{name:>20s}: {k}")
        return "\n".join(lines)


def reduce_timings(tracer: PhaseTimer, span_keys: Dict[str, str],
                   out: dict, counters: Optional[Dict[str, str]] = None
                   ) -> dict:
    """Add a solve's tracer to its ``timings`` dict ``out``, after the one
    wait (``finish``): the seconds of each span name of ``span_keys``
    under its key, the host reads per site (``host_read_sites``), their
    sum (``host_reads``) and the host's time in them
    (``host_read_wait_s``), each counter of ``counters`` under its key;
    where the tracer holds K1's cluster notes (``k1.split``) also those
    (``k1_splits``: (live, C, share of the SMs) a launch;
    ``k1_split_launches``: the launches with C > 1; ``k1_sm_pct``: the
    mean share, where the card gave one).  Sums accumulate over the
    solves that share ``out``."""
    sums = tracer.finish().sums()
    for name, key in span_keys.items():
        out[key] = out.get(key, 0.0) + sums.get(name, 0.0)
    sites = out.setdefault("host_read_sites", {})
    for site, k in tracer.reads().items():
        sites[site] = sites.get(site, 0) + k
    out["host_reads"] = sum(sites.values())
    out["host_read_wait_s"] = out.get("host_read_wait_s", 0.0) \
        + tracer.read_wait
    for name, key in (counters or {}).items():
        out[key] = out.get(key, 0) + tracer.counters.get(name, 0)
    if "k1.split" in tracer.notes:
        splits = out.setdefault("k1_splits", [])
        splits += tracer.notes["k1.split"]
        out["k1_split_launches"] = sum(c > 1 for _, c, _ in splits)
        pcts = [p for _, _, p in splits if p is not None]
        if pcts:
            out["k1_sm_pct"] = sum(pcts) / len(pcts)
    return out


def perturb(rng: np.random.RandomState, arr: torch.Tensor,
            scale: float = 1e-5) -> torch.Tensor:
    """Multiplicative random perturbation that moves every element by a
    factor in [1, 1 + scale), drawn from ``rng`` as the JAX package
    draws it."""
    f = 1.0 + scale * rng.rand(*arr.shape).astype(np.float32)
    return arr * torch.from_numpy(f).to(arr.device)
