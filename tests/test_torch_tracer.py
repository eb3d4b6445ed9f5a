"""The port's tracer (``utils/profiling.py``) and the spans, counters and
host reads of the l2f solve (CPU).

The tracer: nested spans with their parents and solve identifiers,
per-name totals and per-solve sums, counters and counted reads, the
``record_function`` ranges under a running profiler, and the off path
(no active timer: the shared no-op context and the plain read).
``l2f_solve_compact`` with ``timings={}`` on the 8-instance CA set of
``tests/test_torch_l2f.py``: the span keys, compaction and selection
inside the tail, every host read counted by site; with ``timings=None``
the same bits, and no event, no profiler range and no tracer call; on
the ``core.lp`` windows route (K1's limit at 0) the windows' span."""

import time

import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler

from lpbox_admm_tpu_torch.config import LP_CONFIG as TLP, PolicyConfig as TPC
from lpbox_admm_tpu_torch.ops import fused_lp
from lpbox_admm_tpu_torch.train import l2f as tl2f
from lpbox_admm_tpu_torch.utils import profiling
from lpbox_admm_tpu_torch.utils.checkpoint import load_policy

from torch_port_util import CKPT, ca_instances, np_of, problems

OP = dict(fix_confidence=0.98, fix_windows=2, damage_gate=0.25)
KW = dict(ws=100, max_iter=1500, min_bucket=32, policy_windows=3,
          repair_rounds=16, swap_rounds=4, rho_boost_iters=500)
NEW_KEYS = {"compact_s", "lp_window_s", "factor_s", "select_s",
            "host_reads", "host_read_wait_s", "host_read_sites"}
OLD_KEYS = {"policy_s", "tail_s", "buckets", "nside", "policy_route",
            "tail_route", "policy_e_route", "tail_e_route"}
#: K1's clusters (``k1_sm_pct`` only where there is a card)
SPLIT_KEYS = {"k1_splits", "k1_split_launches"}


def test_spans_nest_with_parents_solves_and_totals():
    t = profiling.PhaseTimer("cpu")
    with t:
        first = t.solve
        with profiling.span("outer"):
            for _ in range(2):
                with profiling.span("inner"):
                    time.sleep(0.002)
            assert profiling.read("site", int, torch.tensor(7)) == 7
            t.count("c", 3)
    # inactive again: a span records nothing
    with profiling.span("outside"):
        pass
    with t:
        with profiling.span("inner"):
            pass
    assert t.solve > first
    by = {(s.name, s.solve): s for s in t.spans}
    assert by[("inner", first)].parent is by[("outer", first)]
    assert by[("outer", first)].parent is None
    assert by[("inner", t.solve)].parent is None
    assert t.counts == {"inner": 3, "outer": 1}
    assert profiling.span("outside") is profiling.tracing(None)
    s1 = t.sums(first)
    assert s1["inner"] >= 0.004 and s1["outer"] >= s1["inner"]
    assert set(t.sums()) == {"inner"}
    assert t.totals["inner"] == pytest.approx(
        s1["inner"] + t.sums()["inner"])
    assert t.counters == {"host.read:site": 1, "c": 3}
    assert t.reads() == {"site": 1} and t.read_wait >= 0
    assert "TOTAL" in t.report() and "host.read:site" in t.report()


def test_off_path_is_one_shared_noop():
    assert profiling.span("a") is profiling.span("b")
    assert profiling.tracing(None) is profiling.span("a")
    assert profiling.read("site", bool, torch.tensor(False)) is False


def test_spans_are_profiler_ranges():
    from torch.profiler import profile
    t = profiling.PhaseTimer("cpu")
    with profile() as prof, t:
        with profiling.span("lp.select"):
            profiling.read("l2f.policy_done", bool, torch.ones(3).all())
    names = {e.name for e in prof.events()}
    assert {"lp.select", "host.read:l2f.policy_done"} <= names
    assert t.counts == {"lp.select": 1}


def _solve(timings):
    _, tp = problems(ca_instances(3, 8))
    return tl2f.l2f_solve_compact(
        tp, load_policy(CKPT["mha"], device="cpu"),
        TLP.replace(linsolve="woodbury", incumbent_stride=8),
        TPC(net="mha", **OP), timings=timings, **KW)


@pytest.fixture(scope="module")
def traced():
    tm = {}
    _, out = _solve(tm)
    return tm, out


def test_l2f_timings_hold_the_new_keys(traced):
    tm, _ = traced
    assert set(tm) == OLD_KEYS | NEW_KEYS | SPLIT_KEYS
    assert tm["tail_route"] == "k1"
    assert tm["compact_s"] > 0 and tm["select_s"] > 0
    assert tm["compact_s"] + tm["select_s"] <= tm["tail_s"]
    assert tm["factor_s"] > 0
    # K1's route runs no core.lp window
    assert tm["lp_window_s"] == 0.0
    sites = tm["host_read_sites"]
    assert tm["host_reads"] == sum(sites.values())
    # a done check before each of the 3 policy windows and each tail
    # window, the two bucket reads, E's one-byte check in each phase, a
    # Cholesky's error flag and its solve in init_state, after each fix
    # and in compaction
    assert sites["l2f.policy_done"] == 3
    assert sites["l2f.bucket_n"] == sites["l2f.bucket_m"] == 1
    assert sites["fused_lp.one_byte_exact"] == 2
    assert sites["fused_lp.done"] >= 1
    assert sites["woodbury.cholesky"] >= 5
    assert sites["woodbury.cholesky_solve"] == sites["woodbury.cholesky"]
    assert 0 <= tm["host_read_wait_s"] <= tm["policy_s"] + tm["tail_s"]


def test_untraced_solve_touches_no_tracer(traced, monkeypatch):
    """``timings=None``: the same bits, and neither a CUDA event, nor a
    profiler range (the profiler shown as recording), nor a tracer
    method is reached."""
    def refuse(*a, **k):
        raise AssertionError("tracer reached with timings=None")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(autograd_profiler, "record_function", refuse)
    monkeypatch.setattr(autograd_profiler, "_is_profiler_enabled", True)
    for name in ("__enter__", "span", "read", "count", "finish"):
        monkeypatch.setattr(profiling.PhaseTimer, name, refuse)
    _, out = _solve(None)
    _, ref = traced
    for k in ("solution", "obj", "obj_last", "infeasible", "n_fixed",
              "fixed_mask", "fixed_val"):
        np.testing.assert_array_equal(np_of(out[k]), np_of(ref[k]))
    assert out["iterations"] == ref["iterations"]


def test_windows_route_times_its_windows(monkeypatch):
    monkeypatch.setattr(fused_lp, "_SMEM_MAX", 0)
    tm = {}
    _solve(tm)
    assert tm["policy_route"] == tm["tail_route"] == "windows"
    assert 0 < tm["lp_window_s"] <= tm["policy_s"] + tm["tail_s"]
    sites = tm["host_read_sites"]
    assert "fused_lp.done" not in sites and sites["l2f.tail_done"] >= 1
    assert tm["host_reads"] == sum(sites.values())
