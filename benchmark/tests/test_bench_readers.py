"""The readers of the program's l2f spans and host reads, on synthetic
runs: the mean per batch of the ``timings`` key each reads, in its unit,
and nothing where the batches carry no ``timings`` (untraced runs) or
the program has no such key (a program without the tracer's spans)."""

import pytest

from benchmark.manifest import reader

#: metric -> (its ``timings`` key, the factor to its unit)
READS = {"l2f.compact_ms": ("compact_s", 1e3),
         "woodbury.factor_ms": ("factor_s", 1e3),
         "lp.select_ms": ("select_s", 1e3),
         "lp.window_ms": ("lp_window_s", 1e3),
         "host.reads": ("host_reads", 1),
         "host.read_wait_ms": ("host_read_wait_s", 1e3)}


@pytest.mark.parametrize("metric", sorted(READS))
def test_reader_means_its_key_per_batch(metric):
    key, unit = READS[metric]
    read = reader(metric)
    old = {"policy_s": 0.1, "tail_s": 0.2, "buckets": (128, 64)}
    traced = {"batches": [{"timings": dict(old, **{key: v})}
                          for v in (0.25, 0.75, 2)]}
    assert read(traced) == pytest.approx(unit)
    assert read({"batches": [{"timings": None}, {}]}) is None
    assert read({"batches": [{"timings": old}]}) is None
    assert read({"batches": []}) is None
