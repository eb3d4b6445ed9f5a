"""The readers of K1's cluster counters, on synthetic runs: the mean per
batch of the ``timings`` key each reads, in its unit, and nothing where
the batches carry no ``timings`` (untraced runs) or the program has no
such key (a program whose K1 never spreads an instance over a cluster)."""

import pytest

from benchmark.manifest import reader

#: metric -> (its ``timings`` key, the factor to its unit)
READS = {"k1.split_launches": ("k1_split_launches", 1),
         "k1.sm_pct": ("k1_sm_pct", 1)}


@pytest.mark.parametrize("metric", sorted(READS))
def test_k1_reader_means_its_key_per_batch(metric):
    key, unit = READS[metric]
    read = reader(metric)
    old = {"policy_s": 0.1, "tail_s": 0.2, "buckets": (128, 64),
           "host_reads": 24}
    traced = {"batches": [{"timings": dict(old, **{key: v})}
                          for v in (0.25, 0.75, 2)]}
    assert read(traced) == pytest.approx(unit)
    assert read({"batches": [{"timings": None}, {}]}) is None
    assert read({"batches": [{"timings": old}]}) is None
    assert read({"batches": []}) is None
