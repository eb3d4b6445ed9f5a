"""The generator copy: the reference's recipe unchanged, one stream per
(seed, index)."""

import os

import numpy as np
import pytest

from benchmark import gen


def test_same_seed_same_instance_in_any_order():
    a = [gen.instance(2**31 + 77, i, 20, 60) for i in range(4)]
    b = [gen.instance(2**31 + 77, i, 20, 60) for i in reversed(range(4))]
    for x, y in zip(a, reversed(b)):
        assert np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1])
        assert np.array_equal(x[2], y[2]) and x[3] == y[3]
    c = gen.instance(2**31 + 78, 0, 20, 60)
    assert not np.array_equal(a[0][0], c[0])


def test_seeds_beyond_32_bits():
    x = gen.instance(2**40 + 5, 3, 20, 60)
    assert x[3][1] == 60 and x[1].dtype == np.int32


def test_recipe_equals_the_programs_generator():
    # the same RandomState gives the same instance as the port's copy
    from lpbox_admm_tpu_torch.adapters import ca
    for seed in (0, 7):
        p1, C1 = gen.generate_cauction(np.random.RandomState(seed), 20, 60)
        p2, C2 = ca.generate_cauction(np.random.RandomState(seed), 20, 60)
        assert np.array_equal(p1, p2) and np.array_equal(C1, C2)


def test_coo_is_the_dense_incidence():
    rng = np.random.RandomState(3)
    p, C = gen.generate_cauction(rng, 20, 60)
    p2, (r, c, v, shape) = gen.generate_cauction(np.random.RandomState(3),
                                                 20, 60, return_coo=True)
    D = np.zeros(shape)
    D[r, c] = v
    assert np.array_equal(p, p2) and np.array_equal(D, C)


def test_statistics_match_the_sequential_recipe():
    # per-instance streams draw from the same distribution as one stream
    def summary(insts):
        prices = np.concatenate([i[0] for i in insts])
        per_bid = np.mean([len(i[1]) / i[3][1] for i in insts])
        rows = np.mean([i[3][0] for i in insts])
        return prices.mean(), per_bid, rows
    pool = [gen.instance(11, i, 20, 60) for i in range(40)]
    rng = np.random.RandomState(11)
    seq = []
    for _ in range(40):
        p, (r, c, v, s) = gen.generate_cauction(rng, 20, 60,
                                                return_coo=True)
        seq.append((p, r, c, s))
    a, b = summary(pool), summary(seq)
    assert abs(a[0] - b[0]) / b[0] < 0.1
    assert abs(a[1] - b[1]) / b[1] < 0.1
    assert abs(a[2] - b[2]) / b[2] < 0.1


def test_unknown_kind_is_refused():
    from benchmark.manifest import kind
    assert kind("cauction").make is gen.instance
    with pytest.raises(ValueError, match="no kind"):
        kind("setcover")


def test_pool_kept_in_the_checkout_reads_back(tmp_path, monkeypatch):
    from benchmark import run as R
    monkeypatch.setattr(R, "POOL_DIR", str(tmp_path))
    params = {"n_items": 20, "n_bids": 60}
    made = R.Pool("cauction", params, 2**31 + 9, 5, workers=1)
    assert not made.cached
    a = made.result()
    path = R.pool_file("cauction", params, 2**31 + 9, 5)
    assert os.path.exists(path) and path.startswith(str(tmp_path))
    kept = R.Pool("cauction", params, 2**31 + 9, 5, workers=1)
    assert kept.cached
    b = kept.result()
    assert len(a) == len(b) == 5
    for x, y in zip(a, b):
        assert all(np.array_equal(u, v) for u, v in zip(x[:3], y[:3]))
        assert x[3] == y[3]
    assert R.pool_file("cauction", params, 2**31 + 10, 5) != path
