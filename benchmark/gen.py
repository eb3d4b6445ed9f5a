"""Combinatorial-auction instances for the benchmark (numpy only).

A copy of the port's CA generator (``adapters/ca.generate_cauction``):
the Leyton-Brown "arbitrary" sampler of the reference's
generate_instances.py:137-359, unchanged.  It lives here so that the
benchmark's inputs cannot move when the program changes.  Two things
are the benchmark's own:

* every instance draws from its own ``RandomState``, seeded from
  ``(seed, index)``, so that worker processes can make a pool in
  parallel and the same seed gives the same pool in any order;
* the sampler returns the incidence as a COO pair (rows, columns), the
  form a worker sends back cheaply; the auction kind lays the pool out
  densely on the device.

The auction kind (``kinds/cauction.py``) makes its pool with
``instance``.  This module imports numpy alone: the harness's pool
workers import it and nothing of the program.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def choose_next_item(bundle_mask: np.ndarray, interests: np.ndarray,
                     compats: np.ndarray,
                     rng: np.random.RandomState) -> int:
    """Sample the next bundle item by interest x mean compatibility with
    the items currently in the bundle."""
    prob = (1 - bundle_mask) * interests \
        * compats[bundle_mask.astype(bool), :].mean(axis=0)
    prob = prob / prob.sum()
    return rng.choice(len(interests), p=prob)


def generate_cauction(
    rng: np.random.RandomState,
    n_items: int = 100,
    n_bids: int = 500,
    min_value: float = 1,
    max_value: float = 100,
    value_deviation: float = 0.5,
    add_item_prob: float = 0.7,
    max_n_sub_bids: int = 5,
    additivity: float = 0.2,
    budget_factor: float = 1.5,
    resale_factor: float = 0.5,
    return_coo: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Sample one CA instance: ``(prices, C)`` with ``prices`` (n_bids,)
    and ``C`` the dense 0/1 item-bid incidence matrix of shape
    (n_items + n_dummy, n_bids), empty rows dropped.  With
    ``return_coo`` the incidence comes back as a ``(rows, cols, vals,
    (m, n))`` triplet."""
    values = min_value + (max_value - min_value) * rng.rand(n_items)
    compats = np.triu(rng.rand(n_items, n_items), k=1)
    compats = compats + compats.T
    compats = compats / compats.sum(1)

    def _next(bundle_mask, interests):
        return choose_next_item(bundle_mask, interests, compats, rng)

    bids: List[Tuple[List[int], float]] = []
    n_dummy = 0
    while len(bids) < n_bids:
        private_interests = rng.rand(n_items)
        private_values = values + max_value * value_deviation \
            * (2 * private_interests - 1)

        bidder_bids = {}
        prob = private_interests / private_interests.sum()
        item = rng.choice(n_items, p=prob)
        bundle_mask = np.zeros(n_items)
        bundle_mask[item] = 1
        while rng.rand() < add_item_prob:
            if bundle_mask.sum() == n_items:
                break
            item = _next(bundle_mask, private_interests)
            bundle_mask[item] = 1
        bundle = np.nonzero(bundle_mask)[0]
        price = private_values[bundle].sum() + len(bundle) ** (1 + additivity)
        if price < 0:
            continue
        bidder_bids[frozenset(bundle)] = price

        sub_candidates = []
        for item in bundle:
            sub_mask = np.zeros(n_items)
            sub_mask[item] = 1
            while sub_mask.sum() < len(bundle):
                it2 = _next(sub_mask, private_interests)
                sub_mask[it2] = 1
            sub_bundle = np.nonzero(sub_mask)[0]
            sub_price = private_values[sub_bundle].sum() \
                + len(sub_bundle) ** (1 + additivity)
            sub_candidates.append((sub_bundle, sub_price))

        budget = budget_factor * price
        min_resale = resale_factor * values[bundle].sum()
        order = np.argsort([-p for _, p in sub_candidates])
        for bi in order:
            sub_bundle, sub_price = sub_candidates[bi]
            if (len(bidder_bids) >= max_n_sub_bids + 1
                    or len(bids) + len(bidder_bids) >= n_bids):
                break
            if sub_price < 0 or sub_price > budget:
                continue
            if values[sub_bundle].sum() < min_resale:
                continue
            if frozenset(sub_bundle) in bidder_bids:
                continue
            bidder_bids[frozenset(sub_bundle)] = sub_price

        if len(bidder_bids) > 2:
            dummy = [n_items + n_dummy]
            n_dummy += 1
        else:
            dummy = []
        for bundle_fs, price_v in bidder_bids.items():
            bids.append((list(bundle_fs) + dummy, price_v))

    prices = np.array([p for _, p in bids])
    if return_coo:
        rows_l, cols_l = [], []
        for j, (bundle, _) in enumerate(bids):
            rows_l.extend(bundle)
            cols_l.extend([j] * len(bundle))
        rows = np.asarray(rows_l, np.int64)
        cols = np.asarray(cols_l, np.int64)
        # drop empty item rows, keeping row order (as the dense form does)
        used = np.unique(rows)
        remap = np.full(n_items + n_dummy, -1, np.int64)
        remap[used] = np.arange(len(used))
        return prices, (remap[rows], cols, np.ones(len(rows), np.float32),
                        (len(used), len(bids)))
    C = np.zeros((n_items + n_dummy, len(bids)))
    for j, (bundle, _) in enumerate(bids):
        for item in bundle:
            C[item, j] = 1.0
    keep = C.sum(axis=1) > 0
    return prices, C[keep]


def instance_rng(seed: int, index: int) -> np.random.RandomState:
    """The ``RandomState`` of pool instance ``index`` under ``seed``
    (any whole number >= 0, of any size)."""
    if seed < 0 or index < 0:
        raise ValueError(f"seed and index must be >= 0: {seed}, {index}")
    state = np.random.SeedSequence([seed, index]).generate_state(8)
    return np.random.RandomState(state)


def instance(seed: int, index: int, n_items: int, n_bids: int):
    """Pool instance ``index`` under ``seed``: ``(prices float64 (n,),
    rows int32, cols int32, (m, n))``, the incidence's nonzeros (all
    1)."""
    prices, (rows, cols, _, shape) = generate_cauction(
        instance_rng(seed, index), n_items=n_items, n_bids=n_bids,
        return_coo=True)
    return (prices, rows.astype(np.int32), cols.astype(np.int32),
            tuple(int(d) for d in shape))
