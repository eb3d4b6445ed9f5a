"""Combinatorial-auction instance generation (numpy only).

The port's copy of the JAX package's ``adapters/ca.py`` generator:
the Leyton-Brown "arbitrary" CA sampler (reference
LinerProgramming/LinearProgramming/generate_data/
generate_instances.py:137-359) driven by ``np.random.RandomState``
exactly as the JAX package drives it, so the same seed gives the same
instances, and the set-packing LP

    max  price . x   s.t.  (each item in at most one accepted bid)

in minimization form (b := -price, E x <= 1).

The reference's file formats are written and read byte for byte as the
JAX package does (generate_instances.py:305-359, LPboxADMMsolver.cpp:
2407-2545): ``{prefix}_b.txt``, ``{prefix}_C.txt`` (1-indexed COO) and
the CPLEX ``{prefix}.lp``; ``generate_dataset`` lays instances out as
``{root}/instance/{n_items}_{n_bids}/instance_{i}``.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.problem import (Device, LpProblem, as_device, round_up,
                            stack_lp_instances)


def choose_next_item(bundle_mask: np.ndarray, interests: np.ndarray,
                     compats: np.ndarray,
                     rng: np.random.RandomState) -> int:
    """Sample the next bundle item by interest x mean compatibility with
    the items currently in the bundle (boolean-mask rows; see the JAX
    package's ruling on the reference's integer-index divergence)."""
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
    (m, n))`` triplet, never dense (the only form at the reference
    table's 1e5-bid rungs, where a dense C is 7.9 GB in float32)."""
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


def make_problem(
    instances: Sequence[Tuple[np.ndarray, np.ndarray]],
    n_pad: Optional[int] = None,
    m_pad: Optional[int] = None,
    device: Device = "cuda",
) -> LpProblem:
    """Batch CA instances into a padded LpProblem in minimization form:
    b = -prices, E = C, f = 1.  CA-500 (100 items, 500 bids) pads to
    (m, n) = (256, 512)."""
    bs = [-np.asarray(p, dtype=np.float64) for p, _ in instances]
    Es = [np.asarray(C, dtype=np.float64) for _, C in instances]
    return stack_lp_instances(bs, Es, n_pad=n_pad, m_pad=m_pad,
                              device=device)



def _inst_coo(C) -> Tuple[Tuple[np.ndarray, np.ndarray, np.ndarray],
                          Tuple[int, int]]:
    """``((rows, cols, vals), (m, n))`` of a dense C or a COO triplet."""
    if isinstance(C, tuple):
        rows, cols, vals, shape = C
        return (np.asarray(rows, np.int64), np.asarray(cols, np.int64),
                np.asarray(vals, np.float32)), tuple(int(d) for d in shape)
    C = np.asarray(C)
    rows, cols = np.nonzero(C)
    return (rows, cols, C[rows, cols].astype(np.float32)), C.shape


def _sides(instances, n_pad, m, align, rows):
    """b (minimization form), row and variable masks of a batch; ``rows``
    per instance: the positions of its constraint rows on the m axis."""
    bs = [-np.asarray(p, dtype=np.float64) for p, _ in instances]
    ns = [b.shape[0] for b in bs]
    n = n_pad or round_up(max(ns), align)
    B = len(instances)
    b_arr = np.zeros((B, n), np.float32)
    rmask = np.zeros((B, m), bool)
    vmask = np.zeros((B, n), bool)
    for i, bi in enumerate(bs):
        b_arr[i, :ns[i]] = bi
        vmask[i, :ns[i]] = True
        rmask[i, rows[i]] = True
    return b_arr, rmask, vmask


def _problem(E, b_arr, rmask, vmask, dev) -> LpProblem:
    t = lambda a: torch.from_numpy(a).to(dev)
    return LpProblem(b=t(b_arr), E=E,
                     f=torch.ones(rmask.shape, dtype=torch.float32,
                                  device=dev),
                     row_mask=t(rmask), var_mask=t(vmask))


def make_sparse_problem(
    instances: Sequence[Tuple[np.ndarray, np.ndarray]],
    n_pad: Optional[int] = None,
    m_pad: Optional[int] = None,
    align: int = 128,
    device: Device = "cuda",
) -> LpProblem:
    """Batch CA instances (dense C or COO triplets) with E stored as an
    ``ops.sparse.SparseEll`` (O(nnz)): the very-large rungs of the
    reference's instance ladder (cython_solver/LPboxADMMsolver.cpp:
    2461-2486) are about 5 nonzeros a column.  The padding contract of
    ``make_problem``."""
    from ..ops import sparse as sparse_ops
    dev = as_device(device)
    packed = [_inst_coo(C) for _, C in instances]
    m = m_pad or round_up(max(s[0] for _, s in packed), align)
    b_arr, rmask, vmask = _sides(instances, n_pad, m, align,
                                 [np.arange(s[0]) for _, s in packed])
    E = sparse_ops.from_coo([c for c, _ in packed], (m, b_arr.shape[1]),
                            device=dev)
    return _problem(E, b_arr, rmask, vmask, dev)


def make_struct_problem(
    instances: Sequence[Tuple[np.ndarray, np.ndarray]],
    n_pad: Optional[int] = None,
    align: int = 128,
    width_cap: int = 12,
    device: Device = "cuda",
) -> Tuple[LpProblem, list]:
    """Batch CA instances with E as the structure-aware
    ``ops.ca_sparse.CaStructE``: item rows as a width-capped ELL block,
    dummy (XOR) rows as their own block of column intervals
    (generate_instances.py:294-303 adds them).  Returns ``(problem,
    row_maps)``: the struct m-axis is ``[item rows | dummy rows]`` per
    instance (each block padded) and ``row_maps[i]`` maps original row
    -> struct row; embed any host-built Gram or inverse through it."""
    from ..ops import ca_sparse
    dev = as_device(device)
    packed = [_inst_coo(C) for _, C in instances]
    n = n_pad or round_up(max(len(p) for p, _ in instances), align)
    E, row_maps = ca_sparse.build([c for c, _ in packed],
                                  [s for _, s in packed], n,
                                  width_cap=width_cap, align=align,
                                  device=dev)
    b_arr, rmask, vmask = _sides(instances, n, E.m, align, row_maps)
    return _problem(E, b_arr, rmask, vmask, dev), row_maps


def make_dense_bf16_problem(
    instances: Sequence[Tuple[np.ndarray, np.ndarray]],
    n_pad: Optional[int] = None,
    m_pad: Optional[int] = None,
    align: int = 128,
    device: Device = "cuda",
) -> LpProblem:
    """Dense E built on the device from COO triplets, stored bfloat16
    (exact for the 0/1 CA entries): ``core.lp`` contracts it with the
    three-limb vector split (f32-equivalent) and factors its Gram in
    float32, and no float32 (B, m, n) copy exists on the host."""
    dev = as_device(device)
    packed = [_inst_coo(C) for _, C in instances]
    m = m_pad or round_up(max(s[0] for _, s in packed), align)
    b_arr, rmask, vmask = _sides(instances, n_pad, m, align,
                                 [np.arange(s[0]) for _, s in packed])
    E = torch.zeros((len(instances), m, b_arr.shape[1]),
                    dtype=torch.bfloat16, device=dev)
    for i, ((rows, cols, vals), _) in enumerate(packed):
        E[i, torch.from_numpy(rows).to(dev), torch.from_numpy(cols).to(dev)] \
            = torch.from_numpy(vals).to(device=dev, dtype=torch.bfloat16)
    return _problem(E, b_arr, rmask, vmask, dev)


def write_instance(path_prefix: str, prices: np.ndarray, C: np.ndarray):
    """Write ``{prefix}_b.txt`` (one price per line), ``{prefix}_C.txt``
    (1-indexed ``row,col,val``) and the CPLEX ``{prefix}.lp``."""
    with open(path_prefix + "_b.txt", "w") as fb:
        for p in prices:
            fb.write(f"{p}\n")
    rows, cols = np.nonzero(C)
    with open(path_prefix + "_C.txt", "w") as fc:
        for r, c in zip(rows, cols):
            fc.write(f"{r + 1},{c + 1},{int(C[r, c])}\n")
    write_instance_lp(path_prefix + ".lp", prices, C)


def write_instance_lp(path: str, prices: np.ndarray, C: np.ndarray):
    """The CPLEX ``.lp`` formulation (generate_instances.py:305-334): a
    maximization over binary bid variables with one ``<= 1``
    set-packing row per non-empty item."""
    n = len(prices)
    with open(path, "w") as f:
        f.write("maximize\nOBJ:")
        for i, p in enumerate(prices):
            f.write(f" +{p} x{i + 1}")
        f.write("\n\nsubject to\n")
        for row in np.asarray(C):
            (cols,) = np.nonzero(row)
            if cols.size:
                for i in cols:
                    f.write(f" +1 x{i + 1}")
                f.write(" <= 1\n")
        f.write("\nbinary\n")
        for i in range(n):
            f.write(f" x{i + 1}")
        f.write("\n")


def read_instance_lp(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse a ``.lp`` of ``write_instance_lp`` back into ``(prices,
    C)``, one row of C per constraint line."""
    with open(path) as f:
        text = f.read()
    obj_part, rest = text.split("subject to", 1)
    body = rest.split("binary")[0]
    terms = re.findall(r"\+([0-9.eE+-]+) x(\d+)", obj_part)
    n = max(int(i) for _, i in terms)
    prices = np.zeros(n)
    for val, i in terms:
        prices[int(i) - 1] = float(val)
    rows = [ln for ln in body.strip().splitlines() if "<=" in ln]
    C = np.zeros((len(rows), n))
    for r, ln in enumerate(rows):
        for _, i in re.findall(r"\+(1) x(\d+)", ln):
            C[r, int(i) - 1] = 1.0
    return prices, C


def read_instance(path_prefix: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read ``{prefix}_b.txt`` / ``{prefix}_C.txt`` into ``(prices, C)``
    (reference readFile, LPboxADMMsolver.cpp:2407-2545)."""
    from ..runtime import io as rio
    b = rio.read_dense_vec(path_prefix + "_b.txt")
    rows, cols, vals = rio.read_coo(path_prefix + "_C.txt")
    C = np.zeros((int(rows.max()), int(cols.max())))
    C[rows - 1, cols - 1] = vals
    return b, C


def generate_batch(seed: int, count: int, n_items: int = 100,
                   n_bids: int = 500, device: Device = "cuda",
                   **kw) -> LpProblem:
    """``count`` seeded instances, batched on ``device``."""
    rng = np.random.RandomState(seed)
    insts = [generate_cauction(rng, n_items=n_items, n_bids=n_bids, **kw)
             for _ in range(count)]
    return make_problem(insts, device=device)


def generate_dataset(root: str, seed: int, count: int, n_items: int = 100,
                     n_bids: int = 500, **kw) -> List[str]:
    """Generate and write instances in the reference's layout
    ``{root}/instance/{n_items}_{n_bids}/instance_{i}``; returns the
    path prefixes."""
    out_dir = os.path.join(root, "instance", f"{n_items}_{n_bids}")
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    prefixes = []
    for i in range(count):
        prices, C = generate_cauction(rng, n_items=n_items, n_bids=n_bids,
                                      **kw)
        prefix = os.path.join(out_dir, f"instance_{i + 1}")
        write_instance(prefix, prices, C)
        prefixes.append(prefix)
    return prefixes
