"""Structure-aware sparse storage for CA constraint matrices.

The port of the JAX package's ``ops/ca_sparse.py``.  At the reference's
very-large CA rungs (cython_solver/LPboxADMMsolver.cpp:2461-2486) m is
dominated by DUMMY rows, the XOR rows the Leyton-Brown sampler adds per
substitutable bidder (generate_instances.py:294-303): at (1000 items,
1e5 bids) m is about 19.8k, of which about 18.8k are dummy rows.  Each
bid (column) carries at most one dummy nonzero, and each dummy row
covers its bidder's bids, which the sampler appends consecutively: the
dummy rows are disjoint, ascending column intervals.

``CaStructE`` splits E row-wise into

* an **item block** (m1 ~ n_items rows): a width-capped ``SparseEll``
  plus a compacted overflow ``SparseEll`` for the few columns above the
  width cap, rejoined through a one-nonzero-per-column selector;
* a **dummy block**, a ``SparseEll`` whose column layout has width 1
  (``E^T w`` is one gather per column) and whose row layout holds each
  dummy row's consecutive interval (``E v`` is a gather over at most
  ``max_n_sub_bids + 1`` columns per row).

Every product is a gather (``ops/sparse.py``): the JAX module's window
machinery for the dummy block (``drow_loc``, ``dbase``, ``rwin``, Rmax)
serves its MXU one-hots, which the card does not need.

The m-axis layout is ``[item rows (padded to m1p) | dummy rows (padded
to m2p)]`` per instance; ``adapters.ca.make_struct_problem`` and
``ops.struct_ginv`` build f, row_mask and G^{-1} in the same layout
through ``row_maps``.  The split is detected structurally (the maximal
suffix of rows that are disjoint ascending column intervals), so a
matrix without such rows gets ``m1 = m``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..core.problem import Device, as_device, round_up
from . import sparse as sparse_ops


@dataclasses.dataclass(frozen=True)
class CaStructE:
    """Batched structured sparse (B, m1p + m2p, n) matrix."""

    item: sparse_ops.SparseEll     # (B, m1p, n) width-capped item block
    over: sparse_ops.SparseEll     # (B, m1p, n_ov) overflow columns
    sel: sparse_ops.SparseEll      # (B, n, n_ov) overflow column selector
    dummy: sparse_ops.SparseEll    # (B, m2p, n) dummy block
    m2_rows: torch.Tensor          # (B, m2p) f32 1/0 real dummy row mask
    csq: torch.Tensor              # (B, n) per-column squared norms

    is_sparse_matrix = True        # ops/sparse.py dispatch marker

    @property
    def batch(self) -> int:
        return self.item.batch

    @property
    def m1(self) -> int:
        return self.item.m

    @property
    def m2(self) -> int:
        return self.m2_rows.shape[1]

    @property
    def m(self) -> int:
        return self.m1 + self.m2

    @property
    def n(self) -> int:
        return self.item.n

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (self.batch, self.m, self.n)

    @property
    def device(self) -> torch.device:
        return self.csq.device

    def map(self, fn) -> "CaStructE":
        """The same matrix with ``fn`` applied to every tensor."""
        return CaStructE(
            item=self.item.map(fn), over=self.over.map(fn),
            sel=self.sel.map(fn), dummy=self.dummy.map(fn),
            m2_rows=fn(self.m2_rows), csq=fn(self.csq))

    def nbytes(self) -> int:
        return (self.item.nbytes() + self.over.nbytes() + self.sel.nbytes()
                + self.dummy.nbytes() + self.m2_rows.nbytes
                + self.csq.nbytes)

    # ---- products ---------------------------------------------------

    def mv_many(self, Vk: torch.Tensor) -> torch.Tensor:
        """E @ v stack: (B, k, n) -> (B, k, m1p + m2p)."""
        out_i = sparse_ops.mv_many(self.item, Vk)
        if self.over.n > 0:
            V_ov = sparse_ops.mtv_many(self.sel, Vk)      # (B, k, n_ov)
            out_i = out_i + sparse_ops.mv_many(self.over, V_ov)
        out_d = sparse_ops.mv_many(self.dummy, Vk)
        return torch.cat([out_i, out_d], dim=-1)

    def mtv_many(self, Wk: torch.Tensor) -> torch.Tensor:
        """E^T @ w stack: (B, k, m1p + m2p) -> (B, k, n)."""
        m1p = self.m1
        Wi, Wd = Wk[:, :, :m1p], Wk[:, :, m1p:]
        out = sparse_ops.mtv_many(self.item, Wi)
        if self.over.n > 0:
            ov = sparse_ops.mtv_many(self.over, Wi)       # (B, k, n_ov)
            out = out + sparse_ops.mv_many(self.sel, ov)
        return out + sparse_ops.mtv_many(self.dummy, Wd)

    def mv(self, v: torch.Tensor) -> torch.Tensor:
        return self.mv_many(v[:, None])[:, 0]

    def mtv(self, w: torch.Tensor) -> torch.Tensor:
        return self.mtv_many(w[:, None])[:, 0]

    def colsq(self) -> torch.Tensor:
        return self.csq


# --------------------------------------------------------------------------
# Host-side construction
# --------------------------------------------------------------------------

def detect_interval_suffix(rows: np.ndarray, cols: np.ndarray,
                           m: int) -> int:
    """The smallest boundary ``mb`` such that every row in [mb, m) is a
    consecutive-column interval, the intervals are disjoint and ascend
    with the row index, and no column carries two suffix rows.  Rows
    below mb form the generic item block."""
    order = np.lexsort((cols, rows))
    r_s, c_s = rows[order], cols[order]
    starts = np.full(m, -1, np.int64)
    ends = np.full(m, -2, np.int64)
    counts = np.bincount(rows, minlength=m)
    first = np.searchsorted(r_s, np.arange(m), side="left")
    last = np.searchsorted(r_s, np.arange(m), side="right") - 1
    has = counts > 0
    starts[has] = c_s[first[has]]
    ends[has] = c_s[last[has]]
    consec = has & (ends - starts + 1 == counts)
    mb = m
    prev_start = np.iinfo(np.int64).max
    for r in range(m - 1, -1, -1):
        if not consec[r] or ends[r] >= prev_start:
            break
        prev_start = starts[r]
        mb = r
    return mb


class _StructParts(NamedTuple):
    item_coo: Tuple[np.ndarray, np.ndarray, np.ndarray]
    over_coo: Tuple[np.ndarray, np.ndarray, np.ndarray]
    sel_cols: np.ndarray           # original column of each overflow col
    dummy_coo: Tuple[np.ndarray, np.ndarray, np.ndarray]
    mb: int                        # item-row count
    m2: int                        # dummy-row count


def _split_instance(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                    m: int, n: int, width_cap: int) -> _StructParts:
    mb = detect_interval_suffix(rows, cols, m)
    dummy = rows >= mb
    ir, ic, iv = rows[~dummy], cols[~dummy], vals[~dummy]
    # width cap: per column the first ``width_cap`` item nonzeros stay in
    # the main block, the rest go to the compacted overflow block
    order = np.lexsort((ir, ic))
    ir, ic, iv = ir[order], ic[order], iv[order]
    ccounts = np.bincount(ic, minlength=n)
    cstarts = np.concatenate([[0], np.cumsum(ccounts)[:-1]])
    pos = np.arange(len(ic)) - cstarts[ic]
    main = pos < width_cap
    over_cols = np.unique(ic[~main])
    remap = np.full(n, -1, np.int64)
    remap[over_cols] = np.arange(len(over_cols))
    return _StructParts(
        item_coo=(ir[main], ic[main], iv[main]),
        over_coo=(ir[~main], remap[ic[~main]], iv[~main]),
        sel_cols=over_cols,
        dummy_coo=(rows[dummy] - mb, cols[dummy], vals[dummy]),
        mb=mb, m2=m - mb)


def build(coos: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
          shapes: Sequence[Tuple[int, int]], n: int,
          width_cap: int = 12, align: int = 128,
          device: Device = "cuda") -> Tuple[CaStructE, list]:
    """A batched CaStructE from per-instance COO triplets with
    per-instance ``shapes`` (m_i, n_i), padded to a shared column count
    ``n``.  Returns ``(S, row_maps)``: ``row_maps[i]`` (m_i,) gives each
    original row's position on the struct m-axis (items, then dummies,
    each block padded)."""
    dev = as_device(device)
    B = len(coos)
    parts = [_split_instance(np.asarray(r, np.int64), np.asarray(c, np.int64),
                             np.asarray(v, np.float32), mi, n, width_cap)
             for (r, c, v), (mi, _) in zip(coos, shapes)]
    m1p = round_up(max(max(p.mb for p in parts), 1), align)
    m2p = round_up(max(max(p.m2 for p in parts), 1), align)
    n_ov = round_up(max(max(len(p.sel_cols) for p in parts), 1), align)

    item = sparse_ops.from_coo([p.item_coo for p in parts], (m1p, n), dev)
    over = sparse_ops.from_coo([p.over_coo for p in parts], (m1p, n_ov), dev)
    sel = sparse_ops.from_coo(
        [(p.sel_cols, np.arange(len(p.sel_cols)),
          np.ones(len(p.sel_cols), np.float32)) for p in parts],
        (n, n_ov), dev)
    dummy = sparse_ops.from_coo([p.dummy_coo for p in parts], (m2p, n), dev)
    m2_rows = np.zeros((B, m2p), np.float32)
    csq = np.zeros((B, n), np.float32)
    row_maps = []
    for b, (p, (r, c, v)) in enumerate(zip(parts, coos)):
        m2_rows[b, :p.m2] = 1.0
        csq[b] = np.bincount(np.asarray(c, np.int64),
                             weights=np.asarray(v, np.float64) ** 2,
                             minlength=n)[:n]
        row_maps.append(np.concatenate([np.arange(p.mb),
                                        m1p + np.arange(p.m2)]))
    S = CaStructE(item=item, over=over, sel=sel, dummy=dummy,
                  m2_rows=torch.from_numpy(m2_rows).to(dev),
                  csq=torch.from_numpy(csq).to(dev))
    return S, row_maps


def to_dense(S: CaStructE) -> torch.Tensor:
    """Materialize (B, m, n): tests only."""
    B, m, n = S.shape
    eye = torch.eye(n, dtype=torch.float32, device=S.device)
    return S.mv_many(eye[None].expand(B, n, n)).transpose(1, 2)
