"""Schur-structured Woodbury inverse for the struct CA layout.

The port of the JAX package's ``ops/struct_ginv.py``.  At the
reference's very-large CA rungs (cython_solver/LPboxADMMsolver.cpp:
2461-2486) the Woodbury Gram ``G = ratio I + C C^T`` is (m, m) with
m ~ 2e4, dominated by dummy rows; a dense inverse is 1.6 GB an instance.
In the struct layout (``ops/ca_sparse``: m-axis = [item rows | dummy
rows]) the dummy rows have disjoint column supports, so the dummy-dummy
Gram block is diagonal and

    G = [[ A,    Bm ],        A  (m1, m1) dense, m1 ~ n_items
         [ Bm^T, D  ]]        D  (m2,) diagonal, Bm (m1, m2)

Block elimination with the (m1, m1) Schur complement
``S = A - Bm D^{-1} Bm^T`` applies G^{-1} exactly:

    z2' = D^{-1} r2
    z1  = S^{-1} (r1 - Bm z2')
    z2  = D^{-1} (r2 - Bm^T z1)

Per apply: two passes over Bm and one (m1, m1) product, each a
broadcast multiply and a sum in f32.  No matmul, so no TF32 whatever the
caller's ``torch.backends.cuda.matmul`` setting (one TF32 pass would
round Bm's products to 10 mantissa bits).  The host build is one
(m1, m1) Cholesky in float64 (scipy).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.problem import Device, as_device


@dataclasses.dataclass(frozen=True)
class StructGinv:
    """Structured explicit inverse of ``ratio I + C C^T`` in the struct
    row layout; stands in for the dense (B, m, m) ``ginv`` of
    ``core/lp`` (dispatched on ``is_struct_ginv``)."""

    sinv: torch.Tensor   # (B, m1p, m1p) f32 Schur complement inverse
    b12: torch.Tensor    # (B, m1p, m2p) f32 item-dummy coupling block
    dinv: torch.Tensor   # (B, m2p) f32 inverse diagonal dummy block

    is_struct_ginv = True

    @property
    def m(self) -> int:
        return self.sinv.shape[1] + self.dinv.shape[1]

    def map(self, fn) -> "StructGinv":
        return StructGinv(fn(self.sinv), fn(self.b12), fn(self.dinv))

    def where(self, do: torch.Tensor, old: "StructGinv") -> "StructGinv":
        """Per instance, these blocks where ``do`` (B,) holds, else
        ``old``'s."""
        pick = lambda new, prev: torch.where(
            do.reshape((-1,) + (1,) * (new.ndim - 1)), new, prev)
        return StructGinv(pick(self.sinv, old.sinv), pick(self.b12, old.b12),
                          pick(self.dinv, old.dinv))

    def nbytes(self) -> int:
        return self.sinv.nbytes + self.b12.nbytes + self.dinv.nbytes

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        """G^{-1} r: (B, m) -> (B, m) by block elimination."""
        m1 = self.sinv.shape[1]
        r = r.float()
        r1, r2 = r[:, :m1], r[:, m1:]
        z2p = self.dinv * r2
        t = r1 - (self.b12 * z2p[:, None, :]).sum(-1)
        z1 = (self.sinv * t[:, None, :]).sum(-1)
        z2 = self.dinv * (r2 - (self.b12 * z1[..., None]).sum(1))
        return torch.cat([z1, z2], dim=-1)


def schur_blocks(C, m1p: int, m2p: int, ratio: float):
    """(sinv, Bm, dinv) in float64 for a scipy CSR ``C`` whose rows are
    laid out [item rows (m1p) | dummy rows (m2p)]."""
    from scipy.linalg import cho_factor, cho_solve
    C1, C2 = C[:m1p], C[m1p:]
    G22 = (C2 @ C2.T).tocoo()
    off = G22.row != G22.col
    assert not np.any(np.abs(G22.data[off]) > 0), \
        "dummy rows are not support-disjoint; struct layout drifted"
    d = np.full(m2p, ratio, np.float64)
    d[G22.row[~off]] += G22.data[~off]
    Bm = (C1 @ C2.T).toarray()
    A = (C1 @ C1.T).toarray() + ratio * np.eye(m1p)
    S = A - (Bm / d[None, :]) @ Bm.T
    sinv = cho_solve(cho_factor(S, lower=True), np.eye(m1p))
    return sinv, Bm, 1.0 / d


def build_struct_ginv(
    coos: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
    shapes: Sequence[Tuple[int, int]],
    row_maps: Sequence[np.ndarray],
    m1p: int, m2p: int, n: int, ratio: float,
    free: Optional[np.ndarray] = None,
    device: Device = "cuda",
) -> StructGinv:
    """Host-side build from per-instance COO triplets in the layout of
    ``ca_sparse.build`` (``row_maps`` comes from it).

    ``free``: optional (B, n) bool mask; the Gram then uses only the free
    columns (the early-fixing refactorization that
    ``core.lp.apply_fix(..., ginv=)`` takes).  Asserts that the dummy
    block is diagonal, which the struct detector guarantees."""
    import scipy.sparse as sp

    dev = as_device(device)
    B = len(coos)
    sinv = np.zeros((B, m1p, m1p), np.float32)
    b12 = np.zeros((B, m1p, m2p), np.float32)
    dinv = np.zeros((B, m2p), np.float32)
    for b, ((r, c, v), rm) in enumerate(zip(coos, row_maps)):
        c = np.asarray(c)
        v = np.asarray(v, np.float64)
        if free is not None:
            v = v * np.asarray(free[b], np.float64)[c]
        C = sp.csr_matrix((v, (rm[np.asarray(r)], c)), shape=(m1p + m2p, n))
        s, Bm, di = schur_blocks(C, m1p, m2p, ratio)
        sinv[b], b12[b], dinv[b] = s, Bm, di
    t = lambda a: torch.from_numpy(a).to(dev)
    return StructGinv(sinv=t(sinv), b12=t(b12), dinv=t(dinv))
