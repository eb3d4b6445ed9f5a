"""Batched sparse matrices in ELL (fixed-nnz gather) layout.

The port of the JAX package's ``ops/sparse.py``.  The reference stores
its constraint matrices in Eigen CSR (LinerProgramming/.../
cython_solver/LPboxADMMsolver.cpp:115-162); here every row is padded to
the batch's largest row count, indices and values as dense (B, rows, K)
tensors.

Both the ROW layout (for ``M @ v``) and the COLUMN layout (for
``M^T @ w``) are built once, so both products are gathers
(``torch.gather`` and a sum over the width): no scatter and no atomic
add appears in any iteration, and the summation order of every product
is fixed from run to run (ADMM trajectories are chaotic, so an atomic
add's run-to-run order would make two runs of one solve differ).

Padding convention: unused slots carry ``idx = 0, val = 0``; they gather
a real element and multiply it by zero.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.problem import Device, as_device


@dataclasses.dataclass(frozen=True)
class SparseEll:
    """Batched (B, m, n) sparse matrix, ELL row and column layouts."""

    row_idx: torch.Tensor   # (B, m, Kr) int64: column index of each nnz
    row_val: torch.Tensor   # (B, m, Kr) float32
    col_idx: torch.Tensor   # (B, n, Kc) int64: row index of each nnz
    col_val: torch.Tensor   # (B, n, Kc) float32

    @property
    def batch(self) -> int:
        return self.row_idx.shape[0]

    @property
    def m(self) -> int:
        return self.row_idx.shape[1]

    @property
    def n(self) -> int:
        return self.col_idx.shape[1]

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (self.batch, self.m, self.n)

    @property
    def device(self) -> torch.device:
        return self.row_val.device

    def map(self, fn) -> "SparseEll":
        """The same matrix with ``fn`` applied to every tensor (a batch
        slice, a device move)."""
        return SparseEll(*(fn(getattr(self, f.name))
                           for f in dataclasses.fields(self)))

    def nbytes(self) -> int:
        return sum(getattr(self, f.name).nbytes
                   for f in dataclasses.fields(self))


def is_sparse(M) -> bool:
    """SparseEll, or a structured type with the ``is_sparse_matrix``
    marker and mv/mtv(_many)/colsq methods (``ops.ca_sparse.CaStructE``)."""
    return isinstance(M, SparseEll) or getattr(M, "is_sparse_matrix", False)


def _gather_sum(val: torch.Tensor, idx: torch.Tensor,
                V: torch.Tensor) -> torch.Tensor:
    """sum_k val[b, r, k] * V[b, j, idx[b, r, k]]: (B, J, N) -> (B, J, R)."""
    B, R, K = idx.shape
    J = V.shape[1]
    g = torch.gather(V.float(), 2, idx.reshape(B, 1, R * K).expand(B, J, R * K))
    return (g.view(B, J, R, K) * val[:, None]).sum(-1)


def mv_many(S, Vk: torch.Tensor) -> torch.Tensor:
    """Stacked ``M @ v``: (B, k, n) -> (B, k, m)."""
    if not isinstance(S, SparseEll):
        return S.mv_many(Vk)
    if S.m == 0 or S.n == 0:     # zero-row/col block (absent constraints)
        return Vk.new_zeros(Vk.shape[:2] + (S.m,), dtype=torch.float32)
    return _gather_sum(S.row_val, S.row_idx, Vk)


def mtv_many(S, Wk: torch.Tensor) -> torch.Tensor:
    """Stacked ``M^T @ w``: (B, k, m) -> (B, k, n)."""
    if not isinstance(S, SparseEll):
        return S.mtv_many(Wk)
    if S.m == 0 or S.n == 0:
        return Wk.new_zeros(Wk.shape[:2] + (S.n,), dtype=torch.float32)
    return _gather_sum(S.col_val, S.col_idx, Wk)


def mv(S, v: torch.Tensor) -> torch.Tensor:
    """``M @ v``: (B, n) -> (B, m)."""
    return mv_many(S, v[:, None])[:, 0]


def mtv(S, w: torch.Tensor) -> torch.Tensor:
    """``M^T @ w``: (B, m) -> (B, n)."""
    return mtv_many(S, w[:, None])[:, 0]


def colsq(S) -> torch.Tensor:
    """Per-column squared norms diag(M^T M) -> (B, n)."""
    if not isinstance(S, SparseEll):
        return S.colsq()
    return (S.col_val * S.col_val).sum(-1)


def rowsq(S: SparseEll) -> torch.Tensor:
    """Per-row squared norms diag(M M^T) -> (B, m)."""
    return (S.row_val * S.row_val).sum(-1)


def diag(S: SparseEll) -> torch.Tensor:
    """Main diagonal of a square sparse matrix -> (B, n)."""
    r = torch.arange(S.m, device=S.device)[None, :, None]
    return torch.where(S.row_idx == r, S.row_val,
                       torch.zeros_like(S.row_val)).sum(-1)


def gram(S: SparseEll, free: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense Gram matrix ``M_f M_f^T`` (B, m, m), columns masked by
    ``free`` (B, n): each column's Kc x Kc outer product added into place.
    A one-time cost at factorization (``woodbury.factorize``), never in
    the iteration; with 0/1 entries the sums are small integers, exact in
    any order."""
    if not isinstance(S, SparseEll):
        raise ValueError(
            "on-device Gram assembly is not provided for structured sparse "
            "types; pass a host-built ginv to init_state "
            "(ops.struct_ginv.build_struct_ginv)")
    cv = S.col_val
    if free is not None:
        cv = cv * free.to(cv.dtype)[:, :, None]
    B, n, K = S.col_idx.shape
    m = S.m
    flat = (S.col_idx[:, :, :, None] * m + S.col_idx[:, :, None, :])
    vv = cv[:, :, :, None] * cv[:, :, None, :]
    G = torch.zeros((B, m * m), dtype=torch.float32, device=S.device)
    G.scatter_add_(1, flat.reshape(B, -1), vv.reshape(B, -1))
    return G.view(B, m, m)


def to_dense(S: SparseEll) -> torch.Tensor:
    """Materialize (B, m, n): tests and small problems only."""
    B, m, K = S.row_idx.shape
    flat = torch.arange(m, device=S.device)[None, :, None] * S.n + S.row_idx
    D = torch.zeros((B, m * S.n), dtype=torch.float32, device=S.device)
    D.scatter_add_(1, flat.reshape(B, -1), S.row_val.reshape(B, -1))
    return D.view(B, m, S.n)


# --------------------------------------------------------------------------
# Host-side constructors (numpy; problems are assembled on the host)
# --------------------------------------------------------------------------

def _ell_pack(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
              nrows: int, K: Optional[int] = None
              ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Pack COO (by ``rows``) into ELL (nrows, K) idx/val arrays."""
    order = np.argsort(rows, kind="stable")
    rows, cols, vals = rows[order], cols[order], vals[order]
    counts = np.bincount(rows, minlength=nrows)
    k = int(counts.max()) if counts.size and counts.max() > 0 else 1
    K = max(K or 0, k, 1)
    idx = np.zeros((nrows, K), np.int64)
    val = np.zeros((nrows, K), np.float32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(len(rows)) - starts[rows]
    idx[rows, pos] = cols
    val[rows, pos] = vals
    return idx, val, K


def from_coo(coos: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
             shape: Tuple[int, int], device: Device = "cuda") -> SparseEll:
    """Batched SparseEll from per-instance COO triplets ``(rows, cols,
    vals)`` sharing one (m, n) shape; K is the batch's largest row
    (column) count."""
    dev = as_device(device)
    m, n = shape
    packed = []
    Kr = Kc = 1
    for rows, cols, vals in coos:
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        vals = np.asarray(vals, np.float32)
        if rows.size:
            Kr = max(Kr, int(np.bincount(rows, minlength=m).max()))
            Kc = max(Kc, int(np.bincount(cols, minlength=n).max()))
        packed.append((rows, cols, vals))
    B = len(coos)
    ri = np.zeros((B, m, Kr), np.int64)
    rv = np.zeros((B, m, Kr), np.float32)
    ci = np.zeros((B, n, Kc), np.int64)
    cv = np.zeros((B, n, Kc), np.float32)
    for b, (rows, cols, vals) in enumerate(packed):
        ri[b], rv[b], _ = _ell_pack(rows, cols, vals, m, Kr)
        ci[b], cv[b], _ = _ell_pack(cols, rows, vals, n, Kc)
    t = lambda a: torch.from_numpy(a).to(dev)
    return SparseEll(row_idx=t(ri), row_val=t(rv), col_idx=t(ci),
                     col_val=t(cv))


def from_dense(M: np.ndarray, tol: float = 0.0,
               device: Device = "cuda") -> SparseEll:
    """Convert a dense (B, m, n) batch (tests, interop)."""
    M = np.asarray(M)
    coos = []
    for b in range(M.shape[0]):
        rows, cols = np.nonzero(np.abs(M[b]) > tol)
        coos.append((rows, cols, M[b][rows, cols]))
    return from_coo(coos, M.shape[-2:], device=device)


def empty(batch: int, m: int, n: int, device: Device = "cuda") -> SparseEll:
    """Zero-row / zero-matrix block (absent constraints)."""
    dev = as_device(device)
    z = lambda r, dt: torch.zeros((batch, r, 1), dtype=dt, device=dev)
    return SparseEll(row_idx=z(m, torch.int64), row_val=z(m, torch.float32),
                     col_idx=z(n, torch.int64), col_val=z(n, torch.float32))
