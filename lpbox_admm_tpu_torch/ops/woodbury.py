"""Exact x-update factors: Woodbury (m side) and direct (n side).

The LP x-update solves ``(c I + rho4 E_f^T E_f) x = rhs`` on the free
columns, ``c = rho1 + rho2``.  Under the LP schedule ``c / rho4 = 2``
(``ratio``) is constant, so one factor serves until the next fix event:

* m side: ``G^{-1}`` with ``G = ratio I_m + E_f E_f^T``; the solve is
  ``(rhs - E^T G^{-1} E rhs) / c``;
* n side: ``H^{-1}`` with ``H = ratio I_n + E_f^T E_f`` (and ``E_f^T
  E_f`` for the warm-start residual); the solve is ``H^{-1} rhs / rho4``,
  the right side once compaction leaves n <= m.

Cholesky through ``torch.linalg`` in float32, as the JAX package does
it in f32 at highest precision.  Each inverse is the tracer's span
``woodbury.factor``.  Both library calls wait for the device, counted as
host reads: ``torch.linalg.cholesky`` reads its error flag back
(``woodbury.cholesky``), and on the card the batched
``torch.cholesky_solve`` (MAGMA's) synchronises its stream, besides a
``cudaMalloc`` and a ``cudaFree`` of its own (``woodbury.cholesky_solve``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import profiling


class WoodburyFactor(NamedTuple):
    ginv: torch.Tensor   # (B, m, m) explicit inverse of G
    ratio: float


class NsideFactor(NamedTuple):
    hinv: torch.Tensor   # (B, n, n) (ratio I + E_f^T E_f)^{-1}
    ete: torch.Tensor    # (B, n, n) E_f^T E_f
    ratio: float


def _spd_inverse(A: torch.Tensor) -> torch.Tensor:
    with profiling.span("woodbury.factor"):
        chol = profiling.read("woodbury.cholesky", torch.linalg.cholesky, A)
        eye = torch.eye(A.shape[-1], dtype=A.dtype,
                        device=A.device).expand(A.shape)
        return profiling.read("woodbury.cholesky_solve",
                              torch.cholesky_solve, eye, chol)


def factorize_from_gram(G: torch.Tensor, ratio: float) -> WoodburyFactor:
    """WoodburyFactor from an unshifted Gram ``E_f E_f^T``."""
    m = G.shape[-1]
    G = G.float() + ratio * torch.eye(m, dtype=torch.float32,
                                      device=G.device)
    return WoodburyFactor(ginv=_spd_inverse(G), ratio=ratio)


def factorize(E, free: torch.Tensor, ratio: float) -> WoodburyFactor:
    """Invert ``G = ratio I + E_f E_f^T`` for the free mask (B, n); E
    dense or an ``ops.sparse.SparseEll`` (its Gram assembled sparsely)."""
    from . import sparse as sparse_ops
    if sparse_ops.is_sparse(E):
        return factorize_from_gram(sparse_ops.gram(E, free), ratio)
    Ef = E.float() * free[:, None, :].float()
    return factorize_from_gram(Ef @ Ef.transpose(1, 2), ratio)


def factorize_nside(E: torch.Tensor, free: torch.Tensor,
                    ratio: float) -> NsideFactor:
    """Direct inverse of ``ratio I + E_f^T E_f`` on the n side."""
    Ef = E.float() * free[:, None, :].float()
    ete = Ef.transpose(1, 2) @ Ef
    n = ete.shape[-1]
    H = ete + ratio * torch.eye(n, dtype=ete.dtype, device=ete.device)
    return NsideFactor(hinv=_spd_inverse(H), ete=ete, ratio=ratio)


def solve(factor: WoodburyFactor, E: torch.Tensor, free: torch.Tensor,
          rhs: torch.Tensor, c) -> torch.Tensor:
    """Apply ``(c I + rho4 E_f^T E_f)^{-1}`` to ``rhs`` (masked to free);
    ``c`` is a scalar or a (B,) tensor."""
    free_f = free.to(rhs.dtype)
    rhs = rhs * free_f
    Erhs = torch.einsum("bmn,bn->bm", E, rhs)
    u = torch.einsum("bmk,bk->bm", factor.ginv, Erhs)
    corr = torch.einsum("bmn,bm->bn", E, u)
    c = torch.as_tensor(c, dtype=rhs.dtype, device=rhs.device)
    c_col = c[..., None] if c.ndim == 1 else c
    return free_f * (rhs - corr) / c_col
