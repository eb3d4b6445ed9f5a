"""The JAX package's ``ops/mxu_sparse.py`` API on the gather route.

The JAX module recasts the sparse products as iota-one-hot matmuls
because XLA's TPU lowering of an ELL gather serializes (its
mxu_sparse.py:1-12).  That premise belongs to the TPU: on the card a
gather over an ELL layout reads each index once and vectorizes, so the
port keeps one route, ``torch.gather`` over the layouts of
``ops/sparse.py``, and this module gives the JAX module's entry points
on it.  The A/B switches of the JAX package (``LPBOX_SPARSE``,
``LPBOX_MXU_EXACT``) chose between routes the card does not have, and
the products here are exact f32 gathers (the JAX package's ``exact``
payload mode); ROADMAP C records this as a departure on purpose.

``_limbs3`` is the three-limb bfloat16 split of an f32 vector, which the
port uses where a bfloat16 operand meets an f32 vector
(``core.lp._mv`` and its stacked forms on bfloat16 E or G^{-1}).
"""

from __future__ import annotations

import torch

from . import sparse as sparse_ops


def _limbs3(x: torch.Tensor) -> torch.Tensor:
    """Split f32 ``x`` into three bfloat16 limbs stacked on a new last
    axis: x = l0 + l1 + l2 to about 24 mantissa bits (f32-equivalent).
    Each limb is the round-to-nearest-even bfloat16 of what the limbs
    before it left, as ``lax.reduce_precision(x, 8, 7)`` gives it."""
    r = x.float()
    limbs = []
    for _ in range(3):
        l = r.to(torch.bfloat16)
        limbs.append(l)
        r = r - l.float()
    return torch.stack(limbs, dim=-1)


def mv_many(S: sparse_ops.SparseEll, Vk: torch.Tensor) -> torch.Tensor:
    """``M @ v`` for a stack: (B, k, n) -> (B, k, m)."""
    return sparse_ops.mv_many(S, Vk)


def mtv_many(S: sparse_ops.SparseEll, Wk: torch.Tensor) -> torch.Tensor:
    """``M^T @ w`` for a stack: (B, k, m) -> (B, k, n)."""
    return sparse_ops.mtv_many(S, Wk)


def mv(S: sparse_ops.SparseEll, v: torch.Tensor) -> torch.Tensor:
    """``M @ v``: (B, n) -> (B, m)."""
    return sparse_ops.mv(S, v)


def mtv(S: sparse_ops.SparseEll, w: torch.Tensor) -> torch.Tensor:
    """``M^T @ w``: (B, m) -> (B, n)."""
    return sparse_ops.mtv(S, w)
