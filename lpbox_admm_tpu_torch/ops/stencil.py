"""Grid-stencil operator of the segmentation QPs (the port of the JAX
package's ``ops/stencil.py``).

A pixel grid's ``A' = D - W`` (D = diag(W 1)) is a stencil: its matvec
is a sum of 8 shifted elementwise products, batched over images, with no
sparse format (reference Segmentation/.../image_segmentation_utils.cpp
``get_binary_cost``/``get_A_b_from_cost`` store W sparsely).

Edge weights are (B, 8, H, W) planes: ``w[:, d, i, j]`` is the weight
between pixel (i, j) and its neighbour in direction ``OFFSETS[d]``;
out-of-grid and masked-out neighbours carry weight 0.  Shifts are
slices: ``shift`` copies the in-grid block into a zeroed output, and the
matvec adds each direction's product into the in-grid block of its
output, so no pixel outside the grid is read.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

#: 8-neighbourhood offsets (row, col)
OFFSETS: Tuple[Tuple[int, int], ...] = (
    (-1, -1), (-1, 0), (-1, 1),
    (0, -1), (0, 1),
    (1, -1), (1, 0), (1, 1),
)


def _span(d: int, size: int) -> Tuple[slice, slice]:
    """(destination, source) slices along one axis for a shift by d:
    result[i] = x[i + d] where 0 <= i + d < size."""
    lo, hi = max(0, -d), min(size, size - d)
    return slice(lo, hi), slice(lo + d, hi + d)


def shift(x: torch.Tensor, dr: int, dc: int) -> torch.Tensor:
    """Shift (..., H, W) so that result[i, j] = x[i + dr, j + dc], zero
    outside the grid."""
    H, W = x.shape[-2], x.shape[-1]
    (r_dst, r_src), (c_dst, c_src) = _span(dr, H), _span(dc, W)
    out = torch.zeros_like(x)
    out[..., r_dst, c_dst] = x[..., r_src, c_src]
    return out


@dataclasses.dataclass(frozen=True)
class Stencil:
    """A' = diag(degree) - W as neighbour weight planes."""

    weights: torch.Tensor   # (B, 8, H, W)
    degree: torch.Tensor    # (B, H, W) = sum of incident weights

    @property
    def grid(self) -> Tuple[int, int]:
        return self.weights.shape[-2], self.weights.shape[-1]

    def w_matvec(self, x: torch.Tensor) -> torch.Tensor:
        """(W x) for x of shape (B, H, W)."""
        H, W = x.shape[-2], x.shape[-1]
        out = torch.zeros_like(x)
        for d, (dr, dc) in enumerate(OFFSETS):
            (r_dst, r_src), (c_dst, c_src) = _span(dr, H), _span(dc, W)
            out[..., r_dst, c_dst] += (self.weights[:, d, r_dst, c_dst]
                                       * x[..., r_src, c_src])
        return out

    def a_matvec(self, x: torch.Tensor) -> torch.Tensor:
        """(A' x) = degree * x - W x."""
        return self.degree * x - self.w_matvec(x)

    def a_diag(self) -> torch.Tensor:
        """diag(A') = degree (W has an empty diagonal)."""
        return self.degree


def build_stencil(weights: torch.Tensor) -> Stencil:
    """The operator of weight planes, its degrees computed."""
    return Stencil(weights=weights, degree=weights.sum(1))


def quad_form(st: Stencil, x: torch.Tensor) -> torch.Tensor:
    """x^T A' x per batch element, x of shape (B, H, W)."""
    return (x * st.a_matvec(x)).sum((-2, -1))
