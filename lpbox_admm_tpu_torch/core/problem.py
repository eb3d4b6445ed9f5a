"""Batched problem container.

A batch of binary LPs is dense, padded and statically shaped, the
instance batch being the leading axis of every tensor.

Padding contract:
  * padded constraint rows have ``E`` row = 0, ``f`` = 1, ``row_mask`` = False
  * padded variables have ``b`` = 0, ``E`` column = 0, ``var_mask`` = False;
    the solver treats them as fixed-to-0 from the start.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch

Device = Union[str, torch.device]


def as_device(device: Device) -> torch.device:
    """``torch.device`` for ``device``; a CUDA device without CUDA raises
    instead of quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class LpProblem:
    """Batched binary LP: min b.x  s.t.  E x <= f,  x in {0,1}^n."""

    b: torch.Tensor          # (B, n) objective (minimization form)
    E: torch.Tensor          # (B, m, n) inequality constraint matrix
    f: torch.Tensor          # (B, m) rhs
    row_mask: torch.Tensor   # (B, m) bool, valid constraint rows
    var_mask: torch.Tensor   # (B, n) bool, valid variables

    @property
    def batch(self) -> int:
        return self.b.shape[0]

    @property
    def n(self) -> int:
        return self.b.shape[-1]

    @property
    def m(self) -> int:
        return self.f.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.b.device

    def replace(self, **kw) -> "LpProblem":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class QpProblem:
    """Batched unconstrained binary QP in dense form: min x.A x + b.x,
    x in {0,1}^n.  A plain container (the JAX package's
    ``core/problem.QpProblem``, which no solver takes): the grid
    segmentation QP is ``core.qp.QpProblem`` (A as a stencil), a dense
    or sparse A goes through ``core.general``."""

    A: torch.Tensor          # (B, n, n) symmetric
    b: torch.Tensor          # (B, n)
    var_mask: torch.Tensor   # (B, n)
    const: torch.Tensor      # (B,) additive constant (Seg's unary offset c)

    @property
    def batch(self) -> int:
        return self.b.shape[0]

    @property
    def n(self) -> int:
        return self.b.shape[-1]


def pad_to(x: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """Zero-pad ``x`` up to ``shape`` (trailing padding per axis)."""
    pads = [(0, t - s) for s, t in zip(x.shape, shape)]
    return np.pad(x, pads)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def stack_lp_instances(
    bs: Sequence[np.ndarray],
    Es: Sequence[np.ndarray],
    fs: Optional[Sequence[np.ndarray]] = None,
    n_pad: Optional[int] = None,
    m_pad: Optional[int] = None,
    align: int = 128,
    dtype=np.float32,
    device: Device = "cuda",
) -> LpProblem:
    """Stack heterogeneous dense LP instances into one padded batch,
    shapes rounded up to ``align``."""
    dev = as_device(device)
    B = len(bs)
    ns = [b.shape[0] for b in bs]
    ms = [E.shape[0] for E in Es]
    n = n_pad or round_up(max(ns), align)
    m = m_pad or round_up(max(ms), align)

    b_arr = np.zeros((B, n), dtype=dtype)
    E_arr = np.zeros((B, m, n), dtype=dtype)
    f_arr = np.ones((B, m), dtype=dtype)
    rmask = np.zeros((B, m), dtype=bool)
    vmask = np.zeros((B, n), dtype=bool)
    for i, (bi, Ei) in enumerate(zip(bs, Es)):
        ni, mi = ns[i], ms[i]
        b_arr[i, :ni] = bi
        E_arr[i, :mi, :ni] = Ei
        if fs is not None:
            f_arr[i, :mi] = fs[i]
        rmask[i, :mi] = True
        vmask[i, :ni] = True
    t = lambda a: torch.from_numpy(a).to(dev)
    return LpProblem(b=t(b_arr), E=t(E_arr), f=t(f_arr),
                     row_mask=t(rmask), var_mask=t(vmask))
