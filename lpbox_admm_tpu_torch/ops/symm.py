"""K4: the symmetric G^{-1} matvec that reads only the lower-triangle
blocks (``csrc/symm.cu``), its plain PyTorch version and the packing.

Port of the JAX package's ``ops/symm_xla.py`` (the plain version and
the packing) and ``ops/pallas_symm.py`` (the kernel).  The Woodbury
x-update applies the symmetric (B, m, m) G^{-1} to one m-vector per
ADMM iteration; at the large CA rungs that read is the iteration's
second-largest stream after E.  ``pack_tril`` stores the L = T(T+1)/2
lower 128 x 128 blocks once per window, (B, L, bm, bm) with block-row r,
block-column c <= r in row-major order, and the apply reads each of them
once for ``y_r += G_rc v_c`` and, off the diagonal, ``y_c += G_rc^T
v_r``: 0.54x the dense bytes at m = 1664.

``symm_matvec`` launches the CUDA kernel on a CUDA tensor (counted in
``LAUNCHES``) and runs ``symm_matvec_plain`` on a CPU tensor.  The lower
triangle is taken as the truth; a Cholesky-solve inverse is symmetric
to float32 rounding.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

BM = 128

#: kernel launches made by ``symm_matvec_cuda`` in this process
LAUNCHES = 0


def _block_index(mb: int):
    """(row, col) of the packed blocks, row-major over the lower
    triangle: slot l holds block (r, c) with l = r(r+1)/2 + c."""
    blocks = [(r, c) for r in range(mb) for c in range(r + 1)]
    ridx = np.array([r for r, _ in blocks], np.int64)
    cidx = np.array([c for _, c in blocks], np.int64)
    return ridx, cidx


def packable(m: int, bm: int = BM) -> bool:
    return m % bm == 0 and m // bm >= 2


def pack_tril(ginv: torch.Tensor, bm: int = BM) -> torch.Tensor:
    """(B, m, m) symmetric -> (B, L, bm, bm) lower-triangle blocks."""
    B, m, m2 = ginv.shape
    if m != m2 or m % bm:
        raise ValueError(f"pack_tril needs a square (B, m, m) with m a "
                         f"multiple of {bm}, got {tuple(ginv.shape)}")
    mb = m // bm
    ridx, cidx = _block_index(mb)
    Gb = ginv.float().reshape(B, mb, bm, mb, bm).transpose(2, 3)
    dev = ginv.device
    return Gb[:, torch.from_numpy(ridx).to(dev),
              torch.from_numpy(cidx).to(dev)].contiguous()


def _shape(Gp: torch.Tensor, v: torch.Tensor):
    B, L, bm, bm2 = Gp.shape
    m = v.shape[-1]
    mb = m // bm
    if bm != bm2 or m % bm or L != mb * (mb + 1) // 2 or \
            tuple(v.shape) != (B, m):
        raise ValueError(f"packed blocks {tuple(Gp.shape)} do not match "
                         f"v {tuple(v.shape)}")
    return B, L, bm, m, mb


def symm_matvec_plain(Gp: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """y = G v from the packed blocks, in plain tensor code (the JAX
    package's ``symm_xla.symm_matvec``): block gathers and scatters as
    one-hot matrix products, so the sums keep one order on every
    device."""
    B, L, bm, m, mb = _shape(Gp, v)
    ridx, cidx = _block_index(mb)
    eye = np.eye(mb, dtype=np.float32)
    dev = v.device
    sel_r = torch.from_numpy(eye[ridx]).to(dev)                 # (L, mb)
    sel_c = torch.from_numpy(eye[cidx]).to(dev)
    off = torch.from_numpy((ridx != cidx).astype(np.float32)).to(dev)
    V = v.float().reshape(B, mb, bm)
    Vc = torch.einsum("lk,bki->bli", sel_c, V)                  # (B, L, bm)
    Vr = torch.einsum("lk,bki->bli", sel_r, V)
    G = Gp.float()
    P1 = (G @ Vc[..., None])[..., 0]                             # rows ridx
    P2 = (G.transpose(-1, -2) @ Vr[..., None])[..., 0] \
        * off[None, :, None]                                     # rows cidx
    U = torch.einsum("lk,bli->bki", sel_r, P1) \
        + torch.einsum("lk,bli->bki", sel_c, P2)
    return U.reshape(B, m)


class _Args(ctypes.Structure):
    """ctypes mirror of ``SymmArgs`` in csrc/symm.cu."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "Gp", "v", "y", "part")] + [
        (name, ctypes.c_int) for name in ("B", "m", "T", "L")]


def symm_matvec_cuda(Gp: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream."""
    global LAUNCHES
    from ..kernels import build

    B, L, bm, m, mb = _shape(Gp, v)
    if bm != BM:
        raise ValueError(f"the kernel takes {BM} x {BM} blocks, got {bm}")
    for name, t in (("Gp", Gp), ("v", v)):
        if not t.is_cuda or t.device != Gp.device:
            raise ValueError(f"{name}: expected a tensor on the CUDA device "
                             f"of Gp, got device {t.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous float32, got "
                             f"{t.dtype}")
    y = torch.empty((B, m), dtype=torch.float32, device=v.device)
    part = torch.empty((B, L, 2, BM), dtype=torch.float32, device=v.device)
    p = build.ptr
    args = _Args(p(Gp), p(v), p(y), p(part), B, m, mb, L)
    lib = build.library()
    build.check_struct(lib, "lpbox_symm_args_size", _Args)
    stream = torch.cuda.current_stream(v.device).cuda_stream
    build.check(lib, lib.lpbox_symm_matvec(ctypes.addressof(args), stream),
                "symm kernel")
    LAUNCHES += 1
    return y


def symm_matvec(Gp: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """y = G v from ``pack_tril``'s blocks: the kernel on a CUDA tensor,
    the plain version on a CPU tensor."""
    if v.is_cuda:
        return symm_matvec_cuda(Gp, v)
    if v.device.type == "cpu":
        return symm_matvec_plain(Gp, v)
    raise ValueError(f"no symmetric matvec for device {v.device}")
