"""K2: the fused policy forward (``csrc/policy.cu``) and its plain
PyTorch version.

Port of the JAX package's ``models/pallas_policy.py``.
``pack_policy_weights`` folds the policy module's BatchNorm layers into
per-feature affines, applies the attention init shift, and lays the
attention weights out per head (column h*K + k of q|k|v, row h*K + k of
the out-projection).  ``policy_operand`` lays the dense weights out as
the kernel reads them (fragment order for the tensor cores; the
classifier's first two layers split into TF32 hi|lo), once per solve.
``policy_scores_fused`` scores (rows, ws) trajectory rows: on CUDA
tensors with the CUDA kernels (one call, counted in ``LAUNCHES``), on
CPU tensors with ``policy_scores_plain``, the same math over the same
packed weights in f32.  Both take ``chunk`` windows (token t
= row[t*C : t*C+C], stride C) and ``sliding`` windows (stride 1).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
from torch import nn

from ..config import PolicyConfig

#: kernel launches made by ``policy_scores_fused`` in this process
LAUNCHES = 0


class PackedPolicy(NamedTuple):
    w_top: torch.Tensor   # (C, E) embed weights of the data channels
    peb: torch.Tensor     # (T, E) position encoding @ embed + embed bias
    wqkv: torch.Tensor    # (L, E, 3E) q|k|v, column h*K + k
    wo: torch.Tensor      # (L, E, E) out projection, row h*K + k
    g1: torch.Tensor      # (L, E) BN1 folded scale
    c1: torch.Tensor      # (L, E) BN1 folded shift
    w1: torch.Tensor      # (L, E, F) FF up
    b1: torch.Tensor      # (L, F)
    w2: torch.Tensor      # (L, F, E) FF down
    b2: torch.Tensor      # (L, E)
    g2: torch.Tensor      # (L, E) BN2 folded scale
    c2: torch.Tensor      # (L, E)
    wc0: torch.Tensor     # (T*E, 256) classifier
    bc0: torch.Tensor     # (256,)
    wc1: torch.Tensor     # (256, 128)
    bc1: torch.Tensor     # (128,)
    wc2: torch.Tensor     # (128, 16)
    bc2: torch.Tensor     # (16,)
    w3: torch.Tensor      # (16,) final logit weights
    b3: torch.Tensor      # (1,) final logit bias


def _fold_bn(bn: nn.BatchNorm1d):
    g = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    return g, bn.bias - bn.running_mean * g


@torch.no_grad()
def pack_policy_weights(model: nn.Module) -> PackedPolicy:
    """Pack a ``models.policy`` encoder (MHA or MLP) for the kernel."""
    W = model.embed.weight.t()                   # (C+P, E)
    C = model.chunk_dim
    E = W.shape[1]
    peb = model.pe @ W[C:] + model.embed.bias[None, :]
    L = len(model.layers)
    lists = {k: [] for k in ("wqkv", "wo", "g1", "c1", "w1", "b1", "w2",
                             "b2", "g2", "c2")}
    for layer in model.layers:
        att = layer.mha
        sh = att.shifted
        # (H, E, K) -> (E, H*K)
        lanes = lambda w: w.permute(1, 0, 2).reshape(E, -1)
        lists["wqkv"].append(torch.cat([lanes(sh(att.W_query)),
                                        lanes(sh(att.W_key)),
                                        lanes(sh(att.W_val))], dim=1))
        lists["wo"].append(sh(att.W_out).reshape(-1, E))
        g, c = _fold_bn(layer.bn1)
        lists["g1"].append(g), lists["c1"].append(c)
        lists["w1"].append(layer.ff[0].weight.t())
        lists["b1"].append(layer.ff[0].bias)
        lists["w2"].append(layer.ff[2].weight.t())
        lists["b2"].append(layer.ff[2].bias)
        g, c = _fold_bn(layer.bn2)
        lists["g2"].append(g), lists["c2"].append(c)
    dev = W.device
    F = lists["w1"][0].shape[1] if L else 0
    empty = {"wqkv": (0, E, 3 * E), "wo": (0, E, E), "w1": (0, E, F),
             "b1": (0, F), "w2": (0, F, E)}
    st = {k: (torch.stack(v) if v else
              torch.zeros(empty.get(k, (0, E)), device=dev))
          for k, v in lists.items()}
    cl = model.classifier.layers
    c = lambda t: t.detach().float().contiguous()
    return PackedPolicy(
        w_top=c(W[:C]), peb=c(peb), **{k: c(v) for k, v in st.items()},
        wc0=c(cl[0].weight.t()), bc0=c(cl[0].bias),
        wc1=c(cl[1].weight.t()), bc1=c(cl[1].bias),
        wc2=c(cl[2].weight.t()), bc2=c(cl[2].bias),
        w3=c(cl[3].weight[0]), b3=c(cl[3].bias))


def stride_of(pcfg: PolicyConfig) -> int:
    if pcfg.window_mode == "chunk":
        return pcfg.chunk_dim
    if pcfg.window_mode == "sliding":
        return 1
    raise ValueError(f"unknown window_mode {pcfg.window_mode!r}")


@torch.no_grad()
def policy_scores_plain(pk: PackedPolicy, rows: torch.Tensor, stride: int,
                        row_chunk: int = 8192) -> torch.Tensor:
    """Sigmoid scores (R,) for (R, ws) rows over the packed weights,
    ``row_chunk`` rows at a time to bound activation memory."""
    T, E = pk.peb.shape
    C = pk.w_top.shape[0]
    L = pk.wqkv.shape[0]
    H = 8
    scale = 1.0 / (E // H) ** 0.5
    outs = []
    for r0 in range(0, rows.shape[0], row_chunk):
        x = rows[r0:r0 + row_chunk].float()
        R = x.shape[0]
        tok = torch.stack([x[:, t * stride:t * stride + C]
                           for t in range(T)], dim=1)      # (R, T, C)
        h = tok @ pk.w_top + pk.peb
        for l in range(L):
            q, k, v = (h @ pk.wqkv[l]).reshape(R, T, 3, H, E // H).unbind(2)
            attn = torch.softmax(
                torch.einsum("rthd,rshd->rhts", q, k) * scale, dim=-1)
            heads = torch.einsum("rhts,rshd->rthd", attn, v).reshape(R, T, E)
            h1 = (h + heads @ pk.wo[l]) * pk.g1[l] + pk.c1[l]
            ff = torch.relu(h1 @ pk.w1[l] + pk.b1[l]) @ pk.w2[l] + pk.b2[l]
            h = (h1 + ff) * pk.g2[l] + pk.c2[l]
        z = torch.relu(h.reshape(R, T * E) @ pk.wc0 + pk.bc0)
        z = torch.relu(z @ pk.wc1 + pk.bc1)
        z = torch.relu(z @ pk.wc2 + pk.bc2)
        outs.append(torch.sigmoid((z * pk.w3).sum(-1) + pk.b3))
    return torch.cat(outs) if outs else rows.new_zeros((0,))


class PolicyOperand(NamedTuple):
    """The dense weights of a ``PackedPolicy`` as the kernel reads them
    (``policy_operand``): made once per solve and handed to every
    launch."""
    enc: torch.Tensor     # (L, 65536 + 256 F) encoder stream, f32
    wc0: torch.Tensor     # (T*E*256*2,) classifier layer 0, hi|lo
    wc1: torch.Tensor     # (256*128*2,) classifier layer 1, hi|lo


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on the bits: 10 of f32's 23 mantissa bits,
    rounded to nearest with ties away from zero."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor):
    """x = hi + lo with hi = tf32(x) and lo = tf32(x - hi) (x - hi is
    exact in f32)."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def _frag(w: torch.Tensor) -> torch.Tensor:
    """(K, N) -> (K/8, N/16, 32, 4): the m16n8k8 A fragments of w^T, the
    N output features as rows.  Lane 4g + t of k-step ks and m-tile mt
    holds w[8ks + 2t, 16mt + g], w[8ks + 2t, 16mt + g + 8], w[8ks + 2t
    + 1, 16mt + g], w[8ks + 2t + 1, 16mt + g + 8]: k slot t is k 2t and
    slot t + 4 is k 2t + 1, so the token operand is one 8-byte load."""
    K, N = w.shape
    return w.reshape(K // 8, 4, 2, N // 16, 2, 8).permute(
        0, 3, 5, 1, 2, 4).reshape(K // 8, N // 16, 32, 4)


def frag_order(w: torch.Tensor) -> torch.Tensor:
    """(K, N) f32 -> (K*N,) in fragment order ([k-step][m-tile][lane]
    [4]), the layout of the encoder's weight stream."""
    return _frag(w).reshape(-1)


def frag_order_split(w: torch.Tensor) -> torch.Tensor:
    """(K, N) f32 -> (2*K*N,): for each (k-step, m-tile) the 32 lanes' 4
    hi values, then their 4 lo values (``tf32_split``)."""
    hi, lo = tf32_split(w)
    return torch.stack([_frag(hi), _frag(lo)], dim=2).reshape(-1)


def encoder_stream(pk: PackedPolicy, layer: int) -> torch.Tensor:
    """One layer's dense weights in the order the encoder kernel streams
    them: q|k (256 columns of wqkv), v (128), the out-projection, then
    for each 256-unit half of the feed-forward its up and down
    projections; each in fragment order."""
    E, FH = pk.wqkv.shape[1], 256
    parts = [pk.wqkv[layer][:, :2 * E], pk.wqkv[layer][:, 2 * E:],
             pk.wo[layer]]
    for f0 in range(0, pk.w1.shape[-1], FH):
        parts += [pk.w1[layer][:, f0:f0 + FH], pk.w2[layer][f0:f0 + FH]]
    return torch.cat([frag_order(p) for p in parts])


@torch.no_grad()
def policy_operand(pk: PackedPolicy) -> PolicyOperand:
    """The kernel's weights (plain torch, any device): the encoder
    stream of every layer (f32) and the classifier's first two layers
    split into TF32 hi|lo, all in fragment order."""
    L, E = pk.wqkv.shape[:2]
    F = pk.w1.shape[-1]
    enc = torch.stack([encoder_stream(pk, l) for l in range(L)]) if L \
        else pk.wqkv.new_zeros((0, E * 4 * E + 2 * E * F))
    return PolicyOperand(enc=enc.contiguous(),
                         wc0=frag_order_split(pk.wc0),
                         wc1=frag_order_split(pk.wc1))


class _Args(ctypes.Structure):
    """ctypes mirror of ``PolicyArgs`` in csrc/policy.cu."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "rows", "enc", "wc0", "wc1", "w_top", "peb", "g1", "c1", "b1", "b2",
        "g2", "c2", "bc0", "bc1", "wc2", "bc2", "w3", "b3", "hout",
        "out")] + [(name, ctypes.c_int) for name in (
            "n_rows", "ws", "T", "C", "stride", "L", "F")]


def _check(name, t, shape, dev):
    if t.device != dev or t.dtype != torch.float32 or \
            tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous float32 {shape} "
                         f"on {dev}, got {t.dtype} {tuple(t.shape)} "
                         f"on {t.device}")


def policy_scores_cuda(pk: PackedPolicy, rows: torch.Tensor, stride: int,
                       op: Optional[PolicyOperand] = None) -> torch.Tensor:
    """Launch the CUDA kernels on PyTorch's current stream.  ``op``:
    ``policy_operand(pk)``, made by the caller once per solve (else made
    here).  Shapes the kernel does not take are refused before any
    launch."""
    from ..kernels import build

    dev = rows.device
    n_rows, ws = rows.shape
    T, E = pk.peb.shape
    C = pk.w_top.shape[0]
    L = pk.wqkv.shape[0]
    F = pk.w1.shape[-1]
    if E != 128 or T > 20 or (L and F % 256):
        raise ValueError(f"kernel takes E=128, T<=20, F%256==0: "
                         f"{(E, T, F)}")
    if (T - 1) * stride + C > ws:
        raise ValueError(f"{T} tokens of {C} at stride {stride} exceed "
                         f"rows of {ws}")
    shapes = dict(w_top=(C, E), peb=(T, E), wqkv=(L, E, 3 * E),
                  wo=(L, E, E), g1=(L, E), c1=(L, E), w1=(L, E, F),
                  b1=(L, F), w2=(L, F, E), b2=(L, E), g2=(L, E), c2=(L, E),
                  wc0=(T * E, 256), bc0=(256,), wc1=(256, 128), bc1=(128,),
                  wc2=(128, 16), bc2=(16,), w3=(16,), b3=(1,))
    for name, shape in shapes.items():
        _check(name, getattr(pk, name), shape, dev)
    if rows.dtype != torch.float32 or not rows.is_contiguous():
        raise ValueError("rows must be contiguous float32")
    if op is None:
        op = policy_operand(pk)
    for name, shape in dict(enc=(L, 4 * E * E + 2 * E * F),
                            wc0=(T * E * 256 * 2,),
                            wc1=(256 * 128 * 2,)).items():
        _check(f"op.{name}", getattr(op, name), shape, dev)
    hout = torch.empty((n_rows, T * E), dtype=torch.float32, device=dev)
    out = torch.empty((n_rows,), dtype=torch.float32, device=dev)
    p = build.ptr
    args = _Args(p(rows), p(op.enc), p(op.wc0), p(op.wc1),
                 *(p(getattr(pk, f)) for f in (
                     "w_top", "peb", "g1", "c1", "b1", "b2", "g2", "c2",
                     "bc0", "bc1", "wc2", "bc2", "w3", "b3")),
                 p(hout), p(out), n_rows, ws, T, C, stride, L, F)
    lib = build.library()
    build.check_struct(lib, "lpbox_policy_args_size", _Args)
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(lib, lib.lpbox_policy_forward(ctypes.addressof(args), stream),
                "policy kernel")
    return out


def policy_scores_fused(pk: PackedPolicy, rows: torch.Tensor,
                        pcfg: PolicyConfig,
                        op: Optional[PolicyOperand] = None) -> torch.Tensor:
    """Sigmoid scores (R,) for (R, ws) trajectory rows: the CUDA kernels
    on a CUDA tensor (``op``: ``policy_operand(pk)``, made once per
    solve), the plain version on a CPU tensor."""
    global LAUNCHES
    stride = stride_of(pcfg)
    if pk.peb.shape[0] != pcfg.node_size or \
            pk.w_top.shape[0] != pcfg.chunk_dim:
        raise ValueError("packed weights do not match node_size/chunk_dim")
    if rows.is_cuda:
        out = policy_scores_cuda(pk, rows.contiguous(), stride, op)
        LAUNCHES += 1
        return out
    if rows.device.type == "cpu":
        return policy_scores_plain(pk, rows, stride)
    raise ValueError(f"no policy kernel for device {rows.device}")
