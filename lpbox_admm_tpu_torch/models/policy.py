"""Early-fixing policy networks as ``torch.nn`` modules.

The port of the JAX package's ``models/policy.py`` (reference
LinerProgramming/LinearProgramming/mha.py):

* ``GraphAttentionEncoder`` (mha.py:202-253): per-variable trajectory
  chunks (B, node_size, chunk_dim) + sinusoidal position encoding
  (concat) -> linear embed -> n_layers x ``MHALayer`` -> flatten ->
  ``Classifier`` -> (logit, sigmoid).
* ``MLPEncoder`` (mha.py:255-304): the same without attention.
* ``FixingEncoder`` (mha.py:307-367): the MLP with an 11-way head.

Parameter layouts follow the flax checkpoints (``utils/checkpoint``
maps them): attention tensors are (heads, in, key) and (heads, key,
out), and the reference's init shift -- the stored attention weights
are U(0, 2 stdv) and the layer subtracts stdv = 1/sqrt(last dim) when
it runs -- is kept in ``MultiHeadAttention.forward``, so the stored
(raw) tensor is what trains, as in flax.  In training mode the
BatchNorm layers follow flax (``BatchNorm``); ``init_weights`` draws
fresh weights with flax's initializers from a ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn


def position_encoding(n_pos: int, d: int) -> torch.Tensor:
    """Sinusoidal position encoding (reference common/utils.py:20-32).
    Row 0 is zeroed before sin/cos, so its cos slots are 1 (the
    reference's quirk, kept)."""
    pe = np.array(
        [[pos / np.power(10000, 2 * (j // 2) / d) for j in range(d)]
         if pos != 0 else np.zeros(d) for pos in range(n_pos)])
    pe[:, 0::2] = np.sin(pe[:, 0::2])
    pe[:, 1::2] = np.cos(pe[:, 1::2])
    return torch.tensor(pe, dtype=torch.float32)


class MultiHeadAttention(nn.Module):
    """Self-attention with per-head projection tensors (mha.py:20-122)."""

    def __init__(self, n_heads: int = 8, embed_dim: int = 128):
        super().__init__()
        key_dim = embed_dim // n_heads
        self.W_query = nn.Parameter(torch.empty(n_heads, embed_dim, key_dim))
        self.W_key = nn.Parameter(torch.empty(n_heads, embed_dim, key_dim))
        self.W_val = nn.Parameter(torch.empty(n_heads, embed_dim, key_dim))
        self.W_out = nn.Parameter(torch.empty(n_heads, key_dim, embed_dim))
        for w in (self.W_query, self.W_key, self.W_val, self.W_out):
            uniform_shifted_(w)

    @staticmethod
    def shifted(w: torch.Tensor) -> torch.Tensor:
        """The weight the layer applies: stored value minus stdv."""
        return w - 1.0 / math.sqrt(w.shape[-1])

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        key_dim = self.W_query.shape[-1]
        q = torch.einsum("btd,hdk->bhtk", h, self.shifted(self.W_query))
        k = torch.einsum("btd,hdk->bhtk", h, self.shifted(self.W_key))
        v = torch.einsum("btd,hdk->bhtk", h, self.shifted(self.W_val))
        logits = torch.einsum("bhtk,bhsk->bhts", q, k) / math.sqrt(key_dim)
        attn = torch.softmax(logits, dim=-1)
        heads = torch.einsum("bhts,bhsk->bhtk", attn, v)
        return torch.einsum("bhtk,hke->bte", heads,
                            self.shifted(self.W_out))


def uniform_shifted_(w: torch.Tensor,
                     generator: Optional[torch.Generator] = None):
    """The reference's attention init as flax stores it: U(0, 2 stdv),
    stdv = 1/sqrt(last dim) (the layer subtracts stdv)."""
    with torch.no_grad():
        return w.uniform_(0.0, 2.0 / math.sqrt(w.shape[-1]),
                          generator=generator)


class BatchNorm(nn.BatchNorm1d):
    """``nn.BatchNorm`` of flax over the rows of (N, D) (policy.py:90-97,
    ``momentum=0.9``, ``epsilon=1e-5``).  In training mode the batch is
    normalized with its biased variance, and the running variance is
    updated with that same biased variance (``BatchNorm1d`` would use
    the unbiased one); ``momentum`` keeps torch's convention, 0.1 = 1 -
    flax's 0.9.  The variance is taken in two passes, E[(x - E[x])^2]:
    flax's one pass, E[x^2] - E[x]^2, cancels where a feature's mean is
    large against its spread, as on the shipped checkpoint's layers, and
    its backward pass then loses the gradient's accuracy
    (``tests/test_torch_imitation.py`` prints both against the float64
    gradient).  In evaluation mode it is ``BatchNorm1d``'s
    running-statistics affine.

    With ``mesh`` set to a data-parallel mesh of more than one rank
    (``set_batchnorm_mesh``), training mode normalizes with the moments
    of the global batch, as flax's BatchNorm over a sharded batch does:
    the mean is the all-reduced sum of the rows over the all-reduced row
    count, the variance the all-reduced sum of (x - mean)^2 over that
    count (the same two passes), both all-reduces differentiable, so
    that the backward pass is the global one, and the running statistics
    take the global moments, the same on every rank.  Without a mesh the
    module is as described above, bit for bit."""

    mesh = None

    def __getstate__(self):
        # a process group does not pickle; a module sent elsewhere leaves
        # its mesh behind
        state = dict(super().__getstate__())
        state.pop("mesh", None)
        return state

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        mesh = self.mesh
        if mesh is None or mesh.world == 1:
            mean = x.mean(0)
            xc = x - mean
            var = (xc * xc).mean(0)
        else:
            from ..parallel.mesh import all_reduce_sum
            s = all_reduce_sum(torch.cat([x.sum(0),
                                          x.new_full((1,), x.shape[0])]),
                               mesh)
            n = s[-1]
            mean = s[:-1] / n
            xc = x - mean
            var = all_reduce_sum((xc * xc).sum(0), mesh) / n
        with torch.no_grad():
            mo = self.momentum
            self.running_mean.mul_(1.0 - mo).add_(mo * mean)
            self.running_var.mul_(1.0 - mo).add_(mo * var)
        return xc * torch.rsqrt(var + self.eps) * self.weight + self.bias


def set_batchnorm_mesh(model: nn.Module, mesh) -> nn.Module:
    """Give every ``BatchNorm`` of ``model`` the data-parallel ``mesh``
    whose global batch it normalizes over in training mode (None: each
    rank's own rows)."""
    for mod in model.modules():
        if isinstance(mod, BatchNorm):
            mod.mesh = mesh
    return model


class MHALayer(nn.Module):
    """Skip(MHA) -> BatchNorm -> Skip(FF) -> BatchNorm (mha.py:157-183)."""

    def __init__(self, n_heads: int = 8, embed_dim: int = 128,
                 feed_forward_hidden: int = 512):
        super().__init__()
        self.mha = MultiHeadAttention(n_heads, embed_dim)
        self.bn1 = BatchNorm(embed_dim, eps=1e-5, momentum=0.1)
        self.ff = nn.Sequential(nn.Linear(embed_dim, feed_forward_hidden),
                                nn.ReLU(),
                                nn.Linear(feed_forward_hidden, embed_dim))
        self.bn2 = BatchNorm(embed_dim, eps=1e-5, momentum=0.1)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        B, T, D = h.shape
        h = h + self.mha(h)
        h = self.bn1(h.reshape(B * T, D)).reshape(B, T, D)
        h = h + self.ff(h)
        return self.bn2(h.reshape(B * T, D)).reshape(B, T, D)


class Classifier(nn.Module):
    """``Net2``: in -> 256 -> 128 -> 16 -> out (mha.py:185-199)."""

    def __init__(self, in_dim: int, out_dim: int = 1):
        super().__init__()
        self.layers = nn.ModuleList([
            nn.Linear(in_dim, 256), nn.Linear(256, 128), nn.Linear(128, 16),
            nn.Linear(16, out_dim)])

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        for layer in self.layers[:-1]:
            h = torch.relu(layer(h))
        return self.layers[-1](h)


class _Encoder(nn.Module):
    def __init__(self, n_layers: int, node_size: int, chunk_dim: int,
                 pe_dim: int, embed_dim: int, n_heads: int,
                 feed_forward_hidden: int, out_dim: int):
        super().__init__()
        self.node_size, self.chunk_dim, self.pe_dim = \
            node_size, chunk_dim, pe_dim
        self.register_buffer("pe", position_encoding(node_size, pe_dim),
                             persistent=False)
        self.embed = nn.Linear(chunk_dim + pe_dim, embed_dim)
        self.layers = nn.ModuleList([
            MHALayer(n_heads, embed_dim, feed_forward_hidden)
            for _ in range(n_layers)])
        self.classifier = Classifier(node_size * embed_dim, out_dim)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, node_size, chunk_dim) -> (logit, sigmoid), each (B, out)."""
        B, T, _ = x.shape
        x = torch.cat([x, self.pe[None].expand(B, T, self.pe_dim)], dim=-1)
        h = self.embed(x)
        for layer in self.layers:
            h = layer(h)
        logit = self.classifier(h.flatten(1))
        return logit, torch.sigmoid(logit)


class GraphAttentionEncoder(_Encoder):
    """MHA policy (mha.py:202-253)."""

    def __init__(self, node_size: int = 20, chunk_dim: int = 5,
                 pe_dim: int = 5, embed_dim: int = 128, n_heads: int = 8,
                 n_layers: int = 2, feed_forward_hidden: int = 512,
                 out_dim: int = 1):
        super().__init__(n_layers, node_size, chunk_dim, pe_dim, embed_dim,
                         n_heads, feed_forward_hidden, out_dim)


class MLPEncoder(_Encoder):
    """MLP ablation: embed + flatten + classify (mha.py:255-304)."""

    def __init__(self, node_size: int = 20, chunk_dim: int = 5,
                 pe_dim: int = 5, embed_dim: int = 128, out_dim: int = 1):
        super().__init__(0, node_size, chunk_dim, pe_dim, embed_dim, 8, 512,
                         out_dim)


class FixingEncoder(_Encoder):
    """11-way fixing head variant (mha.py:307-367): embed + flatten +
    an 11-output classifier, no attention."""

    def __init__(self, node_size: int = 20, chunk_dim: int = 5,
                 pe_dim: int = 5, embed_dim: int = 128):
        super().__init__(0, node_size, chunk_dim, pe_dim, embed_dim, 8, 512,
                         11)


def build_policy(net: str, node_size: int = 20, chunk_dim: int = 5,
                 pe_dim: int = 5, out_dim: int = 1) -> nn.Module:
    """Factory mirroring the reference's ``-net mha|mlp|fixing`` flag;
    the module is returned in evaluation mode."""
    if net == "mha":
        model = GraphAttentionEncoder(node_size, chunk_dim, pe_dim,
                                      out_dim=out_dim)
    elif net == "mlp":
        model = MLPEncoder(node_size, chunk_dim, pe_dim, out_dim=out_dim)
    elif net == "fixing":
        model = FixingEncoder(node_size, chunk_dim, pe_dim)
    else:
        raise ValueError(f"unknown net {net!r}; expected "
                         "'mha'|'mlp'|'fixing'")
    return model.eval()


def lecun_normal_(w: torch.Tensor,
                  generator: Optional[torch.Generator] = None):
    """flax's default Dense kernel init on an ``nn.Linear`` weight (out,
    in): a normal truncated to +-2 standard deviations, scaled to
    variance 1/fan_in (jax ``variance_scaling(1, "fan_in",
    "truncated_normal")``)."""
    std = math.sqrt(1.0 / w.shape[1]) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
        return w.mul_(std)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fresh weights with flax's initializers, drawn from ``generator``
    (the distributions of the JAX package's ``model.init``, not its
    PRNG's bits): Dense kernels ``lecun_normal``, biases 0, attention
    tensors U(0, 2 stdv), BatchNorm scale 1, bias 0, running mean 0 and
    variance 1."""
    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            lecun_normal_(mod.weight, generator)
            mod.bias.zero_()
        elif isinstance(mod, MultiHeadAttention):
            for w in (mod.W_query, mod.W_key, mod.W_val, mod.W_out):
                uniform_shifted_(w, generator)
        elif isinstance(mod, BatchNorm):
            mod.reset_parameters()
    return model
