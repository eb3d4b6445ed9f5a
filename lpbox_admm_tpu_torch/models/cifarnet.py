"""CifarNet victim model (the port of the JAX package's
``models/cifarnet.py``; reference SparseAttack/SparseAttack/model.py:3-37).

4 valid 3x3 convs (3->64->64, pool, 64->128->128, pool) and 3 dense
layers (3200->256->256->10) with ReLU, dropout 0.5 after fc1 in training
only; NCHW throughout, so the flatten before fc1 is the reference's
``view(-1, 3200)`` and the JAX model's transpose-back-then-reshape.

Weights: ``victim_from_flax`` carries the JAX package's flax variables
across (conv kernels (kh, kw, in, out) -> (out, in, kh, kw), dense
kernels (in, out) -> (out, in)); ``load_victim_npz`` reads the shipped
``checkpoints/cifar_victim.npz`` (``leaf/NNNNN`` in flax's tree order:
conv1.bias, conv1.kernel, ..., fc3.kernel); ``load_torch_checkpoint``
reads the reference's ``cifar_best.pth`` where a user has it (the
repository does not ship it).  ``init_victim(seed)`` draws torch's own
initialisation from ``seed``: JAX's PRNG is not reproduced, so a seeded
random victim differs between the packages (tests carry weights across).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.problem import Device, as_device

LAYERS = ("conv1", "conv2", "conv3", "conv4", "fc1", "fc2", "fc3")


class CifarNet(nn.Module):
    """Input (B, 3, 32, 32); returns logits (B, 10)."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 3)
        self.conv2 = nn.Conv2d(64, 64, 3)
        self.conv3 = nn.Conv2d(64, 128, 3)
        self.conv4 = nn.Conv2d(128, 128, 3)
        self.fc1 = nn.Linear(3200, 256)
        self.fc2 = nn.Linear(256, 256)
        self.fc3 = nn.Linear(256, 10)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.conv1(x))
        x = F.max_pool2d(F.relu(self.conv2(x)), 2, 2)
        x = F.relu(self.conv3(x))
        x = F.max_pool2d(F.relu(self.conv4(x)), 2, 2)
        x = F.relu(self.fc1(x.reshape(x.shape[0], -1)))
        x = F.dropout(x, 0.5, training=self.training)
        return self.fc3(F.relu(self.fc2(x)))


def init_victim(seed: int = 0, device: Device = "cuda") -> CifarNet:
    """A CifarNet with torch's default initialisation drawn from
    ``seed``, in evaluation mode on ``device``."""
    dev = as_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = CifarNet()
    return model.to(dev).eval()


def _state_dict(params: Mapping[str, Mapping[str, np.ndarray]]
                ) -> Dict[str, torch.Tensor]:
    sd = {}
    for name in LAYERS:
        k = np.asarray(params[name]["kernel"], np.float32)
        w = k.transpose(3, 2, 0, 1) if k.ndim == 4 else k.T
        sd[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(w))
        sd[f"{name}.bias"] = torch.from_numpy(
            np.asarray(params[name]["bias"], np.float32).copy())
    return sd


def victim_from_flax(variables: Mapping[str, Any],
                     device: Device = "cuda") -> CifarNet:
    """The JAX package's flax variables (``{"params": {...}}`` of numpy
    or array-like leaves) as a CifarNet on ``device``, evaluation mode."""
    dev = as_device(device)
    params = variables.get("params", variables)
    model = CifarNet()
    model.load_state_dict(_state_dict(params), strict=True)
    return model.to(dev).eval()


def load_victim_npz(path: str, device: Device = "cuda") -> CifarNet:
    """``checkpoints/cifar_victim.npz``: the flax variables saved leaf by
    leaf in ``tree_flatten`` order (sorted layer names, bias before
    kernel); the ``meta`` entry is not needed."""
    as_device(device)
    with np.load(path, allow_pickle=False) as z:
        keys = sorted(k for k in z.files if k.startswith("leaf/"))
        leaves = [z[k] for k in keys]
    if len(leaves) != 2 * len(LAYERS):
        raise ValueError(f"{path}: {len(leaves)} leaves, CifarNet has "
                         f"{2 * len(LAYERS)}")
    params = {name: {"bias": leaves[2 * i], "kernel": leaves[2 * i + 1]}
              for i, name in enumerate(LAYERS)}
    return victim_from_flax({"params": params}, device)


def load_torch_state_dict(state_dict: Mapping[str, Any],
                          device: Device = "cuda") -> CifarNet:
    """A state dict of the reference's torch CifarNet (model.py), whose
    parameter names and layouts are this module's."""
    dev = as_device(device)
    model = CifarNet()
    model.load_state_dict({k: torch.as_tensor(np.asarray(v))
                           for k, v in state_dict.items()}, strict=True)
    return model.to(dev).eval()


def load_torch_checkpoint(path: str, device: Device = "cuda") -> CifarNet:
    """The reference's ``cifar_best.pth`` (tensors only)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return load_torch_state_dict(sd, device)


def train_cifarnet(images: np.ndarray, labels: np.ndarray,
                   epochs: int = 5, batch: int = 64, lr: float = 1e-3,
                   seed: int = 0, device: Device = "cuda") -> CifarNet:
    """Fit a victim from (N, 3, 32, 32) images in [0, 1]: Adam, inputs
    minus 0.5 (the attack's normalisation, main_mha.py:33-36), dropout
    in training, mean cross-entropy, ``epochs`` passes in minibatches of
    ``batch`` (a last partial batch dropped).  Dropout masks come from
    torch's generator seeded with ``seed + 1``."""
    dev = as_device(device)
    model = init_victim(seed, dev)
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    rng = np.random.RandomState(seed)
    n = images.shape[0]
    x_all = torch.as_tensor(images, dtype=torch.float32, device=dev)
    y_all = torch.as_tensor(labels, dtype=torch.long, device=dev)
    with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
        torch.manual_seed(seed + 1)
        model.train()
        for _ in range(epochs):
            order = rng.permutation(n)
            for i in range(0, n - batch + 1, batch):
                idx = torch.from_numpy(order[i:i + batch]).to(dev)
                loss = F.cross_entropy(model(x_all[idx] - 0.5), y_all[idx])
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
    return model.eval()
