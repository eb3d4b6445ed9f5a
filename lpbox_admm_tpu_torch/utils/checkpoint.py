"""Policy checkpoints in the JAX package's format, both ways.

The JAX package saves a policy as a plain ``.npz`` (no pickle) whose
``v/params/...`` and ``v/batch_stats/...`` keys are the flax variable
paths and whose ``opt/NNNN`` keys are the optax state's leaves in
order (``train/imitation.checkpoint_arrays``).  ``variables_from_npz``
reads one into the state dict of the port's ``models.policy`` modules;
``load_policy`` builds the module and loads it.  Flax ``Dense`` kernels
are (in, out) and are transposed into ``nn.Linear`` (out, in); flax
``BatchNorm`` scale/bias/mean/var become the BatchNorm layers'
weight/bias/running_mean/running_var.

The write side: ``variable_arrays`` is the inverse map, and
``adam_arrays`` / ``load_adam_arrays`` carry a ``torch.optim.Adam``
state to and from the leaves of ``optax.adam(schedule)``'s state --
the Adam count (int32), every first moment in flax's sorted-path order
(``param_paths``), every second moment, then the schedule's count.

Any solver state, dataset or other container of tensors
(``utils.tree``: the port's frozen dataclasses, NamedTuples, tuples,
dicts) checkpoints with ``save_pytree`` / ``load_pytree`` /
``load_meta`` in the JAX package's format: an ``.npz`` of the leaves in
order as ``leaf/%05d`` and a JSON ``meta`` entry, no pickle.  Loading
needs an ``example`` of the same structure (an ``init_state(...)`` of
the same shapes) and checks every leaf's shape and dtype against it.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch
from torch import nn

from ..core.problem import Device, as_device
from ..models.policy import build_policy
from ..utils.tree import leaves as tree_leaves, unflatten

_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean",
       "var": "running_var"}


def _target(path: str) -> str:
    """flax variable path (without ``v/``) -> port state-dict key."""
    parts = path.split("/")
    coll, rest = parts[0], parts[1:]
    if coll not in ("params", "batch_stats"):
        raise KeyError(path)
    if rest[0] == "Dense_0":
        return f"embed.{'weight' if rest[1] == 'kernel' else 'bias'}"
    if rest[0] == "Classifier_0":
        k = int(re.fullmatch(r"Dense_(\d+)", rest[1]).group(1))
        return f"classifier.layers.{k}." \
               f"{'weight' if rest[2] == 'kernel' else 'bias'}"
    m = re.fullmatch(r"MHALayer_(\d+)", rest[0])
    if m is None:
        raise KeyError(path)
    layer = f"layers.{m.group(1)}."
    mod = rest[1]
    if mod == "MultiHeadAttention_0":
        return layer + "mha." + rest[2]
    if mod in ("BatchNorm_0", "BatchNorm_1"):
        return layer + ("bn1." if mod == "BatchNorm_0" else "bn2.") \
            + _BN[rest[2]]
    if mod in ("Dense_0", "Dense_1"):
        return layer + ("ff.0." if mod == "Dense_0" else "ff.2.") \
            + ("weight" if rest[2] == "kernel" else "bias")
    raise KeyError(path)


_BN_FLAX = {v: k for k, v in _BN.items()}


def _flax_path(name: str) -> Optional[str]:
    """Port state-dict key -> flax variable path (without ``v/``); None
    for keys flax does not have (``num_batches_tracked``).  The inverse
    of ``_target``."""
    parts = name.split(".")
    kb = lambda p: "kernel" if p == "weight" else "bias"
    if parts[0] == "embed":
        return f"params/Dense_0/{kb(parts[1])}"
    if parts[0] == "classifier":
        return f"params/Classifier_0/Dense_{parts[2]}/{kb(parts[3])}"
    if parts[0] != "layers":
        raise KeyError(name)
    layer = f"MHALayer_{parts[1]}"
    mod = parts[2]
    if mod == "mha":
        return f"params/{layer}/MultiHeadAttention_0/{parts[3]}"
    if mod in ("bn1", "bn2"):
        if parts[3] == "num_batches_tracked":
            return None
        leaf = _BN_FLAX[parts[3]]
        coll = "batch_stats" if leaf in ("mean", "var") else "params"
        return f"{coll}/{layer}/BatchNorm_{int(mod[2]) - 1}/{leaf}"
    if mod == "ff":
        return f"params/{layer}/Dense_{int(parts[3]) // 2}/{kb(parts[4])}"
    raise KeyError(name)


def _flax_layout(path: str, t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().float().numpy()
    return np.ascontiguousarray(a.T if path.endswith("/kernel")
                                and a.ndim == 2 else a)


def variable_arrays(model: nn.Module) -> Dict[str, np.ndarray]:
    """The module's weights and BatchNorm statistics as flax variable
    arrays keyed ``v/params/...`` and ``v/batch_stats/...``."""
    out = {}
    for name, t in model.state_dict().items():
        path = _flax_path(name)
        if path is not None:
            out["v/" + path] = _flax_layout(path, t)
    return out


def param_paths(model: nn.Module) -> List[tuple]:
    """(flax path, parameter) of every trainable tensor, in the order
    jax flattens the flax params dict (keys sorted at every level)."""
    pairs = [(_flax_path(n), p) for n, p in model.named_parameters()]
    return sorted(pairs, key=lambda kv: tuple(kv[0].split("/")))


def adam_arrays(model: nn.Module, optimizer: torch.optim.Optimizer,
                count: int) -> List[np.ndarray]:
    """The leaves of ``optax.adam(schedule)``'s state for the module's
    ``torch.optim.Adam``: Adam count, first moments, second moments,
    schedule count (``count`` updates made; zero moments before the
    first)."""
    pairs = param_paths(model)
    mom = {"exp_avg": [], "exp_avg_sq": []}
    for path, p in pairs:
        st = optimizer.state.get(p, {})
        for k in mom:
            mom[k].append(_flax_layout(path, st[k]) if k in st else
                          _flax_layout(path, torch.zeros_like(p)))
    c = np.asarray(count, np.int32)
    return [c] + mom["exp_avg"] + mom["exp_avg_sq"] + [c.copy()]


def load_adam_arrays(model: nn.Module, optimizer: torch.optim.Optimizer,
                     leaves: List[np.ndarray]) -> int:
    """Set the ``torch.optim.Adam`` state of the module's parameters from
    optax state leaves (``adam_arrays``' order); returns the count."""
    pairs = param_paths(model)
    P = len(pairs)
    if len(leaves) != 2 * P + 2:
        raise ValueError(f"{len(leaves)} optimizer leaves, expected "
                         f"{2 * P + 2} for {P} parameters")
    count, sched = int(leaves[0]), int(leaves[-1])
    if count != sched:
        raise ValueError(f"Adam count {count} != schedule count {sched}")

    def tensor(path, p, a):
        a = np.asarray(a, np.float32)
        if path.endswith("/kernel") and a.ndim == 2:
            a = a.T
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"{path}: optimizer leaf {a.shape} for a "
                             f"parameter {tuple(p.shape)}")
        return torch.from_numpy(np.ascontiguousarray(a)).to(p.device)

    for i, (path, p) in enumerate(pairs):
        optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": tensor(path, p, leaves[1 + i]),
            "exp_avg_sq": tensor(path, p, leaves[1 + P + i])}
    return count


def variables_from_arrays(arrays: Mapping[str, np.ndarray]
                          ) -> Dict[str, torch.Tensor]:
    """The port's state dict from flax variable arrays keyed by path
    (``v/params/...``, ``v/batch_stats/...``, or the same without the
    ``v/`` prefix).  Other keys (optimizer state, step) are ignored."""
    sd: Dict[str, torch.Tensor] = {}
    for key, arr in arrays.items():
        path = key[2:] if key.startswith("v/") else key
        if not path.startswith(("params/", "batch_stats/")):
            continue
        a = np.asarray(arr, dtype=np.float32)
        name = _target(path)
        if path.endswith("/kernel") and a.ndim == 2:
            a = a.T                                 # (in, out) -> (out, in)
        sd[name] = torch.from_numpy(np.array(a, order="C"))
    for name in list(sd):
        if name.endswith("bn1.running_mean") or \
                name.endswith("bn2.running_mean"):
            sd[name[:-len("running_mean")] + "num_batches_tracked"] = \
                torch.tensor(0, dtype=torch.long)
    return sd


def variables_from_npz(path: str) -> Dict[str, torch.Tensor]:
    """Read a JAX-package policy checkpoint (``allow_pickle=False``: a
    checkpoint never executes code) into the port's state dict."""
    with np.load(path, allow_pickle=False) as z:
        return variables_from_arrays({k: z[k] for k in z.files
                                      if k.startswith("v/")})


def net_of(state_dict: Mapping[str, torch.Tensor]) -> str:
    """'mha' if the state dict has attention layers, else 'mlp'."""
    return "mha" if any(k.startswith("layers.") for k in state_dict) \
        else "mlp"


def policy_shape(state_dict: Mapping[str, torch.Tensor],
                 pe_dim: int = 5) -> tuple:
    """(node_size, chunk_dim) of a policy's weights: the classifier's
    input width over the embedding width, and the embedding's input
    width less ``pe_dim``."""
    embed = state_dict["embed.weight"]                  # (E, C + P)
    cls_in = state_dict["classifier.layers.0.weight"].shape[1]
    node_size, rest = divmod(cls_in, embed.shape[0])
    if rest or embed.shape[1] <= pe_dim:
        raise ValueError(f"a classifier input of {cls_in} and an embedding "
                         f"of {tuple(embed.shape)} fit no node_size and "
                         f"chunk_dim with pe_dim {pe_dim}")
    return node_size, embed.shape[1] - pe_dim


def load_policy(path: str, node_size: Optional[int] = None,
                chunk_dim: Optional[int] = None, pe_dim: int = 5,
                device: Device = "cuda") -> nn.Module:
    """Build the checkpoint's policy module (MHA or MLP, with the
    checkpoint's output width) in evaluation mode on ``device`` with the
    checkpoint's weights.  ``node_size`` and ``chunk_dim`` default to
    the checkpoint's own (``policy_shape``: ``ca500_mha`` 20 and 5,
    ``seg_mha`` 5 and 5); a value given that the checkpoint contradicts
    raises, naming both."""
    sd = variables_from_npz(path)
    have = dict(zip(("node_size", "chunk_dim"), policy_shape(sd, pe_dim)))
    for name, want in (("node_size", node_size), ("chunk_dim", chunk_dim)):
        if want is not None and want != have[name]:
            raise ValueError(f"{name}={want} was asked for, but the "
                             f"checkpoint {path} has {name}={have[name]}")
    out_dim = sd["classifier.layers.3.weight"].shape[0]
    model = build_policy(net_of(sd), have["node_size"], have["chunk_dim"],
                         pe_dim, out_dim=out_dim)
    model.load_state_dict(sd, strict=True)
    return model.to(as_device(device)).eval()


def _leaf_array(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_pytree(path: str, tree: Any, meta: Optional[dict] = None) -> None:
    """Write ``tree``'s leaves (tensors from any device, numpy arrays,
    Python numbers) in order and ``meta`` as JSON."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrs = {f"leaf/{i:05d}": _leaf_array(leaf)
            for i, leaf in enumerate(tree_leaves(tree))}
    arrs["meta"] = np.frombuffer(json.dumps(meta or {}).encode(),
                                 dtype=np.uint8)
    with open(path, "wb") as f:
        np.savez(f, **arrs)


def load_pytree(path: str, example: Any) -> Any:
    """A tree saved by ``save_pytree`` (either package's) restored into
    the structure of ``example``: tensors on the example's devices,
    Python numbers as Python numbers.  A leaf whose shape or dtype is
    not the example's raises, naming the leaf."""
    want = tree_leaves(example)
    with np.load(path, allow_pickle=False) as z:
        keys = sorted(k for k in z.files if k.startswith("leaf/"))
        if len(keys) != len(want):
            raise ValueError(f"checkpoint has {len(keys)} leaves, example "
                             f"has {len(want)}")
        got = [z[k] for k in keys]
    out = []
    for i, (a, w) in enumerate(zip(got, want)):
        wa = _leaf_array(w)
        if a.shape != wa.shape or a.dtype != wa.dtype:
            raise ValueError(
                f"checkpoint leaf {i} ({keys[i]}) has shape {a.shape} dtype "
                f"{a.dtype}, example expects shape {wa.shape} dtype "
                f"{wa.dtype}")
        if isinstance(w, torch.Tensor):
            out.append(torch.from_numpy(np.array(a)).to(w.device))
        elif isinstance(w, (bool, int, float)):
            out.append(type(w)(a))
        else:
            out.append(a)
    return unflatten(example, out)


def load_meta(path: str) -> dict:
    """The ``meta`` entry of a ``save_pytree`` checkpoint."""
    with np.load(path, allow_pickle=False) as z:
        return json.loads(bytes(z["meta"]).decode())
