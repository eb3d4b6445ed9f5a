"""Helpers shared by the tests that hold the PyTorch port
(``lpbox_admm_tpu_torch``) against the JAX package: the small seeded CA
batches both sides solve, conversion of solver states and policy
variables through numpy, and the shipped checkpoints' paths."""

from pathlib import Path

import numpy as np
import torch

from lpbox_admm_tpu.adapters import ca as jca
from lpbox_admm_tpu_torch.adapters import ca as tca
from lpbox_admm_tpu_torch.core import lp as tlp

# The suite runs in several worker processes on a few cores; PyTorch's
# default of one intra-op thread per core in every worker oversubscribes
# them (measured: 8x slower), and these tests' tensors are small.
torch.set_num_threads(1)


def ca_instances(seed, count, n_items=20, n_bids=60):
    rng = np.random.RandomState(seed)
    return [jca.generate_cauction(rng, n_items=n_items, n_bids=n_bids)
            for _ in range(count)]


def problems(insts):
    """The same instances batched by both packages (port on the CPU)."""
    return jca.make_problem(insts), tca.make_problem(insts, device="cpu")


def np_of(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def torch_state(jstate):
    """A JAX ``LpState`` as the port's ``LpState`` (CPU tensors; a
    Schur-structured G^-1 as the port's ``StructGinv``)."""
    from lpbox_admm_tpu_torch.ops.struct_ginv import StructGinv
    kw = {}
    for f in tlp.LpState.__dataclass_fields__:
        v = getattr(jstate, f)
        if f == "it":
            kw[f] = int(v)
        elif getattr(v, "is_struct_ginv", False):
            kw[f] = StructGinv(*(torch.from_numpy(np.array(a)) for a in v))
        else:
            kw[f] = torch.from_numpy(np.array(v))
    return tlp.LpState(**kw)


def flat_variables(tree, prefix=""):
    """Flax variables (nested dicts) -> {"params/.../kernel": array}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(flat_variables(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def flax_variables_from_npz(path):
    """A JAX-package checkpoint's variables as flax nested dicts (the
    ``v/params/...`` and ``v/batch_stats/...`` entries)."""
    import jax.numpy as jnp
    out = {}
    with np.load(path, allow_pickle=False) as z:
        for k in z.files:
            if not k.startswith("v/"):
                continue
            parts = k[2:].split("/")
            d = out
            for p in parts[:-1]:
                d = d.setdefault(p, {})
            d[parts[-1]] = jnp.asarray(z[k])
    return out


def port_policy(variables, net, pcfg):
    """The port's policy module with flax ``variables`` carried across."""
    from lpbox_admm_tpu_torch.models.policy import build_policy
    from lpbox_admm_tpu_torch.utils.checkpoint import variables_from_arrays
    model = build_policy(net, pcfg.node_size, pcfg.chunk_dim, pcfg.pe_dim)
    model.load_state_dict(variables_from_arrays(flat_variables(variables)))
    return model


ROOT = Path(__file__).resolve().parent.parent
CKPT = {net: str(ROOT / "checkpoints" / f"ca500_{net}" / "checkpoint"
                 / "best_checkpoint.npz") for net in ("mha", "mlp")}


def torch_carry(jcarry):
    """A JAX ``pallas_stream.StreamCarry`` as the port's (CPU tensors)."""
    from lpbox_admm_tpu_torch.ops import fused_stream
    kw = {f: torch.from_numpy(np.array(getattr(jcarry, f)))
          for f in fused_stream.StreamCarry._fields if f != "state"}
    return fused_stream.StreamCarry(state=torch_state(jcarry.state), **kw)


#: solver-state fields held absolutely (in [0, 1] or O(1) sums of them),
#: the duals, and the objectives
STATE_ABS = ("x", "y1", "y2", "y3", "ex")
STATE_DUALS = ("z1", "z2", "z4")
STATE_OBJS = ("cur_obj", "best_bin_obj")


def state_errors(got, ref, cfg):
    """Per field, the error of the port's state ``got`` against ``ref``
    (either package's state) in the units of x: absolute for x and its
    copies, duals divided by gamma*rho of the last iteration run (the
    factor by which a dual step scales an error of x), objectives
    relative to max(1, |ref|) per instance."""
    from lpbox_admm_tpu_torch.ops.schedule import gamma_at, rho_at
    last = max(int(ref.it) - 1, 0)
    unit = gamma_at(last, cfg) * rho_at(last, cfg)
    out = {}
    for f in STATE_ABS + STATE_DUALS + STATE_OBJS:
        a = np_of(getattr(got, f)).astype(np.float64)
        b = np_of(getattr(ref, f)).astype(np.float64)
        d = np.abs(a - b)
        if f in STATE_DUALS:
            d = d / unit
        elif f in STATE_OBJS:
            d = d / np.maximum(1.0, np.abs(b))
        out[f] = float(d.max())
    return out


def step_scales(js, js1, jp, cfg):
    """Magnitudes of the terms one step's fields are computed from (the
    x-update cancels rhs against E^T u, so its rounding error scales with
    |rhs| / 2 rho, not with |x|): JAX states before and after the step."""
    from lpbox_admm_tpu.ops.schedule import gamma_at, rho_at
    it = js.it
    rho = float(rho_at(it, cfg))
    gr = float(gamma_at(it, cfg)) * rho
    free = np.asarray(js.free, np.float64)
    rhs = free * (rho * np.asarray(js1.y1) + rho * np.asarray(js1.y2)
                  - (np.asarray(jp.b) + np.asarray(js.z1)
                     + np.asarray(js.z2)) + np.asarray(js.et_next))
    erhs = np.einsum("bmn,bn->bm", np.asarray(jp.E, np.float64), rhs)
    s_x = np.abs(rhs).max() / (2 * rho)
    s_ex = np.abs(erhs).max() / (2 * rho)
    s_obj = s_x * np.abs(np.asarray(jp.b)).sum(-1).max()
    return {"x": s_x, "best_sol": s_x, "x_prev": s_x, "ex": s_ex,
            "z1": gr * s_x, "z2": gr * s_x, "z4": gr * s_ex,
            "obj_ring": s_obj}


def rel(a, b, scale=0.0):
    """max |a - b| over max(1, max |b|, scale)."""
    a, b = np_of(a).astype(np.float64), np_of(b).astype(np.float64)
    return np.abs(a - b).max() / max(1.0, np.abs(b).max(), scale)


def tf32_rna(x):
    """``cvt.rna.tf32.f32`` on the bits: keep 10 of f32's 23 mantissa
    bits, rounding to nearest with ties away from zero (add half of the
    dropped range to the magnitude, then clear it)."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)
