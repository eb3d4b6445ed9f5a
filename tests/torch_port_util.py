"""Helpers shared by the tests that hold the PyTorch port
(``lpbox_admm_tpu_torch``) against the JAX package: the small seeded CA
batches both sides solve, conversion of solver states and policy
variables through numpy, and the shipped checkpoints' paths."""

import sys
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


# --- segmentation -----------------------------------------------------------

SEG_CKPT = str(ROOT / "checkpoints" / "seg_mha" / "checkpoint"
               / "best_checkpoint.npz")


def seg_image(rng, H, W):
    """A synthetic segmentation image of the smoke's recipe: a smoothed
    Gaussian random field (sigma H/12) scaled to [0, 1], plus noise of
    0.05, clipped, quantised to 8 bits, divided by 263 as ``load_image``
    does.  Piecewise-constant images are too easy (their l2f gap is 0)."""
    from scipy.ndimage import gaussian_filter
    f = gaussian_filter(rng.randn(H, W), sigma=H / 12)
    f = (f - f.min()) / (f.max() - f.min())
    f = np.clip(f + 0.05 * rng.randn(H, W), 0.0, 1.0)
    return np.round(255 * f) / 263.0


def seg_images(seed, count, H, W):
    rng = np.random.RandomState(seed)
    return [seg_image(rng, H, W) for _ in range(count)]


def seg_pcfg(package, **kw):
    """The seg policy's PolicyConfig (5 tokens of 5, sliding) of either
    package's config module."""
    return package.PolicyConfig(node_size=5, chunk_dim=5,
                                window_mode="sliding", **kw)


def seg_referee(images, ws=10, max_iter=30, repair=8, pair=4):
    """The JAX package's CPU readings that ``chip_smoke.py``'s seg phase
    holds the card against: the plain solve's reported energies
    (``build_dataset_qp``, record 50, polished as ``run_seg -phase
    test`` polishes) and its iterations, and the masked ``l2f_solve``
    with ``seg_mha`` at the test protocol: mean energy gap, pixels fixed
    and fix errors per image."""
    from lpbox_admm_tpu import config as jconfig
    from lpbox_admm_tpu.adapters import segmentation as jseg
    from lpbox_admm_tpu.models.policy import build_policy
    from lpbox_admm_tpu.train import imitation as jim
    from lpbox_admm_tpu.train import l2f as jl2f
    cfg = jconfig.SEG_CONFIG
    prob = jseg.make_problem(images)
    ds = jim.build_dataset_qp(prob, cfg, record_iters=5 * ws,
                              repair_sweeps=repair, pair_sweeps=pair)
    state = jl2f.l2f_solve(prob, build_policy("mha"),
                           flax_variables_from_npz(SEG_CKPT), cfg,
                           seg_pcfg(jconfig), ws=ws, max_iter=max_iter)
    m = jl2f.l2f_metrics_qp(state, prob, ds.oracle_obj,
                            ds.labels.reshape(prob.b.shape),
                            repair_sweeps=repair, pair_sweeps=pair)
    return {"plain_energy": [float(v) for v in np.asarray(ds.oracle_obj)],
            "plain_iters": int(ds.oracle_iters),
            "l2f_gap_mean": float(np.mean(np.asarray(m["energy_gap"]))),
            "l2f_fixed": [int(v) for v in np.asarray(m["n_fixed"])],
            "l2f_fix_errors": [int(v) for v in np.asarray(m["fix_errors"])]}


# --- sparse attack -----------------------------------------------------------

ATTACK_CKPT = str(ROOT / "checkpoints" / "attack_mha" / "checkpoint"
                  / "best_checkpoint.npz")
VICTIM_NPZ = str(ROOT / "checkpoints" / "cifar_victim.npz")

# the smoke's own synthetic images (chip_smoke.py imports nothing of the
# tests, the JAX package or the port at module level)
sys.path.insert(0, str(ROOT))
from chip_smoke import attack_images  # noqa: E402


def attack_setup_jax(images, segments):
    """The JAX package's attack inputs for ``images``: the victim from
    ``cifar_victim.npz``, its own predictions as labels, the reference's
    targets, SLIC masks padded to the largest count, unit noise
    weights."""
    import jax.numpy as jnp
    from lpbox_admm_tpu.adapters import attack as ja
    from lpbox_admm_tpu.adapters import slic as jslic
    from lpbox_admm_tpu.models.cifarnet import init_victim
    from lpbox_admm_tpu.utils.checkpoint import load_pytree
    model, variables = init_victim()
    variables = load_pytree(VICTIM_NPZ, variables)
    labels = np.asarray(jnp.argmax(model.apply(
        variables, ja.normalize(jnp.asarray(images))), -1))
    targets = np.array([(t - 2) + 9 if t - 2 < 0 else t - 2 for t in labels])
    Bms = [jslic.segment_masks((im.transpose(1, 2, 0) * 255).astype(np.uint8),
                               n_segments=segments) for im in images]
    Bm = np.zeros((len(images), max(b.shape[0] for b in Bms))
                  + images.shape[1:], np.float32)
    for i, b in enumerate(Bms):
        Bm[i, :b.shape[0]] = b
    return model, variables, labels, targets, Bm, np.ones_like(images)


def attack_referee(images, l2f_lambda, segments=150):
    """The JAX package's CPU readings that ``chip_smoke.py``'s attack
    phase holds the card against: per-image success and L0 of one
    ``attack_single`` at the full ``ATTACK_CONFIG``, plain at
    ``init_lambda1`` and l2f (``attack_mha``, node 10 x chunk 5) at
    ``l2f_lambda``."""
    import jax.numpy as jnp
    from lpbox_admm_tpu import config as jconfig
    from lpbox_admm_tpu.adapters import attack as ja
    from lpbox_admm_tpu.models.policy import build_policy
    cfg = jconfig.ATTACK_CONFIG.replace(segments=segments)
    model, variables, labels, targets, Bm, nw = attack_setup_jax(images,
                                                                 segments)
    pcfg = jconfig.PolicyConfig(net="mha", node_size=10, chunk_dim=5)
    out = {"labels": labels.tolist(), "targets": targets.tolist()}
    for mode in ("plain", "l2f_at"):
        kw, lam_v = {}, cfg.init_lambda1
        if mode == "l2f_at":
            kw = dict(use_l2f=True, policy_model=build_policy("mha"),
                      policy_variables=flax_variables_from_npz(ATTACK_CKPT),
                      pcfg=pcfg)
            lam_v = l2f_lambda
        lam = jnp.full((len(images),), lam_v, jnp.float32)
        res = ja.attack_single(model, variables, jnp.asarray(images),
                               jnp.asarray(targets), jnp.asarray(Bm),
                               jnp.asarray(nw), cfg, lam, **kw)
        out[mode] = {"success": [bool(v) for v in np.asarray(res["success"])],
                     "L0": [int(v) for v in np.asarray(res["L0"])]}
    out["l2f_at"]["lambda1"] = l2f_lambda
    return out


def jax_grads(jt, params, stats, x, lab, w, dtype):
    """``PolicyTrainer._train_step_impl``'s chunk loop, op by op, with the
    parameters, statistics and rows cast to ``dtype`` (float64 under
    ``jax.enable_x64``): rows zero-padded to a multiple of
    ``micro_rows``, each chunk's loss scaled by chunk_rows / R, the
    statistics chained, the gradients summed.  Returns the loss, the
    statistics and the gradient leaves (float64 numpy)."""
    import jax
    import jax.numpy as jnp
    from lpbox_admm_tpu.train.imitation import weighted_bce
    R = x.shape[0]
    pad = (-R) % jt.micro_rows
    xp, lp_, wp = (np.concatenate([a, np.zeros((pad,) + a.shape[1:],
                                               np.float32)]).astype(dtype)
                   for a in (x, lab, w))
    with jax.enable_x64(dtype == np.float64):
        cast = lambda t: jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a, dtype)), t)
        params, stats = cast(params), cast(stats)
        loss, acc = 0.0, None
        for c in range(0, R + pad, jt.micro_rows):
            xc, lc, wc = (jnp.asarray(a[c:c + jt.micro_rows])
                          for a in (xp, lp_, wp))

            def chunk_loss(p, s):
                (logits, _), mut = jt.model.apply(
                    {"params": p, "batch_stats": s}, xc, train=True,
                    mutable=["batch_stats"])
                return weighted_bce(logits[:, 0], lc, wc) \
                    * (xc.shape[0] / R), mut["batch_stats"]

            (lk, stats), g = jax.value_and_grad(chunk_loss, has_aux=True)(
                params, stats)
            assert lk.dtype == dtype
            loss += float(lk)
            acc = g if acc is None else jax.tree_util.tree_map(
                lambda a, b: a + b, acc, g)
        stats = jax.tree_util.tree_map(np.asarray, stats)
        return loss, stats, [np.asarray(a, np.float64) for a in
                             jax.tree_util.tree_leaves(acc)]


def port_grads(model):
    """The port's gradient leaves in flax's layout and order; a parameter
    that got no gradient counts as zero."""
    from lpbox_admm_tpu_torch.utils.checkpoint import _flax_layout, param_paths
    return [np.asarray(_flax_layout(
        p, t.grad if t.grad is not None else torch.zeros_like(t)),
        np.float64) for p, t in param_paths(model)]


if __name__ == "__main__":
    # prints the referee constants of chip_smoke.py's seg phase, or with
    # the argument "attack" its attack phase's:
    #   JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_port_util.py [attack]
    import json
    import chip_smoke
    if sys.argv[1:] == ["attack"]:
        print(json.dumps(attack_referee(chip_smoke.attack_images(
            chip_smoke.ATTACK_SEED, chip_smoke.ATTACK_BATCH),
            chip_smoke.ATTACK_REFEREE["l2f_at"]["lambda1"])))
    else:
        print(json.dumps(seg_referee(chip_smoke.seg_images(
            chip_smoke.SEG_SEED, chip_smoke.SEG_BATCH,
            *chip_smoke.SEG_GRID))))

