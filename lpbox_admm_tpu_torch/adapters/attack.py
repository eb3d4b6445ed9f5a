"""Sparse adversarial attack: 4-block ADMM on a binary pixel mask (the
port of the JAX package's ``adapters/attack.py``; reference SparseAttack
silo, generate_data.py / main_mha.py).

Find a binary mask G in {0,1}^(3x32x32) with ||G||_0 <= k and a noise
tensor epsilon such that ``clip(image + G*epsilon)`` is classified as the
target label, with group sparsity over SLIC superpixels.

* ``update_epsilon``     ~ generate_data.py:309-353 (SGD on epsilon)
* ``g_window``           ~ loop (:502-623): y1 box clip, y2 shifted
  l2-sphere, y3 group shrinkage over the masks, scalar cardinality dual
  z4, gradient step on G mixing the CNN loss gradient; rho x1.01 per
  iteration, capped; lr x0.9 every 50 iterations, floored; the G
  trajectory recorded
* ``update_g_plain``     ~ update_G (:626-743), maxIter_g iterations
* ``update_g_l2f``       ~ update_G_l2f (:376-499): 3 windows of 50
  iterations, the policy resetting confident entries to 0/1 after each
  of the first two (a soft reset: optimisation goes on over all entries)
* ``attack_single``      ~ train_sgd_atom (:251-307): the eps/G
  alternation, the final threshold, the eps finetune
* ``attack_with_search`` ~ train_adptive (main_mha.py:206-248): the
  per-image lambda1 search on the host
* losses / statistics    ~ utils.py:26-117

The victim is any ``nn.Module`` in evaluation mode taking (B, 3, H, W);
the CNN gradient oracle is ``torch.autograd.grad`` of the summed
per-image loss, with the convolutions in float32 (no TF32).  The attack
runs where its tensors live.  The l2f windows are scored by
``train.l2f._scorer``: K2 on the card, the module's forward on the CPU
(the JAX package scores them with the module in XLA).

Parity with the JAX package: the clip at the pixel bounds and the CW
hinge are ``torch.minimum``/``torch.maximum`` of tensors, whose gradient
at a tie is 0.5 as ``jnp.clip``/``jnp.maximum``'s is (``torch.clamp``
gives 1; attacks start at epsilon = 0, where every 0 or 1 pixel is a
tie).  The schedules raise float32 bases to float32 powers on the host
(torch's ``pow``; XLA's float32 ``pow`` is its own approximation and
differs from it by an ulp for some exponents).  ``cardinality_repair``
takes ``torch.topk``, whose order among equal values is unspecified
(see there).
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import AttackConfig, PolicyConfig

IMG_MEAN = 0.5   # normalization mean/std (main_mha.py:33-36)
IMG_STD = 1.0

Scorer = Callable[[torch.Tensor], torch.Tensor]


class AttackState(NamedTuple):
    """Carried through the ADMM-on-G windows (other_params/init_params
    of the reference, generate_data.py:395-405)."""

    G: torch.Tensor       # (B, 3, H, W)
    y1: torch.Tensor
    y2: torch.Tensor
    y3: torch.Tensor
    z1: torch.Tensor
    z2: torch.Tensor
    z3: torch.Tensor
    z4: torch.Tensor      # (B,) scalar cardinality dual
    it: int               # global G iteration


def normalize(x: torch.Tensor) -> torch.Tensor:
    return (x - IMG_MEAN) / IMG_STD


def _f32_convs():
    """cuDNN convolutions in float32 (PyTorch lets them take TF32 by
    default); the other cuDNN settings as they are."""
    cd = torch.backends.cudnn
    return cd.flags(enabled=cd.enabled, benchmark=cd.benchmark,
                    deterministic=cd.deterministic, allow_tf32=False)


@functools.lru_cache(maxsize=None)
def _scalar(value: float, device: torch.device,
            dtype: torch.dtype) -> torch.Tensor:
    """A 0-dim tensor of ``value`` on ``device``, made once (read only)."""
    return torch.full((), value, device=device, dtype=dtype)


def _clip_pixels(x: torch.Tensor, cfg: AttackConfig) -> torch.Tensor:
    """``jnp.clip(x, min_pix, max_pix)`` with its gradient: 0.5 where x
    equals a bound (``torch.clamp`` would give 1 there)."""
    lo = _scalar(cfg.min_pix_value, x.device, x.dtype)
    hi = _scalar(cfg.max_pix_value, x.device, x.dtype)
    return torch.minimum(torch.maximum(x, lo), hi)


def cnn_loss(model: nn.Module, images, target, epsilon, G,
             cfg: AttackConfig) -> torch.Tensor:
    """Per-image CW (or CE) loss of the perturbed images
    (compute_cnn_loss, utils.py:54-75).  Returns (B,)."""
    adv = _clip_pixels(images + G * epsilon, cfg)
    logits = model(normalize(adv))
    # F.one_hot reads its input's range back to the host: a sync a call
    classes = torch.arange(cfg.categories, device=target.device)
    is_target = target[:, None] == classes
    if cfg.loss == "ce":
        onehot = is_target.to(logits.dtype)
        return -(onehot * F.log_softmax(logits, dim=-1)).sum(-1)
    # sum(logits * onehot) and max((1 - onehot) * logits - onehot * 1e4),
    # the JAX package's forms, as a gather and a masked max: the same
    # values (the other terms are exact zeros) and the same gradients
    real = logits.gather(1, target[:, None].long())[:, 0]
    # amax spreads the gradient of a tie evenly, as jnp.max does
    other_max = logits.masked_fill(is_target, -10000.0).amax(dim=-1)
    hinge = other_max - real + cfg.confidence
    return torch.maximum(hinge, _scalar(0.0, hinge.device, hinge.dtype))


@torch.no_grad()
def predictions(model: nn.Module, images, epsilon, G,
                cfg: AttackConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(predicted labels, adversarial images)
    (compute_predictions_labels, utils.py:109-117)."""
    adv = _clip_pixels(images + G * epsilon, cfg)
    with _f32_convs():
        logits = model(normalize(adv))
    return torch.argmax(logits, dim=-1), adv


def _loss_grad(model, images, target, epsilon, G, cfg, wrt: str):
    """Gradient of the summed per-image loss in ``epsilon`` or ``G``."""
    with torch.enable_grad(), _f32_convs():
        x = (epsilon if wrt == "eps" else G).detach().requires_grad_(True)
        eps, g = (x, G) if wrt == "eps" else (epsilon, x)
        loss = cnn_loss(model, images, target, eps, g, cfg).sum()
        return torch.autograd.grad(loss, x)[0]


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


def _lr_at(its: List[int], lr0: float, cfg: AttackConfig) -> List[float]:
    """max(lr0 * decay ** (it // lr_decay_step), lr_min) in float32."""
    k = _f32([it // cfg.lr_decay_step for it in its])
    lr = torch.maximum(_f32(lr0) * _f32(cfg.lr_decay_factor) ** k,
                       _f32(cfg.lr_min))
    return lr.tolist()


def _rho_at(its: List[int], rho0: float, cap: float,
            cfg: AttackConfig) -> List[float]:
    """min(rho0 * rho_increase_factor ** it, cap) in float32."""
    r = _f32(rho0) * _f32(cfg.rho_increase_factor) ** _f32(its)
    return torch.minimum(r, _f32(cap)).tolist()


def _per_image(lam, like: torch.Tensor) -> torch.Tensor:
    lam = torch.as_tensor(lam, dtype=like.dtype, device=like.device)
    return lam[:, None, None, None] if lam.ndim == 1 else lam


@torch.no_grad()
def update_epsilon(model: nn.Module, images, target, epsilon, G,
                   noise_weight, cfg: AttackConfig, finetune: bool = False,
                   lr0: Optional[float] = None,
                   lambda1=None) -> torch.Tensor:
    """SGD on the noise epsilon (generate_data.py:309-353): maxIter_e
    iterations, half as many in a finetune; ``lambda1`` per image (B,)
    or one value."""
    iters = cfg.maxIter_e // 2 if finetune else cfg.maxIter_e
    lr0 = cfg.lr_e if lr0 is None else lr0
    lam_b = _per_image(cfg.lambda1 if lambda1 is None else lambda1, images)
    # the JAX body's (i + 1) // lr_decay_step
    lrs = _lr_at(list(range(1, iters + 1)), lr0, cfg)
    for i in range(iters):
        cnn_g = _loss_grad(model, images, target, epsilon, G, cfg, "eps")
        g = 2.0 * epsilon * G * G * noise_weight * noise_weight \
            + lam_b * cnn_g
        epsilon = epsilon - lrs[i] * g
    return epsilon


@torch.no_grad()
def group_shrink(C: torch.Tensor, Bmask: torch.Tensor, rho3: float,
                 lambda2: float) -> torch.Tensor:
    """y3 block shrinkage over superpixel groups
    (generate_data.py:530-542).  C (B,3,H,W), Bmask (B,S,3,H,W): the
    dense product and sum, as the JAX package computes it."""
    BC = C[:, None] * Bmask
    norm = torch.sqrt((BC * BC).sum(dim=(2, 3, 4), keepdim=True))
    norm = norm.clamp_min(1e-30)
    coef = (1.0 - lambda2 / (rho3 * norm)).clamp_min(0.0)
    return (coef * BC).sum(1)


def init_attack_state(G: torch.Tensor) -> AttackState:
    """y's = 1, z's = 0 (generate_data.py:389-405)."""
    ones, zeros = torch.ones_like(G), torch.zeros_like(G)
    return AttackState(G=G, y1=ones, y2=ones, y3=ones, z1=zeros, z2=zeros,
                       z3=zeros, z4=G.new_zeros(G.shape[0]), it=0)


@torch.no_grad()
def g_window(model: nn.Module, images, target, epsilon, state: AttackState,
             Bmask, noise_weight, cfg: AttackConfig, window: int, lambda1,
             record: bool = True
             ) -> Tuple[AttackState, Optional[torch.Tensor]]:
    """``window`` ADMM-on-G iterations (loop, generate_data.py:502-623),
    optionally recording the G trajectory (B, 3, H, W, window)."""
    lam_b = _per_image(lambda1, images)
    its = list(range(state.it, state.it + window))
    rhos = [_rho_at(its, r0, cap, cfg) for r0, cap in (
        (cfg.rho1, cfg.rho1_max), (cfg.rho2, cfg.rho2_max),
        (cfg.rho3, cfg.rho3_max), (cfg.rho4, cfg.rho4_max))]
    lrs = _lr_at(its, cfg.lr_g, cfg)
    half_sqrt_n = float(np.float32(np.sqrt(np.prod(images.shape[1:])) / 2.0))
    G, y1, y2, y3, z1, z2, z3, z4 = state[:8]
    zero, one = images.new_zeros(()), images.new_ones(())
    traj = []
    for j in range(window):
        rho1, rho2, rho3, rho4 = (r[j] for r in rhos)
        y1 = torch.minimum(torch.maximum(G + z1 / rho1, zero), one)
        # shifted l2 sphere with shift 0.5, radius sqrt(n)/2
        shift = G + z2 / rho2 - 0.5
        norm = torch.sqrt((shift * shift).sum(dim=(1, 2, 3), keepdim=True))
        y2 = half_sqrt_n * shift / norm.clamp_min(1e-30) + 0.5
        y3 = group_shrink(G + z3 / rho3, Bmask, rho3, cfg.lambda2)

        cnn_g = _loss_grad(model, images, target, epsilon, G, cfg, "G")
        card = (G.sum(dim=(1, 2, 3)) - cfg.k)[:, None, None, None]
        grad_G = (2.0 * G * epsilon * epsilon * noise_weight * noise_weight
                  + lam_b * cnn_g
                  + z1 + z2 + z3 + z4[:, None, None, None]
                  + rho1 * (G - y1) + rho2 * (G - y2) + rho3 * (G - y3)
                  + rho4 * card)
        G = G - lrs[j] * grad_G

        z1 = z1 + rho1 * (G - y1)
        z2 = z2 + rho2 * (G - y2)
        z3 = z3 + rho3 * (G - y3)
        z4 = z4 + rho4 * (G.sum(dim=(1, 2, 3)) - cfg.k)
        if record:
            traj.append(G)
    state = AttackState(G=G, y1=y1, y2=y2, y3=y3, z1=z1, z2=z2, z3=z3,
                        z4=z4, it=state.it + window)
    return state, (torch.stack(traj, dim=-1) if record else None)


def update_g_plain(model: nn.Module, images, target, epsilon, G, Bmask,
                   noise_weight, cfg: AttackConfig, lambda1) -> torch.Tensor:
    """Plain G update: maxIter_g ADMM iterations (update_G,
    generate_data.py:626-743)."""
    state, _ = g_window(model, images, target, epsilon,
                        init_attack_state(G), Bmask, noise_weight, cfg,
                        cfg.maxIter_g, lambda1, record=False)
    return state.G


def policy_scorer(policy_model: nn.Module, pcfg: PolicyConfig,
                  device) -> Scorer:
    """The l2f windows' scorer (``train.l2f._scorer``): K2 on the card,
    the module's forward on the CPU."""
    from ..train.l2f import _scorer
    return _scorer(policy_model, pcfg, torch.device(device), 8192)


@torch.no_grad()
def update_g_l2f(model: nn.Module, images, target, epsilon, G, Bmask,
                 noise_weight, cfg: AttackConfig, lambda1,
                 policy_model: Optional[nn.Module] = None,
                 pcfg: Optional[PolicyConfig] = None,
                 n_windows: int = 3, window: int = 50,
                 score: Optional[Scorer] = None) -> torch.Tensor:
    """Learned-early-fixing G update (update_G_l2f,
    generate_data.py:376-499): windows of ADMM iterations; after each
    window but the last the policy scores each entry's trajectory (node
    10 x chunk 5 for ws = 50) and confident entries are *reset* to 0/1,
    the others keep their value; optimisation goes on over all entries
    and the iteration count carries across the windows.  ``score``:
    ``policy_scorer(policy_model, pcfg, ...)``, made by the caller once
    (else made here)."""
    from ..train.l2f import scores_to_vec
    if pcfg is None:
        raise ValueError("update_g_l2f needs the policy's PolicyConfig")
    if score is None:
        score = policy_scorer(policy_model, pcfg, images.device)
    state = init_attack_state(G)
    for w in range(n_windows):
        state, traj = g_window(model, images, target, epsilon, state, Bmask,
                               noise_weight, cfg, window, lambda1,
                               record=True)
        if w == n_windows - 1:
            break
        vec = scores_to_vec(score(traj.reshape(-1, window)),
                            pcfg.fix_confidence).reshape(G.shape)
        # soft reset (:475-492)
        state = state._replace(G=torch.where(vec >= 0.0, vec, state.G))
    return state.G


@torch.no_grad()
def compute_statistics(images, epsilon, G, noise_weight,
                       cfg: AttackConfig) -> Dict[str, torch.Tensor]:
    """L0/L1/L2/Linf and weighted norms (compute_statistics,
    utils.py:77-96).  All per image (B,)."""
    adv = _clip_pixels(images + epsilon * G, cfg)
    noise = adv - images
    wn = noise * noise_weight
    ax = (1, 2, 3)
    return {
        "G_sum": G.sum(dim=ax),
        "L0": (G > 0.5).sum(dim=ax),
        "L1": noise.abs().sum(dim=ax),
        "L2": torch.sqrt((noise * noise).sum(dim=ax)),
        "Li": noise.abs().amax(dim=ax),
        "WL1": wn.abs().sum(dim=ax),
        "WL2": torch.sqrt((wn * wn).sum(dim=ax)),
        "WLi": wn.abs().amax(dim=ax),
    }


@torch.no_grad()
def cardinality_repair(model: nn.Module, images, target, epsilon,
                       G: torch.Tensor, noise_weight, cfg: AttackConfig,
                       lambda1=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Enforce the L0 budget ``k`` on attacks whose thresholded mask
    overshot it (the JAX package's addition to the reference, which
    reports the overshoot, main_mha.py:190-196): keep the k active
    entries of largest ``|epsilon|``, finetune epsilon twice on the
    reduced mask, and accept an image only where the attack still
    succeeds and its L0 was above k."""
    B = G.shape[0]
    mag = (epsilon.abs() * G).reshape(B, -1)
    l0 = (G.reshape(B, -1) > 0.5).sum(-1)
    # torch.topk's order among equal values is unspecified where
    # lax.top_k takes the lower index first.  The kept set is the k
    # largest values either way, and entries of mag 0 (G = 0 or
    # epsilon = 0) are masked out below, so the two can differ only
    # where positive |epsilon| values tie exactly at the k-th place.
    idx = torch.topk(mag, cfg.k, dim=-1).indices
    keep = torch.zeros_like(mag).scatter_(1, idx, 1.0) * (mag > 0)
    G2 = keep.reshape(G.shape).to(G.dtype)
    eps2 = epsilon
    for _ in range(2):
        eps2 = update_epsilon(model, images, target, eps2, G2, noise_weight,
                              cfg, finetune=True, lambda1=lambda1)
    pred2, _ = predictions(model, images, eps2, G2, cfg)
    acc = ((pred2 == target) & (l0 > cfg.k))[:, None, None, None]
    return torch.where(acc, G2, G), torch.where(acc, eps2, epsilon)


@torch.no_grad()
def attack_single(model: nn.Module, images, target, Bmask, noise_weight,
                  cfg: AttackConfig, lambda1, use_l2f: bool = False,
                  policy_model: Optional[nn.Module] = None,
                  pcfg: Optional[PolicyConfig] = None,
                  repair: bool = False,
                  score: Optional[Scorer] = None) -> Dict[str, Any]:
    """One eps/G alternation, the final threshold and the eps finetune
    (train_sgd_atom, generate_data.py:251-307), batched over images;
    ``repair=True`` appends ``cardinality_repair``."""
    if use_l2f and score is None:
        score = policy_scorer(policy_model, pcfg, images.device)
    G = torch.ones_like(images)
    epsilon = torch.zeros_like(images)
    for _ in range(cfg.maxIter_mm):
        epsilon = update_epsilon(model, images, target, epsilon, G,
                                 noise_weight, cfg, lambda1=lambda1)
        if use_l2f:
            G = update_g_l2f(model, images, target, epsilon, G, Bmask,
                             noise_weight, cfg, lambda1, pcfg=pcfg,
                             score=score)
        else:
            G = update_g_plain(model, images, target, epsilon, G, Bmask,
                               noise_weight, cfg, lambda1)
    G = (G > 0.5).to(images.dtype)
    epsilon = update_epsilon(model, images, target, epsilon, G,
                             noise_weight, cfg, finetune=True,
                             lambda1=lambda1)
    if repair:
        G, epsilon = cardinality_repair(model, images, target, epsilon, G,
                                        noise_weight, cfg, lambda1=lambda1)
    pred, adv = predictions(model, images, epsilon, G, cfg)
    stats = compute_statistics(images, epsilon, G, noise_weight, cfg)
    stats.update({"success": pred == target, "noise_label": pred,
                  "G": G, "epsilon": epsilon, "adv_image": adv})
    return stats


def attack_with_search(model: nn.Module, images, target, Bmask,
                       noise_weight, cfg: AttackConfig,
                       use_l2f: bool = False,
                       policy_model: Optional[nn.Module] = None,
                       pcfg: Optional[PolicyConfig] = None,
                       repair: bool = False, log=None) -> Dict[str, Any]:
    """Per-image lambda1 binary search (train_adptive,
    main_mha.py:206-248): each image carries its own lambda1 and bounds;
    the search runs on the host, each round one batched attack.  With
    ``repair`` a successful result over the budget k pushes lambda1 up by
    10x, with no clamp to ``lambda1_upper_bound`` (the JAX package's
    attack.py:432), and never displaces a success within k."""
    B = images.shape[0]
    # the policy weights are packed once for the whole search
    score = policy_scorer(policy_model, pcfg, images.device) \
        if use_l2f else None
    lam = np.full((B,), cfg.init_lambda1, dtype=np.float32)
    upper = np.full((B,), cfg.lambda1_upper_bound, dtype=np.float32)
    lower = np.full((B,), cfg.lambda1_lower_bound, dtype=np.float32)
    best: Dict[str, np.ndarray] = {}
    ever_success = np.zeros((B,), dtype=bool)
    ever_within = np.zeros((B,), dtype=bool)

    for search in range(cfg.lambda1_search_times):
        res = attack_single(model, images, target, Bmask, noise_weight, cfg,
                            torch.from_numpy(lam).to(images.device),
                            use_l2f=use_l2f, pcfg=pcfg, repair=repair,
                            score=score)
        res = {k: v.cpu().numpy() for k, v in res.items()}
        res["lambda1"] = lam.copy()
        success = res["success"]
        within = success & (res["L0"] <= cfg.k) if repair else success
        if log:
            log(f"search {search}: success={int(success.sum())}/{B} "
                f"within_k={int(within.sum())}/{B} lambda1={lam[:4]}")
        if not best:
            best = {k: v.copy() for k, v in res.items()}
        else:
            # the last successful result per image, except that a success
            # within k is never displaced by one over it; images that never
            # succeeded track their latest attempt (main_mha.py:243-248)
            upd = within | (success & ~ever_within) \
                | (~ever_success & ~success)
            for k in res:
                best[k] = np.where(
                    np.reshape(upd, (B,) + (1,) * (res[k].ndim - 1)),
                    res[k], best[k])
        ever_success |= success
        ever_within |= within

        if search == cfg.lambda1_search_times - 1:
            break
        # per-image bound updates (main_mha.py:224-240)
        for i in range(B):
            if repair and success[i] and res["L0"][i] > cfg.k \
                    and not ever_within[i]:
                # successful but over budget: escalate, unclamped
                lower[i] = max(lower[i], lam[i])
                lam[i] = lam[i] * 10
            elif success[i]:
                if lam[i] < 0.01 * cfg.init_lambda1:
                    continue
                upper[i] = min(upper[i], lam[i])
                if upper[i] < cfg.lambda1_upper_bound:
                    lam[i] = (upper[i] + lower[i]) / 2
            else:
                lower[i] = max(lower[i], lam[i])
                if upper[i] < cfg.lambda1_upper_bound:
                    lam[i] = (upper[i] + lower[i]) / 2
                else:
                    lam[i] = lam[i] * 10
    best["success"] = ever_success
    best["asr"] = float(ever_success.mean())
    return best


def compute_sensitive(image: np.ndarray, weight_type: str = "none"
                      ) -> np.ndarray:
    """Noise sensitivity weighting (compute_sensitive, utils.py:144-192).

    ``image`` is (C, H, W) in [0, 1].  Types: 'none' (ones), 'gradient'
    (Prewitt magnitude), 'variance', 'variance_mean', 'contrast',
    'contrast_mean' over 3x3 neighbourhoods; non-'none' weights are
    inverted (1/(w+1e-4)) and min-max normalised per channel.
    """
    C, H, W = image.shape
    if weight_type == "none":
        return np.ones_like(image, dtype=np.float32)

    w = np.ones_like(image, dtype=np.float64)
    if weight_type == "gradient":
        from scipy.ndimage import prewitt

        im = image.transpose(1, 2, 0)
        gx = prewitt(im, axis=1)
        gy = prewitt(im, axis=0)
        w = np.sqrt(gx ** 2 + gy ** 2).transpose(2, 0, 1)
    else:
        for i in range(H):
            for j in range(W):
                up, down = max(i - 1, 0), min(i + 2, H)
                left, right = max(j - 1, 0), min(j + 2, W)
                for k in range(C):
                    patch = image[k, up:down, left:right]
                    if weight_type == "variance":
                        v = patch.std(ddof=1)
                    elif weight_type == "variance_mean":
                        v = patch.std(ddof=1) * patch.mean()
                    elif weight_type == "contrast":
                        den = patch.max() + patch.min()
                        v = (patch.max() - patch.min()) / den if den else np.nan
                    elif weight_type == "contrast_mean":
                        den = patch.max() + patch.min()
                        v = ((patch.max() - patch.min()) / den * patch.mean()
                             if den else np.nan)
                    else:
                        raise ValueError(
                            f"unknown weight_type {weight_type!r}")
                    w[k, i, j] = 1e-4 if np.isnan(v) else v
    w = 1.0 / (w + 1e-4)
    for k in range(C):
        mn, mx = w[k].min(), w[k].max()
        w[k] = (w[k] - mn) / (mx - mn if mx > mn else 1.0)
    return w.astype(np.float32)
