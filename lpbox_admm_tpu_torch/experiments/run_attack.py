"""Sparse adversarial attack experiment entry point (the port of the JAX
package's ``experiments/run_attack.py``; reference SparseAttack silo,
main_ori.py / main_mha.py / main_mlp.py and experiments/lista_kl.py):

* ``-phase solve`` ~ main_ori.py: plain-ADMM attacks with the lambda1
  search; appends to ``{result_dir}/all_ori.csv`` and, with
  ``-dump_xiter``, writes each image's G trajectories (3 windows of
  ``-ws`` iterations) in the reference's xiter CSV format for imitation
  training (the generate_data.py path);
* ``-phase train`` ~ experiments/lista_kl.py: policy training on the
  recorded G trajectories (3 episodes of ws = 50, node 10 x chunk 5), or
  on trajectories made in one batch where none are recorded; the best
  checkpoint by the in-loop l2f attack's (success rate, -mean L0);
* ``-phase test``  ~ main_mha.py / main_mlp.py: l2f attacks (K2 scores
  the policy windows on the card), success rate and L norms to
  ``{result_dir}/all_{net}.csv``.

    python -m lpbox_admm_tpu_torch.experiments.run_attack -phase solve -image_dir DIR -victim checkpoints/cifar_victim.npz -dump_xiter
    python -m lpbox_admm_tpu_torch.experiments.run_attack -phase train -image_dir DIR -victim checkpoints/cifar_victim.npz
    python -m lpbox_admm_tpu_torch.experiments.run_attack -phase test -image_dir DIR -victim checkpoints/cifar_victim.npz

Images are ``{label}_{index}.png`` files (PIL, imported only to read
them).  ``-victim`` takes the shipped flax ``.npz`` or the reference's
``cifar_best.pth``; without it a victim is drawn from torch's
initialiser seeded with ``-seed`` (not the JAX package's draw).
Everything runs on the card unless ``-device cpu`` is given.
"""

from __future__ import annotations

import glob
import os
import sys
import time
from typing import Optional, Sequence

import numpy as np

from ..utils.cmd_args import base_parser, check_ported

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
#: the reference's CIFAR-10 test images (``{label}_{index}.png``):
#: ``$LPBOX_ATTACK_IMAGES``, else the reference checkout beside the package
CIFAR_DIR = os.environ.get("LPBOX_ATTACK_IMAGES", os.path.join(
    ROOT, "reference", "SparseAttack", "SparseAttack", "data"))


def parse_args(argv: Optional[Sequence[str]] = None):
    p = base_parser("Sparse adversarial attack with learned early fixing")
    p.set_defaults(ws=50)
    p.add_argument("-n", type=int, default=8, help="number of images")
    p.add_argument("-image_dir", default=CIFAR_DIR)
    p.add_argument("-victim", default=None,
                   help="victim checkpoint: torch cifar_best.pth or the "
                        "flax .npz (optional; random-init without)")
    p.add_argument("-k", type=int, default=200, help="L0 budget")
    p.add_argument("-segments", type=int, default=150)
    p.add_argument("-maxIter_e", type=int, default=2000)
    p.add_argument("-maxIter_g", type=int, default=2000)
    p.add_argument("-search", type=int, default=6)
    p.add_argument("-init_lambda1", type=float, default=None,
                   help="starting lambda1 for the binary search "
                        "(default: the reference's 1e-3; random-init "
                        "victims need ~10-100)")
    p.add_argument("-result_dir", default="result")
    p.add_argument("-dump_xiter", action="store_true",
                   help="record G trajectories for policy training")
    p.add_argument("-repair", type=int, default=1,
                   help="1 = L0 cardinality repair on the final mask "
                        "(attack.cardinality_repair; never degrades "
                        "success), 0 = reference reporting semantics")
    p.add_argument("-weight_type", default="none",
                   choices=["none", "gradient", "variance",
                            "variance_mean", "contrast",
                            "contrast_mean"],
                   help="noise sensitivity weighting (utils.py:144)")
    args = p.parse_args(argv)
    check_ported(args, data_parallel=False)
    return args


def load_images(args):
    """The first ``-n`` PNGs of ``-image_dir`` as (N, 3, 32, 32) in
    [0, 1], their labels from the file names and the reference's target
    rule (main_mha.py:84-88)."""
    from PIL import Image
    paths = sorted(glob.glob(os.path.join(args.image_dir, "*.png")))
    paths = paths[:args.n]
    imgs, labels = [], []
    for p in paths:
        im = np.asarray(Image.open(p).convert("RGB"),
                        dtype=np.float32) / 255.0
        imgs.append(im.transpose(2, 0, 1))
        labels.append(int(os.path.basename(p).split("_")[0]))
    targets = np.array([target_of(t) for t in labels])
    return np.stack(imgs), np.array(labels), targets, paths


def target_of(label: int) -> int:
    """The reference's target label (main_mha.py:84-88)."""
    return (label - 2) + 9 if label - 2 < 0 else label - 2


def load_victim(path: Optional[str], seed: int, device):
    from ..models.cifarnet import (init_victim, load_torch_checkpoint,
                                   load_victim_npz)
    if path and path.endswith(".npz"):
        return load_victim_npz(path, device)
    if path:
        return load_torch_checkpoint(path, device)
    return init_victim(seed % (2 ** 31), device)


def group_masks(imgs: np.ndarray, segments: int) -> np.ndarray:
    """Each image's SLIC masks, zero-padded to the largest count:
    (N, S, 3, H, W)."""
    from ..adapters import slic
    Bms = [slic.segment_masks((im.transpose(1, 2, 0) * 255).astype(np.uint8),
                              n_segments=segments) for im in imgs]
    S = max(b.shape[0] for b in Bms)
    Bm = np.zeros((len(imgs), S) + imgs.shape[1:], np.float32)
    for i, b in enumerate(Bms):
        Bm[i, :b.shape[0]] = b
    return Bm


def record_trajectories(model, images, target, eps, Bm, nw, cfg, lam, ws,
                        windows=3):
    """G trajectories of a plain windowed run from G = 1 at ``eps``:
    (N, 3, H, W, windows * ws)."""
    import torch
    from ..adapters import attack
    state = attack.init_attack_state(torch.ones_like(images))
    trajs = []
    for _ in range(windows):
        state, traj = attack.g_window(model, images, target, eps, state, Bm,
                                      nw, cfg, ws, lam, record=True)
        trajs.append(traj)
    return torch.cat(trajs, dim=-1)


def main(argv: Optional[Sequence[str]] = None, log=print):
    """Run one phase; returns the search result (solve, test) or the
    trained state and its history (train)."""
    args = parse_args(argv)
    import torch
    from ..adapters import attack
    from ..config import ATTACK_CONFIG, PolicyConfig
    from ..core.problem import as_device
    from ..models.policy import build_policy
    from ..train.imitation import PolicyTrainer, TrajectoryDataset
    from ..utils import io as uio

    dev = as_device(args.device)
    if args.save_dir == "saved_model":
        args.save_dir = os.path.join("saved_model", "attack", args.net)
    os.makedirs(args.result_dir, exist_ok=True)
    cfg = ATTACK_CONFIG.replace(
        k=args.k, segments=args.segments, maxIter_e=args.maxIter_e,
        maxIter_g=args.maxIter_g, lambda1_search_times=args.search)
    if args.init_lambda1 is None and args.victim is None:
        # a seeded random-init victim has weak, noisy gradients; the
        # reference's 1e-3 start leaves the whole binary search below
        # the useful range (the JAX package observed 3% success vs 100%
        # at 100)
        args.init_lambda1 = 100.0
    if args.init_lambda1 is not None:
        cfg = cfg.replace(init_lambda1=args.init_lambda1,
                          lambda1=args.init_lambda1)
    pcfg = PolicyConfig(net=args.net, node_size=10, chunk_dim=5)

    imgs, labels, targets, paths = load_images(args)
    model = load_victim(args.victim, args.seed, dev)
    Bm = group_masks(imgs, args.segments)
    nw = np.stack([attack.compute_sensitive(im, args.weight_type)
                   for im in imgs])
    t = lambda a: torch.as_tensor(a).to(dev)
    images, target, Bmask, noise_w = t(imgs), t(targets), t(Bm), t(nw)
    if args.phase != "solve":
        policy = build_policy(args.net, pcfg.node_size, pcfg.chunk_dim,
                              pcfg.pe_dim)
        trainer = PolicyTrainer(policy, pcfg, ws=args.ws,
                                save_dir=args.save_dir, device=dev)

    if args.phase in ("solve", "test"):
        use_l2f = args.phase == "test"
        pm = None
        if use_l2f:
            path = args.checkpoint or os.path.join(
                args.save_dir, "checkpoint", "best_checkpoint.npz")
            pm = trainer.variables(trainer.load(path))
        t0 = time.perf_counter()
        res = attack.attack_with_search(
            model, images, target, Bmask, noise_w, cfg, use_l2f=use_l2f,
            policy_model=pm, pcfg=pcfg, repair=bool(args.repair), log=log)
        wall = time.perf_counter() - t0
        tag = args.net if use_l2f else "ori"
        csv = os.path.join(args.result_dir, f"all_{tag}.csv")
        with open(csv, "a") as f:
            for i, p in enumerate(paths):
                f.write(
                    f"Img:{os.path.basename(p)}, "
                    f"Origin Label:{labels[i]}, "
                    f"Target Label:{targets[i]}, "
                    f"asr:{int(res['success'][i])}, "
                    f"L0:{res['L0'][i]}, L1:{res['L1'][i]:.4f}, "
                    f"L2:{res['L2'][i]:.4f}, L-inf:{res['Li'][i]:.4f}\n")
        log(f"success rate {res['asr']:.2f}; mean L0 "
            f"{res['L0'].mean():.0f}, L1 {res['L1'].mean():.2f}, "
            f"L2 {res['L2'].mean():.3f}, Linf {res['Li'].mean():.3f}; "
            f"wall {wall:.1f}s -> {csv}")
        # quartiles as well as means, so that tail behaviour shows
        for norm in ("L0", "L1", "L2", "Li"):
            q = np.percentile(np.asarray(res[norm], np.float64),
                              [0, 25, 50, 75, 100])
            log(f"  {norm} quartiles: min {q[0]:.3f} / q25 {q[1]:.3f}"
                f" / med {q[2]:.3f} / q75 {q[3]:.3f} / max {q[4]:.3f}")
        res["wall_s"] = wall
        if args.dump_xiter and args.phase == "solve":
            xdir = os.path.join(args.data_dir, "attack_xiter")
            traj = record_trajectories(
                model, images, target, t(res["epsilon"]), Bmask, noise_w,
                cfg, t(res["lambda1"]), args.ws).cpu().numpy()
            for i, p in enumerate(paths):
                name = os.path.splitext(os.path.basename(p))[0]
                uio.write_xiter_csv(os.path.join(xdir, f"{name}.csv"),
                                    traj[i].reshape(-1, traj.shape[-1]))
            log(f"dumped {len(paths)} G trajectories to {xdir}")
        return res

    # -phase train (lista_kl.py): recorded CSVs where there are some,
    # else the trajectories made here in one batch
    xdir = os.path.join(args.data_dir, "attack_xiter")
    files = sorted(glob.glob(os.path.join(xdir, "*.csv")))
    ts = trainer.init(args.seed)
    datasets = []
    one = lambda rows: TrajectoryDataset(
        traj=rows, labels=(rows[:, :, -1] >= 0.5).float(),
        var_mask=torch.ones(rows.shape[:2], dtype=torch.bool, device=dev),
        oracle_obj=torch.zeros(rows.shape[0], device=dev),
        oracle_iters=int(rows.shape[-1]))
    lam = torch.full((imgs.shape[0],), cfg.init_lambda1, dtype=torch.float32,
                     device=dev)
    if files:
        for fp in files:
            tr = uio.read_xiter_csv(fp)                    # (3072, T)
            datasets.append(one(torch.from_numpy(
                tr[None].astype(np.float32)).to(dev)))
    else:
        log("no recorded trajectories; generating them")
        res0 = attack.attack_single(model, images, target, Bmask, noise_w,
                                    cfg, lam)
        traj = record_trajectories(model, images, target, res0["epsilon"],
                                   Bmask, noise_w, cfg, lam, args.ws)
        datasets.append(one(traj.reshape(traj.shape[0], -1,
                                         traj.shape[-1])))
    # the best checkpoint by the in-loop l2f attack: success rate first,
    # then mean L0 (the reference intends best-by-eval, SA trainer.py:
    # 437-464)
    best_key = None
    history = []
    for epoch in range(args.num_epochs):
        ts, loss = trainer.train_epoch(ts, datasets, n_episodes=3)
        res = attack.attack_single(model, images, target, Bmask, noise_w,
                                   cfg, lam, use_l2f=True,
                                   policy_model=trainer.variables(ts),
                                   pcfg=pcfg)
        asr = float(res["success"].float().mean())
        l0 = float(res["L0"].float().mean())
        key = (asr, -l0)
        history.append({"epoch": epoch, "loss": loss, "asr": asr, "L0": l0})
        log(f"epoch {epoch}: loss={loss:.5f} eval asr={asr:.2f} L0={l0:.0f}")
        trainer.save(ts, epoch)
        if best_key is None or key > best_key:
            best_key = key
            trainer.save(ts, epoch, best=True)
            log(f"  new best checkpoint (asr={asr:.2f}, L0={l0:.0f})")
    return {"state": ts, "history": history, "best": best_key}


if __name__ == "__main__":
    main(sys.argv[1:])
