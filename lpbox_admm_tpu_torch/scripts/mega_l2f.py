"""Learned early fixing at the very-large struct+Schur CA rungs (the port
of the JAX package's ``scripts/mega_l2f.py``; the reference's own
instance ladder, cython_solver/LPboxADMMsolver.cpp:2461-2486).

    python -m lpbox_admm_tpu_torch.scripts.mega_l2f --phase gen      --seeds bench,7001
    python -m lpbox_admm_tpu_torch.scripts.mega_l2f --phase labels   --seeds bench
    python -m lpbox_admm_tpu_torch.scripts.mega_l2f --phase transfer --seeds bench
    python -m lpbox_admm_tpu_torch.scripts.mega_l2f --phase train    --seeds 7001,7002,bench --init-ckpt ...
    python -m lpbox_admm_tpu_torch.scripts.mega_l2f --phase l2f      [--ckpt ...]

Phases:

* ``gen``      generate and cache instances (``bench`` is the canonical
               ladder instance, the first draw of seed 2207 + n_bids; an
               integer seed is a training instance).
* ``labels``   the plain struct+Schur solve at ``--rho-step`` with the
               first ``--record`` iterations recorded: trajectory
               (float16), converged labels and the selected objective.
* ``transfer`` a checkpoint's deter_fix_2 decisions on the cached
               trajectories against the labels at a grid of
               confidences: fix volume, errors, |b|-weighted error mass.
* ``train``    imitation of the policy (``train.imitation.PolicyTrainer``,
               node size ws / 5) on the ``labels`` datasets, one step per
               dataset an epoch, all seeds but ``--holdout`` (default the
               last); after each epoch the held-out proxy -- the
               deter_fix_2 decisions on the holdout's trajectories
               (scored by ``train.l2f._scorer``: K2 on the card) through
               ``transfer_report``: |b| mass of wrong fixes over |obj|
               plus 0.05 x the shortfall of the fixed fraction below
               ``--target-frac`` -- picks the best checkpoint, saved in
               the JAX package's ``.npz`` format under ``--save-dir``.
* ``l2f``      ``train.l2f_struct.l2f_solve_struct`` on the first seed:
               policy windows on the full struct problem (K2 scores on
               the card), one host fix+compact, the residual at
               ``--tail-rho``; the objective against the float64 CPU
               oracle of ``bench_cache/cpu_oracle_{items}_{bids}.json``
               where there is one (read only).

Instances and datasets are cached in ``--cache`` (default
``lpbox_admm_tpu_torch/_mega_cache``), the train phase's checkpoints in
``--save-dir`` (default ``{cache}/mega_mha``).  Runs on the card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional, Sequence

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CACHE = os.path.join(ROOT, "lpbox_admm_tpu_torch", "_mega_cache")
CKPT = os.path.join(ROOT, "checkpoints", "ca500_mha", "checkpoint",
                    "best_checkpoint.npz")


def bench_seed(n_bids: int) -> int:
    """The canonical ladder instance's seed (the JAX package's
    scripts/bench_sparse_rung.py:58)."""
    return 2207 + n_bids


def generate(n_items: int, n_bids: int, seed) -> tuple:
    """One COO instance ``(prices, (rows, cols, vals, shape))``: the
    first draw of ``RandomState(2207 + n_bids)`` for ``"bench"``, else of
    ``RandomState(seed)``."""
    from ..adapters import ca
    rs = bench_seed(n_bids) if str(seed) == "bench" else int(seed)
    return ca.generate_cauction(np.random.RandomState(rs), n_items=n_items,
                                n_bids=n_bids, return_coo=True)


def get_instance(n_items, n_bids, seed, cache=CACHE):
    """One instance, from ``cache`` or generated and cached there."""
    os.makedirs(cache, exist_ok=True)
    path = os.path.join(cache, f"ca_coo_{n_items}_{n_bids}_s{seed}.npz")
    if os.path.exists(path):
        with np.load(path, allow_pickle=False) as z:
            return (z["p"], (z["r"], z["c"], z["v"], tuple(z["s"])))
    t0 = time.time()
    p, (r, c, v, s) = generate(n_items, n_bids, seed)
    print(f"  gen seed={seed} ({time.time() - t0:.1f}s)", flush=True)
    np.savez(path, p=p, r=r, c=c, v=v, s=np.asarray(s))
    return (p, (r, c, v, s))


def ds_path(n_items, n_bids, seed, cache=CACHE):
    return os.path.join(cache, f"megads_{n_items}_{n_bids}_s{seed}.npz")


def oracle_obj(n_items, n_bids) -> Optional[float]:
    """The float64 CPU oracle of the canonical instance, where the
    repository has one (``bench_cache/cpu_oracle_*.json``)."""
    path = os.path.join(ROOT, "bench_cache",
                        f"cpu_oracle_{n_items}_{n_bids}.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return float(json.load(f)["obj"])


def build_struct(inst, width_cap=12, device="cuda"):
    """The struct problem and its Schur G^{-1} for one instance (B = 1)."""
    from ..adapters import ca
    from ..ops.struct_ginv import build_struct_ginv
    prob, row_maps = ca.make_struct_problem([inst], width_cap=width_cap,
                                            device=device)
    _, (r, c, v, shape) = inst
    E = prob.E
    ginv = build_struct_ginv([(r, c, v)], [tuple(shape)], row_maps, E.m1,
                             E.m2, prob.n, ratio=2.0, device=device)
    return prob, ginv, row_maps


def make_scorer(ckpt, ws=100, device="cuda"):
    """The checkpoint's scorer: K2 on the card, the module's forward on
    the CPU (``train.l2f._scorer``)."""
    import torch
    from ..config import PolicyConfig
    from ..train import l2f
    from ..utils.checkpoint import load_policy
    pcfg = PolicyConfig(net="mha", node_size=ws // 5)
    model = load_policy(ckpt, node_size=pcfg.node_size, device=device)
    return l2f._scorer(model, pcfg, torch.device(device), 8192)


def solve_cfg(rho_step):
    from ..config import LP_CONFIG
    cfg = LP_CONFIG.replace(linsolve="woodbury")
    return cfg.replace(rho_change_step=rho_step) if rho_step else cfg


def phase_labels(args, seeds):
    from ..core import lp
    cfg = solve_cfg(args.rho_step)
    for seed in seeds:
        out = ds_path(args.n_items, args.n_bids, seed, args.cache)
        if os.path.exists(out) and not args.force:
            print(f"labels seed={seed}: cached", flush=True)
            continue
        inst = get_instance(args.n_items, args.n_bids, seed, args.cache)
        t0 = time.time()
        prob, ginv, _ = build_struct(inst, args.width_cap, args.device)
        print(f"labels seed={seed}: struct+schur built "
              f"{time.time() - t0:.1f}s", flush=True)
        t0 = time.time()
        state = lp.init_state(prob, cfg, ginv=ginv)
        state, traj = lp.solve_window(state, prob, cfg, args.record,
                                      record=True, skip_cvg_at=0)
        n_valid = int(prob.var_mask.sum())
        traj_h = traj[0, :n_valid].cpu().numpy().astype(np.float16)
        window = args.window or (100 if prob.n >= 400_000 else 500)
        while state.it < args.cap and not bool(state.done.all()):
            state, _ = lp.solve_window(state, prob, cfg, window,
                                       record=False)
        sol, obj, infeas = lp.select_solution(
            prob, lp.solution(state), lp.solution_best(state))
        wall = time.time() - t0
        np.savez(out, traj=traj_h,
                 labels=sol[0, :n_valid].cpu().numpy().astype(np.uint8),
                 b=prob.b[0, :n_valid].cpu().numpy(),
                 obj=np.float64(obj[0].item()),
                 infeas=np.int32(infeas[0].item()),
                 iters=np.int32(state.it), wall=np.float64(wall))
        print(f"labels seed={seed}: obj {obj[0].item():.1f} infeas "
              f"{int(infeas[0])} iters {state.it} wall {wall:.1f}s -> {out}",
              flush=True)


def phase_transfer(args, seeds):
    from ..train.l2f_struct import (gate_margins, transfer_report,
                                    window_decisions)
    score = make_scorer(args.ckpt, args.ws, args.device)
    for seed in seeds:
        with np.load(ds_path(args.n_items, args.n_bids, seed,
                             args.cache)) as z:
            traj = z["traj"].astype(np.float32)
            labels, b, obj = z["labels"], z["b"], float(z["obj"])
        print(f"transfer seed={seed} (oracle obj {obj:.1f}, "
              f"{traj.shape[1]} recorded iters):", flush=True)
        for conf in args.conf_grid:
            vec, _ = window_decisions(
                traj, score, args.ws, conf, args.fix_windows,
                args.policy_windows,
                margins=gate_margins(b, conf, args.damage_gate),
                device=args.device)
            transfer_report(vec, labels, b, obj,
                            tag=f"C={conf} fw={args.fix_windows} "
                                f"w={args.policy_windows} "
                                f"dg={args.damage_gate}")


def load_dataset(args, seed, device):
    """A ``labels`` dataset as a one-instance ``TrajectoryDataset``."""
    import torch
    from ..train.imitation import TrajectoryDataset
    with np.load(ds_path(args.n_items, args.n_bids, seed, args.cache)) as z:
        t = lambda a: torch.from_numpy(a.astype(np.float32))[None].to(device)
        traj = t(z["traj"])
        return TrajectoryDataset(
            traj=traj, labels=t(z["labels"]),
            var_mask=torch.ones(traj.shape[:2], dtype=torch.bool,
                                device=device),
            oracle_obj=torch.tensor([float(z["obj"])], device=device),
            oracle_iters=int(z["iters"]))


def holdout_proxy(args, model, pcfg, hz, device):
    """The held-out proxy of a policy module: the |b| mass of its wrong
    fixes on the holdout over |obj|, plus 0.05 x the shortfall of the
    fixed fraction below ``--target-frac`` (fixing too little destroys
    the speed-up)."""
    import torch
    from ..train import l2f
    from ..train.l2f_struct import transfer_report, window_decisions
    score = l2f._scorer(model, pcfg, torch.device(device), 8192)
    vec, _ = window_decisions(hz["traj"], score, args.ws, args.conf,
                              args.fix_windows, args.policy_windows,
                              device=device)
    nf, _, mass = transfer_report(vec, hz["labels"], hz["b"], hz["obj"],
                                  tag="holdout")
    return mass / abs(hz["obj"]) + 0.05 * max(0.0, args.target_frac
                                              - nf / len(vec))


def phase_train(args, seeds):
    """Imitation on the cached datasets, the best checkpoint by the
    held-out proxy.  Returns the best proxy, its epoch, each epoch's
    loss and proxy, and the trained state."""
    from ..config import LP_CONFIG, PolicyConfig
    from ..core.problem import as_device
    from ..models.policy import build_policy
    from ..train.imitation import PolicyTrainer
    dev = as_device(args.device)
    train_seeds = [s for s in seeds if s != args.holdout]
    pcfg = PolicyConfig(net="mha", lr=args.lr, node_size=args.ws // 5)
    model = build_policy("mha", pcfg.node_size, pcfg.chunk_dim, pcfg.pe_dim)
    trainer = PolicyTrainer(model, pcfg, LP_CONFIG, ws=args.ws,
                            save_dir=args.save_dir, device=dev)
    datasets = [load_dataset(args, s, dev) for s in train_seeds]
    n_eps = min(args.episodes, datasets[0].traj.shape[-1] // args.ws)
    with np.load(ds_path(args.n_items, args.n_bids, args.holdout,
                         args.cache)) as z:
        hz = {"traj": z["traj"].astype(np.float32), "labels": z["labels"],
              "b": z["b"], "obj": float(z["obj"])}
    if args.init_ckpt:
        ts = trainer.load(args.init_ckpt)
        print(f"init from {args.init_ckpt}", flush=True)
    else:
        ts = trainer.init(args.seed_rng)
    best, history = (np.inf, -1), []
    for epoch in range(args.epochs):
        ts, loss = trainer.train_epoch(ts, datasets, n_episodes=n_eps)
        p = holdout_proxy(args, trainer.variables(ts), pcfg, hz, dev)
        history.append({"epoch": epoch, "loss": loss, "proxy": p})
        print(f"epoch {epoch}: loss {loss:.5f} proxy {p:.5f}", flush=True)
        trainer.save(ts, epoch)
        if p < best[0]:
            best = (p, epoch)
            trainer.save(ts, epoch, best=True)
    print(f"best epoch {best[1]} proxy {best[0]:.5f} -> "
          f"{args.save_dir}/checkpoint/best_checkpoint.npz", flush=True)
    return {"best_proxy": best[0], "best_epoch": best[1],
            "history": history, "state": ts}


def phase_l2f(args, seeds):
    from ..train.l2f_struct import l2f_solve_struct
    seed = seeds[0]
    inst = get_instance(args.n_items, args.n_bids, seed, args.cache)
    orc = oracle_obj(args.n_items, args.n_bids) if seed == "bench" else None
    t0 = time.time()
    prob, ginv, row_maps = build_struct(inst, args.width_cap, args.device)
    build_s = time.time() - t0
    print(f"struct+schur built {build_s:.1f}s", flush=True)
    tm = {}
    out = l2f_solve_struct(
        prob, ginv, inst, row_maps[0],
        make_scorer(args.ckpt, args.ws, args.device),
        solve_cfg(args.rho_step), conf=args.conf,
        fix_windows=args.fix_windows, policy_windows=args.policy_windows,
        ws=args.ws, tail_rho=args.tail_rho or None, cap=args.cap,
        window=args.window, damage_gate=args.damage_gate,
        e_dtype=args.e_dtype, reduced_ginv=args.reduced_ginv,
        oracle_obj=orc, timings=tm)
    total = out["policy_s"] + out["compact_s"] + out["tail_s"]
    print(f"  stages: n {out['n_valid']}->{out['n_red']} (padded "
          f"{out['red_shape']}), decided {out['decided']}, timings "
          f"{ {k: round(v, 2) for k, v in tm.items()} }", flush=True)
    gap = f" gap {out['gap']:+.2%}" if "gap" in out else ""
    print(f"L2F {args.n_items}x{args.n_bids} seed={seed}: wall {total:.1f}s "
          f"(policy {out['policy_s']:.1f} + compact {out['compact_s']:.1f} "
          f"+ tail {out['tail_s']:.1f}; struct build {build_s:.1f}s extra) "
          f"it {out['iterations']} obj {out['obj']:.1f}{gap} infeas "
          f"{out['infeasible']} fixed {out['n_fixed']}", flush=True)
    return out


def parse_args(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phase", required=True,
                    choices=["gen", "labels", "transfer", "train",
                             "l2f"])
    ap.add_argument("--rung", default="1000x100000")
    ap.add_argument("--seeds", default="bench")
    ap.add_argument("--cache", default=CACHE)
    ap.add_argument("--width-cap", type=int, default=12)
    ap.add_argument("--record", type=int, default=500,
                    help="recorded iterations (labels phase)")
    ap.add_argument("--cap", type=int, default=20000)
    ap.add_argument("--window", type=int, default=None,
                    help="residual window iterations (default 100 at "
                         "n >= 4e5, else 500)")
    ap.add_argument("--rho-step", type=int, default=None,
                    help="policy/labels phase rho_change_step (default: "
                         "the reference's 25)")
    ap.add_argument("--tail-rho", type=int, default=12,
                    help="residual-phase rho_change_step (l2f phase); 0 "
                         "keeps the policy schedule")
    ap.add_argument("--ws", type=int, default=100)
    ap.add_argument("--ckpt", default=CKPT)
    ap.add_argument("--conf", type=float, default=0.98)
    ap.add_argument("--conf-grid", default="0.9,0.98,0.995,0.999")
    ap.add_argument("--fix-windows", type=int, default=2)
    ap.add_argument("--policy-windows", type=int, default=3)
    ap.add_argument("--damage-gate", type=float, default=0.0)
    ap.add_argument("--e-dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--reduced-ginv", default="schur",
                    choices=["schur", "dense"])
    ap.add_argument("--force", action="store_true")
    # train phase
    ap.add_argument("--holdout", default=None,
                    help="held-out seed (default: the last of --seeds)")
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--episodes", type=int, default=5)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--seed-rng", type=int, default=0)
    ap.add_argument("--init-ckpt", default=None)
    ap.add_argument("--target-frac", type=float, default=0.6)
    ap.add_argument("--save-dir", default=None,
                    help="train phase checkpoints (default "
                         "{cache}/mega_mha)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.save_dir is None:
        args.save_dir = os.path.join(args.cache, "mega_mha")
    args.n_items, args.n_bids = map(int, args.rung.split("x"))
    args.conf_grid = [float(c) for c in args.conf_grid.split(",")]
    return args


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    seeds = args.seeds.split(",")
    if args.phase == "gen":
        for s in seeds:
            get_instance(args.n_items, args.n_bids, s, args.cache)
    elif args.phase == "labels":
        phase_labels(args, seeds)
    elif args.phase == "transfer":
        phase_transfer(args, seeds)
    elif args.phase == "train":
        if args.holdout is None:
            args.holdout = seeds[-1]
        return phase_train(args, seeds)
    else:
        return phase_l2f(args, seeds)


if __name__ == "__main__":
    main()
