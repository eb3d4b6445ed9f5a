"""Combinatorial-auction LP experiment entry point (the port of the JAX
package's ``experiments/run_lp.py``; reference LP silo entry points):

* ``-phase generate`` ~ generate_data/generate_instances.py (:362-401):
  seeded CA instances written in the reference's format;
* ``-phase solve``    ~ cython_solver/get_iterations.py (:10-30): plain
  batched solves, recorded xiter trajectory CSVs and the allres.csv
  oracle;
* ``-phase train``    ~ experiments/run.py -phase train (:22-61):
  imitation training with in-loop evaluation and checkpoints;
* ``-phase test``     ~ experiments/run.py -phase test (_valid_2): the
  compacting l2f solve (on the card: K1 and K2) against the oracle.

    python -m lpbox_admm_tpu_torch.experiments.run_lp -phase generate -n 120 -j 100 -col 500
    python -m lpbox_admm_tpu_torch.experiments.run_lp -phase solve -n 120
    python -m lpbox_admm_tpu_torch.experiments.run_lp -phase train -net mha -ws 100
    python -m lpbox_admm_tpu_torch.experiments.run_lp -phase test -net mha -ws 100

Everything runs on the card unless ``-device cpu`` is given.

``-mesh N`` (N >= 1) runs the phase in N data-parallel ranks
(``parallel.mesh``; the JAX package's ``-mesh``): each rank builds its
shard of every dataset chunk and of the evaluation batch (``-batch`` and
``-n_eval`` must split evenly), the policy trains with the gradient
summed over the ranks and BatchNorm over the global batch, the
evaluation gathers its per-instance metrics, and rank 0 alone writes
logs, CSVs and checkpoints.  Under torchrun (``WORLD_SIZE`` set, equal
to N) this process is one rank; otherwise ``main`` builds the kernels
and starts N ranks itself, rank r on ``cuda:r`` under NCCL (at most one
rank a card), or N gloo processes with ``-device cpu``.

    torchrun --nproc_per_node 4 -m lpbox_admm_tpu_torch.experiments.run_lp -phase train -mesh 4
    python -m lpbox_admm_tpu_torch.experiments.run_lp -phase train -mesh 4
"""

from __future__ import annotations

import os
import sys
import time
from typing import Optional, Sequence


from ..utils.cmd_args import base_parser, check_ported

#: collective timeout of a rank of ``-mesh``: ranks wait at the end of
#: every dataset build for the slowest shard's solve
RANK_TIMEOUT_S = 1800.0


def parse_args(argv: Optional[Sequence[str]] = None):
    p = base_parser("CA-LP Lp-Box ADMM with learned early fixing")
    p.add_argument("-n", type=int, default=24, help="number of instances")
    p.add_argument("-j", type=int, default=100, help="number of items")
    p.add_argument("-n_eval", type=int, default=8,
                   help="held-out eval instances")
    p.add_argument("-record_iters", type=int, default=1000)
    args = p.parse_args(argv)
    check_ported(args)
    return args


def instance_dir(args) -> str:
    return os.path.join(args.data_dir, "instance", f"{args.j}_{args.col}")


def load_problem(args, lo: int, hi: int, mesh=None):
    """Instances lo..hi-1 as one padded batch on ``args.device``, or with
    a ``mesh`` this rank's shard of it on the rank's device."""
    from ..adapters import ca
    from ..parallel.mesh import shard_batch
    d = instance_dir(args)
    insts = [ca.read_instance(os.path.join(d, f"instance_{i + 1}"))
             for i in range(lo, hi)]
    if mesh is None:
        return ca.make_problem(insts, device=args.device)
    return shard_batch(ca.make_problem(insts, device="cpu"), mesh)


def main(argv: Optional[Sequence[str]] = None, log=print):
    """Run one phase; returns what it made (the instance prefixes, the
    datasets, the trained state or the test metrics).  With ``-mesh N``
    in spawned ranks: rank 0's result, and its log lines go to ``log``
    (printed by the rank as they come when ``log`` is ``print``)."""
    args = parse_args(argv)
    if args.save_dir == "saved_model":
        args.save_dir = os.path.join("saved_model", "lp", args.net)
    from ..config import LP_CONFIG, PolicyConfig

    cfg = LP_CONFIG.replace(linsolve=args.linsolve,
                            matvec_dtype=args.matvec_dtype)
    pcfg = PolicyConfig(net=args.net, node_size=20,
                        chunk_dim=args.ws // 20,
                        damage_gate=args.damage_gate)
    if args.mesh < 1:
        return run(args, cfg, pcfg, None, log)
    return _main_mesh(args, cfg, pcfg, log)


def _silent(msg):
    pass


def _main_mesh(args, cfg, pcfg, log):
    import torch
    import torch.distributed as dist

    from ..parallel.mesh import init_distributed, launch

    n = args.mesh
    if "WORLD_SIZE" in os.environ:
        if int(os.environ["WORLD_SIZE"]) != n:
            raise ValueError(f"-mesh {n} under torchrun's WORLD_SIZE "
                             f"{os.environ['WORLD_SIZE']}")
        mesh = init_distributed(device=None if args.device == "cuda"
                                else "cpu", timeout_s=RANK_TIMEOUT_S)
        try:
            return run(args, cfg, pcfg, mesh,
                       log if mesh.rank == 0 else _silent)
        finally:
            dist.destroy_process_group()
    if args.device == "cuda":
        from ..kernels import build
        if n > torch.cuda.device_count():
            raise ValueError(f"-mesh {n}: {torch.cuda.device_count()} "
                             "card(s) here, and NCCL takes one rank a card")
        build.build()
        devices = [f"cuda:{r}" for r in range(n)]
    else:
        devices = ["cpu"] * n
    value, lines = launch(_rank, n, args, cfg, pcfg, log is print,
                          devices=devices,
                          backend="nccl" if args.device == "cuda"
                          else "gloo",
                          collective_timeout_s=RANK_TIMEOUT_S)[0]
    for line in lines:
        log(line)
    return value


def _rank(mesh, args, cfg, pcfg, echo):
    """One rank of ``-mesh``: the phase on this rank's shards; rank 0
    returns its result and its log lines (none when it printed them)."""
    lines = []
    log = _silent if mesh.rank else (print if echo else lines.append)
    value = run(args, cfg, pcfg, mesh, log)
    return (value, lines) if mesh.rank == 0 else None


def run(args, cfg, pcfg, mesh, log):
    """The phase of ``args`` with the solver and policy configurations,
    on one device (``mesh`` None) or on this rank's shards."""
    import torch.distributed as dist

    from ..adapters import ca
    from ..models.policy import build_policy
    from ..parallel.mesh import gather_batch
    from ..train import imitation
    from ..utils import io as uio

    rank0 = mesh is None or mesh.rank == 0
    gather = (lambda t: t) if mesh is None \
        else (lambda t: gather_batch(t, mesh))

    if args.phase == "generate":
        prefixes = None
        if rank0:
            t0 = time.perf_counter()
            prefixes = ca.generate_dataset(args.data_dir, args.seed, args.n,
                                           n_items=args.j,
                                           n_bids=args.col)
            log(f"generated {args.n} instances in {instance_dir(args)} "
                f"({time.perf_counter() - t0:.1f}s)")
        if mesh is not None:
            dist.barrier()
        return prefixes

    if args.phase == "solve":
        xdir = os.path.join(args.data_dir, "xiter")
        os.makedirs(xdir, exist_ok=True)
        allres = os.path.join(xdir, "allres.csv")
        out = []
        for lo in range(0, args.n, args.batch):
            hi = min(lo + args.batch, args.n)
            prob = load_problem(args, lo, hi, mesh)
            t0 = time.perf_counter()
            ds = gather(imitation.build_dataset(
                prob, cfg, record_iters=args.record_iters, mesh=mesh))
            wall = time.perf_counter() - t0
            per = wall / (hi - lo)
            if rank0:
                traj = ds.traj.cpu().numpy()
                nvars = ds.var_mask.sum(-1).tolist()
                obj = ds.oracle_obj.cpu().numpy()
                for b, i in enumerate(range(lo, hi)):
                    uio.write_xiter_csv(
                        os.path.join(xdir, f"{args.j}_{args.col}_xiters_"
                                           f"{i + 1}.csv"),
                        traj[b, :nvars[b], :])
                    uio.append_allres(allres, i + 1, float(obj[b]),
                                      ds.oracle_iters, per)
                log(f"instances {lo + 1}..{hi}: plain solve "
                    f"{ds.oracle_iters} iters, {wall:.1f}s, "
                    f"mean obj {float(obj.mean()):.1f}")
            out.append(ds)
        return out

    # train / test need the policy
    model = build_policy(args.net)
    trainer = imitation.PolicyTrainer(model, pcfg, cfg, ws=args.ws,
                                      save_dir=args.save_dir,
                                      device=args.device, mesh=mesh)
    n_train = args.n - args.n_eval
    eval_prob = load_problem(args, n_train, args.n, mesh)
    eval_ds = imitation.build_dataset(eval_prob, cfg,
                                      record_iters=args.record_iters,
                                      mesh=mesh)

    if args.phase == "train":
        def train(tee):
            datasets = []
            for lo in range(0, n_train, args.batch):
                hi = min(lo + args.batch, n_train)
                datasets.append(imitation.build_dataset(
                    load_problem(args, lo, hi, mesh), cfg,
                    record_iters=args.record_iters, mesh=mesh))
                tee(f"dataset {lo + 1}..{hi} built "
                    f"(oracle iters {datasets[-1].oracle_iters})")
            ts = trainer.init(args.seed)
            return trainer.train(ts, datasets, eval_prob, eval_ds,
                                 num_epochs=args.num_epochs, log=tee)

        if not rank0:
            return train(_silent)
        os.makedirs(os.path.join(args.save_dir, "log"), exist_ok=True)
        with open(os.path.join(args.save_dir, "log", "log.txt"), "a") as logf:
            def tee(msg):
                log(msg)
                logf.write(msg + "\n")
                logf.flush()

            return train(tee)

    path = args.checkpoint or os.path.join(
        args.save_dir, "checkpoint", "best_checkpoint.npz")
    ts = trainer.load(path)
    m = trainer.evaluate(ts, eval_prob, eval_ds, compact=True)
    log(f"[Lpbox] oracle: mean obj "
        f"{float(gather(eval_ds.oracle_obj).mean()):.2f}, "
        f"iters {eval_ds.oracle_iters}")
    log(f"[l2f] obj gap {m['mean_obj_gap']:+.4f}, "
        f"iters {int(m['iterations'])} "
        f"(speedup {m['iter_speedup']:.2f}x), "
        f"fixed {m['n_fixed'].mean():.0f} vars, "
        f"fix errors {m['fix_errors'].mean():.1f}, "
        f"infeasible {m['infeasible'].mean():.2f}")
    return m


if __name__ == "__main__":
    main(sys.argv[1:])
