"""Data-parallel dry run (the counterpart of the JAX package's
``__graft_entry__.dryrun_multichip`` and ``entry``), and the rank
functions it, the tests and the smoke run.

    python -m lpbox_admm_tpu_torch.parallel.dryrun --n N [--device cpu]

In N ranks (rank r on ``cuda:r`` under NCCL; gloo processes with
``--device cpu``), at the JAX package's tiny shapes (2 CA instances of 8
items x 20 bids a rank, ws 20, 4 tokens of 5): a sharded
``build_dataset``, episode batches and a data-parallel ``train_epoch``
of 2 episodes, then a sharded masked ``l2f_solve`` with ``l2f_metrics``
gathered; the loss and the mean gap must be finite.  Then
``dp_scaling_table`` on the bench-shaped batch (128 CA-500 instances,
seed 2207, generated anew) over 1, 2, 4, ... ranks up to N.

Each rank function takes the rank's ``Mesh`` first and returns host
values, so that ``parallel.mesh.launch`` can carry them back.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from .mesh import Mesh, dp_scaling_table, gather_batch, launch, shard_batch

BENCH_SEED, BENCH_BATCH = 2207, 128


def entry(device="cuda"):
    """The flagship policy's forward (MHA, 20 tokens of 5, fresh weights
    from seed 0) and an example input of 64 rows, as the JAX package's
    ``entry`` returns them."""
    from ..models.policy import build_policy, init_weights
    model = build_policy("mha")
    init_weights(model, torch.Generator().manual_seed(0))
    model = model.to(device).eval()
    x = torch.zeros((64, 20, 5), device=device)

    def fwd(model, x):
        with torch.no_grad():
            logits, _ = model(x)
        return logits

    return fwd, (model, x)


def _flat(ts):
    return torch.cat([p.detach().reshape(-1).cpu()
                      for p in ts.model.parameters()])


def sharded_solve(mesh: Mesh, prob, cfg, max_iters: Optional[int] = None,
                  window: int = 100) -> dict:
    """The rank's shard of ``prob`` solved plain with the fused window
    (K1 on the card), gathered: objectives, solutions, ``done``, and
    the iterations the rank ran."""
    from ..core import lp
    from ..ops import fused_lp
    st = fused_lp.solve_fused(shard_batch(prob, mesh), cfg,
                              max_iters=max_iters, window=window)
    out = gather_batch({"obj": lp.objective(st), "sol": lp.solution(st),
                        "done": st.done}, mesh)
    return dict({k: v.cpu() for k, v in out.items()}, it=st.it)


def sharded_l2f(mesh: Mesh, prob, ckpt: str, cfg, pcfg, ws: int,
                max_iter: int) -> dict:
    """The rank's shard solved by the masked ``l2f_solve`` with the
    policy of ``ckpt``, gathered: objectives and the free masks."""
    from ..core import lp
    from ..train.l2f import l2f_solve
    from ..utils.checkpoint import load_policy
    model = load_policy(ckpt, pcfg.node_size, pcfg.chunk_dim,
                        pcfg.pe_dim, device=mesh.device)
    st = l2f_solve(shard_batch(prob, mesh), model, cfg, pcfg, ws=ws,
                   max_iter=max_iter)
    out = gather_batch({"obj": lp.objective(st), "free": st.free}, mesh)
    return {k: v.cpu() for k, v in out.items()}


def dp_step(mesh: Mesh, ckpt: str, rows, net: str, pcfg, cfg, ws: int,
            micro_rows: int = 16384, plant: Optional[str] = None) -> dict:
    """One data-parallel training step from ``ckpt`` (weights and Adam
    state) on the rank's contiguous block of ``rows`` = (x, labels,
    weights) of the global batch.  Returns the loss, the summed gradient
    and the parameters after the step, flat on the host.

    ``plant`` is a fault the checks must catch: ``"bn"``, BatchNorm on
    each rank's own rows (the mesh withheld from it); ``"loss"``, each
    rank's loss over its own row count instead of the global one."""
    from ..models.policy import build_policy, set_batchnorm_mesh
    from ..train import imitation
    tr = imitation.PolicyTrainer(
        build_policy(net, pcfg.node_size, pcfg.chunk_dim, pcfg.pe_dim),
        pcfg, cfg, ws=ws, micro_rows=micro_rows, mesh=mesh)
    ts = tr.load(ckpt)
    x, lab, w = shard_batch(tuple(rows), mesh)
    sum_fn = imitation.weighted_bce_sum
    if plant == "bn":
        set_batchnorm_mesh(ts.model, None)
    elif plant == "loss":
        scale = rows[0].shape[0] / x.shape[0]
        imitation.weighted_bce_sum = lambda *a: sum_fn(*a) * scale
    elif plant is not None:
        raise ValueError(f"unknown plant {plant!r}")
    try:
        ts, loss = tr.train_step(ts, x, lab, w)
    finally:
        imitation.weighted_bce_sum = sum_fn
    grad = torch.cat([p.grad.reshape(-1).cpu()
                      for p in ts.model.parameters()])
    return {"loss": float(loss), "grad": grad, "params": _flat(ts)}


def dp_epoch(mesh: Mesh, prob, ckpt: str, net: str, pcfg, cfg, ws: int,
             record_iters: int, n_episodes: int, ds=None,
             micro_rows: int = 16384) -> dict:
    """A data-parallel epoch from ``ckpt``: the sharded ``build_dataset``
    of ``prob``, then one ``train_epoch`` step on it, or on the rank's
    shard of the global dataset ``ds`` where one is given (the same
    inputs as a reference's).  Returns the epoch loss, the parameters
    after it (flat, host) and the built dataset, gathered."""
    from ..models.policy import build_policy
    from ..train import imitation
    built = imitation.build_dataset(shard_batch(prob, mesh), cfg,
                                    record_iters=record_iters, mesh=mesh)
    train_on = built if ds is None else shard_batch(ds, mesh)
    tr = imitation.PolicyTrainer(
        build_policy(net, pcfg.node_size, pcfg.chunk_dim, pcfg.pe_dim),
        pcfg, cfg, ws=ws, micro_rows=micro_rows, mesh=mesh)
    ts, loss = tr.train_epoch(tr.load(ckpt), [train_on],
                              n_episodes=n_episodes)
    built = gather_batch(built, mesh)
    return {"loss": loss, "params": _flat(ts),
            "dataset": built._replace(**{
                f: getattr(built, f).cpu() for f in (
                    "traj", "labels", "var_mask", "oracle_obj")})}


def tiny_rehearsal(mesh: Mesh, seed: int = 0) -> dict:
    """The dry run's training and evaluation at the JAX package's tiny
    shapes on this rank's shard (2 instances a rank)."""
    from ..adapters import ca
    from ..config import LP_CONFIG, PolicyConfig
    from ..models.policy import build_policy
    from ..train import imitation, l2f
    rng = np.random.RandomState(seed)
    insts = [ca.generate_cauction(rng, n_items=8, n_bids=20)
             for _ in range(2 * mesh.world)]
    prob = shard_batch(ca.make_problem(insts, device="cpu"), mesh)
    cfg = LP_CONFIG.replace(linsolve="woodbury")
    ws, node = 20, 4
    pcfg = PolicyConfig(net="mha", node_size=node, chunk_dim=ws // node)
    tr = imitation.PolicyTrainer(
        build_policy("mha", node_size=node, chunk_dim=ws // node), pcfg,
        cfg, ws=ws, mesh=mesh)
    ds = imitation.build_dataset(prob, cfg, record_iters=2 * ws, mesh=mesh)
    ts, loss = tr.train_epoch(tr.init(seed), [ds], n_episodes=2)
    state = l2f.l2f_solve(prob, tr.variables(ts), cfg, pcfg, ws=ws,
                          max_iter=10 * ws)
    m = gather_batch(l2f.l2f_metrics(state, prob, ds.oracle_obj,
                                     ds.labels), mesh)
    gap = float(m["obj_gap"].mean())
    if not (np.isfinite(loss) and np.isfinite(gap)):
        raise RuntimeError(f"dry run: loss {loss}, gap {gap}")
    return {"loss": loss, "gap": gap, "it": state.it,
            "instances": int(m["obj"].shape[0]), "device": str(mesh.device)}


def bench_shape_problem(device="cuda"):
    """The bench's 128 x CA-500 batch (seed 2207), generated anew."""
    from ..adapters import ca
    rng = np.random.RandomState(BENCH_SEED)
    insts = [ca.generate_cauction(rng, n_items=100, n_bids=500)
             for _ in range(BENCH_BATCH)]
    return ca.make_problem(insts, device=device)


def dryrun_multichip(n: int, device: str = "cuda", log=print) -> dict:
    """The tiny rehearsal in ``n`` ranks, then the scaling table."""
    from ..config import LP_CONFIG
    if device == "cuda":
        from ..kernels import build
        if n > torch.cuda.device_count():
            raise ValueError(f"{n} ranks on {torch.cuda.device_count()} "
                             "card(s): one rank a card")
        build.build()
        devices = [f"cuda:{r}" for r in range(n)]
    else:
        devices = ["cpu"] * n
    res = launch(tiny_rehearsal, n, devices=devices,
                 backend="nccl" if device == "cuda" else "gloo")
    r0 = res[0]
    log(f"dryrun_multichip({n}) on {', '.join(r['device'] for r in res)}: "
        f"ok, epoch loss={r0['loss']:.4f}, l2f it={r0['it']}, mean obj "
        f"gap={r0['gap']:+.3f} over {r0['instances']} instances")
    prob = bench_shape_problem(device="cpu")
    counts = [c for c in (1, 2, 4, 8, 16, 32) if c <= n]
    table = dp_scaling_table(prob, LP_CONFIG.replace(linsolve="woodbury"),
                             iters=200, device_counts=counts, device=device)
    log(f"dp scaling ({BENCH_BATCH} x CA-500, fixed 200 iterations; eff = "
        "speedup over 1 rank, par_eff = the same shard alone over it):")
    log(json.dumps({"dp_scaling": table}))
    if not table or not all(np.isfinite(r["wall_s"]) for r in table):
        raise RuntimeError(f"dp scaling table: {table}")
    return {"rehearsal": res, "dp_scaling": table}


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=None,
                   help="ranks (default: the visible cards; 2 on the CPU)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    n = args.n or (torch.cuda.device_count() if args.device == "cuda"
                   else 2)
    fwd, fargs = entry(args.device)
    print(f"entry ok: {tuple(fwd(*fargs).shape)}", flush=True)
    dryrun_multichip(n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
