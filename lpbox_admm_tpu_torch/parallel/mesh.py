"""Data parallelism over instances on ``torch.distributed`` (the port of
the JAX package's ``parallel/mesh.py``).

The instances of a batch are independent, so the one parallel axis is
the instance batch: every (B, ...) tensor of an ``LpProblem``,
``LpState`` or ``TrajectoryDataset`` is split along its leading axis
into contiguous equal shards in rank order, and the policy's parameters
are replicated.  The JAX package runs one process over N devices and
lets jit insert the collectives; here each device has its own process
(a rank), and every collective is written out where it is needed: the
policy gradient's all-reduce and the global BatchNorm statistics
(``train/imitation.py``, ``models/policy.py``), the maxima of per-batch
host numbers, and the gathers of per-instance results.

The backend is chosen explicitly: NCCL where every rank owns a distinct
CUDA device, gloo on the CPU and for ranks that share a card (NCCL
refuses two ranks on one device; ``init_distributed`` checks that
before NCCL starts).  There is no switch to another backend when one
fails.  Gloo runs every collective used here on CUDA tensors itself
(``all_reduce``, ``broadcast``, ``all_gather``; on an H100 with torch
2.11), so nothing is staged through the host for it; NCCL
never goes through the host either, and a host tensor under NCCL
(Adam's step count, a Python number) is copied to the rank's device
for the collective.

* ``init_distributed``  ~ ``init_distributed`` (jax.distributed)
* ``make_mesh``         ~ ``make_mesh``
* ``shard_batch``       ~ ``shard_batch_pytree`` / ``host_to_global``
* ``replicate``         ~ ``replicate_pytree``
* ``gather_batch``      ~ ``process_allgather(tiled=True)``
* ``dp_scaling_table``  ~ ``dp_scaling_table``
* ``launch``            starts N ranks (spawned processes) and collects
                        what each returns
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..core.problem import Device, as_device
from ..utils.tree import leaves, tree_map

#: the device this process's rank runs on, set by ``init_distributed``
_RANK_DEVICE: Dict[str, torch.device] = {}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the data-parallel group: its rank, the
    number of ranks, the device its shard lives on, the process group
    (None outside one) and its backend."""

    rank: int
    world: int
    device: torch.device
    group: Any = None
    backend: Optional[str] = None


def _store(init_method: str, rank: int, world: int,
           timeout: datetime.timedelta):
    if init_method.startswith("file://"):
        return dist.FileStore(init_method[len("file://"):], world)
    if init_method == "env://":
        host, port = os.environ["MASTER_ADDR"], os.environ["MASTER_PORT"]
    elif init_method.startswith("tcp://"):
        host, port = init_method[len("tcp://"):].rsplit(":", 1)
    else:
        raise ValueError(f"init_method {init_method!r}: expected file://, "
                         "tcp:// or env://")
    return dist.TCPStore(host, int(port), world, rank == 0, timeout=timeout)


def _refuse_shared_cards(store, rank: int, world: int,
                         dev: torch.device) -> None:
    """NCCL refuses two ranks on one device, with an error that does not
    say so; refuse here, naming the ranks."""
    uuid = str(torch.cuda.get_device_properties(dev).uuid)
    store.set(f"lpbox_card/{rank}", f"{socket.gethostname()}/{uuid}")
    keys = [f"lpbox_card/{r}" for r in range(world)]
    store.wait(keys)
    cards = [store.get(k).decode() for k in keys]
    for r, c in enumerate(cards):
        if cards.index(c) != r:
            raise ValueError(
                f"ranks {cards.index(c)} and {r} share the card {c}: NCCL "
                "takes one rank per device; ranks that share a card pass "
                "backend='gloo'")


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     backend: Optional[str] = None,
                     device: Optional[Device] = None,
                     init_method: Optional[str] = None,
                     timeout_s: float = 60.0) -> Mesh:
    """Join the data-parallel group and return this rank's ``Mesh``.

    Rank and world size are ``process_id`` and ``num_processes``, else
    torchrun's ``RANK`` and ``WORLD_SIZE``.  The group meets at
    ``init_method`` (``file://PATH``, as the tests and the smoke use, or
    ``tcp://HOST:PORT``), else at ``tcp://{coordinator}``, else at
    torchrun's ``MASTER_ADDR``/``MASTER_PORT``.  ``device`` defaults to
    ``cuda:{LOCAL_RANK}`` (``cuda:{rank}`` without torchrun); it raises
    where there is no card, as every entry point of the port does.
    ``backend`` defaults to NCCL on a CUDA device and gloo on the CPU;
    ranks that share a card must pass ``backend="gloo"``.  Every
    collective fails after ``timeout_s`` seconds instead of waiting for
    a rank that is gone."""
    env = os.environ
    rank = int(env.get("RANK", 0)) if process_id is None else process_id
    world = int(env.get("WORLD_SIZE", 1)) if num_processes is None \
        else num_processes
    if device is None:
        device = f"cuda:{int(env.get('LOCAL_RANK', rank))}"
    dev = as_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"backend nccl needs a CUDA device, not {dev}")
    if init_method is None:
        init_method = f"tcp://{coordinator}" if coordinator else "env://"
    timeout = datetime.timedelta(seconds=timeout_s)
    store = _store(init_method, rank, world, timeout)
    if backend == "nccl":
        _refuse_shared_cards(store, rank, world, dev)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world, timeout=timeout)
    _RANK_DEVICE["device"] = dev
    return make_mesh()


def make_mesh(n_devices: Optional[int] = None,
              device: Optional[Device] = None) -> Mesh:
    """The running group's mesh (``n_devices``, if given, must be its
    world size), or outside a group a world-1 mesh on ``device`` (the
    card unless the caller asks for the CPU)."""
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if n_devices is not None and n_devices != world:
            raise ValueError(f"a mesh of {n_devices} devices asked for in a "
                             f"group of {world} ranks")
        dev = as_device(device) if device is not None \
            else _RANK_DEVICE["device"]
        return Mesh(dist.get_rank(), world, dev, dist.group.WORLD,
                    dist.get_backend())
    if n_devices not in (None, 1):
        raise ValueError(f"a mesh of {n_devices} devices outside a process "
                         "group: start the ranks first (init_distributed, "
                         "launch, torchrun)")
    return Mesh(0, 1, as_device("cuda" if device is None else device))


def shard_rows(B: int, mesh: Mesh) -> slice:
    """This rank's rows of a batch of ``B``: contiguous equal shards in
    rank order.  An uneven split is refused, as a ``NamedSharding``
    refuses it."""
    if B % mesh.world:
        raise ValueError(f"a batch of {B} does not split evenly over "
                         f"{mesh.world} ranks")
    k = B // mesh.world
    return slice(mesh.rank * k, (mesh.rank + 1) * k)


def _batch_of(tree: Any) -> int:
    for leaf in leaves(tree):
        if isinstance(leaf, torch.Tensor) and leaf.ndim >= 1:
            return int(leaf.shape[0])
    raise ValueError("no tensor with a batch axis to shard")


def shard_batch(tree: Any, mesh: Mesh, batch: Optional[int] = None) -> Any:
    """This rank's shard of ``tree`` on its device: the rows
    ``shard_rows(batch)`` of every tensor or numpy array whose leading
    axis is the batch (``batch`` defaults to the leading size of the
    first tensor with one), the other tensors whole, other leaves as
    they are.  Tensors move to the rank's device; numpy arrays stay on
    the host."""
    if batch is None:
        batch = _batch_of(tree)
    rows = shard_rows(batch, mesh)

    def place(v):
        if isinstance(v, torch.Tensor):
            if v.ndim >= 1 and v.shape[0] == batch:
                v = v[rows]
            return v.to(mesh.device)
        if hasattr(v, "ndim") and hasattr(v, "shape") and v.ndim >= 1 \
                and v.shape[0] == batch:
            return v[rows]
        return v

    return tree_map(place, tree)


def _comm_device(t: torch.Tensor, mesh: Mesh) -> torch.device:
    """Where a collective runs on ``t``: on the rank's device under NCCL,
    else where ``t`` is."""
    return mesh.device if mesh.backend == "nccl" else t.device


def _in_place(t: torch.Tensor, mesh: Mesh,
              run: Callable[[torch.Tensor], Any]) -> torch.Tensor:
    d = _comm_device(t, mesh)
    if d == t.device and t.is_contiguous():
        run(t)
    else:
        c = t.to(d).contiguous()
        run(c)
        t.copy_(c)
    return t


def all_reduce_(t: torch.Tensor, mesh: Mesh,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """All-reduce ``t`` in place over the mesh (nothing outside a
    group)."""
    if mesh.group is None:
        return t
    return _in_place(t, mesh,
                     lambda c: dist.all_reduce(c, op=op, group=mesh.group))


def broadcast_(t: torch.Tensor, mesh: Mesh, src: int = 0) -> torch.Tensor:
    """Overwrite ``t`` in place with rank ``src``'s."""
    if mesh.group is None:
        return t
    return _in_place(t, mesh,
                     lambda c: dist.broadcast(c, src, group=mesh.group))


class _AllReduceSum(torch.autograd.Function):
    """Σ over ranks, differentiable: every rank's loss depends on every
    rank's input, so the gradient of the summed loss with respect to a
    rank's input is the sum over ranks of the gradients with respect to
    the output."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return all_reduce_(t.clone(), mesh)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.mesh), None


def all_reduce_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Σ over ranks of ``t``, with the gradient of a loss summed over
    ranks (the global BatchNorm's moments)."""
    if mesh.group is None:
        return t
    return _AllReduceSum.apply(t, mesh)


def all_reduce_max(v, mesh: Mesh):
    """The largest ``v`` over the ranks: a Python number (int or float)
    or a tensor (a new one)."""
    if mesh.group is None:
        return v
    if isinstance(v, torch.Tensor):
        return all_reduce_(v.clone(), mesh, dist.ReduceOp.MAX)
    t = torch.tensor(v, dtype=torch.int64 if isinstance(v, int)
                     else torch.float64)
    all_reduce_(t, mesh, dist.ReduceOp.MAX)
    return type(v)(t.item())


def gather_batch(tree: Any, mesh: Mesh) -> Any:
    """The whole batch back from every rank's shard: each tensor with a
    batch axis all-gathered in rank order and concatenated along it (the
    shards must have the same shape on every rank, as ``shard_batch``
    makes them); other leaves as they are.  Outside a group the tree
    itself."""
    if mesh.group is None:
        return tree

    def gather(t):
        if not isinstance(t, torch.Tensor) or t.ndim == 0:
            return t
        d = _comm_device(t, mesh)
        src = t.to(d, torch.uint8 if t.dtype == torch.bool else t.dtype)
        src = src.contiguous()
        parts = [torch.empty_like(src) for _ in range(mesh.world)]
        dist.all_gather(parts, src, group=mesh.group)
        return torch.cat(parts).to(t.device, t.dtype)

    return tree_map(gather, tree)


def replicate(obj, mesh: Mesh, src: int = 0):
    """Rank ``src``'s parameters and buffers on every rank, and for a
    ``TrainState`` its Adam state too (broadcast in place; the optimizer
    state must have the same entries on every rank).  Returns ``obj``."""
    if mesh.group is None:
        return obj
    model = getattr(obj, "model", obj)
    for t in model.state_dict().values():
        broadcast_(t, mesh, src)
    opt = getattr(obj, "optimizer", None)
    if opt is not None:
        for p in model.parameters():
            for t in opt.state.get(p, {}).values():
                if isinstance(t, torch.Tensor):
                    broadcast_(t, mesh, src)
    return obj


# ---- ranks in spawned processes ------------------------------------------

def _rank_main(fn, args_path: str, rank: int, world: int, device: str,
               backend: Optional[str], store: str, timeout_s: float,
               threads: Optional[int], out_path: str) -> None:
    """A spawned rank: join the group, run ``fn(mesh, *args)``, write
    what it returns (or its traceback) to ``out_path``."""
    if threads is not None:
        torch.set_num_threads(threads)
    try:
        args = torch.load(args_path, weights_only=False)
        mesh = init_distributed(num_processes=world, process_id=rank,
                                backend=backend, device=device,
                                init_method=f"file://{store}",
                                timeout_s=timeout_s)
        try:
            value = fn(mesh, *args)
        finally:
            dist.destroy_process_group()
        torch.save({"ok": True, "value": value}, out_path)
    except BaseException:
        torch.save({"ok": False, "error": traceback.format_exc()}, out_path)
        raise


def run_calls(mesh: Mesh, calls: Sequence) -> List[Any]:
    """A rank function that runs each ``(fn, args)`` of ``calls`` in turn,
    as ``fn(mesh, *args)``, and returns their results in order: several
    rank functions in one start of the ranks."""
    return [fn(mesh, *args) for fn, args in calls]


def launch(fn: Callable, world: int, *args,
           devices: Optional[Sequence[Device]] = None,
           backend: Optional[str] = None,
           timeout_s: Optional[float] = None,
           collective_timeout_s: float = 60.0,
           threads: Optional[int] = None) -> List[Any]:
    """Run ``fn(mesh, *args)`` in ``world`` ranks, each a spawned process
    (``fn`` and ``args`` pass through a file, so ``fn`` must be
    importable and ``args`` picklable), and return what each rank
    returned, in rank order.

    ``devices``: each rank's device, by default ``cuda:r`` for rank r;
    ranks that share a card pass ``backend="gloo"``.  ``timeout_s``: a
    deadline for the whole run.  A rank that raises, dies or outlives
    the deadline stops every rank, and the error names it with its
    traceback: no failure of a rank is swallowed.  ``threads``: each
    rank's ``torch.set_num_threads``; ranks on the CPU share this
    process's intra-op threads by default (threads beyond the cores slow
    small ops down several times)."""
    import torch.multiprocessing as mp

    if devices is None:
        devices = [f"cuda:{r}" for r in range(world)]
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    if threads is None and all(torch.device(d).type == "cpu"
                               for d in devices):
        threads = max(1, torch.get_num_threads() // world)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="lpbox_ranks_") as tmp:
        args_path = os.path.join(tmp, "args.pt")
        torch.save(tuple(args), args_path)
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(world)]
        procs = [ctx.Process(target=_rank_main, args=(
            fn, args_path, r, world, str(devices[r]), backend,
            os.path.join(tmp, "store"), collective_timeout_s, threads,
            outs[r])) for r in range(world)]
        for p in procs:
            p.start()
        deadline = None if timeout_s is None \
            else time.monotonic() + timeout_s
        try:
            while True:
                codes = [p.exitcode for p in procs]
                if all(c == 0 for c in codes) or any(c not in (None, 0)
                                                     for c in codes):
                    break
                if deadline is not None and time.monotonic() > deadline:
                    break
                time.sleep(0.02)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        results, errors = [], []
        for r, (p, out) in enumerate(zip(procs, outs)):
            res = torch.load(out, weights_only=False) \
                if os.path.exists(out) else None
            if res is not None and res["ok"] and p.exitcode == 0:
                results.append(res["value"])
            elif res is not None and not res["ok"]:
                errors.append(f"rank {r} raised:\n{res['error']}")
            else:
                errors.append(f"rank {r} ended with exit code {p.exitcode}"
                              + (" (stopped: past the deadline or after "
                                 "another rank failed)" if p.exitcode
                                 is not None and p.exitcode < 0 else ""))
        if errors:
            raise RuntimeError(f"{len(errors)} of {world} ranks failed:\n"
                               + "\n".join(errors))
        return results


# ---- the scaling rehearsal -------------------------------------------------

def _fixed_window_wall(mesh: Mesh, path: str, cfg, iters: int, reps: int,
                       devices: Sequence[str]) -> float:
    """One rank of ``dp_scaling_table``: its shard of the saved problem,
    one ``iters``-iteration ``core.lp.solve_window`` (no convergence
    exit) to warm up, then the best of ``reps`` timed between barriers
    with the host fetch of the objectives inside."""
    from ..core import lp

    if mesh.rank == 0:
        print(f"dp_scaling_table: {mesh.world} rank(s) on "
              f"{', '.join(devices)} ({mesh.backend or 'no group'})",
              flush=True)
    prob = shard_batch(torch.load(path, weights_only=False), mesh)

    def run():
        st = lp.init_state(prob, cfg)
        st, _ = lp.solve_window(st, prob, cfg, iters, record=False,
                                skip_cvg_at=0)
        return lp.objective(st).cpu()

    def barrier():
        if mesh.group is not None:
            dist.barrier(group=mesh.group)

    run()
    best = float("inf")
    for _ in range(reps):
        barrier()
        t0 = time.perf_counter()
        run()
        barrier()
        best = min(best, time.perf_counter() - t0)
    return best


def dp_scaling_table(prob, cfg, iters: int = 200,
                     device_counts=(1, 2, 4, 8), reps: int = 2,
                     device: Optional[Device] = None,
                     timeout_s: Optional[float] = None) -> List[dict]:
    """Fixed-iteration data-parallel rehearsal (the JAX package's
    ``dp_scaling_table``).  For each rank count N (at most the visible
    cards on ``device`` "cuda", any asked for on the CPU, where the
    ranks are gloo processes; N must divide the batch), N ranks each run
    one ``iters``-iteration ``core.lp.solve_window`` on their B/N rows,
    and the row is ``{n, wall_s, inst_iters_per_s, eff, par_eff,
    devices}``: ``eff`` = wall(first N) / wall(N), the speedup over the
    first placement; ``par_eff`` = wall of the same B/N rows in one rank
    / wall(N), the multi-rank overhead alone.  N = 1 and that one-rank
    baseline run in this process outside a group; larger N in spawned
    ranks (``launch``), rank r on ``cuda:r``."""
    dev = prob.device if device is None else as_device(device)
    B = prob.batch
    avail = torch.cuda.device_count() if dev.type == "cuda" \
        else max(device_counts)
    host = tree_map(lambda v: v.cpu() if isinstance(v, torch.Tensor)
                    else v, prob)
    out: List[dict] = []
    base = None
    devices_of = lambda n: [str(dev)] if n == 1 else (
        [f"cuda:{r}" for r in range(n)] if dev.type == "cuda"
        else ["cpu"] * n)
    with tempfile.TemporaryDirectory(prefix="lpbox_scaling_") as tmp:
        def wall_of(p, n):
            path = os.path.join(tmp, f"prob_{p.batch}.pt")
            if not os.path.exists(path):
                torch.save(p, path)
            devs = devices_of(n)
            if n == 1 and not dist.is_initialized():
                return _fixed_window_wall(make_mesh(device=dev), path, cfg,
                                          iters, reps, devs)
            return launch(_fixed_window_wall, n, path, cfg, iters, reps,
                          devs, devices=devs,
                          backend="nccl" if dev.type == "cuda" else "gloo",
                          timeout_s=timeout_s)[0]

        for n in device_counts:
            if n > avail or B % n:
                continue
            wall = wall_of(host, n)
            if base is None:
                base = wall
            shard_wall = wall if n == 1 else wall_of(
                tree_map(lambda v: v[:B // n] if isinstance(v, torch.Tensor)
                         and v.ndim >= 1 and v.shape[0] == B else v, host),
                1)
            out.append({
                "n": n, "wall_s": wall,
                "inst_iters_per_s": B * iters / wall,
                "eff": base / wall, "par_eff": shard_wall / wall,
                "devices": devices_of(n)})
    return out

