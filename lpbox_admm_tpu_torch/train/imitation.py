"""Imitation training of the early-fixing policy (the port of the JAX
package's ``train/imitation.py``; reference ``PolicyKL``,
LinerProgramming/LinearProgramming/trainer.py): the converged
plain-ADMM solution labels each variable, and the policy is trained
with weighted BCE on per-variable trajectory windows.

* ``build_dataset``   ~ readFile/getLabel (:32-98): ``core.lp`` windows
  record the first ``record_iters`` iterations, then the solve runs to
  convergence in windows of 100; labels are the converged solution.
* ``build_dataset_qp`` ~ the segmentation's (Seg trainer.py readFile/
  getLabel + xiter_all.csv): ``core.qp`` grid trajectories flattened to
  (B, H*W, T), the oracle the plain solve's reported energy.
* ``episode_batch``   ~ _train_mha_100 (:254-299): 10 episodes of ws
  columns, episode i weighted 1/i, padded variables weighted 0.
* ``weighted_bce``    ~ nn.BCEWithLogitsLoss(weight) (:292), in optax's
  ``sigmoid_binary_cross_entropy`` form.
* ``PolicyTrainer``   ~ Adam lr 1e-4 + StepLR (run.py:44-45), in-loop
  evaluation (_valid_1/_valid_2, :354-597) and checkpoints (:599-643).

The training step is autograd of the port's ``nn.Module`` (the JAX
package has no Pallas kernel in its training step either: its flax
forward and backward run outside ``pallas_call``).  A step over more
than ``micro_rows`` rows accumulates gradients over row chunks exactly
as the JAX step does: the rows are zero-padded to a multiple of
``micro_rows`` with zero weight, every chunk -- padding included --
enters BatchNorm's batch statistics, the running statistics chain from
chunk to chunk while the parameters stay fixed, and each chunk's loss
is scaled by ``chunk_rows / R`` with the unpadded R.  The optimizer is
``torch.optim.Adam`` with optax's ``exponential_decay`` staircase
schedule: update k (counted from 0, before the increment, as
``ScaleByScheduleState`` counts) uses ``lr * rate ** (k //
lr_decay_step)``.  Checkpoints are the JAX package's ``.npz``
(``utils.checkpoint``), readable by either package.

Data parallelism over instances (``parallel.mesh``; the JAX package
shards the batch and lets jit insert the collectives): a trainer made
with a ``mesh`` of more than one rank takes each rank's rows of the
global batch.  Its step is the single-process step over the global
batch: the micro-chunks are the global batch's (a rank takes its rows
of each, possibly none, and the last rank the zero padding), BatchNorm
normalizes over the global chunk (``models.policy.BatchNorm``), each
rank's loss is its Σ w·bce over the global row count, and the gradients
and the loss are all-reduced with a sum, so the parameters stay the
same, bit for bit, on every rank.  ``build_dataset`` on a shard takes
the largest ``oracle_iters`` and ``oracle_wall_s`` over the ranks, and
``evaluate`` gathers its per-instance metrics before any mean.  Rank 0
alone writes checkpoints.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Iterable, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import LP_CONFIG, PolicyConfig, SolverConfig
from ..core import lp, qp
from ..core.problem import Device, LpProblem, as_device
from ..models.policy import init_weights, set_batchnorm_mesh
from ..parallel.mesh import (Mesh, all_reduce_, all_reduce_max,
                             gather_batch, replicate)
from ..utils.checkpoint import (adam_arrays, load_adam_arrays,
                                variable_arrays, variables_from_arrays)
from ..utils.profiling import sync
from .l2f import l2f_metrics, l2f_solve, l2f_solve_compact, traj_to_tokens


class TrajectoryDataset(NamedTuple):
    """Recorded plain-ADMM trajectories + converged labels."""

    traj: torch.Tensor          # (B, n, T) first T iterations
    labels: torch.Tensor        # (B, n) converged solution (0/1)
    var_mask: torch.Tensor      # (B, n)
    oracle_obj: torch.Tensor    # (B,) selection-reported plain objective
    oracle_iters: int           # iterations the plain solve took
    oracle_wall_s: float = 0.0  # wall time of the plain batch solve
    # optional per-variable BCE weight (fix-error-aware training);
    # None = uniform (reference semantics)
    damage: Optional[torch.Tensor] = None   # (B, n)


def damage_weights(prob: LpProblem, labels: torch.Tensor,
                   alpha: float = 0.5) -> torch.Tensor:
    """Per-variable downstream damage of a wrong fix, as a BCE weight:
    |b_j| for oracle-1 bids; for oracle-0 bids the prices of the
    selected occupiers of the rows the bid needs minus its own price,
    floored at 5% of the mean |b|.  Normalized to mean 1 over valid
    variables and raised to ``alpha``."""
    vm = prob.var_mask
    absb = prob.b.abs()
    sel = (labels > 0.5).float() * vm.float()
    E = prob.E.float()
    row_price = torch.bmm(E, (sel * absb)[..., None])[..., 0]
    disp = torch.bmm(row_price[:, None, :], E)[:, 0]
    floor = 0.05 * torch.where(vm, absb, torch.zeros_like(absb)).mean(
        -1, keepdim=True)
    dmg = torch.where(sel > 0.5, absb, torch.maximum(disp - absb, floor))
    dmg = torch.where(vm, dmg, torch.zeros_like(dmg))
    mean = dmg.sum(-1, keepdim=True) \
        / torch.clamp_min(vm.sum(-1, keepdim=True), 1)
    w = (dmg / torch.clamp_min(mean, 1e-9)) ** alpha
    return torch.where(vm, w, torch.zeros_like(w))


def _record_then_converge(prob: LpProblem, cfg: SolverConfig,
                          record_iters: int):
    """The plain solve: ``record_iters`` recorded iterations (the first
    one's y1/y2 stop skipped), then windows of 100 until ``max_iters``
    or every instance is done."""
    state = lp.init_state(prob, cfg)
    state, traj = lp.solve_window(state, prob, cfg, record_iters,
                                  record=True, skip_cvg_at=0)
    while state.it < cfg.max_iters and not bool(state.done.all()):
        state, _ = lp.solve_window(state, prob, cfg, 100, record=False)
    return state, traj


def build_dataset(prob: LpProblem, cfg: SolverConfig,
                  record_iters: int = 1000,
                  damage_alpha: Optional[float] = None,
                  mesh: Optional[Mesh] = None) -> TrajectoryDataset:
    """Run plain ADMM, recording the first ``record_iters`` iterations
    (the reference's xiter CSVs) and the converged rounding as labels
    (getLabel: final iterate >= 0.5, trainer.py:80-90).

    ``oracle_obj`` is the plain solve's reported objective, the better
    of the last rounding and the best feasible incumbent
    (``core.lp.select_solution``), as solve callers report it;
    ``oracle_wall_s`` times the plain batch solve up to a device
    synchronisation (the denominator of the reference's time speedup,
    trainer.py:560).  On a rank's shard (``mesh``) both are the largest
    over the ranks: the batch's iterations and wall."""
    t0 = time.perf_counter()
    state, traj = _record_then_converge(prob, cfg, record_iters)
    sync(state.x)
    wall = time.perf_counter() - t0
    iters = int(state.it)
    if mesh is not None:
        iters = all_reduce_max(iters, mesh)
        wall = all_reduce_max(wall, mesh)
    labels = lp.solution(state)
    _, oracle, _ = lp.select_solution(prob, labels, lp.solution_best(state))
    dmg = (damage_weights(prob, labels, alpha=damage_alpha)
           if damage_alpha is not None else None)
    return TrajectoryDataset(
        traj=traj, labels=labels, var_mask=prob.var_mask, oracle_obj=oracle,
        oracle_iters=iters, oracle_wall_s=wall, damage=dmg)


def build_dataset_qp(prob: qp.QpProblem, cfg: SolverConfig,
                     record_iters: int = 50, repair_sweeps: int = 0,
                     pair_sweeps: int = 0) -> TrajectoryDataset:
    """Segmentation variant of ``build_dataset``: ``record_iters``
    recorded grid iterations, then windows of 50 to convergence; grid
    trajectories flattened to (B, H*W, T), labels the converged
    rounding, the oracle the plain solve's reported energy (the better
    of the last and the incumbent rounding, polished by
    ``repair_sweeps``/``pair_sweeps`` as ``qp.select_solution`` does),
    so l2f gaps compare equal reporting on both sides.
    ``oracle_wall_s`` times the plain solve up to a device
    synchronisation."""
    t0 = time.perf_counter()
    state = qp.init_state(prob, cfg)
    state, traj = qp.solve_window(state, prob, cfg, record_iters,
                                  record=True)
    while state.it < cfg.max_iters and not bool(state.done.all()):
        state, _ = qp.solve_window(state, prob, cfg, 50, record=False)
    sync(state.x)
    wall = time.perf_counter() - t0
    B = prob.batch
    _, oracle = qp.select_solution(state, prob, repair_sweeps=repair_sweeps,
                                   pair_sweeps=pair_sweeps)
    return TrajectoryDataset(
        traj=traj.reshape(B, -1, record_iters),
        labels=qp.solution(state).reshape(B, -1),
        var_mask=prob.mask.reshape(B, -1), oracle_obj=oracle,
        oracle_iters=int(state.it), oracle_wall_s=wall)


def episode_batch(ds: TrajectoryDataset, pcfg: PolicyConfig, ws: int,
                  n_episodes: int = 10
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The (E*B*n, node, chunk) training batch, its labels and weights:
    episode i covers trajectory columns [(i-1)*ws, i*ws) with weight
    1/i (trainer.py:272-285); rows of padded variables weigh 0."""
    traj = ds.traj.reshape(ds.traj.shape[0], -1, ds.traj.shape[-1])
    B, n, T = traj.shape
    if n_episodes * ws > T:
        raise ValueError(f"{n_episodes} episodes of {ws} need {T} >= "
                         f"{n_episodes * ws} recorded iterations")
    per_var = ds.var_mask.reshape(B * n).float()
    if ds.damage is not None:
        per_var = per_var * ds.damage.reshape(B * n)
    xs, wts = [], []
    for i in range(1, n_episodes + 1):
        sub = traj[:, :, (i - 1) * ws:i * ws]
        xs.append(traj_to_tokens(sub.reshape(B * n, ws), pcfg))
        wts.append(torch.full((B * n,), 1.0 / i, dtype=torch.float32,
                              device=per_var.device) * per_var)
    labels = ds.labels.reshape(B * n).float().repeat(n_episodes)
    return torch.cat(xs), labels, torch.cat(wts)


def _bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return -labels * F.logsigmoid(logits) \
        - (1.0 - labels) * F.logsigmoid(-logits)


def weighted_bce(logits: torch.Tensor, labels: torch.Tensor,
                 weight: torch.Tensor) -> torch.Tensor:
    """``BCEWithLogitsLoss(weight=w)``: the mean over all elements of
    w * bce(logit, label), bce in optax's log-sigmoid form."""
    return (weight * _bce(logits, labels)).mean()


def weighted_bce_sum(logits: torch.Tensor, labels: torch.Tensor,
                     weight: torch.Tensor) -> torch.Tensor:
    """The sum over the rows of w * bce(logit, label): a rank's share of
    the global loss before it is divided by the global row count."""
    return (weight * _bce(logits, labels)).sum()


class TrainState(NamedTuple):
    """The policy module and its ``torch.optim.Adam``, both updated in
    place by a step, and the count of steps taken (the JAX package's
    ``TrainState.step``)."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int


def _adam(model: nn.Module, pcfg: PolicyConfig) -> torch.optim.Adam:
    return torch.optim.Adam(model.parameters(), lr=pcfg.lr,
                            betas=(0.9, 0.999), eps=1e-8)


def adam_count(optimizer: torch.optim.Optimizer) -> int:
    """Updates the optimizer has made (optax's Adam count)."""
    for st in optimizer.state.values():
        return int(st["step"])
    return 0


def checkpoint_arrays(ts: TrainState, epoch: int) -> Dict[str, np.ndarray]:
    """A TrainState as the JAX package's checkpoint arrays: ``v/...``
    flax variables, ``opt/NNNN`` optax Adam leaves, ``step``,
    ``epoch``."""
    arrs = variable_arrays(ts.model)
    for i, leaf in enumerate(adam_arrays(ts.model, ts.optimizer,
                                         adam_count(ts.optimizer))):
        arrs[f"opt/{i:04d}"] = leaf
    arrs["step"] = np.asarray(int(ts.step))
    arrs["epoch"] = np.asarray(int(epoch))
    return arrs


def load_checkpoint(path: str, model: nn.Module,
                    optimizer: torch.optim.Optimizer) -> TrainState:
    """Load a checkpoint of either package (``allow_pickle=False``: a
    checkpoint never executes code) into ``model`` and its Adam
    ``optimizer``, optimizer state included."""
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    dev = next(model.parameters()).device
    sd = {k: v.to(dev) for k, v in variables_from_arrays(arrays).items()}
    model.load_state_dict(sd, strict=True)
    okeys = sorted(k for k in arrays if k.startswith("opt/"))
    load_adam_arrays(model, optimizer, [arrays[k] for k in okeys])
    return TrainState(model=model, optimizer=optimizer,
                      step=int(arrays["step"]))


class PolicyTrainer:
    """Imitation training + in-loop l2f evaluation (the reference's
    PolicyKL).  The module trains on ``device`` (the card unless the
    caller asks for the CPU), or with a data-parallel ``mesh`` on the
    rank's device, its BatchNorm layers normalizing over the global
    batch."""

    def __init__(self, model: nn.Module, pcfg: PolicyConfig,
                 cfg: SolverConfig = LP_CONFIG, ws: int = 100,
                 save_dir: Optional[str] = None, micro_rows: int = 16384,
                 device: Device = "cuda", mesh: Optional[Mesh] = None):
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else as_device(device)
        if self._dp:
            set_batchnorm_mesh(model, mesh)
        self.model = model.to(self.device)
        self.pcfg = pcfg
        self.cfg = cfg
        self.ws = ws
        self.save_dir = save_dir
        # rows per gradient-accumulation chunk
        self.micro_rows = micro_rows

    def lr_at(self, count: int) -> float:
        """The learning rate of update ``count`` (0-based)."""
        p = self.pcfg
        return p.lr * p.lr_decay_factor ** (count // p.lr_decay_step)

    def init(self, generator: Union[torch.Generator, int]) -> TrainState:
        """Fresh weights (flax's initializers, drawn from ``generator``
        or a generator seeded with it) and a fresh Adam state."""
        if isinstance(generator, int):
            generator = torch.Generator().manual_seed(generator)
        init_weights(self.model.cpu(), generator)
        self.model.to(self.device).eval()
        return self._replicated(TrainState(
            model=self.model, optimizer=_adam(self.model, self.pcfg),
            step=0))

    def _replicated(self, ts: TrainState) -> TrainState:
        """Rank 0's weights and Adam state on every rank."""
        if self._dp:
            replicate(ts, self.mesh)
        return ts

    @property
    def _dp(self) -> bool:
        """Data parallel: a mesh of more than one rank."""
        return self.mesh is not None and self.mesh.world > 1

    def variables(self, ts: TrainState) -> nn.Module:
        """The policy as the l2f solvers take it: the module, in
        evaluation mode."""
        return ts.model.eval()

    def train_step(self, ts: TrainState, x: torch.Tensor,
                   labels: torch.Tensor, weight: torch.Tensor,
                   positions: Optional[torch.Tensor] = None
                   ) -> Tuple[TrainState, torch.Tensor]:
        """One optimizer step on the rows (R, node, chunk); returns the
        state and the loss (the weighted BCE over the R rows).  Under a
        mesh of more than one rank the rows are this rank's part of the
        global batch, at the global ``positions`` (by default the rank's
        contiguous block in rank order), and the loss is the global
        one."""
        if self._dp:
            return self._train_step_dp(ts, x, labels, weight, positions)
        model, opt = ts.model, ts.optimizer
        x, labels, weight = (t.to(self.device).float()
                             for t in (x, labels, weight))
        R = x.shape[0]
        if R <= self.micro_rows:
            chunks = [(x, labels, weight)]
        else:
            pad = (-R) % self.micro_rows
            zpad = lambda t: torch.cat([t, t.new_zeros((pad,) + t.shape[1:])])
            xs, ls, wsp = (zpad(t).split(self.micro_rows)
                           for t in (x, labels, weight))
            chunks = list(zip(xs, ls, wsp))
        opt.zero_grad(set_to_none=True)
        model.train()
        try:
            loss = torch.zeros((), device=self.device)
            for xc, lc, wc in chunks:
                logits, _ = model(xc)
                lk = weighted_bce(logits[:, 0], lc, wc) * (xc.shape[0] / R)
                lk.backward()
                loss = loss + lk.detach()
        finally:
            model.eval()
        return self._apply(ts), loss

    def _apply(self, ts: TrainState) -> TrainState:
        """The optimizer update at the schedule's learning rate."""
        opt = ts.optimizer
        lr = self.lr_at(adam_count(opt))
        for g in opt.param_groups:
            g["lr"] = lr
        opt.step()
        return ts._replace(step=ts.step + 1)

    def _train_step_dp(self, ts, x, labels, weight, positions):
        """The data-parallel step (see the module docstring): the global
        batch's micro-chunks, this rank's rows of each at their global
        positions, the zero padding on the last rank, each chunk's loss
        Σ w·bce over the global row count R, then the sum over ranks of
        the gradients (one flat all-reduce) and of the loss."""
        mesh, model = self.mesh, ts.model
        x, labels, weight = (t.to(self.device).float()
                             for t in (x, labels, weight))
        n_loc = x.shape[0]
        counts = gather_batch(torch.tensor([n_loc], device=self.device),
                              mesh).tolist()
        R, off = sum(counts), sum(counts[:mesh.rank])
        if positions is None:
            positions = torch.arange(off, off + n_loc, device=self.device)
        positions = positions.to(self.device)
        M = self.micro_rows if R > self.micro_rows else R
        n_chunks = -(-R // M)
        pad = n_chunks * M - R
        if pad and mesh.rank == mesh.world - 1:
            zpad = lambda t: torch.cat([t, t.new_zeros((pad,) + t.shape[1:])])
            x, labels, weight = zpad(x), zpad(labels), zpad(weight)
            positions = torch.cat([positions, torch.arange(
                R, R + pad, device=self.device)])
        chunk_of = positions // M
        ts.optimizer.zero_grad(set_to_none=True)
        model.train()
        try:
            loss = torch.zeros((), device=self.device)
            for c in range(n_chunks):
                sel = (chunk_of == c).nonzero()[:, 0]
                logits, _ = model(x[sel])
                lk = weighted_bce_sum(logits[:, 0], labels[sel],
                                      weight[sel]) / R
                lk.backward()
                loss = loss + lk.detach()
        finally:
            model.eval()
        params = list(model.parameters())
        flat = torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).reshape(-1)
                          for p in params])
        all_reduce_(flat, mesh)
        for p, g in zip(params, flat.split([p.numel() for p in params])):
            p.grad = g.view_as(p).clone()
        all_reduce_(loss, mesh)
        return self._apply(ts), loss

    def _episode_positions(self, ds: TrajectoryDataset,
                          n_episodes: int = 10) -> torch.Tensor:
        """The global positions of the rows of ``episode_batch`` on this
        rank's shard of a dataset: episode-major over the global batch's
        instances, as the single-process episode batch orders them."""
        B_loc = ds.traj.shape[0]
        n = ds.traj.reshape(B_loc, -1, ds.traj.shape[-1]).shape[1]
        counts = gather_batch(torch.tensor([B_loc], device=self.device),
                              self.mesh).tolist()
        B, off = sum(counts), sum(counts[:self.mesh.rank])
        local = torch.arange(B_loc * n, device=self.device) + off * n
        return torch.cat([e * B * n + local for e in range(n_episodes)])

    def train_epoch(self, ts: TrainState,
                    datasets: Iterable[TrajectoryDataset],
                    n_episodes: int = 10) -> Tuple[TrainState, float]:
        """One pass over the instance datasets, one optimizer step per
        dataset (the reference steps once per instance with all its
        episodes, trainer.py:268-297)."""
        losses = []
        for ds in datasets:
            x, labels, weight = episode_batch(ds, self.pcfg, self.ws,
                                              n_episodes)
            pos = self._episode_positions(ds, n_episodes) if self._dp \
                else None
            ts, loss = self.train_step(ts, x, labels, weight, pos)
            losses.append(float(loss))
        return ts, float(np.mean(losses))

    def evaluate(self, ts: TrainState, prob: LpProblem,
                 ds: TrajectoryDataset, max_iter: Optional[int] = None,
                 compact: bool = False) -> Dict[str, Any]:
        """l2f evaluation against the plain oracle (_valid_1/_valid_2:
        objective gap, speedup, fix errors).  ``compact=True`` runs
        ``l2f_solve_compact`` (on the card: K1 where it holds the shape,
        K2); the default runs the mask-based ``l2f_solve`` (on the card:
        K2).  Walls end on a device synchronisation.  On a rank's shard
        (the trainer's mesh) the per-instance metrics are gathered over
        the ranks before any mean, and the iterations and the wall are
        the largest over them."""
        mesh = self.mesh if self._dp else None
        model = self.variables(ts)
        t0 = time.perf_counter()
        if compact:
            _, oc = l2f_solve_compact(prob, model, self.cfg, self.pcfg,
                                      ws=self.ws, max_iter=max_iter)
            sync(oc["solution"])
            wall = time.perf_counter() - t0
            m = {"obj": oc["obj"], "oracle": ds.oracle_obj,
                 "infeasible": oc["infeasible"], "n_fixed": oc["n_fixed"],
                 "fix_errors": (oc["fixed_mask"]
                                & (oc["fixed_val"] != ds.labels)).sum(-1)}
            if mesh is not None:
                m = gather_batch(m, mesh)
            m = {k: v.cpu().numpy() for k, v in m.items()}
            orc = m.pop("oracle")
            out = dict(m, obj_gap=(m["obj"] - orc) / np.abs(orc),
                       iterations=int(oc["iterations"]))
        else:
            state = l2f_solve(prob, model, self.cfg, self.pcfg, ws=self.ws,
                              max_iter=max_iter)
            sync(state.x)
            wall = time.perf_counter() - t0
            m = l2f_metrics(state, prob, ds.oracle_obj, ds.labels)
            if mesh is not None:
                m = gather_batch(m, mesh)
            out = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                       else v) for k, v in m.items()}
        if mesh is not None:
            out["iterations"] = all_reduce_max(int(out["iterations"]), mesh)
            wall = all_reduce_max(wall, mesh)
        out["wall_time_s"] = wall
        out["mean_obj_gap"] = float(np.mean(out["obj_gap"]))
        out["iter_speedup"] = float(ds.oracle_iters) / max(
            float(out["iterations"]), 1.0)
        if ds.oracle_wall_s > 0:
            out["time_speedup"] = ds.oracle_wall_s / max(wall, 1e-9)
        return out

    # ---- checkpoints (reference trainer.py:599-643) ----------------------
    def save(self, ts: TrainState, epoch: int, best: bool = False):
        """``{save_dir}/checkpoint/checkpoint_{epoch}.npz`` or
        ``best_checkpoint.npz`` in the JAX package's format; under a mesh
        rank 0 alone writes."""
        if not self.save_dir or (self.mesh is not None
                                 and self.mesh.rank != 0):
            return
        os.makedirs(os.path.join(self.save_dir, "checkpoint"), exist_ok=True)
        name = "best_checkpoint.npz" if best else f"checkpoint_{epoch}.npz"
        with open(os.path.join(self.save_dir, "checkpoint", name), "wb") as f:
            np.savez(f, **checkpoint_arrays(ts, epoch))

    def load(self, path: str) -> TrainState:
        """The trainer's module and a new Adam, from a checkpoint of
        either package (under a mesh, rank 0's, on every rank)."""
        return self._replicated(load_checkpoint(
            path, self.model, _adam(self.model, self.pcfg)))

    def train(self, ts: TrainState, datasets, eval_prob: LpProblem,
              eval_ds: TrajectoryDataset, num_epochs: Optional[int] = None,
              log=print) -> TrainState:
        """The training loop: an epoch, the masked evaluation, a
        checkpoint, and the best checkpoint by mean objective gap."""
        if num_epochs is None:
            num_epochs = self.pcfg.num_epochs
        best_gap = None
        for epoch in range(num_epochs):
            ts, loss = self.train_epoch(ts, datasets)
            metrics = self.evaluate(ts, eval_prob, eval_ds)
            gap = metrics["mean_obj_gap"]
            log(f"epoch {epoch}: loss={loss:.5f} obj_gap={gap:+.4f} "
                f"iter_speedup={metrics['iter_speedup']:.2f}x "
                f"fixed={metrics['n_fixed'].mean():.0f}")
            self.save(ts, epoch)
            if best_gap is None or gap < best_gap:
                best_gap = gap
                self.save(ts, epoch, best=True)
        return ts
