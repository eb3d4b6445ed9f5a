"""Batched diagonally-preconditioned conjugate gradient.

The port of the JAX package's ``ops/cg.py`` (reference
LinerProgramming/.../cython_solver/LPboxADMMsolver.cpp:26-96, :169-335):
one CG runs for the whole instance batch (B, n) with per-instance
convergence masks; the matvec is a closure; the reference's ``alpha <
0`` loss-of-positive-definiteness abort (:307) is reported per instance
through ``failed``.  Relative tolerance against ``tol^2 * ||rhs||^2``,
Jacobi preconditioning, initial iterate from the caller (the reference
warm-starts at y1).

The loop ends when no row runs, read on the host once per iteration
(the tracer's read site ``cg.run``): a finished row's update is a
no-op, so the result is that of the JAX package's ``while_loop``.  The
iterations the loop ran add to the tracer's counter ``cg.iters``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..utils import profiling

_TINY = torch.finfo(torch.float32).tiny


class CGResult(NamedTuple):
    x: torch.Tensor             # (B, n) solution
    iters: torch.Tensor         # (B,) iterations this row ran
    failed: torch.Tensor        # (B,) bool: p^T A p <= 0 encountered


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def pcg(matvec: Callable[[torch.Tensor], torch.Tensor], rhs: torch.Tensor,
        x0: torch.Tensor, precond_diag: torch.Tensor, tol: float,
        maxiters: int, active: Optional[torch.Tensor] = None) -> CGResult:
    """Solve ``M x = rhs`` per batch row with Jacobi-preconditioned CG.

    ``matvec``: (B, n) -> (B, n), SPD on the active subspace, zero on
    masked-out coordinates; ``precond_diag``: (B, n), positive also on
    inactive coordinates; ``active``: optional (B,) bool, rows with
    False are returned unchanged."""
    B = rhs.shape[0]
    inv_diag = 1.0 / precond_diag
    rhs_norm2 = _dot(rhs, rhs)
    zero_rhs = rhs_norm2 == 0.0
    threshold = torch.clamp_min(tol * tol * rhs_norm2, _TINY)

    zr = zero_rhs[:, None]
    x = torch.where(zr, torch.zeros_like(x0), x0)
    r = rhs - matvec(x)
    r = torch.where(zr, torch.zeros_like(r), r)
    r_norm2 = _dot(r, r)

    run = r_norm2 >= threshold
    if active is not None:
        run = run & active
        x = torch.where((~active)[:, None], x0, x)
    run = run & ~zero_rhs

    p = inv_diag * r
    abs_new = _dot(r, p)
    failed = torch.zeros((B,), dtype=torch.bool, device=rhs.device)
    row_iters = torch.zeros((B,), dtype=torch.int32, device=rhs.device)
    i = 0
    while i < maxiters and profiling.read("cg.run", bool, run.any()):
        row_iters = row_iters + run.to(torch.int32)
        tmp = matvec(p)
        ptmp = _dot(p, tmp)
        bad = run & (ptmp <= 0.0)
        alpha = abs_new / torch.where(ptmp == 0.0, torch.ones_like(ptmp),
                                      ptmp)
        step = torch.where(run & ~bad, alpha, torch.zeros_like(alpha))
        x = x + step[:, None] * p
        r = r - step[:, None] * tmp
        r_norm2 = torch.where(run, _dot(r, r), r_norm2)
        done_now = r_norm2 < threshold
        z = inv_diag * r
        new_abs = _dot(r, z)
        beta = new_abs / torch.where(abs_new == 0.0,
                                     torch.ones_like(abs_new), abs_new)
        still = run & ~done_now & ~bad
        p = torch.where(still[:, None], z + beta[:, None] * p, p)
        abs_new = torch.where(still, new_abs, abs_new)
        failed = failed | bad
        run = still
        i += 1
    profiling.count("cg.iters", i)
    return CGResult(x=x, iters=row_iters, failed=failed)
