"""Solution repair (the port of the JAX package's ``ops/repair.py``).

LP half: batched polishing of a binary rounding of ``min b.x  s.t.  E x
<= f`` (b <= 0 for CA auctions): eviction to feasibility, greedy refill,
and 1-for-1 swaps.  None of them degrades feasibility or the objective
of a feasible input.  Ties go to the lowest column index, as in the JAX
package (``argmin``/``argmax`` return the first extremum in both).

Seg half: one-flip (``icm_descent``) and domino (``pair_descent``)
descents for the binary grid QP ``min x^T A' x + b^T x`` on the
``ops.stencil`` operator.  Both are discrete: every colour step flips
pixels that are never stencil neighbours of one another, so the energy
falls monotonically, and on the segmentation's integer weights and
costs every quantity is an exact float32 integer -- the port gives the
JAX package's solution bit for bit.  The reference reports the raw ADMM
rounding (Seg LPboxADMMsolver.cpp:1376); both descents are applied alike
to the plain oracle and the l2f side.
"""

from __future__ import annotations

import torch

from . import stencil as st_mod

_TOL = 1e-6


def _slack(prob, sol: torch.Tensor) -> torch.Tensor:
    return prob.f - torch.bmm(prob.E.float(), sol[..., None])[..., 0]


def _column(E: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """E[b, :, j[b]] -> (B, m)."""
    return torch.gather(E, 2, j[:, None, None].expand(-1, E.shape[1], 1)
                        )[..., 0]


def _onehot(n: int, j: torch.Tensor, on: torch.Tensor) -> torch.Tensor:
    return (torch.arange(n, device=j.device)[None, :] == j[:, None]) \
        & on[:, None]


def drop_to_feasible(prob, sol: torch.Tensor, rounds: int = 64
                     ) -> torch.Tensor:
    """Greedy eviction: while a valid row is violated, flip out (one per
    instance per round) the selected bid covering the most violated rows
    per unit price."""
    b, E = prob.b, prob.E.float()
    row_mask, var_mask = prob.row_mask, prob.var_mask
    slack = _slack(prob, sol)
    for _ in range(rounds):
        viol = ((slack < -_TOL) & row_mask).float()
        covers = torch.bmm(viol[:, None, :], E)[:, 0]         # (B, n)
        cand = (covers > _TOL) & (sol > 0.5) & var_mask
        score = torch.where(cand, covers / torch.clamp_min(-b, 1e-6),
                            torch.full_like(covers, -1.0))
        j = score.argmax(-1)
        take = cand.any(-1)
        sol = torch.where(_onehot(sol.shape[-1], j, take),
                          torch.zeros_like(sol), sol)
        slack = slack + torch.where(take[:, None], _column(E, j),
                                    torch.zeros_like(slack))
    return sol


def greedy_repair(prob, sol: torch.Tensor, rounds: int = 16
                  ) -> torch.Tensor:
    """Refill a feasible rounding: per round, flip in the most negative
    coefficient among the columns that still fit the row slack.
    Infeasible instances pass through unchanged."""
    b, E = prob.b, prob.E.float()
    row_mask, var_mask = prob.row_mask, prob.var_mask
    slack = _slack(prob, sol)
    feas0 = ((slack >= -_TOL) | ~row_mask).all(-1)            # (B,)
    for _ in range(rounds):
        fits = ((E <= slack[:, :, None] + _TOL)
                | ~row_mask[:, :, None]).all(1)               # (B, n)
        cand = fits & (sol < 0.5) & var_mask & (b < -_TOL) & feas0[:, None]
        gain = torch.where(cand, b, torch.zeros_like(b))
        j = gain.argmin(-1)
        take = torch.gather(gain, 1, j[:, None])[:, 0] < -_TOL
        sol = torch.where(_onehot(sol.shape[-1], j, take),
                          torch.ones_like(sol), sol)
        slack = slack - torch.where(take[:, None], _column(E, j),
                                    torch.zeros_like(slack))
    return sol


def swap_repair(prob, sol: torch.Tensor, rounds: int = 8,
                refill_rounds: int = 2) -> torch.Tensor:
    """1-for-1 swaps: per round, the best pair (i selected, j not) with
    b_j < b_i such that every row blocking j is occupied by i alone,
    accepted only after an exact feasibility re-check; then
    ``refill_rounds`` of greedy refill."""
    b, E, f = prob.b, prob.E.float(), prob.f
    row_mask, var_mask = prob.row_mask, prob.var_mask
    B, m, n = E.shape
    narange = torch.arange(n, device=E.device)
    feas0 = ((_slack(prob, sol) >= -_TOL) | ~row_mask).all(-1)
    for _ in range(rounds):
        slack = _slack(prob, sol)
        sel = sol > 0.5
        # occupier id per row: the selected bid covering it
        cover = E * sel[:, None, :].float()                   # (B, m, n)
        occ_id = cover.argmax(-1)                             # (B, m)
        occupied = cover.amax(-1) > 0.5
        blocks = (E > slack[:, :, None] + _TOL) & row_mask[:, :, None]
        blocked_occ = blocks & occupied[:, :, None]
        all_occ = (~blocks | occupied[:, :, None]).all(1)
        occ3 = occ_id[:, :, None].expand(B, m, n)
        i_min = torch.where(blocked_occ, occ3,
                            torch.full_like(occ3, n + 1)).amin(1)
        i_max = torch.where(blocked_occ, occ3,
                            torch.full_like(occ3, -1)).amax(1)
        has_block = blocked_occ.any(1)
        single = all_occ & has_block & (i_min == i_max)
        i_idx = torch.clamp(i_min, 0, n - 1)
        b_i = torch.gather(b, 1, i_idx)
        gain = torch.where(single & ~sel & var_mask & feas0[:, None],
                           b - b_i, torch.zeros_like(b))
        j = gain.argmin(-1)
        g = torch.gather(gain, 1, j[:, None])[:, 0]
        i = torch.gather(i_idx, 1, j[:, None])[:, 0]
        new_slack = slack + _column(E, i) - _column(E, j)
        ok = (g < -_TOL) & ((new_slack >= -_TOL) | ~row_mask).all(-1)
        sol = torch.where((narange[None, :] == i[:, None]) & ok[:, None],
                          torch.zeros_like(sol), sol)
        sol = torch.where((narange[None, :] == j[:, None]) & ok[:, None],
                          torch.ones_like(sol), sol)
        if refill_rounds:
            sol = greedy_repair(prob, sol, rounds=refill_rounds)
    return sol


def _flip_delta(stencil, b: torch.Tensor, sol: torch.Tensor):
    """Per pixel, the energy change of flipping it alone,
    ``degree + s (2 (A'x) + b)`` with ``s = 1 - 2x``, and s."""
    s = 1.0 - 2.0 * sol
    return stencil.degree + s * (2.0 * stencil.a_matvec(sol) + b), s


def icm_descent(stencil, b: torch.Tensor, mask: torch.Tensor,
                sol: torch.Tensor, sweeps: int = 8) -> torch.Tensor:
    """One-flip (ICM) descent: flip every pixel whose flip lowers the
    energy, one colour of the 2x2-block 4-colouring at a time (same-
    colour pixels are never 8-neighbours, so a colour step's flips are
    independent and its energy change is the sum of their deltas).  A
    sweep is 4 colour steps, 4 stencil matvecs."""
    H, W = sol.shape[-2], sol.shape[-1]
    dev = sol.device
    color = ((torch.arange(H, device=dev)[:, None] % 2) * 2
             + torch.arange(W, device=dev)[None, :] % 2)
    for _ in range(sweeps):
        for k in range(4):
            delta, _ = _flip_delta(stencil, b, sol)
            flip = (color[None] == k) & mask & (delta < -_TOL)
            sol = torch.where(flip, 1.0 - sol, sol)
    return sol


def pair_descent(stencil, b: torch.Tensor, mask: torch.Tensor,
                 sol: torch.Tensor, sweeps: int = 4) -> torch.Tensor:
    """Domino (two-pixel) flip descent, the moves ``icm_descent`` cannot
    reach: flipping adjacent i, j changes the energy by ``delta_i +
    delta_j - 2 w_ij s_i s_j``.  Each orientation 8-colours its domino
    anchors so that same-colour dominoes never interact under the
    8-neighbour stencil: horizontal (r, c)-(r, c+1) by ``(r % 2) * 4 +
    (c % 4)``, vertical (r, c)-(r+1, c) by ``(r % 4) * 2 + (c % 2)``.  A
    sweep is 2 orientations x 8 colours = 16 stencil matvecs."""
    H, W = sol.shape[-2], sol.shape[-1]
    dev = sol.device
    rows = torch.arange(H, device=dev)[:, None]
    cols = torch.arange(W, device=dev)[None, :]
    color_h = (rows % 2) * 4 + cols % 4
    color_v = (rows % 4) * 2 + cols % 2
    # east / south neighbour planes (ops.stencil.OFFSETS order)
    orient = ((4, 0, 1, color_h), (6, 1, 0, color_v))
    m_f = mask.to(sol.dtype)
    for _ in range(sweeps):
        for d_idx, dr, dc, color in orient:
            m_n = st_mod.shift(m_f, dr, dc) > 0.5
            w = stencil.weights[:, d_idx]
            for k in range(8):
                delta, s = _flip_delta(stencil, b, sol)
                d_n = st_mod.shift(delta, dr, dc)
                s_n = st_mod.shift(s, dr, dc)
                pd = delta + d_n - 2.0 * w * s * s_n
                flip_a = (color[None] == k) & mask & m_n & (pd < -_TOL)
                flip_b = st_mod.shift(flip_a.to(sol.dtype), -dr, -dc) > 0.5
                sol = torch.where(flip_a | flip_b, 1.0 - sol, sol)
    return sol
