"""The plain reference of the segmentation cells: what a grid-QP l2f
solve should give.

Plain PyTorch, written from the reference's description
(SCLBD/Accelerated-Lpbox-ADMM, Segmentation/Segmentation/cython/src:
``image_segmentation_utils.cpp:15-41, 104-208`` for the costs,
``LPboxADMMsolver.cpp:917-1195`` for ``ADMM_bqp_unconstrained_l2f`` and
its Ma/Mb shrink at :1048-1057; ``trainer.py:363-368`` for the sliding
windows the policy reads).  It imports nothing of the program: the
costs are built here from the image, the operator is applied here from
its own weights, the policy is ``reference.Policy`` read from the
checkpoint's ``.npz``.  Every function that multiplies takes a ``prec``
as ``reference.py``'s do (``"float64"``, ``"float32"``, ``"tf32"``:
the operand of every product with the pair weights rounded to TF32).

Departures from the reference, each kept from the program's documented
choices so that the two solve the same problem:

* the pair weights cover the full 8-neighbourhood (the reference's pair
  generator drops the diagonals and mixes index orders,
  image_segmentation_utils.cpp:115, 150-152);
* the quadratic term is ``x^T A' x`` with ``A' = D - W``, the reference's
  ``A = 2 (D - W)`` stored halved (``org_A = _A / 2``);
* the ADMM's rho and gamma follow the closed form of the iteration index
  (``rho0 * fact^(it // step)``, capped), not a running product;
* the CG x-update is Jacobi-preconditioned, warm-started at y1, stops at
  ``||r|| < tol ||rhs||`` or its cap, and keeps the previous iterate of
  an instance whose ``p^T A p`` turns non-positive;
* selection takes the lower-energy of the last rounding and the best
  incumbent's, then the one-flip and domino descents (the reference
  reports the last rounding alone, LPboxADMMsolver.cpp:1376).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from .reference import dtype_of, tf32

#: the 8 neighbours (row, col), in the order of the weight planes
OFFSETS = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0),
           (1, 1))
_EPS = 2.2204e-16
#: an energy change counts as a descent below this (the costs are
#: integers, so any real descent is at least 1)
_TOL = 1e-6


# --- the costs ---------------------------------------------------------------

def costs(I: np.ndarray, sigma: float = 0.1, mean_b: float = 0.6,
          mean_f: float = 0.2, lam: float = 3.0):
    """One image's costs (utils.cpp:15-41, 134-208) in float64: the pair
    weight planes W (8, H, W), W[d, i, j] between pixel (i, j) and its
    neighbour OFFSETS[d] (0 off the image), the linear term b = U2 - U1
    (H, W) and the constant c = sum U1.  U1, U2: the rounded Gaussian
    log-likelihoods of background (mean 0.6) and foreground (two
    components at 0.2), sigma 0.1; pair weights round(3 exp(-(Ii -
    Ij)^2 / s)), s the sample standard deviation of the image."""
    I = np.asarray(I, np.float64)
    H, W_ = I.shape
    norm = math.log(2.0 * math.pi) / 2.0 + math.log(sigma)
    two_s2 = 2.0 * sigma * sigma
    U1 = np.round((I - mean_b) ** 2 / two_s2 + norm)
    like = 2.0 * np.exp(-(I - mean_f) ** 2 / two_s2)
    U2 = np.round(-np.log(like + np.finfo(np.float64).eps) + norm
                  + math.log(2.0))
    s = float(np.std(I, ddof=1))
    W = np.zeros((8, H, W_))
    for d, (dr, dc) in enumerate(OFFSETS):
        r0, r1 = max(0, -dr), min(H, H - dr)
        c0, c1 = max(0, -dc), min(W_, W_ - dc)
        diff = I[r0:r1, c0:c1] - I[r0 + dr:r1 + dr, c0 + dc:c1 + dc]
        W[d, r0:r1, c0:c1] = np.round(lam * np.exp(-diff ** 2 / s))
    W, b = torch.from_numpy(W), torch.from_numpy(U2 - U1)
    return W, b, float(U1.sum())


def neighbour(x: torch.Tensor, dr: int, dc: int) -> torch.Tensor:
    """(..., H, W) -> out[i, j] = x[i + dr, j + dc], 0 off the grid."""
    H, W = x.shape[-2], x.shape[-1]
    out = torch.zeros_like(x)
    r0, r1 = max(0, -dr), min(H, H - dr)
    c0, c1 = max(0, -dc), min(W, W - dc)
    out[..., r0:r1, c0:c1] = x[..., r0 + dr:r1 + dr, c0 + dc:c1 + dc]
    return out


def apply(W: torch.Tensor, x: torch.Tensor, prec: str = "float64"
          ) -> torch.Tensor:
    """A' x = (D - W) x on (B, H, W) grids, W (B, 8, H, W); with
    ``prec="tf32"`` x is read at TF32 (the weights are small integers,
    exact in any format)."""
    x = x.to(dtype_of(prec))
    if prec == "tf32":
        x = tf32(x)
    W = W.to(x.dtype)
    out = W.sum(1) * x
    for d, (dr, dc) in enumerate(OFFSETS):
        out = out - W[:, d] * neighbour(x, dr, dc)
    return out


def energy(W, b, c, x) -> torch.Tensor:
    """x^T A' x + b^T x + c per instance, float64."""
    x = x.double()
    return (x * apply(W, x)).sum((-2, -1)) + (b.double() * x).sum((-2, -1)) \
        + c.double()


# --- one ADMM iteration of the grid QP, with the CG x-update ----------------

def rho_gamma(it: int, cfg: dict):
    k = it // cfg["rho_change_step"]
    rho = cfg["initial_rho"] * cfg["learning_fact"] ** k
    if cfg.get("rho_upper_limit") is not None:
        rho = min(rho, cfg["rho_upper_limit"])
    gamma = max(cfg["gamma0"] * cfg["gamma_factor"] ** k, 1.0)
    return rho, gamma


def cg(matvec, rhs, x0, diag, tol: float, cap: int, active):
    """Jacobi-preconditioned CG per instance of (B, H, W) systems: stops
    an instance at ||r||^2 < tol^2 ||rhs||^2, at ``cap`` iterations, or
    when p^T M p <= 0 (then ``failed``).  Returns (x, failed)."""
    sq = lambda a, b_: (a * b_).sum((-2, -1))
    e = lambda v: v[:, None, None]
    nrm = sq(rhs, rhs)
    bar = torch.clamp_min(tol * tol * nrm, float(np.finfo(np.float32).tiny))
    x = torch.where(e(nrm == 0), torch.zeros_like(x0), x0)
    r = torch.where(e(nrm == 0), torch.zeros_like(x0), rhs - matvec(x))
    run = (sq(r, r) >= bar) & active & (nrm != 0)
    x = torch.where(e(active), x, x0)
    p = r / diag
    rz = sq(r, p)
    failed = torch.zeros_like(run)
    for _ in range(cap):
        if not bool(run.any()):
            break
        q = matvec(p)
        pq = sq(p, q)
        bad = run & (pq <= 0)
        alpha = torch.where(run & ~bad, rz / torch.where(pq == 0,
                                                         torch.ones_like(pq),
                                                         pq),
                            torch.zeros_like(pq))
        x = x + e(alpha) * p
        r = r - e(alpha) * q
        z = r / diag
        rz_new = sq(r, z)
        go = run & ~bad & (sq(r, r) >= bar)
        p = torch.where(e(go), z + e(rz_new / torch.where(
            rz == 0, torch.ones_like(rz), rz)) * p, p)
        rz = torch.where(go, rz_new, rz)
        failed = failed | bad
        run = go
    return x, failed


def iterate(st: Dict[str, torch.Tensor], W: torch.Tensor, cfg: dict,
            steps: int, prec: str, record: bool = False
            ) -> Dict[str, torch.Tensor]:
    """``steps`` ADMM iterations (LPboxADMMsolver.cpp:1067-1195) of the
    reduced grid QP ``min x^T A'_ff x + b_eff^T x`` over the free pixels,
    from ``st``: x, z1, z2 (B, H, W), ``free`` (bool), ``b_eff``, the
    objective ring ``ring`` (B, history), ``count``, ``done``, ``it``.
    y1 = box(x + z1/rho), y2 = the shifted L2 sphere through the free
    pixels' cube corners, the x-update ``(2 A'_ff + 2 rho I) x = rho y1
    + rho y2 - (b_eff + z1 + z2)`` by ``cg`` from free * y1, the dual
    ascent with gamma, the stop tests (||x - y1|| and ||x - y2|| over
    ||x|| at ``stop_threshold``, or the ring's relative std at
    ``std_threshold``).  A done instance does not move.  Returns the
    end state and, with ``record``, x after each step (B, H, W, steps)."""
    dt = dtype_of(prec)
    g = lambda k: st[k].to(dt)
    x, z1, z2, b_eff = g("x"), g("z1"), g("z2"), g("b_eff")
    free = st["free"].bool()
    ff = free.to(dt)
    ring, count = g("ring"), st["count"].clone()
    done = st["done"].bool().clone()
    it = int(st["it"])
    Wt = W.to(dt)
    deg = Wt.sum(1)
    Hs = ring.shape[-1]
    nrm = lambda v: torch.sqrt((torch.where(free, v, torch.zeros_like(v))
                                ** 2).sum((-2, -1)))
    n_free = ff.sum((-2, -1))[:, None, None]
    traj = []
    for _ in range(steps):
        rho, gamma = rho_gamma(it, cfg)
        act = ~done
        a3 = act[:, None, None]
        y1 = torch.clamp(x + z1 / rho, 0.0, 1.0)
        sh = torch.where(free, x + z2 / rho - 0.5, torch.zeros_like(x))
        sh_n = torch.clamp_min(torch.sqrt((sh * sh).sum((-2, -1)))
                               [:, None, None], _EPS)
        y2 = torch.where(free, sh * torch.sqrt(n_free) / (2.0 * sh_n) + 0.5,
                         x)
        rhs = ff * (rho * y1 + rho * y2 - (b_eff + z1 + z2))

        def M(p):
            return ff * (2.0 * apply(Wt, ff * p, prec).to(dt)
                         + 2.0 * rho * p)

        diag = torch.where(free, 2.0 * deg + 2.0 * rho, torch.ones_like(x))
        xs, failed = cg(M, rhs, ff * y1, diag, cfg["pcg_tol"],
                        cfg["pcg_maxiters"], act)
        x_new = torch.where(a3 & ~failed[:, None, None], ff * xs, x)
        z1n = z1 + gamma * rho * ff * (x_new - y1)
        z2n = z2 + gamma * rho * ff * (x_new - y2)
        xn = torch.clamp_min(nrm(x_new), _EPS)
        cvg = ((nrm(x_new - y1) / xn <= cfg["stop_threshold"])
               & (nrm(x_new - y2) / xn <= cfg["stop_threshold"])) | failed
        xf = ff * x_new
        obj = (xf * (ff * apply(Wt, xf, prec).to(dt))).sum((-2, -1)) \
            + (b_eff * xf).sum((-2, -1))
        push = act & ~cvg
        onehot = torch.remainder(count, Hs)[:, None] == \
            torch.arange(Hs, device=x.device)[None, :]
        ring = torch.where(push[:, None] & onehot, obj[:, None], ring)
        count = count + push.to(count.dtype)
        mean = ring.mean(-1, keepdim=True)
        rel = torch.sqrt(((ring - mean) ** 2).sum(-1) / (Hs - 1)) \
            / torch.clamp_min(obj.abs(), _EPS)
        rel = torch.where(count >= Hs, rel, torch.ones_like(rel))
        newly = act & (cvg | (push & (rel <= cfg["std_threshold"])))
        x = torch.where(a3, x_new, x)
        z1 = torch.where(a3, z1n, z1)
        z2 = torch.where(a3, z2n, z2)
        done = done | newly
        it += 1
        if record:
            traj.append(x)
    return {"x": x, "z1": z1, "z2": z2, "ring": ring, "count": count,
            "done": done, "it": it,
            "traj": torch.stack(traj, -1) if record else None}


# --- the policy's rows and the fix rule -------------------------------------

def unfold(rows: torch.Tensor, node_size: int, chunk_dim: int
           ) -> torch.Tensor:
    """(R, ws) trajectory rows -> (R, node_size * chunk_dim): token t is
    row[t : t + chunk_dim], stride 1 (Seg trainer.py:363-368), the
    layout ``reference.Policy.scores`` reads."""
    if node_size + chunk_dim - 1 > rows.shape[1]:
        raise ValueError(f"ws {rows.shape[1]} is too short for {node_size} "
                         f"sliding tokens of {chunk_dim}")
    return torch.cat([rows[:, t:t + chunk_dim] for t in range(node_size)],
                     1)


def boundary_band(x: torch.Tensor, mask: torch.Tensor, band: int
                  ) -> torch.Tensor:
    """Valid pixels within ``band`` 8-neighbour hops of a label change of
    the rounding of x (labels outside ``mask`` do not count, and every
    hop stays inside it)."""
    lab = (x >= 0.5) & mask
    near = torch.zeros_like(mask)
    for dr, dc in OFFSETS:
        inside = neighbour(mask, dr, dc)
        near = near | (inside & (neighbour(lab, dr, dc) != lab))
    near = near & mask
    for _ in range(band - 1):
        grown = near
        for dr, dc in OFFSETS:
            grown = grown | neighbour(near, dr, dc)
        near = grown & mask
    return near


def fix_rule(sig: torch.Tensor, margins: torch.Tensor) -> torch.Tensor:
    """The fix decision of a score: 1 above 1 - margin, 0 below margin,
    else -1 (none)."""
    return torch.where(sig > 1.0 - margins, 1.0,
                       torch.where(sig < margins, 0.0, -1.0)).double()


def gated_margins(margins: torch.Tensor, x: torch.Tensor,
                  mask: torch.Tensor, gate: float, band: int
                  ) -> torch.Tensor:
    """The boundary gate: the margins of the pixels within ``band`` hops
    of the rounding's label boundary scaled by 1 - gate (band <= 0 or
    gate 0: unchanged)."""
    if gate <= 0 or band <= 0:
        return margins
    return torch.where(boundary_band(x, mask, band), margins * (1.0 - gate),
                       margins)


# --- the reduced problem after fixing ---------------------------------------

def restrict(W: torch.Tensor, b: torch.Tensor, free: torch.Tensor,
             fixed_val: torch.Tensor):
    """The reduced problem of (B, H, W) grids on their free pixels, in
    flat grid positions (row * W + col): per image its free pixels in
    grid order and the COO triples (rows, cols, vals; no zeros) of
    ``A'_ff``; and ``b_eff = b + 2 A'_{f,fixed} x_fixed`` (B, H, W), read
    on the free pixels."""
    B, H, W_ = b.shape
    v = torch.where(free, torch.zeros_like(b.double()), fixed_val.double())
    b_eff = b.double() + 2.0 * apply(W, v)
    pos = torch.arange(H * W_, device=b.device).reshape(H, W_)
    grid = torch.ones((H, W_), dtype=torch.bool, device=b.device)
    deg = W.double().sum(1)
    out = []
    for i in range(B):
        on = free[i]
        rows, cols, vals = [pos[on]], [pos[on]], [deg[i][on]]
        for d, (dr, dc) in enumerate(OFFSETS):
            both = on & neighbour(grid, dr, dc) & neighbour(on, dr, dc)
            rows.append(pos[both])
            cols.append(neighbour(pos, dr, dc)[both])
            vals.append(-W[i, d].double()[both])
        r, c, val = (torch.cat(t) for t in (rows, cols, vals))
        keep = val != 0
        out.append((pos[on], (r[keep], c[keep], val[keep])))
    return out, b_eff


def canonical(rows, cols, vals, n: int):
    """COO triples summed per (row, col) and sorted: (keys row * n +
    col, values)."""
    keys = rows.long() * n + cols.long()
    uk, inv = torch.unique(keys, return_inverse=True)
    sums = torch.zeros(uk.shape, dtype=torch.float64, device=keys.device)
    sums.index_add_(0, inv, vals.double())
    keep = sums != 0
    return uk[keep], sums[keep]


# --- selection and the descents ---------------------------------------------

def _flip_delta(W, b, x):
    """Per pixel the energy change of flipping it alone, and 1 - 2x."""
    s = 1.0 - 2.0 * x
    return W.sum(1) + s * (2.0 * apply(W, x) + b), s


def one_flip(W, b, mask, x, sweeps: int) -> torch.Tensor:
    """One-flip descent: each sweep visits the 4 colours of the 2 x 2
    block colouring in order ((r % 2) * 2 + c % 2), flipping at once
    every valid pixel of the colour whose flip lowers the energy."""
    H, W_ = x.shape[-2], x.shape[-1]
    r = torch.arange(H, device=x.device)[:, None]
    c = torch.arange(W_, device=x.device)[None, :]
    colour = (r % 2) * 2 + c % 2
    for _ in range(sweeps):
        for k in range(4):
            delta, _ = _flip_delta(W, b, x)
            x = torch.where((colour == k) & mask & (delta < -_TOL), 1.0 - x,
                            x)
    return x


def domino(W, b, mask, x, sweeps: int) -> torch.Tensor:
    """Domino descent: each sweep takes the horizontal pairs (r, c)-(r,
    c + 1), coloured (r % 2) * 4 + c % 4, then the vertical ones (r,
    c)-(r + 1, c), coloured (r % 4) * 2 + c % 2; colour by colour it
    flips both pixels of every pair of valid pixels whose joint flip
    lowers the energy: delta_i + delta_j - 2 w_ij s_i s_j."""
    H, W_ = x.shape[-2], x.shape[-1]
    r = torch.arange(H, device=x.device)[:, None]
    c = torch.arange(W_, device=x.device)[None, :]
    kinds = ((OFFSETS.index((0, 1)), 0, 1, (r % 2) * 4 + c % 4),
             (OFFSETS.index((1, 0)), 1, 0, (r % 4) * 2 + c % 2))
    for _ in range(sweeps):
        for d, dr, dc, colour in kinds:
            partner_ok = neighbour(mask, dr, dc)
            for k in range(8):
                delta, s = _flip_delta(W, b, x)
                pair = delta + neighbour(delta, dr, dc) \
                    - 2.0 * W[:, d] * s * neighbour(s, dr, dc)
                first = (colour == k) & mask & partner_ok & (pair < -_TOL)
                second = neighbour(first, -dr, -dc)
                x = torch.where(first | second, 1.0 - x, x)
    return x


def select(W, b, c, mask, last, best, one_flip_sweeps: int,
           domino_sweeps: int):
    """The selection the program reports: of the last rounding and the
    best incumbent's (both masked), the lower energy (the last on a
    tie); then the one-flip descent, kept where it lowers the energy;
    then the domino descent followed by max(1, one_flip_sweeps // 2)
    one-flip sweeps, kept where it lowers the energy.  float64; returns
    (labelling, energy)."""
    W, b = W.double(), b.double()
    m = mask.double()
    cand = [last.double() * m, best.double() * m]
    e = [energy(W, b, c, x) for x in cand]
    pick = e[1] < e[0]
    x = torch.where(pick[:, None, None], cand[1], cand[0])
    en = torch.where(pick, e[1], e[0])

    def keep(y, x, en):
        ey = energy(W, b, c, y)
        lower = ey < en
        return torch.where(lower[:, None, None], y, x), torch.where(
            lower, ey, en)

    if one_flip_sweeps > 0:
        x, en = keep(one_flip(W, b, mask, x, one_flip_sweeps), x, en)
    if domino_sweeps > 0:
        y = domino(W, b, mask, x, domino_sweeps)
        y = one_flip(W, b, mask, y, max(1, one_flip_sweeps // 2))
        x, en = keep(y, x, en)
    return x, en
