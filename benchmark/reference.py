"""The benchmark's plain reference: what a solve should give.

Plain PyTorch, written from the algorithm's description (reference
SCLBD/Accelerated-Lpbox-ADMM: LPboxADMMsolver.cpp for the LP iteration,
mha.py for the policy, trainer.py for the fixing rule).  It imports
nothing of the program and takes nothing the program made: the policy
is read from the checkpoint's ``.npz`` here, every factor is worked out
again here from the instance.  Every function takes a ``prec``:

* ``"float64"``: the reference itself;
* ``"float32"``: the same in float32 (products in full float32), a
  witness of how far float32 rounding alone carries a trajectory;
* ``"tf32"``: the control, the same arithmetic in float32 with every
  matrix product's operands rounded to TF32 (10-bit mantissa, round to
  nearest), the precision below the configuration's float32 that a
  faster implementation would be tempted by.  The rounding is explicit,
  so the control reads the same on any device.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

PRECISIONS = ("float64", "float32", "tf32")


def dtype_of(prec: str) -> torch.dtype:
    if prec not in PRECISIONS:
        raise ValueError(f"precision {prec!r}, expected one of {PRECISIONS}")
    return torch.float64 if prec == "float64" else torch.float32


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 explicit mantissa bits (nearest,
    ties away), as the tensor cores read an operand."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "tf32":
        return torch.matmul(tf32(a), tf32(b))
    return torch.matmul(a, b)


def mv(M, v, prec):
    """(B, m, n) x (B, n) -> (B, m)."""
    return matmul(M, v[..., None], prec)[..., 0]


def mtv(M, w, prec):
    """(B, m, n)^T x (B, m) -> (B, n)."""
    return matmul(w[:, None, :], M, prec)[:, 0]


# --- instances --------------------------------------------------------------

def dense_E(rows, cols, shape, m_pad: int, n_pad: int,
            device, dtype=torch.float32) -> torch.Tensor:
    """One instance's 0/1 incidence, zero-padded to (m_pad, n_pad)."""
    E = torch.zeros((m_pad, n_pad), dtype=dtype, device=device)
    E[torch.as_tensor(rows, dtype=torch.long, device=device),
      torch.as_tensor(cols, dtype=torch.long, device=device)] = 1
    return E


def evaluate(sol: torch.Tensor, E: torch.Tensor, b: torch.Tensor,
             var_mask: torch.Tensor):
    """Per instance of (B, n) solutions on the original (B, m, n)
    instances: binary and finite (B,), rows over 1 (B,), objective b.x
    in float64 (B,).  Padded variables must be 0."""
    s = sol.double()
    finite = torch.isfinite(s).all(-1)
    binary = ((s == 0) | (s == 1)).all(-1) & ~((s != 0) & ~var_mask).any(-1)
    s0 = torch.where(torch.isfinite(s), s, torch.zeros_like(s))
    load = torch.bmm(E.double(), s0[..., None])[..., 0]
    over = (load > 1.0).sum(-1)
    obj = (b.double() * s0).sum(-1)
    return finite & binary, over, obj


def greedy_objective(prices: np.ndarray, rows: np.ndarray,
                     cols: np.ndarray, m: int) -> float:
    """The classic greedy for weighted set packing, the quality floor a
    solve is held against: bids by price per sqrt(items), highest first,
    each accepted if it shares no item with an accepted one.  Returns
    the objective in minimisation form (-sum of accepted prices)."""
    n = len(prices)
    items = [[] for _ in range(n)]
    for r, c in zip(rows.tolist(), cols.tolist()):
        items[c].append(r)
    taken = np.zeros(m, bool)
    total = 0.0
    key = [prices[j] / math.sqrt(max(len(items[j]), 1)) for j in range(n)]
    for j in sorted(range(n), key=lambda j: -key[j]):
        if prices[j] <= 0 or any(taken[i] for i in items[j]):
            continue
        for i in items[j]:
            taken[i] = True
        total += prices[j]
    return -total


# --- selection and repair ---------------------------------------------------
# The reference's post-processing of a rounding, run in float32 on the
# float32 prices the solve was given: every quantity but the price
# differences is an exact small integer, and float32 differences of
# float32 prices are correctly rounded, so the reference and any sound
# implementation choose the same bids, ties to the lowest index.

_TOL = 1e-6


def _slack(f, E, sol):
    return f - torch.bmm(E, sol[..., None])[..., 0]


def _col(E, j):
    return torch.gather(E, 2, j[:, None, None].expand(-1, E.shape[1], 1)
                        )[..., 0]


def _put(sol, j, on, value):
    hit = (torch.arange(sol.shape[-1], device=sol.device)[None, :]
           == j[:, None]) & on[:, None]
    return torch.where(hit, torch.full_like(sol, value), sol)


def _greedy(b, E, f, rmask, vmask, sol, rounds):
    slack = _slack(f, E, sol)
    feas0 = ((slack >= -_TOL) | ~rmask).all(-1)
    for _ in range(rounds):
        fits = ((E <= slack[:, :, None] + _TOL) | ~rmask[:, :, None]).all(1)
        cand = fits & (sol < 0.5) & vmask & (b < -_TOL) & feas0[:, None]
        gain = torch.where(cand, b, torch.zeros_like(b))
        j = gain.argmin(-1)
        take = torch.gather(gain, 1, j[:, None])[:, 0] < -_TOL
        sol = _put(sol, j, take, 1.0)
        slack = slack - torch.where(take[:, None], _col(E, j),
                                    torch.zeros_like(slack))
    return sol


def _drop(b, E, f, rmask, vmask, sol, rounds):
    slack = _slack(f, E, sol)
    for _ in range(rounds):
        viol = ((slack < -_TOL) & rmask).float()
        covers = torch.bmm(viol[:, None, :], E)[:, 0]
        cand = (covers > _TOL) & (sol > 0.5) & vmask
        score = torch.where(cand, covers / torch.clamp_min(-b, 1e-6),
                            torch.full_like(covers, -1.0))
        j = score.argmax(-1)
        take = cand.any(-1)
        sol = _put(sol, j, take, 0.0)
        slack = slack + torch.where(take[:, None], _col(E, j),
                                    torch.zeros_like(slack))
    return sol


def _swap(b, E, f, rmask, vmask, sol, rounds, refill=2):
    B, m, n = E.shape
    feas0 = ((_slack(f, E, sol) >= -_TOL) | ~rmask).all(-1)
    for _ in range(rounds):
        slack = _slack(f, E, sol)
        sel = sol > 0.5
        cover = E * sel[:, None, :].float()
        occ_id = cover.argmax(-1)
        occupied = cover.amax(-1) > 0.5
        blocks = (E > slack[:, :, None] + _TOL) & rmask[:, :, None]
        blocked_occ = blocks & occupied[:, :, None]
        all_occ = (~blocks | occupied[:, :, None]).all(1)
        occ3 = occ_id[:, :, None].expand(B, m, n)
        i_min = torch.where(blocked_occ, occ3,
                            torch.full_like(occ3, n + 1)).amin(1)
        i_max = torch.where(blocked_occ, occ3,
                            torch.full_like(occ3, -1)).amax(1)
        single = all_occ & blocked_occ.any(1) & (i_min == i_max)
        i_idx = torch.clamp(i_min, 0, n - 1)
        gain = torch.where(single & ~sel & vmask & feas0[:, None],
                           b - torch.gather(b, 1, i_idx),
                           torch.zeros_like(b))
        j = gain.argmin(-1)
        g = torch.gather(gain, 1, j[:, None])[:, 0]
        i = torch.gather(i_idx, 1, j[:, None])[:, 0]
        new_slack = slack + _col(E, i) - _col(E, j)
        ok = (g < -_TOL) & ((new_slack >= -_TOL) | ~rmask).all(-1)
        sol = _put(sol, i, ok, 0.0)
        sol = _put(sol, j, ok, 1.0)
        if refill:
            sol = _greedy(b, E, f, rmask, vmask, sol, refill)
    return sol


def select(b, E, f, rmask, vmask, sol_last, sol_best, repair_rounds=0,
           swap_rounds=0, drop_rounds=0):
    """Per instance the final rounding or the best incumbent rounding
    (the incumbent when it is feasible and no worse, or the final one is
    infeasible), then eviction, greedy refill and 1-for-1 swaps.
    Returns the (B, n) solution."""
    b, E, f = b.float(), E.float(), f.float()
    sols = torch.stack([sol_last.float(), sol_best.float()], 1)
    load = torch.einsum("bmn,bkn->bkm", E, sols)
    infeas = ((load > f[:, None]) & rmask[:, None]).sum(-1)
    obj = (b[:, None, :] * sols).sum(-1)
    use_best = (infeas[:, 1] == 0) & ((obj[:, 1] <= obj[:, 0])
                                      | (infeas[:, 0] > 0))
    sol = torch.where(use_best[:, None], sols[:, 1], sols[:, 0])
    if drop_rounds:
        sol = _drop(b, E, f, rmask, vmask, sol, drop_rounds)
    if repair_rounds:
        sol = _greedy(b, E, f, rmask, vmask, sol, repair_rounds)
    if swap_rounds:
        sol = _swap(b, E, f, rmask, vmask, sol, swap_rounds)
    return sol


# --- the early-fixing policy ------------------------------------------------

def position_encoding(n_pos: int, d: int) -> np.ndarray:
    """Sinusoidal encoding (reference common/utils.py:20-32), row 0 all
    zeros before sin/cos, as the reference has it."""
    pe = np.array([[pos / np.power(10000, 2 * (j // 2) / d)
                    for j in range(d)] if pos else np.zeros(d)
                   for pos in range(n_pos)])
    pe[:, 0::2] = np.sin(pe[:, 0::2])
    pe[:, 1::2] = np.cos(pe[:, 1::2])
    return pe


class Policy:
    """The MHA early-fixing policy (reference mha.py:20-253) from the
    flax-format checkpoint: trajectory chunks + position encoding ->
    embed -> layers of [x + MHA(x), BatchNorm, x + FF(x), BatchNorm] ->
    flatten -> 4 dense layers -> sigmoid.  Attention weights apply as
    stored minus 1/sqrt(last dim) (the reference's init shift);
    BatchNorm uses its running statistics."""

    def __init__(self, npz_path: str, node_size: int, chunk_dim: int,
                 pe_dim: int, n_heads: int, device, prec: str):
        self.T, self.C, self.heads, self.prec = \
            node_size, chunk_dim, n_heads, prec
        dt = dtype_of(prec)
        with np.load(npz_path) as z:
            v = {k[2:]: z[k] for k in z.files if k.startswith("v/")}
        t = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=dt,
                                      device=device)
        p = "params/"
        self.pe = t(position_encoding(node_size, pe_dim))
        self.embed = (t(v[p + "Dense_0/kernel"]), t(v[p + "Dense_0/bias"]))
        self.layers = []
        k = 0
        while f"{p}MHALayer_{k}/Dense_0/kernel" in v:
            L = f"MHALayer_{k}/"
            att = {n: t(v[f"{p}{L}MultiHeadAttention_0/{n}"])
                   for n in ("W_query", "W_key", "W_val", "W_out")}
            att = {n: w - 1.0 / math.sqrt(w.shape[-1])
                   for n, w in att.items()}
            bns = []
            for j in (0, 1):
                bn = f"{L}BatchNorm_{j}/"
                bns.append((t(v[p + bn + "scale"]), t(v[p + bn + "bias"]),
                            t(v["batch_stats/" + bn + "mean"]),
                            t(v["batch_stats/" + bn + "var"])))
            ff = [(t(v[f"{p}{L}Dense_{j}/kernel"]),
                   t(v[f"{p}{L}Dense_{j}/bias"])) for j in (0, 1)]
            self.layers.append((att, bns, ff))
            k += 1
        self.cls = []
        j = 0
        while f"{p}Classifier_0/Dense_{j}/kernel" in v:
            self.cls.append((t(v[f"{p}Classifier_0/Dense_{j}/kernel"]),
                             t(v[f"{p}Classifier_0/Dense_{j}/bias"])))
            j += 1

    def _bn(self, h, bn):
        scale, bias, mean, var = bn
        return (h - mean) / torch.sqrt(var + 1e-5) * scale + bias

    def _dense(self, h, wb):
        return matmul(h, wb[0], self.prec) + wb[1]

    def scores(self, rows: torch.Tensor, block: int = 8192) -> torch.Tensor:
        """Sigmoids (R,) of (R, node_size * chunk_dim) trajectory rows."""
        out = []
        dt = dtype_of(self.prec)
        for r0 in range(0, rows.shape[0], block):
            x = rows[r0:r0 + block].to(dt)
            R = x.shape[0]
            x = x.reshape(R, self.T, self.C)
            h = self._dense(torch.cat(
                [x, self.pe[None].expand(R, -1, -1)], -1), self.embed)
            for att, bns, ff in self.layers:
                q, k_, v = (torch.einsum("rtd,hdk->rhtk", h, att[n])
                            if self.prec == "float64" else
                            torch.einsum("rtd,hdk->rhtk", tf32(h),
                                         tf32(att[n]))
                            for n in ("W_query", "W_key", "W_val"))
                kd = q.shape[-1]
                logits = matmul(q, k_.transpose(-1, -2), self.prec) \
                    / math.sqrt(kd)
                heads = matmul(torch.softmax(logits, -1), v, self.prec)
                mha = (torch.einsum("rhtk,hke->rte", heads, att["W_out"])
                       if self.prec == "float64" else
                       torch.einsum("rhtk,hke->rte", tf32(heads),
                                    tf32(att["W_out"])))
                h = self._bn(h + mha, bns[0])
                z = torch.relu(self._dense(h, ff[0]))
                h = self._bn(h + self._dense(z, ff[1]), bns[1])
            z = h.reshape(R, -1)
            for wb in self.cls[:-1]:
                z = torch.relu(self._dense(z, wb))
            out.append(torch.sigmoid(self._dense(z, self.cls[-1]))[:, 0])
        return torch.cat(out)


def fix_margins(b: torch.Tensor, var_mask: torch.Tensor, confidence: float,
                damage_gate: float) -> torch.Tensor:
    """Per-variable confidence margins (reference trainer.py's
    deter_fix_2 bar, 1 - C, shrunk by the damage gate): ``(1 - C) (1 -
    gate r)``, r the variable's |b| rank in its instance over
    (count - 1), ties in index order."""
    base = 1.0 - confidence
    if damage_gate <= 0:
        return torch.full(b.shape, base, dtype=torch.float64,
                          device=b.device)
    order = torch.argsort(torch.argsort(b.float().abs(), dim=-1,
                                        stable=True),
                          dim=-1, stable=True).double()
    cnt = torch.clamp_min(var_mask.sum(-1, keepdim=True), 2).double()
    rank = torch.clamp(order / (cnt - 1.0), 0.0, 1.0)
    return base * (1.0 - damage_gate * rank)


# --- the ADMM window -------------------------------------------------------

def window(st: Dict[str, torch.Tensor], E: torch.Tensor, cfg: dict,
           it0: int, steps: int, skip_cvg_at: Optional[int], nside: bool,
           prec: str, record: bool = False) -> Dict[str, torch.Tensor]:
    """``steps`` iterations of Lp-Box ADMM (LPboxADMMsolver.cpp:796-1068)
    on a batch, from a state ``st`` (x, z1, z2, z4, f_eff, free, b,
    rmask, ring, count, done, cur_obj, best_obj, best_sol): the
    exact x-update of ``(2 rho I + rho E_f^T E_f) x = rhs`` on the free
    columns (its factor worked out here from E and the free mask), the
    warm-start keep test (PCG's early exit, :204-209), the dual ascent,
    the y1/y2 residual stop and the objective-history stop, and the
    feasible incumbent every ``incumbent_stride``-th iteration.  A done
    instance does not move.  ``nside``: the solve's n-side form, which
    recomputes E x after the update (the m-side form carries it from the
    factor), as the program's two forms do.  Returns the end state,
    with ``record`` also the iterate after each step (B, steps, n)."""
    dt = dtype_of(prec)
    g = lambda k: st[k].to(dt)
    E = E.to(dt)
    x, z1, z2, z4 = g("x"), g("z1"), g("z2"), g("z4")
    f_eff, b = g("f_eff"), g("b")
    free = st["free"] > 0.5
    rmask = st["rmask"] > 0.5
    free_f = free.to(dt)
    ring, count = g("ring"), st["count"].clone()
    done = st["done"] > 0
    cur_obj, best_obj, best_sol = g("cur_obj"), g("best_obj"), g("best_sol")
    B, m, n = E.shape
    H = ring.shape[-1]
    Ef = E * free_f[:, None, :]
    ratio = 2.0
    eps = 2.2204e-16
    if nside:
        gram = matmul(Ef.transpose(1, 2), Ef, prec)
        fac = torch.cholesky_inverse(torch.linalg.cholesky(
            (gram + ratio * torch.eye(n, dtype=dt, device=E.device))
            .double())).to(dt)
    else:
        gram = matmul(Ef, Ef.transpose(1, 2), prec)
        fac = torch.cholesky_inverse(torch.linalg.cholesky(
            (gram + ratio * torch.eye(m, dtype=dt, device=E.device))
            .double())).to(dt)
    sqrt_n = torch.sqrt(free_f.sum(-1, keepdim=True))
    tol2 = float(cfg["pcg_tol"]) ** 2
    ex = mv(E, free_f * x, prec)
    slot_k = torch.arange(H, device=E.device)[None, :]
    traj = []
    for t in range(steps):
        it = it0 + t
        k = it // cfg["rho_change_step"]
        rho = cfg["initial_rho"] * cfg["learning_fact"] ** k
        gamma = max(cfg["gamma0"] * cfg["gamma_factor"] ** k, 1.0)
        c = 2.0 * rho
        act = ~done
        a1 = act[:, None]
        y1 = torch.clamp(x + z1 / rho, 0.0, 1.0)
        shift = torch.where(free, x + z2 / rho - 0.5, torch.zeros_like(x))
        nrm = torch.sqrt((shift * shift).sum(-1, keepdim=True))
        y2 = torch.where(free, shift * sqrt_n / (2.0 * torch.clamp_min(
            nrm, eps)) + 0.5, x)
        y3 = torch.clamp_min(f_eff - ex - z4 / rho, 0.0)
        rhs = free_f * (rho * y1 + rho * y2 - (b + z1 + z2)
                        + mtv(E, rho * (f_eff - y3) - z4, prec))
        x0 = free_f * y1
        if nside:
            x_exact = free_f * mv(fac, rhs, prec) / rho
            EtEx0 = mv(gram, x0, prec)
        else:
            u = mv(fac, mv(E, rhs, prec), prec)
            x_exact = free_f * (rhs - mtv(E, u, prec)) / c
            Ex0 = mv(E, x0, prec)
            EtEx0 = mtv(E, Ex0, prec)
        r0 = rhs - free_f * (c * x0 + rho * EtEx0)
        keep = (r0 * r0).sum(-1) < tol2 * (rhs * rhs).sum(-1)
        x_new = torch.where(keep[:, None], x0, x_exact)
        x_new = torch.where(a1, x_new, x)
        if nside:
            ex_new = mv(E, x_new, prec)
        else:
            ex_new = torch.where(keep[:, None], Ex0, u / rho)
        ex_new = torch.where(a1, ex_new, ex)
        z1n = z1 + gamma * rho * free_f * (x_new - y1)
        z2n = z2 + gamma * rho * free_f * (x_new - y2)
        z4n = z4 + gamma * rho * (ex_new + y3 - f_eff)
        xn = torch.clamp_min(torch.sqrt((free_f * x_new * x_new).sum(-1)),
                             eps)
        c1 = torch.sqrt((free_f * (x_new - y1) ** 2).sum(-1)) / xn
        c2 = torch.sqrt((free_f * (x_new - y2) ** 2).sum(-1)) / xn
        cvg = (c1 <= cfg["stop_threshold"]) & (c2 <= cfg["stop_threshold"])
        if skip_cvg_at is not None and it == skip_cvg_at:
            cvg = torch.zeros_like(cvg)
        obj_val = (b * free_f * x_new).sum(-1)
        push = act & ~cvg
        onehot = torch.remainder(count, H)[:, None] == slot_k
        ring = torch.where(push[:, None] & onehot, obj_val[:, None], ring)
        count = count + push.to(count.dtype)
        mean = ring.mean(-1, keepdim=True)
        rel = torch.sqrt(((ring - mean) ** 2).sum(-1) / (H - 1)) \
            / torch.clamp_min(obj_val.abs(), eps)
        rel = torch.where(count >= H, rel, torch.ones_like(rel))
        newly = act & (cvg | (push & (rel <= cfg["std_threshold"])))
        stride = cfg["incumbent_stride"]
        if stride <= 1 or it % stride == 0:
            track = act & ~newly
            rounded = free_f * (x_new >= 0.5).to(dt)
            obj_bin = (b * rounded).sum(-1)
            cur_obj = torch.where(track, obj_bin, cur_obj)
            better = track & (best_obj >= obj_bin)
            if cfg["feasible_incumbent"]:
                feas = ((mv(E, rounded, prec) <= f_eff + 1e-6)
                        | ~rmask).all(-1)
                better = better & feas
            best_obj = torch.where(better, obj_bin, best_obj)
            best_sol = torch.where(better[:, None], x_new, best_sol)
        x = x_new
        z1 = torch.where(a1, z1n, z1)
        z2 = torch.where(a1, z2n, z2)
        z4 = torch.where(a1, z4n, z4)
        done = done | newly
        ex = ex_new
        if record:
            traj.append(x)
    return {"x": x, "z1": z1, "z2": z2, "z4": z4, "done": done,
            "count": count, "best_obj": best_obj, "best_sol": best_sol,
            "cur_obj": cur_obj, "ex": ex,
            "traj": torch.stack(traj, 1) if record else None}


def compact_E(E: torch.Tensor, free: torch.Tensor, rmask: torch.Tensor,
              n_new: int, m_new: Optional[int]):
    """The reduced problem's E after early fixing: the free columns
    first, in index order, then fixed ones (zeroed) up to ``n_new``; with
    ``m_new``, the rows that still touch a free column first, in order.
    Returns (E', column index (B, n_new))."""
    B, m, n = E.shape
    idx = torch.argsort((~free).to(torch.uint8), dim=-1,
                        stable=True)[:, :n_new]
    E2 = torch.gather(E, 2, idx[:, None, :].expand(B, m, n_new))
    free2 = torch.gather(free, 1, idx)
    E2 = E2 * free2[:, None, :].to(E2.dtype)
    if m_new is not None and m_new < m:
        support = ((E2 != 0) & free2[:, None, :]).any(-1) & rmask
        ridx = torch.argsort((~support).to(torch.uint8), dim=-1,
                             stable=True)[:, :m_new]
        E2 = torch.gather(E2, 1, ridx[:, :, None].expand(B, m_new, n_new))
    return E2, idx
