"""The comparison that decides ``correct``, the part every kind shares.

After the window has closed, what the timed path produced is held
against the plain reference (``reference.py``), on the instances the
benchmark made itself.  Each problem family's kind module
(``kinds/<kind>.py``) gives its numbers (``numbers``): every answer of
the window against the kind's guarantees, and, in one batch drawn from
the seed (the captured batch), the stages the cell drives.  Shared
here:

* ``k2_numbers``: each policy scoring (K2) against the reference's
  float64 forward (``k2_err``), and each fix decision against the
  reference's decision where its score is clear of the bar
  (``fix_diff``), for every kind that scores with K2; with
  ``control=True`` the reference in TF32 stands in the program's place;
* ``judge``: every limited number present and within its limit.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import reference as ref

#: a fix decision is judged only where the reference's score lies
#: further than this from the bar in each window that made it
FIX_CLEAR = 1e-4


def k2_numbers(policy_cfg: dict, ckpt: str, captures, fixes, b, vmask,
               control: bool) -> dict:
    """``k2_err`` over the captured scorings and ``fix_diff`` over the
    captured fix decisions (window w's scoring precedes its fix)."""
    if not captures:
        return {}
    dev = captures[0][0].device
    mk = lambda prec: ref.Policy(ckpt, policy_cfg["node_size"],
                                 policy_cfg["chunk_dim"],
                                 policy_cfg["pe_dim"], policy_cfg["n_heads"],
                                 dev, prec)
    truth = mk("float64")
    stand_in = mk("tf32") if control else None
    err = 0.0
    sigs = []
    for rows, sig in captures:
        want = truth.scores(rows)
        got = stand_in.scores(rows) if control else sig
        err = max(err, float((got.double() - want).abs().max()))
        sigs.append(want)
    out = {"k2_err": err}
    if fixes:
        margins = ref.fix_margins(b, vmask, policy_cfg["fix_confidence"],
                                  policy_cfg["damage_gate"])
        k = policy_cfg["fix_windows"]
        s1 = torch.zeros(b.shape, dtype=torch.int32, device=b.device)
        s0 = torch.zeros_like(s1)
        clear_hist = []
        diff = 0
        for (free, done, vec), sig in zip(fixes, sigs):
            if sig.numel() != b.numel() or vec.shape != b.shape:
                diff += int(vmask.sum())    # scored another batch
                continue
            sig = sig.reshape(b.shape)
            c1, c0 = sig > 1.0 - margins, sig < margins
            s1 = torch.where(c1, s1 + 1, torch.zeros_like(s1))
            s0 = torch.where(c0, s0 + 1, torch.zeros_like(s0))
            want = torch.where(s1 >= k, 1.0, torch.where(s0 >= k, 0.0, -1.0))
            clear_hist.append(((sig - (1.0 - margins)).abs() > FIX_CLEAR)
                              & ((sig - margins).abs() > FIX_CLEAR))
            clear = torch.stack(clear_hist[-k:]).all(0)
            live = free & ~done[:, None] & vmask
            diff += int(((vec.double() != want) & clear & live).sum())
        out["fix_diff"] = diff
    return out


def judge(nums: Dict[str, float], limits: Dict[str, float]):
    """(correct, rows): every limited number present and within its
    limit; rows of (name, value, limit)."""
    rows, ok = [], True
    for name, limit in limits.items():
        v = nums.get(name)
        good = v is not None and bool(np.isfinite(v)) and v <= limit
        ok = ok and good
        rows.append((name, v, limit))
    return ok, rows
