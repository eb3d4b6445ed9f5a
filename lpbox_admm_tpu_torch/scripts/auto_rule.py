"""Time one iteration of each plain-solve route of ``core.lp.solve_auto``
on the card, at the shapes of the main paths, for its dispatch rule.

    python -m lpbox_admm_tpu_torch.scripts.auto_rule [--iters 60]
        [--end-to-end]

Routes, per shape (ms for one iteration of the whole batch, CUDA-event
timed after a warm-up window, from the solver's initial state):

* CA-500, 128 instances of 100 items x 500 bids (seed 2207), (m, n) =
  (256, 512): K1 windows of 100; ``core.lp`` windows on the batch at
  once; ``core.lp`` windows in blocks of 8 (the per-block time times the
  number of blocks).
* The xl rung, 32 instances of 800 items x 4000 bids, (1664, 4096): the
  first 8 of seed 6207 repeated 4 times (per-iteration cost does not
  depend on which instances): K3 windows in blocks of 8 (bf16 E);
  ``core.lp`` windows on the batch at once, f32 and bf16 E; ``core.lp``
  windows in blocks of 8.

With ``--end-to-end``, each route is also run as a whole solve, to the
cap or every instance done, with its selected objectives: CA-500 on K1
and on ``core.lp`` windows (cap 20 000, windows of 100), and the xl
rung's 32 distinct instances (seed 6207, as ``chip_smoke.py``
generates them) on the K3 stream in blocks of 8 (``solve_blocked(
stream=True)``, bf16 E, the smoke's xl path) and on ``core.lp`` windows
over the whole batch, bf16 and f32 E (cap 9000, windows of 500).

Prints one line per route and, last, a JSON object with every time and
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch


def _ms_per_iter(fn, iters):
    fn(5)                                  # warm-up (and first launches)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    fn(iters)
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def _blocks(prob, block):
    fields = ("b", "E", "f", "row_mask", "var_mask")
    return [prob.replace(**{f: getattr(prob, f)[lo:lo + block]
                            for f in fields})
            for lo in range(0, prob.batch, block)]


def time_routes(prob, cfg, iters, k1=False, stream=False):
    """ms per iteration of the batch on each route that takes ``prob``."""
    from ..core import lp
    from ..ops import fused_lp, fused_stream
    out = {}
    s0 = lp.init_state(prob, cfg)

    def windows(p, c, s):
        return lambda w: lp.solve_window(s, p, c, w, record=False,
                                         skip_cvg_at=0)

    if k1:
        E_op = fused_lp.window_operand(prob.E, cfg)
        out["k1"] = _ms_per_iter(lambda w: fused_lp.lp_window_fused(
            s0, prob, cfg, w, skip_cvg_at=0, E_op=E_op), iters)
    out["windows"] = _ms_per_iter(windows(prob, cfg, s0), iters)
    bcfg = cfg.replace(matvec_dtype="bfloat16")
    if stream:
        out["windows-bf16"] = _ms_per_iter(windows(prob, bcfg, s0), iters)
    blocks = _blocks(prob, 8)
    b0 = lp.init_state(blocks[0], cfg)
    out["blocked"] = len(blocks) * _ms_per_iter(
        windows(blocks[0], cfg, b0), iters)
    if stream:
        E16 = fused_stream.stream_operand(blocks[0].E, bcfg)
        out["stream-bf16"] = len(blocks) * _ms_per_iter(
            lambda w: fused_stream.lp_window_stream(
                b0, blocks[0], bcfg, w, skip_cvg_at=0, E_op=E16), iters)
    return out


def _solved(name, prob, run):
    """Wall, iterations and selected objectives of one whole solve
    (``run()`` returns its end state)."""
    import time
    from ..core import lp
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _, obj, inf = lp.select_solution(prob, lp.solution(st),
                                     lp.solution_best(st), drop_rounds=64,
                                     repair_rounds=16, swap_rounds=4)
    out = {"wall_s": wall, "iterations": int(st.it),
           "done": int(st.done.sum()), "batch": prob.batch,
           "mean_obj": obj.mean().item(),
           "infeasible_instances": int((inf > 0).sum())}
    print(f"  {name}: {out}", flush=True)
    return out


def end_to_end(ca500, cfg):
    """Whole solves on each route at CA-500 and at the xl rung."""
    from ..adapters import ca
    from ..config import LP_CONFIG
    from ..core import lp
    from ..ops import fused_lp
    res = {"ca500 (128, 256, 512)": {
        "k1": _solved("ca500 K1", ca500, lambda: fused_lp.solve_fused(
            ca500, cfg, max_iters=20000, window=100)),
        "windows": _solved("ca500 windows", ca500, lambda: lp.solve(
            ca500, cfg, max_iters=20000, window=100))}}
    rng = np.random.RandomState(2207 + 4000)
    xl = ca.make_problem([ca.generate_cauction(rng, 800, 4000)
                          for _ in range(32)])
    xcfg32 = LP_CONFIG.replace(linsolve="woodbury")      # the smoke's xl
    xcfg = xcfg32.replace(matvec_dtype="bfloat16")
    res["xl (32, 1664, 4096)"] = {
        "stream-bf16": _solved("xl K3 stream, blocks of 8", xl, lambda:
                               lp.solve_blocked(xl, xcfg, block=8,
                                                window=500, max_iters=9000,
                                                stream=True)[0]),
        **{route: _solved(f"xl windows, whole batch, {route}", xl,
                          lambda c=c: lp.solve(xl, c, max_iters=9000,
                                               window=500))
           for route, c in (("windows-bf16", xcfg), ("windows", xcfg32))}}
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--end-to-end", action="store_true",
                    help="also run each route as a whole solve")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("auto_rule times routes on the card; no CUDA device")
    from ..adapters import ca
    from ..config import LP_CONFIG
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = LP_CONFIG.replace(linsolve="woodbury", incumbent_stride=8)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    res = {"card": card}
    rng = np.random.RandomState(2207)
    ca500 = ca.make_problem([ca.generate_cauction(rng, 100, 500)
                             for _ in range(128)])
    res["ca500 (128, 256, 512)"] = time_routes(ca500, cfg, args.iters, k1=True)
    rng = np.random.RandomState(2207 + 4000)
    xl8 = [ca.generate_cauction(rng, 800, 4000) for _ in range(8)]
    xl = ca.make_problem(xl8 * 4)
    res["xl (32, 1664, 4096)"] = time_routes(xl, cfg, args.iters,
                                             stream=True)
    for shape, routes in res.items():
        if shape != "card":
            print(f"{shape}: " + ", ".join(
                f"{k} {v:.4f} ms/it" for k, v in routes.items()), flush=True)
    if args.end_to_end:
        res["end_to_end"] = end_to_end(ca500, cfg)
    print(card, flush=True)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
