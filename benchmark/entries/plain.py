"""The plain solve: ``ops.fused_lp.solve_fused`` (K1 windows from the
first iteration to the iteration cap or every instance done), then
``core.lp.select_solution`` with repair."""

import time


def build(port, setting):
    fused_lp, lp, sync = port["fused_lp"], port["lp"], port["sync"]
    cfg = setting["cfg"]
    args = dict(setting["args"])
    window = args.pop("window")
    max_iters = args.pop("max_iters", cfg.max_iters)

    def solve(prob, traced):
        st = fused_lp.solve_fused(prob, cfg, max_iters=max_iters,
                                  window=window)
        spans = None
        if traced:
            # the benchmark's own span around selection, ended by a
            # synchronise (traced runs only)
            sync()
            t0 = time.perf_counter()
        sol, obj, _ = lp.select_solution(prob, lp.solution(st),
                                         lp.solution_best(st), **args)
        if traced:
            sync()
            spans = {"select_s": time.perf_counter() - t0}
        return {"sol": sol, "obj": obj, "spans": spans}
    return solve
