"""The learned early-fixing solve: ``train.l2f.l2f_solve_compact`` (the
policy phase on K2 and K1 or ``core.lp`` windows, compaction, the K1
tail, selection and repair)."""


def build(port, setting):
    l2f = port["l2f"]
    model, cfg, pcfg = setting["model"], setting["cfg"], setting["pcfg"]
    args = dict(setting["args"])

    def solve(prob, traced):
        # the program's tracer (spans timed by CUDA events, one wait at
        # the solve's end) runs in traced runs only
        tm = {} if traced else None
        _, out = l2f.l2f_solve_compact(prob, model, cfg, pcfg, timings=tm,
                                       **args)
        return {"sol": out["solution"], "obj": out["obj"],
                "n_fixed": out["n_fixed"], "timings": tm,
                "iterations": out["iterations"]}
    return solve
