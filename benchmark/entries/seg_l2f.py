"""The segmentation l2f solve: ``train.l2f.l2f_solve_seg`` (the first
window on the grid with the CG x-update, K2 on its sliding windows and
the fix, compaction of the free pixels into flat windows, selection and
the descents), as ``run_seg -phase test`` runs it."""


def build(port, setting):
    l2f = port["l2f"]
    model, cfg, pcfg = setting["model"], setting["cfg"], setting["pcfg"]
    args = dict(setting["args"])

    def solve(prob, traced):
        # the program's tracer (spans timed by CUDA events, one wait at
        # the solve's end) runs in traced runs only
        tm = {} if traced else None
        _, out = l2f.l2f_solve_seg(prob, model, cfg, pcfg, timings=tm,
                                   **args)
        return {"sol": out["solution"], "obj": out["energy"],
                "n_fixed": out["n_fixed"], "timings": tm,
                "iterations": out["iterations"]}
    return solve
