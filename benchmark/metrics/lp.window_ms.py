"""Mean milliseconds of ``core.lp`` windows per batch: the
``lp_window_s`` of the ``timings`` that ``train.l2f.l2f_solve_compact``
fills in traced runs (the program's span ``lp.window`` around
``core.lp.solve_window``; the policy windows where K1 cannot hold the
problem).  Nothing where the program has no such key."""


def read(run):
    ts = [b["timings"]["lp_window_s"] for b in run["batches"]
          if "lp_window_s" in (b.get("timings") or {})]
    return 1e3 * sum(ts) / len(ts) if ts else None
