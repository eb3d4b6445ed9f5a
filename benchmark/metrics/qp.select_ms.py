"""Mean milliseconds of the segmentation selection per batch: the
``qp_select_s`` of the ``timings`` that ``train.l2f.l2f_solve_seg``
fills in traced runs (the program's span ``qp.select``: the choice of
rounding and the one-flip and domino descents,
``core.qp.select_solution``).  Nothing where the program has no such
key."""


def read(run):
    ts = [b["timings"]["qp_select_s"] for b in run["batches"]
          if "qp_select_s" in (b.get("timings") or {})]
    return 1e3 * sum(ts) / len(ts) if ts else None
