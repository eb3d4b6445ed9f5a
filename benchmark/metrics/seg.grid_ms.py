"""Mean milliseconds of the segmentation solve's grid windows per batch:
the ``grid_s`` of the ``timings`` that ``train.l2f.l2f_solve_seg`` fills
in traced runs (the program's span ``seg.grid``: the QP iterations on
the (B, H, W) grid, their recording, K2's scoring and the fix, timed by
CUDA events).  Nothing where the program has no such key."""


def read(run):
    ts = [b["timings"]["grid_s"] for b in run["batches"]
          if "grid_s" in (b.get("timings") or {})]
    return 1e3 * sum(ts) / len(ts) if ts else None
