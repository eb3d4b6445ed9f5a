"""Mean milliseconds of the segmentation solve's flat windows per batch:
the ``flat_s`` of the ``timings`` that ``train.l2f.l2f_solve_seg`` fills
in traced runs (the program's span ``seg.flat``: the windows after the
first, on the compacted problem through ``core.general``, with their
scoring and fixes).  Nothing where the program has no such key."""


def read(run):
    ts = [b["timings"]["flat_s"] for b in run["batches"]
          if "flat_s" in (b.get("timings") or {})]
    return 1e3 * sum(ts) / len(ts) if ts else None
