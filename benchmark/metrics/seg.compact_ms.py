"""Mean milliseconds of the segmentation solve's compactions per batch:
the ``seg_compact_s`` of the ``timings`` that ``train.l2f.l2f_solve_seg``
fills in traced runs (the program's span ``seg.compact``: the gather of
the free pixels into the flat ELL problem, ``core.qp.compact``, and each
re-compaction, ``core.general.compact_sparse``).  Nothing where the
program has no such key."""


def read(run):
    ts = [b["timings"]["seg_compact_s"] for b in run["batches"]
          if "seg_compact_s" in (b.get("timings") or {})]
    return 1e3 * sum(ts) / len(ts) if ts else None
