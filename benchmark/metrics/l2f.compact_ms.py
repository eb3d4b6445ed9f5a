"""Mean milliseconds of the l2f tail's compaction per batch: the
``compact_s`` of the ``timings`` that ``train.l2f.l2f_solve_compact``
fills in traced runs (the program's span ``l2f.compact``: the gather
into the bucket, the rho fast-forward, K1's operand and the n-side
factor).  Nothing where the program has no such key."""


def read(run):
    ts = [b["timings"]["compact_s"] for b in run["batches"]
          if "compact_s" in (b.get("timings") or {})]
    return 1e3 * sum(ts) / len(ts) if ts else None
