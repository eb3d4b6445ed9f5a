"""Mean milliseconds of the l2f tail per batch (compaction, the residual
solve, selection and repair): ``timings["tail_s"]`` of
``train.l2f.l2f_solve_compact``."""


def read(run):
    ts = [b["timings"]["tail_s"] for b in run["batches"]
          if b.get("timings")]
    return 1e3 * sum(ts) / len(ts) if ts else None
