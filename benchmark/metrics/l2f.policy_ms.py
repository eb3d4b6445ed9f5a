"""Mean milliseconds of the l2f policy phase per batch: the ``policy_s``
of the ``timings`` that ``train.l2f.l2f_solve_compact`` fills in traced
runs (the program's span ``l2f.policy``, timed by CUDA events on the
device's clock, with no synchronise of its own)."""


def read(run):
    ts = [b["timings"]["policy_s"] for b in run["batches"]
          if b.get("timings")]
    return 1e3 * sum(ts) / len(ts) if ts else None
