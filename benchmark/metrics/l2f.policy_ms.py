"""Mean milliseconds of the l2f policy phase per batch: the ``policy_s``
of the ``timings`` that ``train.l2f.l2f_solve_compact`` fills (its
span ends with a synchronise, so traced runs only ask for it)."""


def read(run):
    ts = [b["timings"]["policy_s"] for b in run["batches"]
          if b.get("timings")]
    return 1e3 * sum(ts) / len(ts) if ts else None
