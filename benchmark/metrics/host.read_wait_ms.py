"""Mean milliseconds the host spends in its counted device-to-host
reads per batch: the ``host_read_wait_s`` of the ``timings`` that the
entry fills in traced runs (``train.l2f.l2f_solve_compact``'s, or the
plain solve's under the program's tracer).  Nothing where the program
has no such key."""


def read(run):
    ts = [b["timings"]["host_read_wait_s"] for b in run["batches"]
          if "host_read_wait_s" in (b.get("timings") or {})]
    return 1e3 * sum(ts) / len(ts) if ts else None
