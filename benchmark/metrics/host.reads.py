"""Mean device-to-host reads per batch: the ``host_reads`` of the
``timings`` that the entry fills in traced runs
(``train.l2f.l2f_solve_compact``'s, or the plain solve's under the
program's tracer): the program's counted reads, per site in
``host_read_sites``.  Nothing where the program has no such key."""


def read(run):
    ns = [b["timings"]["host_reads"] for b in run["batches"]
          if "host_reads" in (b.get("timings") or {})]
    return sum(ns) / len(ns) if ns else None
