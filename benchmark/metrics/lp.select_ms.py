"""Mean milliseconds of selection and repair per batch: the
``select_s`` of the ``timings`` that the entry fills in traced runs
(``train.l2f.l2f_solve_compact``'s, or the plain solve's under the
program's tracer): the program's span ``lp.select`` around
``core.lp.select_solution``.  Nothing where the program has no such
key."""


def read(run):
    ts = [b["timings"]["select_s"] for b in run["batches"]
          if "select_s" in (b.get("timings") or {})]
    return 1e3 * sum(ts) / len(ts) if ts else None
