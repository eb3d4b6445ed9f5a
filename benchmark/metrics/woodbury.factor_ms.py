"""Mean milliseconds of the Woodbury inverses per batch: the
``factor_s`` of the ``timings`` that the entry fills in traced runs
(``train.l2f.l2f_solve_compact``'s, or the plain solve's under the
program's tracer): the program's span ``woodbury.factor`` around each
Cholesky inverse of ``ops/woodbury.py`` (l2f: the first factor, one
after each fix, the compacted and the n-side factor; plain: the first
alone).  Nothing where the program has no such key."""


def read(run):
    ts = [b["timings"]["factor_s"] for b in run["batches"]
          if "factor_s" in (b.get("timings") or {})]
    return 1e3 * sum(ts) / len(ts) if ts else None
