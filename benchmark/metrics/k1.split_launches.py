"""Mean K1 launches per batch that spread each instance over a cluster of
more than one block: the ``k1_split_launches`` of the ``timings`` that
the entry fills in traced runs (``train.l2f.l2f_solve_compact``'s, or
the plain solve's under the program's tracer; each launch's (live, C,
share of the SMs) under ``k1_splits``).  Nothing where the program has
no such key."""


def read(run):
    ns = [b["timings"]["k1_split_launches"] for b in run["batches"]
          if "k1_split_launches" in (b.get("timings") or {})]
    return sum(ns) / len(ns) if ns else None
