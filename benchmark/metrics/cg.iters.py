"""Mean CG iterations per batch: the ``cg_iters`` of the ``timings`` that
``train.l2f.l2f_solve_seg`` fills in traced runs (the program's counter
``cg.iters``: the iterations of every CG x-update of the solve, each
loop's count, ``ops/cg.py``; each is one host read, ``cg.run``).
Nothing where the program has no such key."""


def read(run):
    ns = [b["timings"]["cg_iters"] for b in run["batches"]
          if "cg_iters" in (b.get("timings") or {})]
    return sum(ns) / len(ns) if ns else None
