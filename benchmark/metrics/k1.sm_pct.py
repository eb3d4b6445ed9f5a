"""Mean per batch of the share of the card's SMs that K1's launches take:
the ``k1_sm_pct`` of the ``timings`` that the entry fills in traced runs
(``train.l2f.l2f_solve_compact``'s, or the plain solve's under the
program's tracer; over a batch's launches, min(SMs, live * C) / SMs,
C the blocks an instance).  Nothing where the program has no such key."""


def read(run):
    ps = [b["timings"]["k1_sm_pct"] for b in run["batches"]
          if "k1_sm_pct" in (b.get("timings") or {})]
    return sum(ps) / len(ps) if ps else None
