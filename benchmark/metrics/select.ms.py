"""Mean milliseconds of ``core.lp.select_solution`` (the choice of
rounding and the repair) per batch: the benchmark's span around the
call, from a synchronise to a synchronise (traced runs)."""


def read(run):
    ts = [b["spans"]["select_s"] for b in run["batches"] if b.get("spans")]
    return 1e3 * sum(ts) / len(ts) if ts else None
