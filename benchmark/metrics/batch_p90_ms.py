"""The 90th percentile of the window's batch times, each from the call
into the entry point to the synchronise after selection (end to end,
host clock)."""

from benchmark.stats import percentile


def read(run):
    return 1e3 * percentile([b["wall_s"] for b in run["batches"]], 90)
