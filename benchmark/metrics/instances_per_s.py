"""Instances solved and selected in the window over the window's
seconds: all the work over all the time (end to end, host clock)."""


def read(run):
    return sum(b["n"] for b in run["batches"]) / run["window_s"]
