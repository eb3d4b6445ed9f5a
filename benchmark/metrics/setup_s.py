"""Seconds from the process's start to the first timed batch: imports,
the kernels' build or load, the instance pool, the checkpoint, the
upload and the warm-up (end to end, host clock)."""


def read(run):
    return run["setup_s"]
