"""K1 launches per batch: the program's counter
``ops.fused_lp.LAUNCHES`` (all E routes), read before and after each
batch."""


def read(run):
    bs = run["batches"]
    return sum(b["k1"] for b in bs) / len(bs) if bs else None
