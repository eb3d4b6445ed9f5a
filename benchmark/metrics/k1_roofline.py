"""K1's share of its roofline over the window: the least time of the
work its launches did (``work.k1_launch`` on each instance's true sizes
and iterations, at ``work.PEAKS``) over the kernel time the device
trace gives its kernels."""


def read(run):
    tr, wk = run["trace"], run["work"]
    if not tr or not wk or tr["kernel_s"].get("k1", 0.0) <= 0:
        return None
    return 100.0 * wk["k1"]["least_s"] / tr["kernel_s"]["k1"]
