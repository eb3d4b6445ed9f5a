"""K2's share of its roofline over the window: the least time of the
policy forwards it ran (``work.k2_launch``, at 495 TFLOP/s dense TF32,
or the bytes at 3.35 TB/s) over its two kernels' time in the device
trace."""


def read(run):
    tr, wk = run["trace"], run["work"]
    if not tr or not wk or tr["kernel_s"].get("k2", 0.0) <= 0:
        return None
    return 100.0 * wk["k2"]["least_s"] / tr["kernel_s"]["k2"]
