"""The whole window's share of the card's peak: the least times of all
K1 and K2 work in the window (``work.least_time``) over the traced
window's seconds, in %.  It bounds any claim on a kernel: the work is
counted the same whatever implements or fuses it."""


def read(run):
    tr, wk = run["trace"], run["work"]
    if not tr or not wk or tr["window_s"] <= 0:
        return None
    return 100.0 * (wk["k1"]["least_s"] + wk["k2"]["least_s"]) \
        / tr["window_s"]
