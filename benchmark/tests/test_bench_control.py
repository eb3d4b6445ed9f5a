"""The check can fail: the control (the reference in TF32 in the
program's place) and faults planted under the timed path must make
``correct`` false.  On the CPU at toy size: the run skips the look for a
card and the program runs its kernels' plain versions.  On the card,
``python3 -m benchmark.control`` reads the same at the cells' own
sizes."""

import pytest

from benchmark import check, faults
from benchmark import run as R
from benchmark.manifest import kind
from benchmark.tests.toy import toy_cell, toy_routes

SEED = 2**31 + 4242
CELLS = ["ca500-l2f", "xl-l2f", "ca500-plain"]


def toy_run(name, seconds=0.5):
    cell = toy_cell(name)
    with toy_routes(cell):
        return R.Run(cell, SEED, seconds, False, device="cpu", workers=2)


def toy_limits(cell):
    """The cell's limits, with the windows' read at the toy's own scale:
    at 20 items a window's median error is larger than at the cell's
    size."""
    lim = dict(cell.limits["numbers"])
    lim["iter_err"] = max(lim.get("iter_err", 0.0), 0.05)
    return lim


@pytest.fixture(scope="module", params=CELLS)
def sound(request):
    r = toy_run(request.param)
    ok, _, nums, _ = R.judge(r)
    c_ok, _, c_nums, _ = R.judge(r, control=True)
    return request.param, r, nums, c_nums


def test_sound_toy_run_passes(sound):
    name, r, nums, _ = sound
    ok, rows = check.judge(nums, toy_limits(r.cell))
    assert ok, rows
    if "tail_iters" in r.cell.limits["numbers"]:
        assert r.rec.kind.compare["tail"] and nums["tail_stall"] < 0.5


def test_control_fails(sound):
    name, r, nums, c_nums = sound
    ok, rows = check.judge(c_nums, r.cell.limits["numbers"])
    assert not ok, rows
    assert c_nums["iter_err"] > 10 * nums["iter_err"]
    assert c_nums["ex_err"] > 10 * nums["ex_err"]
    for g in r.rec.kind.compare["groups"]:
        assert c_nums[f"iter_err_{g}"] > 10 * nums[f"iter_err_{g}"], g
    if "k2_err" in nums:
        assert c_nums["k2_err"] > 10 * nums["k2_err"]


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in ("ca500-l2f", "xl-l2f") for f in sorted(faults.NAMES)
    if f != "share-lost"]
    + [("ca500-plain", f) for f in ("answer-altered", "half-batch",
                                    "share-lost", "state-unchanged")])
def test_planted_fault_fails_the_check(cell, fault, monkeypatch):
    faults.plant(fault, R.load_port("cpu"),
                 kind(toy_cell(cell).config["instance"]["kind"]),
                 monkeypatch.setattr)
    r = toy_run(cell)
    ok, _, nums, rows = R.judge(r)
    ok_toy, rows_toy = check.judge(nums, toy_limits(r.cell))
    assert not ok and not ok_toy, rows_toy
    if fault == "state-unchanged" and cell != "ca500-plain":
        # the l2f tail's window is held, not only the policy's
        assert nums["tail_iters"] == 1.0 and nums["tail_stall"] == 1.0
    if fault == "share-lost":
        # E x stays the true E's: each cluster group's iterates catch it
        lim = r.cell.limits["numbers"]
        assert nums["ex_err"] <= lim["ex_err"]
        for g in r.rec.kind.compare["groups"]:
            assert nums[f"iter_err_{g}"] > lim[f"iter_err_{g}"], g
