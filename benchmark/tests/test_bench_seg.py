"""The segmentation kind (``kinds/seg.py``) at toy size on the CPU: a
sound run of the cell's path is ``correct``, the TF32 control and each
planted fault are not, a whole run loads neither JAX nor the JAX
package; its pool, and the readers of the solve's spans and counters.
Images of 18 x 24 (portrait 24 x 18) on a 24 x 24 grid, batches of 4
from 8, buckets from 64 pixels: the first window on the grid, then
compaction and one re-compaction, as at the cell's size."""

import os
import subprocess
import sys

import numpy as np
import pytest

from benchmark import check, faults
from benchmark import run as R
from benchmark.manifest import ROOT, Cell, kind, overlay, reader

SEED = 2**31 + 4242
CELL = "seg-1e5-l2f"
TOY = ({"instance": {"height": 18, "width": 24, "h_pad": 24, "w_pad": 24}},
       {"batch": 4, "pool": 8, "warmup_batches": 1,
        "args": {"min_bucket": 64}})


def toy_cell() -> Cell:
    cell = Cell(CELL)
    cell.config = overlay(cell.config, TOY[0])
    cell.traffic = overlay(cell.traffic, TOY[1])
    return cell


def toy_run(seed=SEED, port=None):
    return R.Run(toy_cell(), seed, 0.3, False, device="cpu", workers=2,
                 port=port)


@pytest.fixture(scope="module")
def sound():
    r = toy_run()
    return r, R.judge(r)[2], R.judge(r, control=True)[2]


def test_sound_toy_run_is_correct(sound):
    r, nums, _ = sound
    ok, rows = check.judge(nums, r.cell.limits["numbers"])
    assert ok, rows
    assert nums["infeasible"] == 0 and nums["obj_err"] == 0
    cap = r.rec.kind
    # the captured batch ran the grid window, a compaction, a flat window
    # and a re-compaction
    assert [w["kind"] for w in cap.windows] == ["grid", "flat", "flat"]
    assert [c["kind"] for c in cap.compacts] == ["grid", "flat"]
    assert len(r.rec.k2) == len(cap.fixes) == 3 and len(cap.selects) == 1


def test_control_fails(sound):
    r, nums, c_nums = sound
    ok, rows = check.judge(c_nums, r.cell.limits["numbers"])
    assert not ok, rows
    assert c_nums["k2_err"] > 100 * nums["k2_err"]
    assert c_nums["iter_err"] > 100 * nums["iter_err"]
    assert c_nums["iter_err_grid"] > 100 * nums["iter_err_grid"]


@pytest.mark.parametrize("fault", ["state-unchanged", "half-batch",
                                   "answer-altered", "score-altered",
                                   "grid-coupling-dropped"])
def test_planted_fault_fails_the_check(fault, monkeypatch):
    faults.plant(fault, R.load_port("cpu"), kind("seg"),
                 monkeypatch.setattr)
    r = toy_run()
    ok, _, nums, rows = R.judge(r)
    assert not ok, rows
    caught = {"state-unchanged": "iter_err", "half-batch": "window_operand",
              "answer-altered": "select_diff", "score-altered": "k2_err",
              "grid-coupling-dropped": "iter_err_grid"}
    lim = r.cell.limits["numbers"]
    assert nums[caught[fault]] > lim[caught[fault]], nums
    if fault == "grid-coupling-dropped":
        # the fault lives in the grid window alone: every other number,
        # the flat windows' iter_err among them, reads as a sound run's
        assert [n for n, v, limit in rows if not v <= limit] == \
            ["iter_err_grid"], rows


def test_share_lost_does_not_apply():
    with pytest.raises(ValueError, match="does not apply"):
        faults.plant("share-lost", R.load_port("cpu"), kind("seg"))


def test_a_toy_run_loads_neither_jax_nor_the_jax_package():
    code = f"""
from benchmark import run as R
from benchmark.tests.test_bench_seg import toy_cell
if __name__ == "__main__":
    r = R.Run(toy_cell(), {SEED + 1}, 0.2, True, device="cpu", workers=2)
    R.metrics(r)
    ok = R.judge(r)[0]
    print("CORRECT", ok, "LOADED", R.forbidden_loaded())
"""
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=ROOT),
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "CORRECT True LOADED []" in p.stdout


def test_pool_is_the_seeds_and_holds_portraits():
    seg = kind("seg")
    params = dict(height=274, width=365, portrait_share=0.25, h_pad=365,
                  w_pad=365)
    shapes = [seg.make(0, i, **params).shape for i in range(64)]
    assert set(shapes) == {(274, 365), (365, 274)}
    assert 8 <= shapes.count((365, 274)) <= 24
    a, b = seg.make(7, 3, **params), seg.make(7, 3, **params)
    assert a.dtype == np.uint8 and np.array_equal(a, b)
    assert seg.variables(a) == 274 * 365
    cell = Cell(CELL)
    k, p, size = R.pool_params(cell)
    assert (k, size) == ("seg", 64) and p == params


#: metric -> (its ``timings`` key, the factor to its unit)
READS = {"seg.grid_ms": ("grid_s", 1e3),
         "seg.compact_ms": ("seg_compact_s", 1e3),
         "seg.flat_ms": ("flat_s", 1e3), "qp.select_ms": ("qp_select_s", 1e3),
         "cg.iters": ("cg_iters", 1)}


@pytest.mark.parametrize("metric", sorted(READS))
def test_reader_means_its_key_per_batch(metric):
    key, unit = READS[metric]
    read = reader(metric)
    seg = {"grid_s": 0.5, "host_reads": 3}
    traced = {"batches": [{"timings": dict(seg, **{key: v})}
                          for v in (0.25, 0.75, 2)]}
    assert read(traced) == pytest.approx(unit)
    assert read({"batches": [{"timings": None}, {}]}) is None
    assert read({"batches": []}) is None
    # an l2f auction solve's timings name compaction and selection too:
    # the segmentation readers leave them alone
    lp = {"policy_s": 0.1, "compact_s": 0.2, "select_s": 0.3}
    assert read({"batches": [{"timings": lp}]}) is None
