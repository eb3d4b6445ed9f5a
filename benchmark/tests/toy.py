"""A cell shrunk to a size the CPU runs in seconds: CA instances of 20
items and 60 bids, batches of 4 from a pool of 8, short solves.  The
program then runs its kernels' plain versions."""

import contextlib

import pytest

from benchmark.manifest import Cell, overlay

TOY_INSTANCE = {"n_items": 20, "n_bids": 60, "m_pad": 128, "n_pad": 128}
TOY_TRAFFIC = {
    "l2f": {"batch": 4, "pool": 8, "warmup_batches": 1,
            "args": {"policy_windows": 2, "rho_boost_iters": 500,
                     "max_iter": 1500},
            "check": {"iter": {"k1": [0, 1], "tail": [2]}}},
    # the check's plan pinned here, so that the toy reads the same
    # whatever depth the cell's traffic file compares at
    "plain": {"batch": 4, "pool": 8, "warmup_batches": 1,
              "args": {"max_iters": 1000},
              "check": {"batch_of": 3, "k1_launches": [0, 1, 2],
                        "k1_drawn": [3, 8],
                        "iter": {"k1": [0, 1, 2], "core": [], "steps": 0},
                        "k1_cluster": {
                            "c2": {"clusters": [2], "drawn": [0, 2]},
                            "c4": {"clusters": [4], "drawn": [0, 2]},
                            "c8": {"clusters": [8], "drawn": [0, 3]}}}},
    # the policy windows on core.lp, as at xl: the toy's full (128, 128)
    # is kept from K1 (``xl_routes``), its tail bucket of 64 rows is not
    "xl": {"batch": 4, "pool": 4, "warmup_batches": 1,
           "args": {"policy_windows": 2, "rho_boost_iters": 500,
                    "max_iter": 1500},
           "check": {"k1_launches": [0, 1],
                     "iter": {"core": [0, 1], "tail": [0]}}},
}


def toy_cell(name: str) -> Cell:
    cell = Cell(name)
    cell.config = overlay(cell.config, {"instance": TOY_INSTANCE})
    cell.traffic = overlay(cell.traffic, TOY_TRAFFIC[toy_kind(cell)])
    return cell


def toy_kind(cell: Cell) -> str:
    return "xl" if cell.traffic["draw"] == "repeat" else \
        cell.traffic["entry"]


#: the plain toy's clusters by launch of a solve, as the card's would
#: come while instances finish (C = 1 while many are live, then 2, 4, 8);
#: the toy's four instances all run its ten launches
TOY_CLUSTERS = (1, 1, 1, 2, 2, 4, 4, 8, 8, 8)


@contextlib.contextmanager
def toy_routes(cell: Cell):
    """The routes the cell's own size takes, at the toy's: ``xl_routes``
    for the xl toy; for the plain toy a stand-in card, on which K1's
    launches spread their instances over clusters by ``TOY_CLUSTERS``
    (the plain versions run the same arithmetic on any C)."""
    if toy_kind(cell) != "plain":
        with xl_routes(cell):
            yield
        return
    from lpbox_admm_tpu_torch.ops import fused_lp
    launch = [0]
    solve = fused_lp.solve_fused

    def solve_fused(*args, **kw):
        launch[0] = 0
        return solve(*args, **kw)

    def split_plan(*args):
        c = TOY_CLUSTERS[min(launch[0], len(TOY_CLUSTERS) - 1)]
        launch[0] += 1
        return c
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fused_lp, "card", lambda device: fused_lp.Card(
            132, lambda route, smem, c: 132))
        mp.setattr(fused_lp, "split_plan", split_plan)
        mp.setattr(fused_lp, "solve_fused", solve_fused)
        yield


@contextlib.contextmanager
def xl_routes(cell: Cell):
    """For the xl toy: K1 refuses the full 128 rows, so that the policy
    windows run on ``core.lp`` and the tail on K1, as at the cell's own
    size."""
    if toy_kind(cell) != "xl":
        yield
        return
    from lpbox_admm_tpu_torch.train import l2f
    fits = l2f.fits
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(l2f, "fits", lambda m, n: m < 128 and fits(m, n))
        yield
