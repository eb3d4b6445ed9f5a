"""A cell shrunk to a size the CPU runs in seconds: CA instances of 20
items and 60 bids, batches of 4 from a pool of 8, short solves.  The
program then runs its kernels' plain versions."""

import contextlib
import os

import pytest

from benchmark.manifest import HERE, Cell, _json, overlay

TOY_INSTANCE = {"n_items": 20, "n_bids": 60, "m_pad": 128, "n_pad": 128}
TOY_TRAFFIC = {
    "l2f": {"batch": 4, "pool": 8, "warmup_batches": 1,
            "args": {"policy_windows": 2, "rho_boost_iters": 500,
                     "max_iter": 1500},
            "check": {"iter": {"k1": [0, 1], "tail": [2]}}},
    "plain": {"batch": 4, "pool": 8, "warmup_batches": 1,
              "args": {"max_iters": 1000},
              "check": {"k1_drawn": [3, 8]}},
    # the policy windows on core.lp, as at xl: the toy's full (128, 128)
    # is kept from K1 (``xl_routes``), its tail bucket of 64 rows is not
    "xl": {"batch": 4, "pool": 4, "warmup_batches": 1,
           "args": {"policy_windows": 2, "rho_boost_iters": 500,
                    "max_iter": 1500},
           "check": {"k1_launches": [0, 1],
                     "iter": {"core": [0, 1], "tail": [0]}}},
}

#: the plain solve, which no cell runs yet: the ca500 configuration under
#: the plain traffic file, held to these numbers at toy size
PLAIN = {"traffic": "plain-b128-pool256",
         "limits": {"infeasible": 0, "obj_err": 1e-5, "select_diff": 0,
                    "window_operand": 0, "ex_err": 1e-2, "iter_err": 0.2}}


def toy_cell(name: str) -> Cell:
    if name == "ca500-plain":
        cell = Cell("ca500-l2f")
        cell.name = name
        cell.traffic = _json(os.path.join(HERE, "traffic",
                                          PLAIN["traffic"] + ".json"))
        cell.limits = {"numbers": dict(PLAIN["limits"])}
    else:
        cell = Cell(name)
    cell.config = overlay(cell.config, {"instance": TOY_INSTANCE})
    cell.traffic = overlay(cell.traffic, TOY_TRAFFIC[toy_kind(cell)])
    return cell


def toy_kind(cell: Cell) -> str:
    return "xl" if cell.traffic["draw"] == "repeat" else \
        cell.traffic["entry"]


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
