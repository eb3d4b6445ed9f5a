"""Result CSVs and trajectory dumps in the reference's formats.

The port of the JAX package's ``utils/io.py``:

* ``append_allres`` / ``read_allres``: the plain-ADMM oracle record
  ``idx,-obj,iters,time`` per instance (allres.csv writer,
  LPboxADMMsolver.cpp:1081; reader get_lpbox_info, trainer.py:189-201);
* ``write_xiter_csv`` / ``read_xiter_csv``: per-iteration trajectory
  dumps ``Iter{i},v0,...,vn-1`` (xiter writer, LPboxADMMsolver.cpp:
  903-909; reader readFile, trainer.py:32-48);
* ``SolverLog``: the per-instance iteration log (does_log path,
  LPboxADMMsolver.cpp:1013-1067), the JAX package's text.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np

from ..runtime import io as rio


def append_allres(path: str, idx: int, obj: float, iters: int,
                  seconds: float):
    """One oracle record ``idx,-obj,iters,time`` (the reference negates
    the minimization objective back to auction revenue)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a") as f:
        f.write(f"{idx},{-obj:f},{iters},{seconds:f}\n")


def read_allres(path: str) -> List[List[float]]:
    """[[instance, obj, iters, time], ...] (get_lpbox_info)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append([float(v) for v in line.split(",")])
    return out


def write_xiter_csv(path: str, traj: np.ndarray, start_iter: int = 0):
    """Trajectory dump of ``traj`` (n variables, T iterations): one line
    ``Iter{i},v...`` per iteration."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    rio.write_xiter(path, traj, start_iter)


def read_xiter_csv(path: str) -> np.ndarray:
    """A trajectory CSV back as (n, T) (readFile transposes to
    variables x iterations)."""
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.strip().split(",")
            if len(parts) < 2:
                continue
            rows.append([float(v) for v in parts[1:]])
    return np.asarray(rows).T


class SolverLog:
    """Per-instance iteration log in the form of the reference's
    ``does_log`` output (norms of the splitting variables per iteration,
    LPboxADMMsolver.cpp:1027-1066); nothing is written without a
    path."""

    def __init__(self, path: Optional[str]):
        self.path = path
        self._start = time.time()
        self._f = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "w")

    def iteration(self, it: int, **norms: float):
        if not self._f:
            return
        self._f.write(f"Iteration: {it}\n")
        for k, v in norms.items():
            self._f.write(f"norm of {k}: {v:.9f}\n")
        self._f.write(f"Time elapsed: {time.time() - self._start:f}s\n")
        self._f.write("-" * 49 + "\n")

    def message(self, msg: str):
        if self._f:
            self._f.write(msg + "\n")

    def close(self):
        if self._f:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
