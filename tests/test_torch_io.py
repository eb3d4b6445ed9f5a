"""The port's last host helpers against the JAX package (CPU):

* ``utils.checkpoint.save_pytree`` / ``load_pytree`` / ``load_meta``:
  the JAX package's format (``leaf/%05d`` + a JSON ``meta``, no pickle)
  over the port's dataclasses, NamedTuples, tuples, dicts and tensors; a
  mid-solve ``LpState`` saved and resumed continues bit for bit; either
  package reads the other's ``meta`` and a tree of arrays both ways; a
  leaf of another shape or dtype is refused by name;
* ``utils.io.SolverLog``: the JAX class's text on the same calls;
* ``kernels.build``: a process that finds the library missing while
  another holds the build lock waits and loads what that one built,
  without its own ``nvcc``.
"""

import fcntl
import threading
import time

import numpy as np
import pytest
import torch

from lpbox_admm_tpu.utils import checkpoint as jck
from lpbox_admm_tpu.utils import io as jio
from lpbox_admm_tpu_torch.config import LP_CONFIG
from lpbox_admm_tpu_torch.core import lp
from lpbox_admm_tpu_torch.train.imitation import TrajectoryDataset
from lpbox_admm_tpu_torch.utils import checkpoint as tck
from lpbox_admm_tpu_torch.utils import io as tio

from torch_port_util import ca_instances, problems

CFG = LP_CONFIG.replace(linsolve="woodbury")


def _same_state(a, b):
    for f in lp.LpState.__dataclass_fields__:
        u, v = getattr(a, f), getattr(b, f)
        if isinstance(u, torch.Tensor):
            assert u.dtype == v.dtype and torch.equal(u, v), f
        else:
            assert u == v, f


def test_solver_state_checkpoint_resume(tmp_path):
    """Interrupt a solve, checkpoint its state, restore it into a fresh
    ``init_state``, resume: the same bits as the uninterrupted solve."""
    _, prob = problems(ca_instances(2, 2, 10, 30))
    st = lp.init_state(prob, CFG)
    st, _ = lp.solve_window(st, prob, CFG, 40, record=False)
    path = str(tmp_path / "solver_state.ckpt")
    tck.save_pytree(path, st, meta={"it": st.it})
    assert tck.load_meta(path) == {"it": 40}
    st2 = tck.load_pytree(path, lp.init_state(prob, CFG))
    assert st2.it == 40 and isinstance(st2.it, int)
    _same_state(st, st2)
    a, _ = lp.solve_window(st, prob, CFG, 40, record=False)
    b, _ = lp.solve_window(st2, prob, CFG, 40, record=False)
    _same_state(a, b)


def test_containers_round_trip(tmp_path):
    """A NamedTuple with a None field, dicts (sorted keys), tuples, bool
    and integer tensors and Python numbers come back as they went."""
    ds = TrajectoryDataset(
        traj=torch.rand(2, 3, 4), labels=torch.ones(2, 3),
        var_mask=torch.tensor([[True, False, True]] * 2),
        oracle_obj=torch.tensor([-1.5, 2.0]), oracle_iters=7,
        oracle_wall_s=0.25, damage=None)
    tree = {"b": (ds, torch.arange(5, dtype=torch.int32)), "a": [1.5, 3]}
    path = str(tmp_path / "t.ckpt")
    tck.save_pytree(path, tree)
    with np.load(path, allow_pickle=False) as z:
        assert sorted(z.files) == [f"leaf/{i:05d}"
                                   for i in range(9)] + ["meta"]
    back = tck.load_pytree(path, tree)
    assert back["a"] == [1.5, 3] and isinstance(back["a"][1], int)
    got, ints = back["b"]
    assert isinstance(got, TrajectoryDataset) and got.damage is None
    assert got.oracle_iters == 7 and got.oracle_wall_s == 0.25
    for f in ("traj", "labels", "var_mask", "oracle_obj"):
        assert torch.equal(getattr(got, f), getattr(ds, f)), f
    assert torch.equal(ints, tree["b"][1]) and ints.dtype == torch.int32
    assert tck.load_meta(path) == {}


def test_format_read_by_either_package(tmp_path):
    """A tree of arrays and its meta, written by one package, read by the
    other (dict keys in the same sorted order in both)."""
    rng = np.random.RandomState(0)
    tree = {"w": rng.rand(3, 4).astype(np.float32),
            "idx": np.arange(6, dtype=np.int32).reshape(2, 3),
            "mask": rng.rand(5) > 0.5}
    jpath, tpath = str(tmp_path / "j.ckpt"), str(tmp_path / "t.ckpt")
    jck.save_pytree(jpath, tree, meta={"by": "jax", "n": 3})
    tck.save_pytree(tpath, {k: torch.from_numpy(v) for k, v in tree.items()},
                    meta={"by": "port", "n": 3})
    assert tck.load_meta(jpath) == {"by": "jax", "n": 3}
    assert jck.load_meta(tpath) == {"by": "port", "n": 3}
    example = {k: torch.zeros_like(torch.from_numpy(v))
               for k, v in tree.items()}
    got = tck.load_pytree(jpath, example)
    back = jck.load_pytree(tpath, {k: np.zeros_like(v)
                                   for k, v in tree.items()})
    for k, v in tree.items():
        np.testing.assert_array_equal(got[k].numpy(), v)
        np.testing.assert_array_equal(back[k], v)


def test_checkpoint_shape_mismatch_error(tmp_path):
    tree = {"a": torch.zeros(3, 4), "b": torch.arange(5)}
    path = str(tmp_path / "t.ckpt")
    tck.save_pytree(path, tree)
    with pytest.raises(ValueError, match="leaf 0"):
        tck.load_pytree(path, {"a": torch.zeros(3, 5), "b": torch.arange(5)})
    with pytest.raises(ValueError, match="dtype"):
        tck.load_pytree(path, {"a": torch.zeros(3, 4, dtype=torch.float64),
                               "b": torch.arange(5)})
    with pytest.raises(ValueError, match="2 leaves, example has 1"):
        tck.load_pytree(path, {"a": torch.zeros(3, 4)})


def test_solver_log_matches_jax(tmp_path, monkeypatch):
    clock = iter(np.arange(100.0, 200.0, 0.5))
    now = lambda: float(next(clock))
    monkeypatch.setattr(jio.time, "time", now)
    texts = []
    for mod in (jio, tio):
        path = str(tmp_path / f"{mod.__name__}.txt")
        with mod.SolverLog(path) as log:
            log.iteration(1, x_sol=1.234, y1=0.5)
            log.iteration(2, x_sol=0.25)
            log.message("Stop because y1_y2")
        texts.append(open(path).read())
        with mod.SolverLog(None) as quiet:
            quiet.iteration(1, x=1.0)
            quiet.message("nothing")
    assert texts[0] == texts[1]
    assert "Iteration: 1\nnorm of x_sol: 1.234000000\n" in texts[1]
    assert "Time elapsed: 0.500000s\n" + "-" * 49 in texts[1]


def test_build_waits_for_another_process_build(monkeypatch, tmp_path):
    """While another holder has the build lock, ``build`` waits; once the
    holder has written the library and let go, it returns that library
    without running ``nvcc`` (there is none here)."""
    from lpbox_admm_tpu_torch.kernels import build
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "BUILD_INFO", {})
    lib = tmp_path / f"liblpbox_kernels_{build.source_hash()}.so"
    lock = open(lib.with_name(lib.name + ".lock"), "w")
    fcntl.flock(lock, fcntl.LOCK_EX)
    out = {}
    waiter = threading.Thread(target=lambda: out.update(lib=build.build()))
    waiter.start()
    time.sleep(0.5)
    assert waiter.is_alive() and "lib" not in out
    lib.write_bytes(b"built by the lock holder")
    fcntl.flock(lock, fcntl.LOCK_UN)
    lock.close()
    waiter.join(timeout=10)
    assert not waiter.is_alive()
    assert out["lib"] == lib and build.BUILD_INFO["cached"]
