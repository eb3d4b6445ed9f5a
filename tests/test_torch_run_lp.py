"""The port's experiment entry point and its host IO against the JAX
package (CPU).

* CA instance files (``_b.txt``, ``_C.txt``, ``.lp``), the allres
  oracle CSV and the xiter trajectory CSV: byte for byte the JAX
  package's, and read back as it reads them.
* ``utils/cmd_args``: the same flags plus ``-device``; ``-mesh 2``
  taken (refused for drivers that do not shard), ``-matvec_dtype
  bfloat16`` taken.
* ``utils/profiling``: phase totals, ``perturb`` as the JAX package
  draws it.
* ``experiments/run_lp``: generate -> solve -> train -> test on the CPU
  in a temporary directory (CA 20x60, solves capped at 1500 iterations
  through ``LP_CONFIG.max_iters``), its checkpoint read by the JAX
  package; ``scripts/train_ca500_policy.main`` likewise, its instances
  cut to 20 x 60; ``-phase train`` and ``-phase test`` with ``-mesh 2
  -device cpu`` in two gloo ranks.
"""

import filecmp
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpbox_admm_tpu.adapters import ca as jca
from lpbox_admm_tpu.utils import io as jio
from lpbox_admm_tpu_torch import config as tconfig
from lpbox_admm_tpu_torch.adapters import ca as tca
from lpbox_admm_tpu_torch.runtime import io as trio
from lpbox_admm_tpu_torch.utils import io as tio

from torch_port_util import np_of


def _same_tree(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for n in names:
        pa, pb = os.path.join(a, n), os.path.join(b, n)
        if os.path.isdir(pa):
            _same_tree(pa, pb)
        else:
            assert filecmp.cmp(pa, pb, shallow=False), n


def test_ca_files_match_jax(tmp_path):
    pj = jca.generate_dataset(str(tmp_path / "j"), seed=4, count=3,
                              n_items=20, n_bids=60)
    pt = tca.generate_dataset(str(tmp_path / "t"), seed=4, count=3,
                              n_items=20, n_bids=60)
    assert [os.path.relpath(p, tmp_path / "t") for p in pt] == \
        [os.path.relpath(p, tmp_path / "j") for p in pj]
    _same_tree(str(tmp_path / "j"), str(tmp_path / "t"))
    for prefix in pt:
        bj, Cj = jca.read_instance(prefix)
        bt, Ct = tca.read_instance(prefix)
        np.testing.assert_array_equal(bt, bj)
        np.testing.assert_array_equal(Ct, Cj)
        lj, Lj = jca.read_instance_lp(prefix + ".lp")
        lt, Lt = tca.read_instance_lp(prefix + ".lp")
        np.testing.assert_array_equal(lt, lj)
        np.testing.assert_array_equal(Lt, Lj)
    # the batch from the files is the generator's batch
    pb = tca.generate_batch(4, 3, n_items=20, n_bids=60, device="cpu")
    jb = jca.generate_batch(4, 3, n_items=20, n_bids=60)
    for f in ("b", "E", "f", "row_mask", "var_mask"):
        np.testing.assert_array_equal(np_of(getattr(pb, f)),
                                      np.asarray(getattr(jb, f)))


def test_coo_reader_refuses_malformed_lines(tmp_path):
    p = tmp_path / "bad_C.txt"
    p.write_text("1,2,1\n3,x,1\n")
    with pytest.raises(IOError, match="malformed"):
        trio.read_coo(str(p))
    with pytest.raises(IOError):
        trio.read_dense_vec(str(tmp_path / "missing_b.txt"))


def test_allres_and_xiter_csv_match_jax(tmp_path):
    rng = np.random.RandomState(8)
    traj = rng.rand(37, 25).astype(np.float32)
    traj[3, 4] = -0.0
    traj[5, 6] = 1.0 - 1e-9
    for pkg, io_ in (("j", jio), ("t", tio)):
        io_.write_xiter_csv(str(tmp_path / pkg / "x.csv"), traj,
                            start_iter=100)
        for i, (o, it, s) in enumerate([(-1375.25, 9300, 0.5),
                                        (-7453.0812, 20000, 1.25e-3)]):
            io_.append_allres(str(tmp_path / pkg / "allres.csv"), i + 1,
                              o, it, s)
    _same_tree(str(tmp_path / "j"), str(tmp_path / "t"))
    x = tio.read_xiter_csv(str(tmp_path / "t" / "x.csv"))
    np.testing.assert_array_equal(x, jio.read_xiter_csv(
        str(tmp_path / "j" / "x.csv")))
    assert x.shape == (37, 25) and np.abs(x - traj).max() <= 6e-7
    assert tio.read_allres(str(tmp_path / "t" / "allres.csv")) == \
        jio.read_allres(str(tmp_path / "j" / "allres.csv"))


def test_cmd_args_refuse_what_is_not_ported():
    from lpbox_admm_tpu.utils.cmd_args import base_parser as jparser
    from lpbox_admm_tpu_torch.utils.cmd_args import base_parser, check_ported
    a = base_parser("x").parse_args([])
    j = jparser("x").parse_args([])
    assert {k: v for k, v in vars(a).items() if k != "device"} == vars(j)
    assert a.device == "cuda"
    check_ported(a)
    # data parallelism is ported for run_lp: -mesh 2 passes; the drivers
    # that do not shard their workload (run_seg, run_attack) refuse it
    mesh2 = base_parser("x").parse_args(["-mesh", "2"])
    check_ported(mesh2)
    assert mesh2.mesh == 2
    with pytest.raises(ValueError, match="mesh 2"):
        check_ported(mesh2, data_parallel=False)
    # bfloat16 E in core.lp.step is ported: the flag passes
    bf = base_parser("x").parse_args(["-matvec_dtype", "bfloat16"])
    check_ported(bf)
    assert bf.matvec_dtype == "bfloat16"


def test_profiling_matches_jax():
    from lpbox_admm_tpu.utils.profiling import perturb as jperturb
    from lpbox_admm_tpu_torch.utils.profiling import PhaseTimer, perturb
    t = PhaseTimer()
    for _ in range(2):
        with t.phase("a"):
            t.sync(torch.zeros(3))
    assert t.counts == {"a": 2} and t.totals["a"] >= 0
    assert "TOTAL" in t.report()
    x = np.linspace(-3, 3, 24, dtype=np.float32).reshape(4, 6)
    pj = np.asarray(jperturb(np.random.RandomState(3), jnp.asarray(x)))
    pt = perturb(np.random.RandomState(3), torch.from_numpy(x))
    np.testing.assert_array_equal(np_of(pt), pj)


@pytest.fixture
def capped(monkeypatch):
    """The entry points' solves capped at 1500 iterations (their config is
    ``LP_CONFIG``; no flag of theirs sets it)."""
    monkeypatch.setattr(tconfig, "LP_CONFIG",
                        tconfig.LP_CONFIG.replace(max_iters=1500))


def test_run_lp_phases_on_cpu(tmp_path, capped):
    from lpbox_admm_tpu.config import PolicyConfig as JPC, LP_CONFIG as JLP
    from lpbox_admm_tpu.models.policy import build_policy as jbuild
    from lpbox_admm_tpu.train import imitation as jim
    from lpbox_admm_tpu_torch.experiments import run_lp
    common = ["-j", "20", "-col", "60", "-n", "4", "-n_eval", "2",
              "-batch", "2", "-num_epochs", "1", "-device", "cpu",
              "-data_dir", str(tmp_path / "data"),
              "-save_dir", str(tmp_path / "model")]
    logs = []
    run = lambda phase: run_lp.main(["-phase", phase] + common,
                                    log=logs.append)
    prefixes = run("generate")
    assert len(prefixes) == 4
    dss = run("solve")
    assert [ds.oracle_iters <= 1500 for ds in dss] == [True, True]
    xdir = tmp_path / "data" / "xiter"
    rows = tio.read_allres(str(xdir / "allres.csv"))
    assert [r[0] for r in rows] == [1, 2, 3, 4]
    x1 = tio.read_xiter_csv(str(xdir / "20_60_xiters_1.csv"))
    n1 = tca.read_instance(prefixes[0])[0].shape[0]
    assert x1.shape == (n1, 1000)
    np.testing.assert_allclose(x1, np_of(dss[0].traj[0, :n1]), rtol=0,
                               atol=6e-7)
    ts = run("train")
    assert ts.step == 1
    best = tmp_path / "model" / "checkpoint" / "best_checkpoint.npz"
    assert best.exists()
    jt = jim.PolicyTrainer(jbuild("mha"), JPC(), JLP)
    assert int(jt.load(str(best)).step) == 1
    m = run("test")
    assert np.isfinite(m["obj"]).all() and m["obj"].shape == (2,)
    assert {"obj_gap", "n_fixed", "fix_errors", "infeasible",
            "wall_time_s", "iter_speedup"} <= set(m)
    assert any(line.startswith("[l2f] obj gap") for line in logs)


def test_run_lp_train_and_test_on_two_ranks(tmp_path, capped):
    """``-mesh 2 -device cpu``: two gloo ranks, spawned by ``main``, run
    the train and the test phase on their shards (the capped
    ``LP_CONFIG`` handed to them); rank 0 alone writes the checkpoint and
    the log, and the test phase reads the checkpoint back."""
    from lpbox_admm_tpu_torch.experiments import run_lp
    common = ["-j", "20", "-col", "60", "-n", "4", "-n_eval", "2",
              "-batch", "2", "-num_epochs", "1", "-device", "cpu",
              "-data_dir", str(tmp_path / "data"),
              "-save_dir", str(tmp_path / "model")]
    logs = []
    run = lambda phase, *extra: run_lp.main(
        ["-phase", phase, *extra] + common, log=logs.append)
    assert len(run("generate")) == 4
    ts = run("train", "-mesh", "2")
    assert ts.step == 1
    ck = tmp_path / "model" / "checkpoint"
    assert sorted(os.listdir(ck)) == ["best_checkpoint.npz",
                                      "checkpoint_0.npz"]
    log_txt = (tmp_path / "model" / "log" / "log.txt").read_text()
    assert log_txt.count("epoch 0:") == 1 and "dataset 1..2" in log_txt
    m = run("test", "-mesh", "2")
    assert m["obj"].shape == (2,) and np.isfinite(m["obj"]).all()
    assert any(line.startswith("[l2f] obj gap") for line in logs)


def test_train_ca500_policy_main_on_cpu(tmp_path, capped, monkeypatch):
    """The training script's whole flow at 20 x 60 instances."""
    from lpbox_admm_tpu_torch.scripts import train_ca500_policy
    small = tca.generate_cauction
    monkeypatch.setattr(tca, "generate_cauction",
                        lambda rng, n_items, n_bids: small(rng, 20, 60))
    logs = []
    run = train_ca500_policy.main(
        ["-n_train", "2", "-n_eval", "2", "-batch", "2", "-epochs", "1",
         "-eval_every", "1", "-out", str(tmp_path), "-device", "cpu"],
        log=logs.append)
    assert run.state.step == 1 and len(run.datasets) == 1
    assert run.eval_prob.batch == 2 and run.eval_ds.traj.shape[0] == 2
    assert np.isfinite(run.metrics["obj"]).all()
    ck = tmp_path / "ca500_mha" / "checkpoint"
    assert sorted(os.listdir(ck)) == ["best_checkpoint.npz",
                                      "checkpoint_0.npz"]
    assert logs[-1] == "done" and "obj_gap=" in logs[-2]
