"""The port's data parallelism (``parallel.mesh``) on the CPU: two gloo
ranks, each a spawned process with one thread, a ``file://`` store, a
60 s collective timeout and a 120 s deadline for the whole start, held
against the port in one process and against the JAX package
(``tests/test_parallel.py``'s cases).  The inputs are
``tests/test_parallel.py``'s ``batch16`` (16 CA instances of 12 x 32,
seed 3), made with numpy; weights are carried across from the JAX
package in its checkpoint format.  The rank functions are the package's
(``parallel.dryrun``); one start of the ranks runs them all
(``parallel.mesh.run_calls``) while this process computes the
references.

* sharded plain solve: gathered objectives equal the one-process solve's
  (rtol 1e-5), ``done`` equal; the converged ones within 5% of the JAX
  package's (``test_torch_lp.py::test_solve_fused_converges_like_jax``);
* data-parallel step on the shipped ``ca500_mha`` checkpoint with its
  Adam state, on rows of CA instances of two sizes padded to one shape
  (the first rank's instances are the small ones, so the shards' moments
  differ) in micro-chunks that straddle the ranks: loss rtol 1e-6 and
  gradient within 1e-6 of max |g| of the one-process step (or its own
  float32 rounding, ``step_tol``), and within ``GRAD_TOL`` of the JAX
  package's float32 gradient (of max |g| of the float64 one); the
  parameters after the step bit for bit the same on both ranks; the
  plant (BatchNorm on each rank's own rows) fails the first bound;
* data-parallel ``train_epoch`` on the JAX package's dataset against its
  ``train_epoch``: loss rtol 1e-4, parameters rtol 3e-3 / atol 3e-5
  (``test_dp_train_epoch_matches_single``); the sharded ``build_dataset``
  gathered against the one-process one; an MHA epoch in micro-chunks of
  the episode-major global batch against the one-process epoch (loss
  rtol 1e-6);
* sharded masked ``l2f_solve`` against the one-process run: objectives
  rtol 1e-4, ``free`` equal;
* ``dp_scaling_table`` at 1 and 2 ranks, the refusals of ``shard_rows``
  and ``make_mesh``.  ``run_lp -phase train`` / ``-phase test`` with
  ``-mesh 2 -device cpu`` end to end is in ``tests/test_torch_run_lp.py``.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpbox_admm_tpu.config import LP_CONFIG as JLP, PolicyConfig as JPC
from lpbox_admm_tpu.core import lp as jlp
from lpbox_admm_tpu.models.policy import build_policy as jbuild
from lpbox_admm_tpu.train import imitation as jim
from lpbox_admm_tpu_torch.config import LP_CONFIG as TLP, PolicyConfig as TPC
from lpbox_admm_tpu_torch.core import lp as tlp
from lpbox_admm_tpu_torch.models.policy import build_policy as tbuild
from lpbox_admm_tpu_torch.parallel import dryrun
from lpbox_admm_tpu_torch.parallel import mesh as pm
from lpbox_admm_tpu_torch.train import imitation as tim
from lpbox_admm_tpu_torch.train.l2f import traj_to_tokens
from lpbox_admm_tpu_torch.utils import checkpoint as tck

from torch_port_util import (CKPT, ca_instances, flat_variables, jax_grads,
                             np_of, port_grads, problems)

CFG_J = JLP.replace(linsolve="woodbury")
CFG_T = TLP.replace(linsolve="woodbury")
WORLD = 2
SPAWN_S, COLLECTIVE_S = 120, 60
MICRO = 192                 # 512 rows: 3 chunks, the middle one on both
GRAD_TOL = 1e-4             # as tests/test_torch_imitation.py holds it
MLP = dict(net="mlp", node_size=4, chunk_dim=5)
MHA4 = dict(net="mha", node_size=4, chunk_dim=5)
EPOCH_MICRO = 1536          # 2 episodes of 16 x 128 rows: 3 chunks
CAP = 1500                  # the dataset solves' iterations


def ranks(fn, *args):
    return pm.launch(fn, WORLD, *args, devices=["cpu"] * WORLD, threads=1,
                     timeout_s=SPAWN_S, collective_timeout_s=COLLECTIVE_S)


def one(fn, *args):
    """``fn`` as a world-1 rank in this process."""
    return fn(pm.make_mesh(device="cpu"), *args)


def step_rows():
    """Episode rows of 4 CA instances, 2 of 20 x 20 then 2 of 20 x 60,
    padded to (128, 128): 100 recorded iterations as 20 tokens of 5, the
    last iterate's rounding as labels, the variable mask as weights."""
    insts = ca_instances(5, 2, 20, 20) + ca_instances(6, 2, 20, 60)
    _, tp = problems(insts)
    _, traj = tlp.solve_window(tlp.init_state(tp, CFG_T), tp, CFG_T, 100,
                               record=True, skip_cvg_at=0)
    rows = traj.reshape(-1, 100)
    x = traj_to_tokens(rows, TPC(net="mha"))
    lab = (rows[:, -1] >= 0.5).float()
    w = tp.var_mask.reshape(-1).float()
    return x, lab, w


def step_grad64(x, lab, w):
    """The one-process step's gradient in float64: ``train_step``'s
    chunks (zero padding, loss scaled by chunk rows over R) on the
    shipped checkpoint cast to float64."""
    model = tck.load_policy(CKPT["mha"], device="cpu").double().train()
    R = x.shape[0]
    pad = (-R) % MICRO
    z = lambda t: torch.cat([t, t.new_zeros((pad,) + t.shape[1:])]).double()
    xp, lp_, wp = z(x), z(lab), z(w)
    for c in range(0, R + pad, MICRO):
        logits, _ = model(xp[c:c + MICRO])
        (tim.weighted_bce(logits[:, 0], lp_[c:c + MICRO], wp[c:c + MICRO])
         * (MICRO / R)).backward()
    return torch.cat([p.grad.reshape(-1) for p in model.parameters()])


def grads_as_port(flat, net, **kw):
    model = tbuild(net, **kw)
    for p, g in zip(model.parameters(),
                    flat.split([p.numel() for p in model.parameters()])):
        p.grad = g.view_as(p)
    return port_grads(model)


def params_as_flax(flat, net, **kw):
    model = tbuild(net, **kw)
    with torch.no_grad():
        for p, v in zip(model.parameters(),
                        flat.split([p.numel() for p in model.parameters()])):
            p.copy_(v.view_as(p))
    return {k[2:]: v for k, v in tck.variable_arrays(model).items()
            if k.startswith("v/params/")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    insts = ca_instances(3, 16, 12, 32)
    jp, tp = problems(insts)
    x, lab, w = step_rows()
    pcfg_mlp = TPC(**MLP)
    cap_t = CFG_T.replace(max_iters=CAP)
    # the JAX package's epoch: its dataset and init, carried across
    jt = jim.PolicyTrainer(jbuild("mlp"), JPC(**MLP), CFG_J, ws=20)
    ts0 = jt.init(jax.random.PRNGKey(0), jnp.zeros((2, 4, 5)))
    init_ckpt = str(tmp / "mlp_init.npz")
    np.savez(init_ckpt, **jim.checkpoint_arrays(ts0, 0))
    jds = jim.build_dataset(jp, CFG_J.replace(max_iters=CAP),
                            record_iters=200)
    tds = tim.TrajectoryDataset(
        traj=torch.from_numpy(np.asarray(jds.traj)),
        labels=torch.from_numpy(np.asarray(jds.labels)),
        var_mask=torch.from_numpy(np.asarray(jds.var_mask)),
        oracle_obj=torch.from_numpy(np.asarray(jds.oracle_obj)),
        oracle_iters=int(jds.oracle_iters))
    # an MHA epoch in micro-chunks: each rank's rows of a chunk are not
    # contiguous in the global (episode-major) batch
    tt = tim.PolicyTrainer(tbuild(**MHA4), TPC(**MHA4), cap_t, ws=20,
                           micro_rows=EPOCH_MICRO, device="cpu")
    mha_ckpt = str(tmp / "mha4_init.npz")
    np.savez(mha_ckpt, **tim.checkpoint_arrays(tt.init(0), 0))
    variables = jbuild("mlp").init(jax.random.PRNGKey(1),
                                   jnp.zeros((2, 4, 5)), train=True)
    l2f_ckpt = str(tmp / "mlp_l2f.npz")
    np.savez(l2f_ckpt, **{"v/" + k: v
                          for k, v in flat_variables(variables).items()})
    calls = [
        (dryrun.sharded_solve, (tp, CFG_T, 4000, 50)),
        (dryrun.dp_step, (CKPT["mha"], (x, lab, w), "mha", TPC(net="mha"),
                          CFG_T, 100, MICRO, None)),
        (dryrun.dp_step, (CKPT["mha"], (x, lab, w), "mha", TPC(net="mha"),
                          CFG_T, 100, MICRO, "bn")),
        (dryrun.dp_epoch, (tp, init_ckpt, "mlp", pcfg_mlp, cap_t, 20, 200, 5,
                           tds)),
        (dryrun.sharded_l2f, (tp, l2f_ckpt, CFG_T, pcfg_mlp, 20, 2000)),
        (dryrun.dp_epoch, (tp, mha_ckpt, "mha", TPC(**MHA4), cap_t, 20, 200,
                           2, tds, EPOCH_MICRO)),
    ]
    with ThreadPoolExecutor(1) as ex:
        fut = ex.submit(ranks, pm.run_calls, calls)
        ref = {"jp": jp, "tp": tp, "rows": (x, lab, w)}
        ref["solve"] = one(dryrun.sharded_solve, tp, CFG_T, 4000, 50)
        ref["jsolve"] = jlp.solve(jp, CFG_J, max_iters=4000, window=50)
        tr = tim.PolicyTrainer(tbuild("mha"), TPC(net="mha"), CFG_T,
                               micro_rows=MICRO, device="cpu")
        ts, loss = tr.train_step(tr.load(CKPT["mha"]), x, lab, w)
        ref["step"] = (float(loss), torch.cat(
            [p.grad.reshape(-1) for p in ts.model.parameters()]))
        ref["step64"] = step_grad64(x, lab, w)
        jts = jim.PolicyTrainer(jbuild("mha"), JPC(net="mha"), CFG_J,
                                ws=100, micro_rows=MICRO)
        js = jts.load(CKPT["mha"])
        ref["jgrad"] = jax_grads(jts, js.params, js.batch_stats,
                                 *map(np_of, (x, lab, w)), np.float32)[2]
        ref["build"] = tim.build_dataset(tp, cap_t, record_iters=200)
        ref["jepoch"] = jt.train_epoch(ts0, [jds], n_episodes=5)
        ref["l2f"] = one(dryrun.sharded_l2f, tp, l2f_ckpt, CFG_T, pcfg_mlp,
                         20, 2000)
        ref["epoch_mha"] = tt.train_epoch(tt.load(mha_ckpt), [tds],
                                          n_episodes=2)[1]
        res = fut.result()
    names = ("solve", "step", "plant_bn", "epoch", "l2f", "epoch_mha")
    return ref, [dict(zip(names, r)) for r in res]


def test_sharded_solve_matches_local(runs):
    ref, res = runs
    loc = ref["solve"]
    for r in res:
        np.testing.assert_allclose(np_of(r["solve"]["obj"]),
                                   np_of(loc["obj"]), rtol=1e-5)
        np.testing.assert_array_equal(np_of(r["solve"]["done"]),
                                      np_of(loc["done"]))
    js = ref["jsolve"]
    both = np_of(loc["done"]) & np.asarray(js.done)
    assert both.sum() >= 8, both
    o, o_ref = np_of(loc["obj"])[both], np.asarray(jlp.objective(js))[both]
    assert np.all(np.abs(o - o_ref) / np.abs(o_ref) < 0.05), (o, o_ref)


def _step_dist(got, ref):
    G = ref.abs().max()
    return float((got.double() - ref.double()).abs().max() / G)


def step_tol(ref):
    """The bound of the data-parallel gradient against the one-process
    one: 1e-6 of max |g|, or the one-process float32 gradient's own
    distance from its float64 gradient where that is larger.  The
    data-parallel step sums each straddling chunk's BatchNorm moments
    rank by rank; on these rows (many all-zero rows of padded variables,
    whose features have small spreads in a chunk) that change of
    summation order moves the float32 gradient by about what float32
    rounding itself does (9.9e-5 of max |g| against float64, 5.1e-5
    between the two orders, in the builder's run), so 1e-6 alone would
    not tell a fault from rounding."""
    return max(1e-6, _step_dist(ref["step"][1], ref["step64"]))


def test_dp_step_matches_single_and_jax(runs):
    ref, res = runs
    loss, g1 = ref["step"]
    r0 = res[0]["step"]
    assert abs(r0["loss"] - loss) <= 1e-6 * abs(loss)
    d, tol = _step_dist(r0["grad"], g1), step_tol(ref)
    print(f"dp step: gradient {d:.2e} of max |g| from one process "
          f"(bound {tol:.2e}); against float64 "
          f"{_step_dist(r0['grad'], ref['step64']):.2e}")
    assert d <= tol
    assert torch.equal(res[0]["step"]["params"], res[1]["step"]["params"])
    assert torch.equal(res[0]["step"]["grad"], res[1]["step"]["grad"])
    g_dp, g_j = grads_as_port(r0["grad"], "mha"), ref["jgrad"]
    G = float(ref["step64"].abs().max())
    dist = max(np.abs(u - v).max() for u, v in zip(g_dp, g_j)) / G
    print(f"dp step against the JAX package's float32 gradient: {dist:.2e}")
    assert dist <= GRAD_TOL


def test_dp_step_catches_per_rank_batchnorm(runs):
    """With BatchNorm on each rank's own rows the step is another
    function: the shards hold instances of different sizes, so their
    moments differ."""
    ref, res = runs
    d = _step_dist(res[0]["plant_bn"]["grad"], ref["step"][1])
    print(f"per-rank BatchNorm plant: gradient {d:.2e} of max |g|")
    assert d > step_tol(ref)


def test_dp_train_epoch_matches_jax(runs):
    ref, res = runs
    jts, jloss = ref["jepoch"]
    r0 = res[0]["epoch"]
    np.testing.assert_allclose(r0["loss"], float(jloss), rtol=1e-4)
    assert torch.equal(r0["params"], res[1]["epoch"]["params"])
    got = params_as_flax(r0["params"], "mlp", node_size=4, chunk_dim=5)
    want = flat_variables({"params": jts.params})
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=3e-3, atol=3e-5,
                                   err_msg=k)
    # the sharded dataset build, gathered, is the one-process build
    built, loc = r0["dataset"], ref["build"]
    assert built.oracle_iters == loc.oracle_iters
    assert built.oracle_wall_s > 0
    np.testing.assert_allclose(np_of(built.traj), np_of(loc.traj),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(np_of(built.labels), np_of(loc.labels))
    np.testing.assert_allclose(np_of(built.oracle_obj), np_of(loc.oracle_obj),
                               rtol=1e-5)


def test_dp_epoch_takes_the_global_chunks(runs):
    """An MHA epoch over 3 micro-chunks of the episode-major global batch,
    whose chunks hold rows of both ranks at scattered positions: the
    loss is the one-process epoch's (BatchNorm over the same rows), the
    parameters the same bits on both ranks."""
    ref, res = runs
    r0 = res[0]["epoch_mha"]
    assert abs(r0["loss"] - ref["epoch_mha"]) <= 1e-6 * abs(ref["epoch_mha"])
    assert torch.equal(r0["params"], res[1]["epoch_mha"]["params"])


def test_sharded_l2f_matches_local(runs):
    ref, res = runs
    for r in res:
        np.testing.assert_allclose(np_of(r["l2f"]["obj"]),
                                   np_of(ref["l2f"]["obj"]), rtol=1e-4)
        np.testing.assert_array_equal(np_of(r["l2f"]["free"]),
                                      np_of(ref["l2f"]["free"]))


def test_dp_scaling_table_on_cpu():
    _, tp = problems(ca_instances(3, 16, 12, 32))
    table = pm.dp_scaling_table(tp, CFG_T, iters=20, device_counts=(1, 2),
                                reps=1, device="cpu", timeout_s=SPAWN_S)
    assert [r["n"] for r in table] == [1, 2]
    assert table[1]["devices"] == ["cpu", "cpu"]
    for r in table:
        assert np.isfinite(r["wall_s"]) and r["wall_s"] > 0
        assert r["inst_iters_per_s"] > 0 and r["par_eff"] > 0
    assert table[0]["eff"] == 1.0


def test_mesh_refuses_what_it_cannot_split():
    mesh = pm.Mesh(rank=1, world=2, device=torch.device("cpu"))
    assert pm.shard_rows(16, mesh) == slice(8, 16)
    with pytest.raises(ValueError, match="split evenly"):
        pm.shard_rows(15, mesh)
    with pytest.raises(ValueError, match="outside a process group"):
        pm.make_mesh(2, device="cpu")
    assert pm.make_mesh(1, device="cpu").world == 1
    # outside a group the collectives leave their input as it is
    m1 = pm.make_mesh(device="cpu")
    t = torch.arange(4.0)
    assert pm.gather_batch({"t": t}, m1)["t"] is t
    assert pm.all_reduce_max(3, m1) == 3
