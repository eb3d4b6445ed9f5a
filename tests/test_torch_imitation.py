"""The port's imitation training against the JAX package (CPU).

CA 20x60, 2 instances, both packages fed the same numpy inputs, weights
and optimizer state carried across in the JAX package's checkpoint
format (``utils.checkpoint``):

* training-mode forward (flax ``apply(train=True, mutable=...)``): the
  logits and the updated BatchNorm statistics to 1e-5 relative;
* training steps, with ``micro_rows`` small enough to pad the last
  chunk: one step resumed from the shipped ``ca500_mha`` checkpoint
  (its Adam state included), and 3 steps from a fresh flax init over
  the learning-rate decay boundary (``lr_decay_step=2``), each from the
  same state in both packages (the port's state carried into the JAX
  package through a checkpoint before every step).  The loss to 1e-5
  relative against ``PolicyTrainer._train_step``; the batch statistics
  to 1e-5 relative against the same chunk losses differentiated op by
  op with ``jax.value_and_grad``; the gradients to 1e-4 of max |g| of
  the JAX package's own gradient, in float64 (``jax.enable_x64``, the
  flax variables cast) or in float32 (``GRAD_TOL`` says why either);
  the parameters after the step and the Adam moments to 1e-5 against
  the trainer's own ``tx`` applied to the port's gradient.  A planted
  fault (W_out detached) must fail the gradient check;
* ``episode_batch``, ``damage_weights``, ``weighted_bce`` pointwise;
* ``build_dataset``: the first 20 recorded iterations to 1e-3; past
  them only the oracle objectives and the label agreement;
* checkpoints both ways, each followed by one more step that agrees;
  the shipped checkpoint read and written back unchanged, optax's leaf
  order read from ``tree_leaves(tx.init(params))``.
"""


import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lpbox_admm_tpu.config import LP_CONFIG as JLP, PolicyConfig as JPC
from lpbox_admm_tpu.models.policy import build_policy as jbuild
from lpbox_admm_tpu.train import imitation as jim
from lpbox_admm_tpu_torch.config import LP_CONFIG as TLP, PolicyConfig as TPC
from lpbox_admm_tpu_torch.models import policy as tpolicy
from lpbox_admm_tpu_torch.models.policy import build_policy as tbuild
from lpbox_admm_tpu_torch.train import imitation as tim
from lpbox_admm_tpu_torch.utils import checkpoint as tck

from torch_port_util import (CKPT, ca_instances, flat_variables,
                             flax_variables_from_npz, jax_grads, np_of,
                             port_grads as _port_grads, problems)

CFG_J = JLP.replace(linsolve="woodbury")
CFG_T = TLP.replace(linsolve="woodbury")
ROWS, MICRO = 300, 128          # 3 chunks, the last one padded


@pytest.fixture(scope="module")
def data():
    """Both packages' datasets of the same 2 CA 20x60 instances, and the
    training rows: the first ROWS of the JAX dataset's episode batch."""
    jp, tp = problems(ca_instances(11, 2))
    jds = jim.build_dataset(jp, CFG_J, record_iters=1000)
    tds = tim.build_dataset(tp, CFG_T, record_iters=1000)
    x, lab, w = (np.asarray(a)[:ROWS] for a in
                 jim.episode_batch(jds, JPC(net="mha"), 100))
    return dict(jp=jp, tp=tp, jds=jds, tds=tds, x=x, lab=lab, w=w)


_JAX_TRAINERS = {}


def jax_trainer(lr_decay_step=2000, save_dir=None):
    """One JAX trainer per schedule for the whole module: its jitted
    ``_train_step`` compiles once."""
    if lr_decay_step not in _JAX_TRAINERS:
        _JAX_TRAINERS[lr_decay_step] = jim.PolicyTrainer(
            jbuild("mha"), JPC(net="mha", lr_decay_step=lr_decay_step),
            CFG_J, ws=100, micro_rows=MICRO)
    jt = _JAX_TRAINERS[lr_decay_step]
    jt.save_dir = save_dir
    return jt


def _leaves(params):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(params)]


def _tree_like(params, leaves):
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params), [jnp.asarray(a) for a in leaves])


def _flax_vars(model):
    return {k[2:]: v for k, v in tck.variable_arrays(model).items()}


# The port's float32 gradient against the JAX package's, over max |g|
# of the float64 one: within GRAD_TOL of the JAX package's float64
# gradient or of its float32 trainer's.  Two things part a float32
# gradient from the float64 one by more than GRAD_TOL, and the JAX
# package's two gradients each catch one: flax's one-pass batch variance
# (E[x^2] - E[x]^2) cancels on the shipped checkpoint's layers, where the
# JAX float32 gradient is 1.8e-3 off and the port's two-pass one 1.2e-6;
# and at the fresh init one ReLU input of 3.3e-7 changes sign between
# float32 and float64, where both packages' float32 gradients are 2.4e-4
# off float64 and 2.0e-6 from each other.  A detached W_out is 3.9e-1
# off both.  ``pytest -s`` prints the distances.
GRAD_TOL = 1e-4


def _grad_distances(jt, js, tt, tts, x, lab, w):
    """One step of the port from ``tts``, and gradient distances over
    max |g| of the JAX package's float64 gradient of the same loss (from
    the state ``js``): the port's from that float64 gradient
    (``port_64``) and from the JAX package's float32 chunk loop
    (``port_32``), and the latter's from float64 (``jax32_64``).
    Returns the port's state, loss and gradient, the distances, and
    JAX's float32 loss and statistics."""
    _, _, g64 = jax_grads(jt, js.params, js.batch_stats, x, lab, w,
                          np.float64)
    loss_j, stats_j, g_j = jax_grads(jt, js.params, js.batch_stats, x, lab,
                                     w, np.float32)
    tts, loss_t = tt.train_step(tts, *(torch.from_numpy(a)
                                       for a in (x, lab, w)))
    G = max(np.abs(g).max() for g in g64)
    dist = lambda a, b: max(np.abs(u - v).max() for u, v in zip(a, b)) / G
    g_t = _port_grads(tts.model)
    d = dict(port_64=dist(g_t, g64), port_32=dist(g_t, g_j),
             jax32_64=dist(g_j, g64))
    return tts, loss_t, g_t, d, loss_j, stats_j


def _step_both(jt, tt, tts, x, lab, w, tmp_path):
    """One step of the port from ``tts`` and the JAX package's references
    from the same state (carried across in a checkpoint); checks
    everything and returns the port's new state."""
    path = str(tmp_path / "step.npz")
    np.savez(path, **tim.checkpoint_arrays(tts, 0))
    js = jt.load(path)
    count = tim.adam_count(tts.optimizer)
    _, jloss = jt._train_step(js, jnp.asarray(x), jnp.asarray(lab),
                              jnp.asarray(w))
    tts, loss_t, g_t, d, loss_j, stats_j = _grad_distances(
        jt, js, tt, tts, x, lab, w)
    print(f"step {count}: gradient distances over max |g|: {d}")
    assert tts.optimizer.param_groups[0]["lr"] == tt.lr_at(count)
    assert abs(float(loss_t) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert abs(float(loss_t) - loss_j) <= 1e-5 * abs(loss_j)
    assert min(d["port_64"], d["port_32"]) <= GRAD_TOL, d
    # batch statistics
    got = _flax_vars(tts.model)
    for key, b in flat_variables({"batch_stats": stats_j}).items():
        assert np.abs(got[key] - b).max() <= 1e-5 * np.abs(b).max(), key
    # the optimizer: optax's Adam on the port's gradient
    g_tree = _tree_like(js.params, [a.astype(np.float32) for a in g_t])
    updates, opt_ref = jt.tx.update(g_tree, js.opt_state, js.params)
    p_ref = optax.apply_updates(js.params, updates)
    for key, b in flat_variables({"params": p_ref}).items():
        assert np.abs(got[key] - b).max() <= 1e-5 * max(
            1.0, np.abs(b).max()), key
    jl = _leaves(opt_ref)
    tl = tck.adam_arrays(tts.model, tts.optimizer,
                         tim.adam_count(tts.optimizer))
    assert [int(tl[0]), int(tl[-1])] == [int(jl[0]), int(jl[-1])] \
        == [count + 1] * 2
    for a, b in zip(tl[1:-1], jl[1:-1]):
        assert np.abs(a - b).max() <= 1e-5 * max(np.abs(b).max(), 1e-30)
    return tts


def test_train_mode_forward_matches_flax(data):
    v = flax_variables_from_npz(CKPT["mha"])
    x = data["x"][:300]
    (lj, _), mut = jbuild("mha").apply(v, jnp.asarray(x), train=True,
                                      mutable=["batch_stats"])
    model = tck.load_policy(CKPT["mha"], device="cpu").train()
    with torch.no_grad():
        lt, _ = model(torch.from_numpy(x))
    lj = np.asarray(lj)
    assert np.abs(np_of(lt) - lj).max() <= 1e-5 * np.abs(lj).max()
    ref = flat_variables({"batch_stats": mut["batch_stats"]})
    got = _flax_vars(model)
    for key, b in ref.items():
        assert np.abs(got[key] - b).max() <= 1e-5 * np.abs(b).max(), key


@pytest.mark.parametrize("case", ["resume-1", "fresh-3"])
def test_train_step_matches_jax(data, case, tmp_path):
    x, lab, w = data["x"], data["lab"], data["w"]
    decay, steps = (2000, 1) if case == "resume-1" else (2, 3)
    jt = jax_trainer(decay)
    pj, pt = jt.pcfg, TPC(net="mha", lr_decay_step=decay)
    tt = tim.PolicyTrainer(tbuild("mha"), pt, CFG_T, ws=100,
                           micro_rows=MICRO, device="cpu")
    if case == "resume-1":
        tts = tt.load(CKPT["mha"])
    else:
        ts = jt.init(jax.random.PRNGKey(0), jnp.zeros((2, 20, 5)))
        path = str(tmp_path / "init.npz")
        np.savez(path, **jim.checkpoint_arrays(ts, 0))
        tts = tt.load(path)
    schedule = optax.exponential_decay(
        pj.lr, transition_steps=pj.lr_decay_step,
        decay_rate=pj.lr_decay_factor, staircase=True)
    step0 = tts.step
    lrs = []
    for _ in range(steps):
        count = tim.adam_count(tts.optimizer)
        lrs.append(tt.lr_at(count))
        assert lrs[-1] == pytest.approx(float(schedule(count)), rel=1e-6)
        tts = _step_both(jt, tt, tts, x, lab, w, tmp_path)
    assert tts.step == step0 + steps and not tts.model.training
    if case == "fresh-3":
        assert lrs == [pj.lr, pj.lr, pj.lr * pj.lr_decay_factor]


def test_gradient_check_catches_detached_w_out(data, monkeypatch):
    """The gradient check does not follow the port: with every layer's
    W_out detached (the forward unchanged), the port's gradient is
    farther than ``GRAD_TOL`` from both of the JAX package's."""
    x, lab, w = data["x"], data["lab"], data["w"]
    jt = jax_trainer()
    tt = tim.PolicyTrainer(tbuild("mha"), TPC(net="mha"), CFG_T, ws=100,
                           micro_rows=MICRO, device="cpu")
    shifted = tpolicy.MultiHeadAttention.shifted
    # W_out is (heads, key, embed), the others (heads, embed, key)
    monkeypatch.setattr(
        tpolicy.MultiHeadAttention, "shifted", staticmethod(
            lambda t: shifted(t).detach() if t.shape[1] < t.shape[2]
            else shifted(t)))
    _, loss_t, _, d, loss_j, _ = _grad_distances(
        jt, jt.load(CKPT["mha"]), tt, tt.load(CKPT["mha"]), x, lab, w)
    print(f"W_out detached: gradient distances over max |g|: {d}")
    assert abs(float(loss_t) - loss_j) <= 1e-5 * abs(loss_j)
    assert min(d["port_64"], d["port_32"]) > GRAD_TOL, d


def test_pointwise_helpers(data):
    jp, tp, jds = data["jp"], data["tp"], data["jds"]
    lab = np.asarray(jds.labels)
    dj = np.asarray(jim.damage_weights(jp, jnp.asarray(lab), alpha=0.5))
    dt = np_of(tim.damage_weights(tp, torch.from_numpy(lab), alpha=0.5))
    np.testing.assert_allclose(dt, dj, rtol=1e-5, atol=1e-6)
    # the JAX dataset's trajectories through both episode batches
    tds = tim.TrajectoryDataset(
        traj=torch.from_numpy(np.asarray(jds.traj)),
        labels=torch.from_numpy(lab), var_mask=tp.var_mask,
        oracle_obj=torch.from_numpy(np.asarray(jds.oracle_obj)),
        oracle_iters=int(jds.oracle_iters), damage=torch.from_numpy(dj))
    jds_d = jds._replace(damage=jnp.asarray(dj))
    for got, ref in zip(tim.episode_batch(tds, TPC(), 100, 4),
                        jim.episode_batch(jds_d, JPC(), 100, 4)):
        np.testing.assert_array_equal(np_of(got), np.asarray(ref))
    rng = np.random.RandomState(2)
    logits = (rng.randn(500) * 8).astype(np.float32)
    lb = (rng.rand(500) > 0.5).astype(np.float32)
    wt = rng.rand(500).astype(np.float32)
    bj = float(jim.weighted_bce(jnp.asarray(logits), jnp.asarray(lb),
                                jnp.asarray(wt)))
    bt = float(tim.weighted_bce(*(torch.from_numpy(a)
                                  for a in (logits, lb, wt))))
    assert abs(bt - bj) <= 1e-6 * abs(bj)


def test_build_dataset_matches_jax(data):
    jds, tds = data["jds"], data["tds"]
    tj, tt_ = np.asarray(jds.traj), np_of(tds.traj)
    assert tt_.shape == tj.shape == (2, 128, 1000)
    assert np.abs(tt_[..., :20] - tj[..., :20]).max() <= 1e-3
    oj, ot = np.asarray(jds.oracle_obj), np_of(tds.oracle_obj)
    assert np.all(np.abs(ot - oj) / np.abs(oj) < 0.05), (ot, oj)
    vm = np.asarray(jds.var_mask)
    agree = (np_of(tds.labels) == np.asarray(jds.labels))[vm].mean()
    assert agree >= 0.9, agree
    assert set(np.unique(np_of(tds.labels))) <= {0.0, 1.0}
    assert tds.oracle_iters > 1000 and tds.oracle_wall_s > 0
    assert tds.damage is None


def test_shipped_checkpoint_round_trip(tmp_path):
    """Read into the port and written back, the shipped checkpoint's 114
    arrays come out equal (keys, dtypes, values: optax's leaf order)."""
    tt = tim.PolicyTrainer(tbuild("mha"), TPC(net="mha"), CFG_T,
                           device="cpu")
    ts = tt.load(CKPT["mha"])
    with np.load(CKPT["mha"], allow_pickle=False) as z:
        ref = {k: z[k] for k in z.files}
    assert len(ref) == 114 and ref["opt/0000"].dtype == np.int32
    assert ts.step == int(ref["step"]) == 320
    got = tim.checkpoint_arrays(ts, int(ref["epoch"]))
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    # optax's own leaf order and shapes for these params
    jt = jax_trainer()
    jts = jt.load(CKPT["mha"])
    tl = jax.tree_util.tree_leaves(jt.tx.init(jts.params))
    opt = [got[f"opt/{i:04d}"] for i in range(len(tl))]
    assert [a.shape for a in opt] == [np.shape(a) for a in tl]
    assert [a.dtype for a in opt] == [np.asarray(a).dtype for a in tl]


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_checkpoint_both_ways(data, tmp_path, direction):
    """A state after one step, saved by one package and loaded by the
    other; then one more step from it agrees in both."""
    x, lab, w = data["x"], data["lab"], data["w"]
    jt = jax_trainer(save_dir=str(tmp_path))
    tt = tim.PolicyTrainer(tbuild("mha"), TPC(net="mha"), CFG_T,
                           micro_rows=MICRO, device="cpu",
                           save_dir=str(tmp_path))
    path = str(tmp_path / "checkpoint" / "checkpoint_4.npz")
    if direction == "jax-to-port":
        ts = jt.init(jax.random.PRNGKey(3), jnp.zeros((2, 20, 5)))
        ts, _ = jt._train_step(ts, jnp.asarray(x), jnp.asarray(lab),
                               jnp.asarray(w))
        jt.save(ts, 4)
        tts = tt.load(path)
        ref = jim.checkpoint_arrays(ts, 4)
    else:
        tts = tt.init(torch.Generator().manual_seed(3))
        tts, _ = tt.train_step(tts, *(torch.from_numpy(a)
                                      for a in (x, lab, w)))
        tt.save(tts, 4)
        ts = jt.load(path)
        ref = tim.checkpoint_arrays(tts, 4)
    assert tts.step == int(ts.step) == 1
    with np.load(path, allow_pickle=False) as z:
        assert set(z.files) == set(ref)
    got = jim.checkpoint_arrays(ts, 4)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    _step_both(jt, tt, tts, x, lab, w, tmp_path)
