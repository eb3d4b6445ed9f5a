"""The port's sparse attack (``adapters/attack.py``, ``adapters/slic.py``,
``models/cifarnet.py``, ``experiments/run_attack.py``) against the JAX
package on the CPU, on synthetic images (``chip_smoke.attack_images``:
8-bit, with pixels at exactly 0 and 1) at B = 2, S <= 40
segments and tens of iterations.

Tolerances: CifarNet logits 1e-4 (weights carried across); SLIC label
maps and masks equal; ``compute_sensitive`` 1e-6; the loss and its
epsilon and G gradients at epsilon = 0 1e-5 (relative to max |ref| where
that exceeds 1); ``group_shrink`` 1e-6; one G iteration 1e-5 and 20
iterations 1e-3 (the bound every port test applies to <= 20 iterations
of a chaotic iteration); 20 epsilon iterations 1e-3; the l2f decisions
equal wherever both packages' sigmoids are more than 1e-3 from the fix
margins; the repair's kept sets equal; the lambda1 search's per-round
lambda1 equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lpbox_admm_tpu import config as jconfig
from lpbox_admm_tpu.adapters import attack as ja
from lpbox_admm_tpu.adapters import slic as jslic
from lpbox_admm_tpu_torch import config as tconfig
from lpbox_admm_tpu_torch.adapters import attack as ta
from lpbox_admm_tpu_torch.adapters import slic as tslic
from lpbox_admm_tpu_torch.models import cifarnet as tcn
from lpbox_admm_tpu_torch.train.l2f import scores_to_vec

from torch_port_util import (ATTACK_CKPT, VICTIM_NPZ, attack_images,
                             attack_setup_jax, flax_variables_from_npz, np_of,
                             rel)

SEGMENTS = 40


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def setup():
    """Two images, the JAX victim and inputs, and the port's victim from
    the same ``.npz``."""
    imgs = attack_images(0, 2)
    jm, jv, labels, targets, Bm, nw = attack_setup_jax(imgs, SEGMENTS)
    tm = tcn.load_victim_npz(VICTIM_NPZ, device="cpu")
    return dict(imgs=imgs, jm=jm, jv=jv, tm=tm, targets=targets, Bm=Bm,
                nw=nw, lam=np.full((2,), 10.0, np.float32))


def cfgs(**kw):
    return (jconfig.ATTACK_CONFIG.replace(**kw),
            tconfig.ATTACK_CONFIG.replace(**kw))


def test_attack_images_are_8bit_with_saturated_pixels():
    """Every image of the smoke's recipe is 8-bit and has pixels at
    exactly 0 and 1 in every channel: the clip's tie at its bounds is
    hit from the first iteration."""
    a = attack_images(3, 2)
    assert a.dtype == np.float32 and a.shape == (2, 3, 32, 32)
    assert np.array_equal(np.round(a * 255) / 255, a)
    assert (a == 0).any(axis=(2, 3)).all() and (a == 1).any(axis=(2, 3)).all()


@pytest.mark.parametrize("weights", ["init3", "npz"])
def test_cifarnet_logits_match_jax(weights):
    from lpbox_admm_tpu.models.cifarnet import init_victim
    from lpbox_admm_tpu.utils.checkpoint import load_pytree
    jm, jv = init_victim(3)
    if weights == "npz":
        jv = load_pytree(VICTIM_NPZ, jv)
        tm = tcn.load_victim_npz(VICTIM_NPZ, device="cpu")
    else:
        tm = tcn.victim_from_flax(jax.tree_util.tree_map(np.asarray, jv),
                                  device="cpu")
    x = attack_images(1, 3)
    want = np.asarray(jm.apply(jv, jnp.asarray(x)))
    got = np_of(tm(T(x)))
    assert np.abs(got - want).max() <= 1e-4


def test_init_victim_is_seeded():
    a, b = (tcn.init_victim(3, device="cpu") for _ in range(2))
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(),
                                                 b.parameters()))
    assert not a.training


def test_train_cifarnet_and_state_dict_round_trip():
    """``train_cifarnet`` takes Adam steps on minus-0.5 inputs and returns
    the victim in evaluation mode; its state dict loads back through
    ``load_torch_state_dict`` (the reference's ``.pth`` layout) with the
    same logits."""
    rng = np.random.RandomState(0)
    x = rng.rand(64, 3, 32, 32).astype(np.float32)
    y = rng.randint(0, 10, 64)
    start = tcn.init_victim(0, device="cpu")
    m = tcn.train_cifarnet(x, y, epochs=1, batch=32, device="cpu")
    assert not m.training
    assert not torch.equal(m.fc3.weight, start.fc3.weight)
    back = tcn.load_torch_state_dict(
        {k: v.numpy() for k, v in m.state_dict().items()}, device="cpu")
    with torch.no_grad():
        assert torch.equal(back(T(x[:4])), m(T(x[:4])))


@pytest.mark.parametrize("seed,segments", [(0, 40), (1, 150), (2, 90)])
def test_slic_bit_for_bit(seed, segments):
    im = (attack_images(seed, 1)[0].transpose(1, 2, 0) * 255).astype(np.uint8)
    assert np.array_equal(tslic.slic(im, n_segments=segments),
                          jslic.slic(im, n_segments=segments))
    assert np.array_equal(tslic.segment_masks(im, n_segments=segments),
                          jslic.segment_masks(im, n_segments=segments))


@pytest.mark.parametrize("wt", ["none", "gradient", "variance",
                                "variance_mean", "contrast",
                                "contrast_mean"])
def test_compute_sensitive_matches_jax(wt):
    im = attack_images(4, 1, 12, 12)[0]
    got, want = ta.compute_sensitive(im, wt), ja.compute_sensitive(im, wt)
    assert got.dtype == want.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-6


def _grads(setup, clip=None):
    """The port's loss and its epsilon and G gradients at epsilon = 0,
    G = 1 (every 0 and 1 pixel a tie of the clip)."""
    s = setup
    _, cfg = cfgs()
    x, tg = T(s["imgs"]), T(s["targets"])
    eps, G = torch.zeros_like(x), torch.ones_like(x)
    if clip is not None:
        real = ta._clip_pixels
        ta._clip_pixels = clip
    try:
        loss = ta.cnn_loss(s["tm"], x, tg, eps, G, cfg)
        ge = ta._loss_grad(s["tm"], x, tg, eps, G, cfg, "eps")
        gg = ta._loss_grad(s["tm"], x, tg, eps, G, cfg, "G")
    finally:
        if clip is not None:
            ta._clip_pixels = real
    return np_of(loss), np_of(ge), np_of(gg)


def _jax_grads(setup):
    s = setup
    cfg, _ = cfgs()
    x, tg = jnp.asarray(s["imgs"]), jnp.asarray(s["targets"])
    eps, G = jnp.zeros_like(x), jnp.ones_like(x)
    f = lambda e, g: ja.cnn_loss(s["jm"], s["jv"], x, tg, e, g, cfg)
    ge = jax.grad(lambda e: jnp.sum(f(e, G)))(eps)
    gg = jax.grad(lambda g: jnp.sum(f(eps, g)))(G)
    return np.asarray(f(eps, G)), np.asarray(ge), np.asarray(gg)


def test_loss_and_gradients_at_the_pixel_bounds(setup):
    """At epsilon = 0 the perturbed image is the image, whose 0 and 1
    pixels sit on the clip's bounds: the gradient there is half, as
    jax.grad of jnp.clip gives."""
    assert (setup["imgs"] == 0).any() and (setup["imgs"] == 1).any()
    want = _jax_grads(setup)
    got = _grads(setup)
    assert np.all(want[0] > 0)
    for g, w in zip(got, want):
        assert rel(g, w) <= 1e-5


def test_torch_clamp_would_break_the_tie_gradient(setup):
    """The same gradients with ``torch.clamp`` (gradient 1 at a bound)
    miss the JAX package's by far more than the tolerance."""
    want = _jax_grads(setup)
    clamp = lambda x, cfg: torch.clamp(x, cfg.min_pix_value,
                                       cfg.max_pix_value)
    got = _grads(setup, clip=clamp)
    assert rel(got[0], want[0]) <= 1e-5           # same forward
    assert rel(got[1], want[1]) > 1e-2


def test_max_pool_tie_gradient_matches_jax():
    """A 2x2 window of equal values sends its gradient to the first
    element in row-major order in both packages."""
    import flax.linen as nn
    x = np.zeros((1, 4, 4, 1), np.float32)
    x[0, :2, :2, 0] = 0.7
    x[0, 2:, 2:, 0] = [[0.2, 0.9], [0.9, 0.9]]
    w = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)
    gj = jax.grad(lambda v: jnp.sum(nn.max_pool(v, (2, 2), (2, 2))[..., 0]
                                    * w))(jnp.asarray(x))
    xt = T(x.transpose(0, 3, 1, 2)).requires_grad_(True)
    (torch.nn.functional.max_pool2d(xt, 2, 2)[0, 0] * T(w)).sum().backward()
    got = np_of(xt.grad).transpose(0, 2, 3, 1)
    assert np.array_equal(got, np.asarray(gj))
    assert got[0, 0, 0, 0] == 1.0 and got[0, 2, 3, 0] == 4.0


def test_group_shrink_matches_jax(setup):
    C = np.random.RandomState(0).randn(2, 3, 32, 32).astype(np.float32)
    for rho3, lam2 in ((5e-3, 1e-3), (1.0, 1e-2), (100.0, 1e-3)):
        want = np.asarray(ja.group_shrink(jnp.asarray(C),
                                          jnp.asarray(setup["Bm"]),
                                          jnp.float32(rho3), lam2))
        got = np_of(ta.group_shrink(T(C), T(setup["Bm"]), rho3, lam2))
        assert np.abs(got - want).max() <= 1e-6


def _eps_after(setup, iters=20):
    s = setup
    cj, ct = cfgs(maxIter_e=iters)
    x = s["imgs"]
    want = np.asarray(ja.update_epsilon(
        s["jm"], s["jv"], jnp.asarray(x), jnp.asarray(s["targets"]),
        jnp.zeros_like(jnp.asarray(x)), jnp.ones_like(jnp.asarray(x)),
        jnp.asarray(s["nw"]), cj, lambda1=jnp.asarray(s["lam"])))
    got = np_of(ta.update_epsilon(
        s["tm"], T(x), T(s["targets"]), torch.zeros(x.shape),
        torch.ones(x.shape), T(s["nw"]), ct, lambda1=T(s["lam"])))
    return got, want


def test_update_epsilon_20_iterations(setup):
    got, want = _eps_after(setup)
    assert np.abs(want).max() > 1e-2
    assert np.abs(got - want).max() <= 1e-3


@pytest.mark.parametrize("n,tol", [(1, 1e-5), (20, 1e-3)])
def test_g_window_matches_jax(setup, n, tol):
    s = setup
    cj, ct = cfgs()
    eps, _ = _eps_after(setup)
    x = s["imgs"]
    G = np.ones_like(x)
    sj, trj = ja.g_window(s["jm"], s["jv"], jnp.asarray(x),
                          jnp.asarray(s["targets"]), jnp.asarray(eps),
                          ja.init_attack_state(jnp.asarray(G)),
                          jnp.asarray(s["Bm"]), jnp.asarray(s["nw"]), cj, n,
                          jnp.asarray(s["lam"]))
    st, trt = ta.g_window(s["tm"], T(x), T(s["targets"]), T(eps),
                          ta.init_attack_state(T(G)), T(s["Bm"]),
                          T(s["nw"]), ct, n, T(s["lam"]))
    assert st.it == int(sj.it) == n
    assert tuple(trt.shape) == (2, 3, 32, 32, n)
    for f in ("G", "y1", "y2", "y3", "z1", "z2", "z3", "z4"):
        assert np.abs(np_of(getattr(st, f))
                      - np.asarray(getattr(sj, f))).max() <= tol, f
    assert np.abs(np_of(trt) - np.asarray(trj)).max() <= tol


def test_update_g_l2f_decisions_match_jax(setup, monkeypatch):
    """Two windows of 50 with attack_mha (one scoring and soft reset):
    the same fix decisions wherever both packages' sigmoids are more
    than 1e-3 from the margins, and G at the end within 1e-3 there."""
    import lpbox_admm_tpu.train.l2f as jl2f
    from lpbox_admm_tpu.models.policy import build_policy
    from lpbox_admm_tpu_torch.utils.checkpoint import load_policy
    s = setup
    cj, ct = cfgs()
    eps, _ = _eps_after(setup)
    x = s["imgs"]
    jp = jconfig.PolicyConfig(net="mha", node_size=10, chunk_dim=5)
    tp = tconfig.PolicyConfig(net="mha", node_size=10, chunk_dim=5)
    sig = {}
    real = jl2f.policy_scores

    def jscore(*a, **k):
        sig["jax"] = np.asarray(real(*a, **k))
        return sig["jax"]

    monkeypatch.setattr(jl2f, "policy_scores", jscore)
    Gj = np.asarray(ja.update_g_l2f(
        s["jm"], s["jv"], jnp.asarray(x), jnp.asarray(s["targets"]),
        jnp.asarray(eps), jnp.ones_like(jnp.asarray(x)),
        jnp.asarray(s["Bm"]), jnp.asarray(s["nw"]), cj,
        jnp.asarray(s["lam"]), build_policy("mha"),
        flax_variables_from_npz(ATTACK_CKPT), jp, n_windows=2))
    score0 = ta.policy_scorer(load_policy(ATTACK_CKPT, node_size=10,
                                          chunk_dim=5, device="cpu"), tp,
                              "cpu")

    def tscore(rows):
        assert tuple(rows.shape) == (2 * 3072, 50)
        sig["port"] = np_of(score0(rows))
        return score0(rows)

    Gt = np_of(ta.update_g_l2f(s["tm"], T(x), T(s["targets"]), T(eps),
                               torch.ones(x.shape), T(s["Bm"]), T(s["nw"]),
                               ct, T(s["lam"]), pcfg=tp, n_windows=2,
                               score=tscore))
    C = jp.fix_confidence
    sj, sp = sig["jax"], sig["port"]
    far = np.ones(sj.shape, bool)
    for v in (sj, sp):
        far &= (np.abs(v - C) > 1e-3) & (np.abs(v - (1 - C)) > 1e-3)
    vj = np.asarray(jl2f.scores_to_vec(jnp.asarray(sj), C))
    vp = np_of(scores_to_vec(T(sp), C))
    assert far.mean() > 0.99 and (vj >= 0).sum() > 0
    assert np.array_equal(vj[far], vp[far])
    # G after the reset and the second window: 50 iterations from equal
    # resets, within the bound of a short run
    far = far.reshape(x.shape)
    assert np.abs(Gt[far] - Gj[far]).max() <= 1e-3


# --- the linear victim of tests/test_attack.py, in both packages ---------

@pytest.fixture(scope="module")
def linear(setup):
    import flax.linen as nn

    class LinearNet(nn.Module):
        @nn.compact
        def __call__(self, x):
            return nn.Dense(10)(x.reshape(x.shape[0], -1))

    jm = LinearNet()
    jv = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 3, 32, 32)))
    k = np.asarray(jv["params"]["Dense_0"]["kernel"])
    b = np.asarray(jv["params"]["Dense_0"]["bias"])
    tm = torch.nn.Sequential(torch.nn.Flatten(), torch.nn.Linear(3072, 10))
    with torch.no_grad():
        tm[1].weight.copy_(T(k.T))
        tm[1].bias.copy_(T(b))
    return jm, jv, tm.eval()


def test_cardinality_repair_kept_sets_match_jax(setup, linear):
    """Masks of about 400 entries against k = 200: the k largest |eps|
    kept, two finetunes, accepted per image where the attack still
    succeeds; the same kept sets and acceptances as the JAX package."""
    jm, jv, tm = linear
    s = setup
    cj, ct = cfgs(maxIter_e=40, k=200)
    rng = np.random.RandomState(5)
    x = s["imgs"]
    G = (rng.rand(*x.shape) < 0.13).astype(np.float32)
    G[0, 0, 0, :5] = 0.0
    eps = (rng.randn(*x.shape) * 0.3).astype(np.float32)
    eps[1, 0, 0, :3] = 0.0                      # active entries of eps 0
    for lam in (1.0, 100.0):
        lamv = np.full((2,), lam, np.float32)
        Gj, ej = ja.cardinality_repair(
            jm, jv, jnp.asarray(x), jnp.asarray(s["targets"]),
            jnp.asarray(eps), jnp.asarray(G), jnp.asarray(s["nw"]), cj,
            lambda1=jnp.asarray(lamv))
        Gt, et = ta.cardinality_repair(
            tm, T(x), T(s["targets"]), T(eps), T(G), T(s["nw"]), ct,
            lambda1=T(lamv))
        assert np.array_equal(np_of(Gt), np.asarray(Gj)), lam
        assert np.abs(np_of(et) - np.asarray(ej)).max() <= 1e-3
    # the larger lambda1 makes the reduced attack succeed on both images
    assert np.asarray(Gj).reshape(2, -1).sum(-1).max() <= 200


def test_attack_with_search_pins_unclamped_escalation(setup, linear,
                                                      monkeypatch):
    """Three rounds with the repair on: the same lambda1 per round as
    the JAX package, and a successful result over k escalates lambda1
    x10 past lambda1_upper_bound (no clamp, the JAX package's
    attack.py:432)."""
    jm, jv, tm = linear
    s = setup
    kw = dict(maxIter_e=30, maxIter_g=40, k=20, lambda1_search_times=3,
              init_lambda1=30.0, lambda1_upper_bound=100.0)
    cj, ct = cfgs(**kw)
    seen = {"jax": [], "port": []}
    real_j, real_t = ja.attack_single, ta.attack_single

    def wrap(real, key):
        def f(*a, **k):
            seen[key].append(np.array(np_of(a[7 if key == "jax" else 6])))
            return real(*a, **k)
        return f

    monkeypatch.setattr(ja, "attack_single", wrap(real_j, "jax"))
    monkeypatch.setattr(ta, "attack_single", wrap(real_t, "port"))
    x = s["imgs"]
    rj = ja.attack_with_search(jm, jv, jnp.asarray(x),
                               jnp.asarray(s["targets"]),
                               jnp.asarray(s["Bm"]), jnp.asarray(s["nw"]),
                               cj, repair=True)
    rt = ta.attack_with_search(tm, T(x), T(s["targets"]), T(s["Bm"]),
                               T(s["nw"]), ct, repair=True)
    assert len(seen["port"]) == len(seen["jax"]) == 3
    for a, b in zip(seen["port"], seen["jax"]):
        assert np.array_equal(a, b), (seen["port"], seen["jax"])
    assert np.array_equal(rt["success"], rj["success"])
    assert np.array_equal(rt["L0"], np.asarray(rj["L0"]))
    # pinned: 30 -> 300 (> the upper bound 100) -> 3000
    lams = np.stack(seen["port"])
    assert lams.max() > cj.lambda1_upper_bound
    assert np.array_equal(lams[:, 0], np.float32([30.0, 300.0, 3000.0]))


# --- the experiment entry point ---------------------------------------------

def test_run_attack_solve_train_test_on_cpu(tmp_path):
    """``run_attack -phase solve -dump_xiter`` -> ``train`` (1 epoch on
    the dumped CSVs) -> ``test`` with the trained checkpoint, on the CPU,
    on the first (by name) of two PNGs."""
    Image = pytest.importorskip("PIL.Image")
    from lpbox_admm_tpu_torch.experiments import run_attack
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    imgs = attack_images(6, 2)
    for i, (im, label) in enumerate(zip(imgs, (3, 1))):
        Image.fromarray(np.round(im.transpose(1, 2, 0) * 255)
                        .astype(np.uint8)).save(img_dir / f"{label}_{i}.png")
    common = ["-image_dir", str(img_dir), "-n", "1", "-victim", VICTIM_NPZ,
              "-segments", "40", "-maxIter_e", "10", "-maxIter_g", "20",
              "-search", "1", "-device", "cpu", "-data_dir",
              str(tmp_path / "data"), "-save_dir", str(tmp_path / "save"),
              "-result_dir", str(tmp_path / "result")]
    lines = []
    res = run_attack.main(["-phase", "solve", "-dump_xiter"] + common,
                          log=lines.append)
    assert res["G"].shape == (1, 3, 32, 32)
    csvs = sorted((tmp_path / "data" / "attack_xiter").glob("*.csv"))
    assert [p.name for p in csvs] == ["1_1.csv"]
    from lpbox_admm_tpu_torch.utils.io import read_xiter_csv
    assert read_xiter_csv(str(csvs[0])).shape == (3072, 150)
    rows = (tmp_path / "result" / "all_ori.csv").read_text().splitlines()
    assert len(rows) == 1 and rows[0].startswith("Img:1_1.png, Origin "
                                                 "Label:1, Target Label:8")
    out = run_attack.main(["-phase", "train", "-num_epochs", "1"] + common,
                          log=lines.append)
    assert np.isfinite(out["history"][0]["loss"])
    ckpt = tmp_path / "save" / "checkpoint" / "best_checkpoint.npz"
    assert ckpt.exists()
    res = run_attack.main(["-phase", "test"] + common, log=lines.append)
    assert set(np.unique(res["G"])) <= {0.0, 1.0}
    assert (tmp_path / "result" / "all_mha.csv").exists()
