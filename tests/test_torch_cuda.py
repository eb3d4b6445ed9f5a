"""K1 to K4 and P1 to P3 against their plain versions on a CUDA device
(K2 also at row counts off both of its kernels' blocks),
K1's one-byte E routes against its f32 route bit for bit, K1 on
clusters of 2, 4 and 8 blocks an instance at the l2f tails' shapes (its
transpose products add the blocks' partials in another order, so it is
held to the plain version's limits, and to its own bits from a repeat
launch), K1's refusal of the xl shape and one l2f policy window at that
shape.

Marked ``cuda``: skipped where there is no card (``torch.cuda`` is
asked inside the fixture, never at import).  On the card:
``python -m pytest tests/test_torch_cuda.py -q``.  Shapes are the small
ones of the CPU tests; ``chip_smoke.py`` repeats the checks at CA-500
size.  Tolerances after 20 iterations (f32 sums in another order), as
in ``chip_smoke.py``: 1e-3 absolute on x, its copies y1/y2/y3, E x and
the incumbent; 1e-3 on the duals divided by gamma*rho of the window's
last iteration (the factor by which a dual step scales an error of x);
1e-3 relative to max(1, |ref|) per instance on the objectives; 1e-4
absolute on the sigmoids (K2's three TF32 passes; T = 5, 10 on seeded
random modules, T = 20 on the shipped checkpoints).  One K3 sweep: 1e-4
relative to max(1, max |ref|) per output (f32 sums over m and n in
another order); K4 and P1-P3: 1e-5 relative to max |ref|.  K2, K3, K4
and P1-P3 sum in a fixed order without atomics, so a repeat launch, and
K3 on bf16 and on f32 E (0/1 entries), give the same bits.  K1's one-byte routes decode
each entry exactly and keep the f32 route's order of sums, so they give
its bits.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from lpbox_admm_tpu_torch.adapters import ca
from lpbox_admm_tpu_torch.config import LP_CONFIG, PolicyConfig
from lpbox_admm_tpu_torch.core import lp
from lpbox_admm_tpu_torch.core.problem import LpProblem
from lpbox_admm_tpu_torch.models import fused_policy
from lpbox_admm_tpu_torch.models.policy import build_policy
from lpbox_admm_tpu_torch.ops import fused_lp, fused_stream, symm, woodbury
from lpbox_admm_tpu_torch.ops.schedule import gamma_at, rho_at
from lpbox_admm_tpu_torch.scripts import probe_dot
from lpbox_admm_tpu_torch.train import l2f
from lpbox_admm_tpu_torch.utils.checkpoint import load_policy

pytestmark = pytest.mark.cuda

CFG = LP_CONFIG.replace(linsolve="woodbury")
CKPT = str(Path(__file__).resolve().parent.parent / "checkpoints"
           / "ca500_mha" / "checkpoint" / "best_checkpoint.npz")


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def prob(cuda):
    rng = np.random.RandomState(7)
    insts = [ca.generate_cauction(rng, n_items=20, n_bids=60)
             for _ in range(4)]
    return ca.make_problem(insts, device=cuda)


def k1_start(prob, cfg, mode):
    """Start state of one K1 case.  ``done-*``: the end state of a plain
    solve with every instance but the first frozen, so one window runs
    the done-instance exit beside an active instance."""
    if not mode.startswith("done"):
        return lp.init_state(prob, cfg)
    st = fused_lp.solve_fused(prob, cfg, max_iters=20000, window=100)
    first = torch.arange(st.done.shape[0], device=st.done.device) == 0
    return st.replace(done=st.done & ~first)


@pytest.mark.parametrize("mode", ["mside", "nside", "record", "stride8",
                                  "bf16E", "done-freezing",
                                  "done-freezing-record"])
def test_k1_matches_plain(prob, mode):
    cfg = CFG.replace(incumbent_stride=8) if mode == "stride8" else CFG
    kcfg = cfg.replace(matvec_dtype="bfloat16") if mode == "bf16E" else cfg
    s0 = k1_start(prob, cfg, mode)
    record = mode.endswith("record")
    kw = {"record": record}
    if not mode.startswith("done"):
        kw["skip_cvg_at"] = 0
    if mode == "nside":
        nf = woodbury.factorize_nside(prob.E, s0.free, 2.0)
        kw["nfactor"] = (nf.hinv, nf.ete)
    before = sum(fused_lp.LAUNCHES.values())
    k = fused_lp.lp_window_fused(s0, prob, kcfg, 20, **kw)
    p = fused_lp.lp_window_plain(s0, prob, cfg, 20, **kw)
    assert sum(fused_lp.LAUNCHES.values()) == before + 1
    if record:
        (k, tk), (p, tp) = k, p
        assert (tk - tp).abs().max().item() <= 1e-3
    for f in ("x", "y1", "y2", "y3", "ex", "best_sol"):
        assert (getattr(k, f) - getattr(p, f)).abs().max().item() <= 1e-3, f
    dual_unit = gamma_at(p.it - 1, cfg) * rho_at(p.it - 1, cfg)
    for f in ("z1", "z2", "z4"):
        d = (getattr(k, f) - getattr(p, f)).abs().max().item()
        assert d / dual_unit <= 1e-3, f
    for f in ("cur_obj", "best_bin_obj", "obj_ring"):
        ref = getattr(p, f)
        d = (getattr(k, f) - ref).abs() / ref.abs().clamp_min(1.0)
        assert d.max().item() <= 1e-3, f
    assert bool((k.done == p.done).all())
    assert bool((k.obj_count == p.obj_count).all())
    if mode.startswith("done"):
        d = s0.done
        assert bool(d.any())
        frozen = {"x": s0.x, "y1": s0.x, "y2": s0.x, "y3": s0.f_eff,
                  "z1": s0.z1, "z2": s0.z2, "z4": s0.z4,
                  "best_sol": s0.best_sol, "obj_ring": s0.obj_ring}
        for f, v in frozen.items():
            assert bool((getattr(k, f)[d] == v[d]).all()), f
        if record:
            assert bool((tk[d] == s0.x[d][..., None]).all())


def random_lp(cuda, B, m, n, density, seed):
    """B random 0/1 LPs of shape (m, n) on the card."""
    g = torch.Generator(cuda).manual_seed(seed)
    E = (torch.rand(B, m, n, device=cuda, generator=g) < density).float()
    return LpProblem(b=-torch.rand(B, n, device=cuda, generator=g) * 100,
                     E=E, f=torch.ones(B, m, device=cuda),
                     row_mask=torch.ones(B, m, dtype=torch.bool,
                                         device=cuda),
                     var_mask=torch.ones(B, n, dtype=torch.bool,
                                         device=cuda))


@pytest.mark.parametrize("route", ["int8-resident", "int8-stream"])
@pytest.mark.parametrize("shape", ["ca60", "ca500", "tails"])
def test_k1_one_byte_routes_match_f32(prob, prob500, shape, route,
                                      monkeypatch):
    """Each one-byte route against the f32-stream launch, bit for bit on
    every output, trajectories included: m side recorded with incumbent
    stride 8, and n side.  ``tails``: (m, n) = (52, 100), rows short of a
    warp's share and columns short of a lane sweep.  The stream route is
    taken at these shapes by lowering K1's limit to the carve-up alone,
    so the one-byte E no longer fits beside it."""
    p = {"ca60": prob, "ca500": prob500,
         "tails": random_lp(prob.E.device, 3, 52, 100, 0.1, 5)}[shape]
    if route == "int8-stream":
        monkeypatch.setattr(fused_lp, "_SMEM_MAX",
                            fused_lp.smem_bytes(p.m, p.n))
    assert fused_lp.e_route(fused_lp.window_operand(p.E, CFG)) == route
    cfg = CFG.replace(incumbent_stride=8)
    s0 = lp.init_state(p, cfg)
    nf = woodbury.factorize_nside(p.E, s0.free, 2.0)
    for kw in ({"record": True, "skip_cvg_at": 0},
               {"nfactor": (nf.hinv, nf.ete), "skip_cvg_at": 0}):
        before = dict(fused_lp.LAUNCHES)
        k = fused_lp.lp_window_fused(s0, p, cfg, 20, **kw)
        assert fused_lp.LAUNCHES[route] == before[route] + 1
        # the same window with K1 reading E as stored: the f32 route
        a = fused_lp.window_inputs(s0, p, cfg, kw.get("nfactor"))
        record = kw.get("record", False)
        f = fused_lp.window_state(
            s0, p, cfg, 20, fused_lp.window_cuda(
                a._replace(E=p.E), cfg, s0.it, 20, 0, record), record)
        if kw.get("record"):
            (k, tk), (f, tf) = k, f
            assert torch.equal(tk, tf)
        for name in ("x", "z1", "z2", "z4", "y1", "y2", "y3", "ex",
                     "obj_ring", "obj_count", "done", "cur_obj",
                     "best_bin_obj", "best_sol"):
            assert torch.equal(getattr(k, name), getattr(f, name)), name
        pl = fused_lp.lp_window_plain(s0, p, cfg, 20, **kw)
        pl = pl[0] if kw.get("record") else pl
        assert (k.x - pl.x).abs().max().item() <= 1e-3


#: K1 on clusters at the l2f tails' shapes: (B, m, n, n side, 0/1
#: density); every other instance done
SPLITS = {"ca500-tail": (4, 256, 256, True, 0.02),
          "xl-tail": (2, 1664, 2048, False, 0.004)}
#: (shape, C): the factor's rows resident where they fit beside the
#: carve-up (the ca500 tail from C = 4), else streamed
SPLIT_CASES = [("ca500-tail", 2), ("ca500-tail", 4), ("ca500-tail", 8),
               ("xl-tail", 2), ("xl-tail", 4), ("xl-tail", 8)]
K1_STATE = ("x", "z1", "z2", "z4", "y1", "y2", "y3", "ex", "obj_ring",
            "obj_count", "done", "cur_obj", "best_bin_obj", "best_sol")


@pytest.fixture(scope="module")
def split_starts(cuda):
    out = {}
    for name, (B, m, n, nside, dens) in SPLITS.items():
        p = random_lp(cuda, B, m, n, dens, B)
        cfg = CFG.replace(incumbent_stride=8)
        s0 = lp.init_state(p, cfg)
        s0 = s0.replace(done=torch.arange(B, device=cuda) % 2 == 1)
        nf = None
        if nside:
            f = woodbury.factorize_nside(p.E, s0.free, 2.0)
            nf = (f.hinv, f.ete)
        out[name] = (p, cfg, s0, nf)
    return out


def _k1_run(a, s0, p, cfg, W=20):
    out = fused_lp.window_cuda(a, cfg, s0.it, W, 0)
    return fused_lp.window_state(s0, p, cfg, W, out, False)


@pytest.mark.parametrize("shape,C", SPLIT_CASES,
                         ids=[f"{s}-C{c}" for s, c in SPLIT_CASES])
def test_k1_cluster_matches_plain(split_starts, shape, C):
    """One instance on a cluster of C blocks, 20 iterations: within
    K1's limits of the plain version (the transpose products add the
    blocks' partials in another order), the same bits from a repeat
    launch, done instances' state returned as it came (their E x as the
    one-block launch gives it), and the one-block launch of the same
    operands still the f32-stream route's bits."""
    p, cfg, s0, nf = split_starts[shape]
    a = fused_lp.window_inputs(s0, p, cfg, nf)
    B, m, n = a.E.shape
    route = fused_lp.e_route(a.E)
    assert route == ("int8-resident" if shape == "ca500-tail"
                     else "int8-stream")
    assert fused_lp.factor_resident(m, n, route, C, nf is not None) == \
        (shape == "ca500-tail" and C > 2)
    ac = a._replace(cluster=C)
    k = _k1_run(ac, s0, p, cfg)
    again = _k1_run(ac, s0, p, cfg)
    one = _k1_run(a, s0, p, cfg)
    f32 = _k1_run(a._replace(E=p.E), s0, p, cfg)
    for name in K1_STATE:
        assert torch.equal(getattr(k, name), getattr(again, name)), name
        assert torch.equal(getattr(one, name), getattr(f32, name)), name
    pl = fused_lp.lp_window_plain(s0, p, cfg, 20, skip_cvg_at=0, nfactor=nf)
    for f in ("x", "y1", "y2", "y3", "ex", "best_sol"):
        assert (getattr(k, f) - getattr(pl, f)).abs().max().item() <= 1e-3, f
    dual_unit = gamma_at(pl.it - 1, cfg) * rho_at(pl.it - 1, cfg)
    for f in ("z1", "z2", "z4"):
        d = (getattr(k, f) - getattr(pl, f)).abs().max().item()
        assert d / dual_unit <= 1e-3, f
    for f in ("cur_obj", "best_bin_obj", "obj_ring"):
        ref = getattr(pl, f)
        d = (getattr(k, f) - ref).abs() / ref.abs().clamp_min(1.0)
        assert d.max().item() <= 1e-3, f
    assert torch.equal(k.done, pl.done)
    assert torch.equal(k.obj_count, pl.obj_count)
    d = s0.done
    frozen = {"x": s0.x, "y1": s0.x, "y2": s0.x, "y3": s0.f_eff,
              "z1": s0.z1, "z2": s0.z2, "z4": s0.z4, "best_sol": s0.best_sol,
              "obj_ring": s0.obj_ring, "obj_count": s0.obj_count,
              "cur_obj": s0.cur_obj, "best_bin_obj": s0.best_bin_obj,
              "ex": one.ex}
    for f, v in frozen.items():
        assert torch.equal(getattr(k, f)[d], v[d]), f


def test_k1_split_plan_on_the_card(split_starts, cuda):
    """The card's answers to the rule (its SM count, the clusters it
    holds at once) at the cells' shapes, and a counted launch through
    ``lp_window_fused`` taking the plan."""
    from lpbox_admm_tpu_torch.utils import profiling
    hw = fused_lp.card(cuda)
    assert hw.sms == torch.cuda.get_device_properties(cuda) \
        .multi_processor_count
    plan = lambda live, m, n, nside, route: fused_lp.split_plan(
        live, m, n, nside, route, hw.sms, hw.max_active)
    assert plan(128, 256, 512, False, "int8-resident") == 1
    assert plan(1, 256, 256, True, "int8-resident") == 8
    assert plan(32, 1664, 2048, False, "int8-stream") >= 2
    assert plan(None, 256, 256, True, "int8-resident") == 1
    p, cfg, s0, nf = split_starts["ca500-tail"]
    live = int((~s0.done).sum())
    t = profiling.PhaseTimer(cuda)
    before = dict(fused_lp.LAUNCHES)
    with t:
        fused_lp.lp_window_fused(s0, p, cfg, 20, skip_cvg_at=0, nfactor=nf,
                                 live=live)
    assert fused_lp.LAUNCHES["int8-resident"] == \
        before["int8-resident"] + 1
    C = plan(live, 256, 256, True, "int8-resident")
    assert t.notes["k1.split"] == [(live, C, fused_lp.sm_pct(live, C,
                                                             hw.sms))]


K2_NETS = [("mha", 20), ("mlp", 20), ("mha", 10), ("mlp", 10),
           ("mha", 5), ("mlp", 5)]


def k2_packed(cuda, net, T):
    """The shipped checkpoint at T = 20, else a seeded random module."""
    if T == 20:
        path = CKPT.replace("ca500_mha", f"ca500_{net}")
        return fused_policy.pack_policy_weights(load_policy(path,
                                                            device=cuda))
    torch.manual_seed(T)
    return fused_policy.pack_policy_weights(
        build_policy(net, node_size=T).to(cuda))


@pytest.mark.parametrize("mode", ["chunk", "sliding"])
@pytest.mark.parametrize("net,T", K2_NETS,
                         ids=[f"{n}-T{t}" for n, t in K2_NETS])
def test_k2_matches_plain(cuda, net, T, mode):
    """K2 at 1, 7 and 301 rows (block tails of both kernels): within
    1e-4 of its plain version, one launch counted a call, and a repeat
    launch gives the same bits."""
    pcfg = PolicyConfig(net=net, node_size=T, window_mode=mode)
    pk = k2_packed(cuda, net, T)
    op = fused_policy.policy_operand(pk)
    gen = torch.Generator(cuda).manual_seed(T)
    for n in (1, 7, 301):
        rows = torch.rand(n, 100, device=cuda, generator=gen)
        before = fused_policy.LAUNCHES
        sk = fused_policy.policy_scores_fused(pk, rows, pcfg, op)
        assert fused_policy.LAUNCHES == before + 1
        sp = fused_policy.policy_scores_plain(pk, rows,
                                              fused_policy.stride_of(pcfg))
        assert tuple(sk.shape) == (n,)
        assert (sk - sp).abs().max().item() <= 1e-4
        assert torch.equal(fused_policy.policy_scores_fused(pk, rows, pcfg,
                                                            op), sk)


def test_k2_matches_plain_past_a_policy_window(cuda):
    """65 536 + 3 rows (a CA-500 policy window and a tail), the operand
    made by the wrapper."""
    pcfg = PolicyConfig(net="mha")
    pk = k2_packed(cuda, "mha", 20)
    rows = torch.rand(65536 + 3, 100, device=cuda,
                      generator=torch.Generator(cuda).manual_seed(1))
    sk = fused_policy.policy_scores_fused(pk, rows, pcfg)
    sp = fused_policy.policy_scores_plain(pk, rows, 5)
    assert (sk - sp).abs().max().item() <= 1e-4


def k3_start(prob):
    """A carry at iteration 24 (rho steps at the next iteration)."""
    s, _ = lp.solve_window(lp.init_state(prob, CFG), prob, CFG, 24,
                           record=False, skip_cvg_at=0)
    return s, fused_stream._bootstrap(s, prob, CFG)


def k3_args(prob, s, carry, dtype):
    E = fused_stream.stream_operand(prob.E, CFG.replace(matvec_dtype=dtype))
    return fused_stream._sweep_args(carry, E, prob, s.free.float(), CFG)


@pytest.fixture(scope="module")
def prob500(cuda):
    """Two CA-500 instances, (256, 512): two column chunks per instance."""
    rng = np.random.RandomState(2207)
    insts = [ca.generate_cauction(rng, n_items=100, n_bids=500)
             for _ in range(2)]
    return ca.make_problem(insts, device=cuda)


@pytest.mark.parametrize("shape", ["ca60", "ca500"])
def test_k3_matches_plain(prob, prob500, shape):
    p = prob if shape == "ca60" else prob500
    s, carry = k3_start(p)
    before = fused_stream.LAUNCHES
    k = fused_stream.sweep_cuda(*k3_args(p, s, carry, "bfloat16"))
    assert fused_stream.LAUNCHES == before + 1
    ref = fused_stream.sweep_plain(*k3_args(p, s, carry, "float32"))
    for name, a, b in zip(ref._fields, k, ref):
        err = (a - b).abs().max().item() / max(1.0, b.abs().max().item())
        assert err <= 1e-4, (name, err)
    again = fused_stream.sweep_cuda(*k3_args(p, s, carry, "bfloat16"))
    f32 = fused_stream.sweep_cuda(*k3_args(p, s, carry, "float32"))
    for a, b, c in zip(k, again, f32):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("B, m, n", [(3, 200, 640), (2, 1100, 1024),
                                     (1, 2100, 256), (1, 4096, 256)])
def test_k3_matches_plain_off_tile_rows(cuda, B, m, n):
    """K3 at m that is not a multiple of the 256-row parts, the 480 rows
    of a forward pass or a warp's 32 rows, with units that split
    instances between blocks, and past m = 2036 (one 16-byte chunk per
    staged row; at m = 4096 two stages, no tile in flight): against the
    plain version, and bf16 / f32 E and a repeat launch bit for bit."""
    p = random_lp(cuda, B, m, n, 0.02, m)
    s, carry = k3_start(p)
    k = fused_stream.sweep_cuda(*k3_args(p, s, carry, "bfloat16"))
    ref = fused_stream.sweep_plain(*k3_args(p, s, carry, "float32"))
    for name, a, b in zip(ref._fields, k, ref):
        err = (a - b).abs().max().item() / max(1.0, b.abs().max().item())
        assert err <= 1e-4, (name, err)
    again = fused_stream.sweep_cuda(*k3_args(p, s, carry, "bfloat16"))
    f32 = fused_stream.sweep_cuda(*k3_args(p, s, carry, "float32"))
    for a, b, c in zip(k, again, f32):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_k3_window_matches_plain(prob):
    s0 = lp.init_state(prob, CFG)
    cfg = CFG.replace(matvec_dtype="bfloat16")
    before = fused_stream.LAUNCHES
    k = fused_stream.lp_window_stream(s0, prob, cfg, 20, skip_cvg_at=0)
    p = fused_stream.lp_window_stream_plain(s0, prob, cfg, 20, skip_cvg_at=0)
    assert fused_stream.LAUNCHES == before + 20 and k.it == p.it == 20
    for f in ("x", "y1", "y2", "y3", "ex", "best_sol"):
        assert (getattr(k, f) - getattr(p, f)).abs().max().item() <= 1e-3, f
    dual_unit = gamma_at(19, CFG) * rho_at(19, CFG)
    for f in ("z1", "z2", "z4"):
        d = (getattr(k, f) - getattr(p, f)).abs().max().item()
        assert d / dual_unit <= 1e-3, f
    assert bool((k.done == p.done).all())


@pytest.mark.parametrize("m", [384, 1664])
def test_k4_matches_plain(cuda, m):
    g = torch.Generator(cuda).manual_seed(m)
    A = torch.randn(2, m, m, device=cuda, generator=g) / m ** 0.5
    G = A @ A.transpose(1, 2) + torch.eye(m, device=cuda)
    v = torch.randn(2, m, device=cuda, generator=g)
    Gp = symm.pack_tril(G)
    before = symm.LAUNCHES
    y = symm.symm_matvec(Gp, v)
    assert symm.LAUNCHES == before + 1
    for ref in (symm.symm_matvec_plain(Gp, v),
                torch.bmm(G, v[..., None])[..., 0]):
        err = (y - ref).abs().max().item() / ref.abs().max().item()
        assert err <= 1e-5, err
    assert torch.equal(y, symm.symm_matvec_cuda(Gp, v))


PROBE_SHAPES = [
    (8, 256, 256),  # the probe's own
    (1, 5, 8),      # fewer rows than one 16-row tile of P2
    (3, 10, 260),   # P2's 16-row tiles span instances
    (64, 16, 64),   # P2's bt limit: 8 n-tiles
    (8, 256, 262),  # n % 4: 4-byte copies in P2, scalar loads in P1, P3
    (2, 8, 12292),  # past the 12288 floats of v the first P1 held
    (8, 1664, 4096),  # the xl block
    (3, 5, 1),      # n = 1: no step of P1 lies in one row
    (70000, 2, 8),  # bt past grid.y: P1 only (P2 and P3 refuse it)
]


@pytest.mark.parametrize("shape", PROBE_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("name", probe_dot.NAMES)
def test_probe_matches_plain(cuda, name, shape):
    E_np, v_np = probe_dot.make_inputs(*shape)
    E, v = torch.from_numpy(E_np).to(cuda), torch.from_numpy(v_np).to(cuda)
    bt = shape[0]
    if (name == "pairs" and bt > probe_dot.P2_BTMAX
            or name == "vpu" and bt > probe_dot.GRID_Y_MAX):
        with pytest.raises(ValueError, match="over"):
            probe_dot.matvec(name, E, v)
        return
    before = probe_dot.LAUNCHES[name]
    y = probe_dot.matvec(name, E, v)
    assert probe_dot.LAUNCHES[name] == before + 1
    want = torch.einsum("bmn,bn->bm", E.double(), v.double())
    scale = want.abs().max().item()
    for ref in (probe_dot.PLAIN[name](E, v).double(), want):
        assert (y.double() - ref).abs().max().item() <= 1e-5 * scale
    assert torch.equal(y, probe_dot.launch(name, E, v))


@pytest.fixture(scope="module")
def prob_xl(cuda):
    """Eight random 0/1 LPs at the xl rung's padded shape (1664, 4096)."""
    return random_lp(cuda, 8, 1664, 4096, 0.004, 0)


def test_k1_refuses_xl_shape(prob_xl):
    assert not fused_lp.fits(prob_xl.m, prob_xl.n)
    s0 = lp.init_state(prob_xl, CFG)
    before = dict(fused_lp.LAUNCHES)
    with pytest.raises(ValueError, match="232448 bytes"):
        fused_lp.lp_window_fused(s0, prob_xl, CFG, 2)
    torch.cuda.synchronize()
    assert fused_lp.LAUNCHES == before


def test_l2f_policy_window_at_xl(prob_xl):
    """One policy window where K1 cannot hold the shape: recorded by
    core.lp windows, scored by K2, fixed in {-1, 0, 1}."""
    cfg = CFG.replace(incumbent_stride=8)
    pcfg = PolicyConfig(net="mha", fix_confidence=0.98, fix_windows=1,
                        damage_gate=0.25)
    route = l2f._route(prob_xl.m, prob_xl.n, cfg)
    assert route == "windows"
    packed = fused_policy.pack_policy_weights(
        load_policy(CKPT, device=prob_xl.device))
    s0 = lp.init_state(prob_xl, cfg)
    zeros = torch.zeros(s0.x.shape, dtype=torch.int32, device=s0.x.device)
    k1, k2 = dict(fused_lp.LAUNCHES), fused_policy.LAUNCHES
    st, vec, streak1, streak0 = l2f._policy_window(
        s0, prob_xl, packed, cfg, pcfg, 100, route,
        l2f.fix_margins(prob_xl.b, prob_xl.var_mask, pcfg), zeros, zeros)
    torch.cuda.synchronize()
    assert fused_lp.LAUNCHES == k1 and fused_policy.LAUNCHES == k2 + 1
    assert st.it == 100 and vec.shape == (8, 4096)
    assert set(vec.unique().tolist()) <= {-1.0, 0.0, 1.0}
    assert not bool((~st.free & (vec < 0)).any())   # fixed only where told
    assert bool(torch.isfinite(st.x).all())


def _step_grads(model):
    return {n: p.grad.detach().double().cpu() for n, p in
            model.named_parameters()}


def test_train_step_on_card_matches_cpu(cuda):
    """One imitation step (3 micro-chunks, the last padded) from the
    shipped checkpoint with its Adam state, on the card and on the CPU:
    loss to 1e-5 relative, gradients to 1e-4 of max |g|."""
    from lpbox_admm_tpu_torch.train import imitation
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(700, 20, 5).astype(np.float32))
    lab = torch.from_numpy((rng.rand(700) > 0.5).astype(np.float32))
    w = torch.from_numpy(rng.rand(700).astype(np.float32))
    out = {}
    for dev in ("cpu", "cuda"):
        tr = imitation.PolicyTrainer(build_policy("mha"),
                                     PolicyConfig(net="mha"), CFG,
                                     micro_rows=256, device=dev)
        ts = tr.load(CKPT)
        ts, loss = tr.train_step(ts, x, lab, w)
        out[dev] = (float(loss), _step_grads(ts.model))
    (lc, gc), (lg, gg) = out["cpu"], out["cuda"]
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    G = max(float(g.abs().max()) for g in gc.values())
    assert max(float((gg[k] - gc[k]).abs().max()) for k in gc) <= 1e-4 * G


def test_masked_l2f_scores_with_k2(prob, monkeypatch):
    """The trainer's masked evaluation (``l2f_solve``) on the card scores
    every window through K2, never the module's forward, and fixes what
    the module's forward would: the same solve with the forward as its
    scorer fixes the same variables to the same values."""
    pcfg = PolicyConfig(net="mha", fix_confidence=0.6)
    model = load_policy(CKPT, device=prob.device)
    k2 = fused_policy.LAUNCHES
    st = l2f.l2f_solve(prob, model, CFG, pcfg, ws=100, max_iter=300)
    torch.cuda.synchronize()
    windows = st.it // 100      # fewer than 3 where every instance is done
    assert st.it % 100 == 0 and 1 <= windows <= 3
    assert windows == 3 or bool(st.done.all())
    assert fused_policy.LAUNCHES == k2 + windows
    assert bool(torch.isfinite(st.x).all())
    monkeypatch.setattr(l2f, "_scorer", lambda m, pc, dev, chunk: (
        lambda rows: l2f.policy_scores(m, rows, pc, chunk)))
    sp = l2f.l2f_solve(prob, model, CFG, pcfg, ws=100, max_iter=300)
    assert sp.it == st.it and fused_policy.LAUNCHES == k2 + windows
    assert int((~st.free & prob.var_mask).sum()) > 0
    assert torch.equal(st.free, sp.free)
    assert torch.equal(st.fixed_val, sp.fixed_val)

# --- the very-large rungs: struct E, the Schur inverse, bfloat16 E ------

@pytest.fixture(scope="module")
def struct_pair(cuda):
    """One CA 50x300 instance as a struct problem with its Schur inverse,
    on the card and on the CPU."""
    from lpbox_admm_tpu_torch.scripts import mega_l2f
    inst = ca.generate_cauction(np.random.RandomState(5), n_items=50,
                                n_bids=300, return_coo=True)
    return inst, mega_l2f.build_struct(inst, device=cuda), \
        mega_l2f.build_struct(inst, device="cpu")


def test_struct_products_and_schur_apply_match_cpu(struct_pair):
    """The struct gathers and the Schur apply on the card against the
    same on the CPU: 1e-6 of max |ref| (f32 sums in another order), and
    the apply unchanged by the caller's TF32 setting."""
    _, (pg, gg, _), (pc, gc, _) = struct_pair
    gen = torch.Generator().manual_seed(0)
    V = torch.rand(1, 3, pc.n, generator=gen)
    W = torch.randn(1, 2, pc.m, generator=gen)
    rel = lambda a, b: ((a.cpu() - b).abs().max() / b.abs().max()).item()
    assert rel(pg.E.mv_many(V.cuda()), pc.E.mv_many(V)) <= 1e-6
    assert rel(pg.E.mtv_many(W.cuda()), pc.E.mtv_many(W)) <= 1e-6
    ref = gc.apply(W[:, 0])
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf = gg.apply(W[:, 0].cuda())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert rel(tf, ref) <= 1e-6
    assert rel(gg.apply(W[:, 0].cuda()), ref) <= 1e-6


def test_bf16_emv_on_card_and_one_limb_plant(prob):
    """The three-limb products with cuBLAS's f32 output on the card
    against the float32 product: 1e-6 of max |ref|; one limb misses it."""
    gen = torch.Generator(prob.device).manual_seed(0)
    V = torch.rand(prob.batch, 2, prob.n, device=prob.device,
                   generator=gen) * 4 - 2
    W = torch.rand(prob.batch, 3, prob.m, device=prob.device,
                   generator=gen) * 200 - 100
    E16 = prob.E.to(torch.bfloat16)
    rel = lambda a, b: ((a - b).abs().max() / b.abs().max()).item()
    ref = lp._mv_many(prob.E, V)
    assert rel(lp._mv_many(E16, V), ref) <= 1e-6
    assert rel(lp._mtv_many(E16, W), lp._mtv_many(prob.E, W)) <= 1e-6
    one = lp._limbs3(V)[..., :1].permute(0, 2, 1, 3).reshape(
        prob.batch, prob.n, 2)
    assert rel(lp._bf16_bmm(E16, one).transpose(1, 2), ref) > 1e-4


def test_k2_at_mega_row_count(cuda):
    """K2 on 100 000 rows (the mega rung's policy window; not a multiple
    of either kernel's block) against its plain version."""
    pcfg = PolicyConfig(net="mha")
    pk = fused_policy.pack_policy_weights(load_policy(CKPT, device=cuda))
    rows = torch.rand(100000, 100, device=cuda,
                      generator=torch.Generator(cuda).manual_seed(2))
    sk = fused_policy.policy_scores_fused(pk, rows, pcfg)
    sp = fused_policy.policy_scores_plain(pk, rows, 5)
    assert (sk - sp).abs().max().item() <= 1e-4


def test_l2f_solve_struct_scores_through_k2(struct_pair):
    """``l2f_solve_struct`` on the card launches K2 once per policy window
    (counted), and its result is feasible."""
    from lpbox_admm_tpu_torch.scripts import mega_l2f
    from lpbox_admm_tpu_torch.train import l2f_struct
    inst, (pg, gg, rm), _ = struct_pair
    k2 = fused_policy.LAUNCHES
    out = l2f_struct.l2f_solve_struct(
        pg, gg, inst, rm[0], mega_l2f.make_scorer(CKPT, 100, "cuda"), CFG,
        policy_windows=3, cap=4000)
    assert fused_policy.LAUNCHES == k2 + 3
    assert out["infeasible"] == 0 and out["decided"] > 0


# --- segmentation (since the seg slice) --------------------------------------

def _seg_pair(cuda, H=24, W=32):
    """The same two synthetic images (the smoke's recipe) on the CPU and
    on the card."""
    import sys
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke
    from lpbox_admm_tpu_torch.adapters import segmentation as seg
    ims = chip_smoke.seg_images(3, 2, H, W)
    return (seg.make_problem(ims, device="cpu"),
            seg.make_problem(ims, device=cuda))


def test_qp_window_on_card_matches_cpu(cuda):
    """20 grid QP iterations on the card against the CPU: x and its
    copies to 1e-3 absolute, the duals to 1e-3 of gamma*rho."""
    from lpbox_admm_tpu_torch.config import SEG_CONFIG
    from lpbox_admm_tpu_torch.core import qp
    pc, pg = _seg_pair(cuda)
    sc, _ = qp.solve_window(qp.init_state(pc, SEG_CONFIG), pc, SEG_CONFIG,
                            20, record=False)
    sg, _ = qp.solve_window(qp.init_state(pg, SEG_CONFIG), pg, SEG_CONFIG,
                            20, record=False)
    unit = gamma_at(19, SEG_CONFIG) * rho_at(19, SEG_CONFIG)
    for f in ("x", "y1", "y2", "best_sol"):
        assert (getattr(sg, f).cpu() - getattr(sc, f)).abs().max() <= 1e-3, f
    for f in ("z1", "z2"):
        assert (getattr(sg, f).cpu() - getattr(sc, f)).abs().max() \
            <= 1e-3 * unit, f


def test_seg_l2f_scores_with_k2_at_stride_1(cuda):
    """The masked and the compacting seg l2f on the card launch K2 on
    the sliding windows and fix as the CPU's module forward does."""
    from lpbox_admm_tpu_torch.config import SEG_CONFIG
    ckpt = str(Path(CKPT).parents[2] / "seg_mha" / "checkpoint"
               / "best_checkpoint.npz")
    pcfg = PolicyConfig(node_size=5, chunk_dim=5, window_mode="sliding")
    pc, pg = _seg_pair(cuda)
    mc = load_policy(ckpt, node_size=5, chunk_dim=5, device="cpu")
    mg = load_policy(ckpt, node_size=5, chunk_dim=5, device=cuda)
    for solve in (l2f.l2f_solve, l2f.l2f_solve_compact_qp):
        fused_policy.LAUNCHES = 0
        sg = solve(pg, mg, SEG_CONFIG, pcfg, ws=10, max_iter=30)
        assert fused_policy.LAUNCHES > 0
        sc = solve(pc, mc, SEG_CONFIG, pcfg, ws=10, max_iter=30)
        fixed_g = (~sg.free & pg.mask).sum().item()
        fixed_c = (~sc.free & pc.mask).sum().item()
        assert fixed_c > 0 and abs(fixed_g - fixed_c) <= 0.02 * fixed_c


# --- sparse attack (since the attack slice) ----------------------------------

ATTACK_CKPT = str(Path(CKPT).parents[2] / "attack_mha" / "checkpoint"
                  / "best_checkpoint.npz")
VICTIM = str(Path(CKPT).parents[2] / "cifar_victim.npz")


def test_k2_at_attack_shape(cuda):
    """K2 on the attack's rows: B * 3072 = 24 576 rows of ws 50, 10
    tokens of 5 (chunk mode), attack_mha's weights: within 1e-4 of its
    plain version, one launch counted, a repeat launch the same bits."""
    pcfg = PolicyConfig(net="mha", node_size=10, chunk_dim=5)
    pk = fused_policy.pack_policy_weights(
        load_policy(ATTACK_CKPT, node_size=10, chunk_dim=5, device=cuda))
    op = fused_policy.policy_operand(pk)
    rows = torch.rand(8 * 3072, 50, device=cuda,
                      generator=torch.Generator(cuda).manual_seed(3))
    before = fused_policy.LAUNCHES
    sk = fused_policy.policy_scores_fused(pk, rows, pcfg, op)
    assert fused_policy.LAUNCHES == before + 1
    sp = fused_policy.policy_scores_plain(pk, rows, 5)
    assert (sk - sp).abs().max().item() <= 1e-4
    assert torch.equal(fused_policy.policy_scores_fused(pk, rows, pcfg, op),
                       sk)


def _attack_pair(cuda, n=2, segments=40):
    import sys
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke
    from lpbox_admm_tpu_torch.experiments import run_attack
    from lpbox_admm_tpu_torch.models import cifarnet
    imgs = chip_smoke.attack_images(5, n)
    Bm = run_attack.group_masks(imgs, segments)
    out = []
    for dev in ("cpu", cuda):
        model = cifarnet.load_victim_npz(VICTIM, device=dev)
        x = torch.from_numpy(imgs).to(dev)
        tg = torch.tensor([run_attack.target_of(int(t)) for t in
                           model(x - 0.5).argmax(-1)], device=dev)
        out.append((model, x, tg, torch.from_numpy(Bm).to(dev),
                    torch.ones_like(x)))
    return out


def test_g_window_on_card_matches_cpu(cuda):
    """20 G iterations on the card against the CPU: every state field
    within 1e-3."""
    from lpbox_admm_tpu_torch.adapters import attack
    from lpbox_admm_tpu_torch.config import ATTACK_CONFIG
    cfg = ATTACK_CONFIG.replace(maxIter_e=20)
    res = []
    for model, x, tg, Bm, nw in _attack_pair(cuda):
        lam = torch.full((x.shape[0],), 10.0, device=x.device)
        eps = attack.update_epsilon(model, x, tg, torch.zeros_like(x),
                                    torch.ones_like(x), nw, cfg, lambda1=lam)
        st, _ = attack.g_window(model, x, tg, eps,
                                attack.init_attack_state(torch.ones_like(x)),
                                Bm, nw, cfg, 20, lam, record=False)
        res.append(st)
    for f in ("G", "y1", "y2", "y3", "z1", "z2", "z3", "z4"):
        assert (getattr(res[1], f).cpu() - getattr(res[0], f)).abs().max() \
            <= 1e-3, f


def test_attack_l2f_scores_with_k2(cuda):
    """The l2f G update on the card launches K2 after each window but the
    last (2 of 3), on B * 3072 rows of 50."""
    from lpbox_admm_tpu_torch.adapters import attack
    from lpbox_admm_tpu_torch.config import ATTACK_CONFIG
    pcfg = PolicyConfig(net="mha", node_size=10, chunk_dim=5)
    model, x, tg, Bm, nw = _attack_pair(cuda)[1]
    policy = load_policy(ATTACK_CKPT, node_size=10, chunk_dim=5, device=cuda)
    lam = torch.full((x.shape[0],), 1e-3, device=cuda)
    before = fused_policy.LAUNCHES
    G = attack.update_g_l2f(model, x, tg, torch.zeros_like(x),
                            torch.ones_like(x), Bm, nw, ATTACK_CONFIG, lam,
                            policy_model=policy, pcfg=pcfg)
    assert fused_policy.LAUNCHES == before + 2
    assert bool(torch.isfinite(G).all())


def test_world1_nccl_shard_solve_gather(prob, tmp_path):
    """A world-1 NCCL group (``parallel.mesh``): the shard of the whole
    batch solved with K1 and gathered back through NCCL is the unsharded
    solve bit for bit, and the largest iteration count is its own."""
    import torch.distributed as dist
    from lpbox_admm_tpu_torch.parallel import mesh as pm
    ref = fused_lp.solve_fused(prob, CFG, max_iters=2000, window=100)
    mesh = pm.init_distributed(num_processes=1, process_id=0,
                               backend="nccl", device=prob.device,
                               init_method=f"file://{tmp_path}/store",
                               timeout_s=30)
    try:
        assert (mesh.world, mesh.backend) == (1, "nccl")
        st = fused_lp.solve_fused(pm.shard_batch(prob, mesh), CFG,
                                  max_iters=2000, window=100)
        got = pm.gather_batch({"obj": lp.objective(st), "x": st.x,
                               "done": st.done}, mesh)
        it = pm.all_reduce_max(st.it, mesh)
    finally:
        dist.destroy_process_group()
    assert torch.equal(got["obj"], lp.objective(ref))
    assert torch.equal(got["x"], ref.x) and torch.equal(got["done"], ref.done)
    assert it == ref.it
