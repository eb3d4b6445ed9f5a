"""The port's learned-early-fixing solve against the JAX package (CPU).

``l2f_solve_compact`` (the JAX package's with ``use_fused=True``) with
the shipped ``ca500_mha`` checkpoint at the bench operating point, on
the 8-instance set of ``tests/test_pallas_lp.py``: per-instance
objectives within 6% (the JAX suite's own bar for fused vs unfused
l2f), binary solutions, equal infeasible counts.  The same on the
``core.lp`` windows route that shapes K1 cannot hold take, against the
JAX package's unfused branch; K1's shared-memory need that decides the
route.  Plus the fixing rules on the same inputs.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lpbox_admm_tpu.config import LP_CONFIG as JLP, PolicyConfig as JPC
from lpbox_admm_tpu.models.policy import build_policy as jbuild
from lpbox_admm_tpu.train import l2f as jl2f
from lpbox_admm_tpu_torch.config import LP_CONFIG as TLP, PolicyConfig as TPC
from lpbox_admm_tpu_torch.ops import fused_lp
from lpbox_admm_tpu_torch.train import l2f as tl2f
from lpbox_admm_tpu_torch.utils.checkpoint import load_policy

from torch_port_util import (CKPT, ca_instances, flax_variables_from_npz,
                             np_of, problems)

OP = dict(fix_confidence=0.98, fix_windows=2, damage_gate=0.25)


def _compact_both(use_fused):
    """Both packages' ``l2f_solve_compact`` on the 8-instance set; the
    JAX side fused or unfused, the port's route its own."""
    jp, tp = problems(ca_instances(3, 8))
    kw = dict(ws=100, max_iter=4000, min_bucket=32, policy_windows=3,
              repair_rounds=16, swap_rounds=4)
    _, oj = jl2f.l2f_solve_compact(
        jp, jbuild("mha"), flax_variables_from_npz(CKPT["mha"]),
        JLP.replace(linsolve="woodbury", incumbent_stride=8),
        JPC(net="mha", **OP), scorer="model", use_fused=use_fused, **kw)
    tm = {}
    _, ot = tl2f.l2f_solve_compact(
        tp, load_policy(CKPT["mha"], device="cpu"),
        TLP.replace(linsolve="woodbury", incumbent_stride=8),
        TPC(net="mha", **OP), timings=tm, **kw)
    return oj, ot, tm


def _assert_l2f_agrees(oj, ot, tm):
    o_j, o_t = np.asarray(oj["obj"]), np_of(ot["obj"])
    gap = np.abs(o_t - o_j) / np.abs(o_j)
    assert np.all(gap < 0.06), (o_t, o_j)
    assert set(np.unique(np_of(ot["solution"]))) <= {0.0, 1.0}
    np.testing.assert_array_equal(np_of(ot["infeasible"]),
                                  np.asarray(oj["infeasible"]))
    assert ot["iterations"] == int(oj["iterations"])
    assert tm["nside"] == (tm["buckets"][0] <= tm["buckets"][1])
    assert set(tm) >= {"policy_s", "tail_s"}


def test_l2f_compact_matches_jax():
    oj, ot, tm = _compact_both(use_fused=True)
    _assert_l2f_agrees(oj, ot, tm)
    assert tm["policy_route"] == tm["tail_route"] == "k1"
    # CA's 0/1 E is exact in one byte and small enough to stay resident
    assert tm["policy_e_route"] == tm["tail_e_route"] == "int8-resident"


def test_l2f_windows_route_matches_jax_unfused(monkeypatch):
    """With K1's limit at 0 no shape fits, so both phases take the
    ``core.lp`` windows route (never K1 or its plain version), held to
    the JAX package's ``use_fused=False`` branch."""
    monkeypatch.setattr(fused_lp, "_SMEM_MAX", 0)

    def no_k1(*a, **k):
        raise AssertionError("K1 route taken")

    monkeypatch.setattr(tl2f, "lp_window_fused", no_k1)
    monkeypatch.setattr(tl2f, "solve_fused_from", no_k1)
    oj, ot, tm = _compact_both(use_fused=False)
    _assert_l2f_agrees(oj, ot, tm)
    assert tm["policy_route"] == tm["tail_route"] == "windows"
    assert tm["policy_e_route"] is None and tm["tail_e_route"] is None


# (m, n) -> floats K1 needs: CA-500, the xl rung, xl with half the columns
K1_NEED = {(256, 512): 13124, (1664, 4096): 76484, (1664, 2048): 45764}


@pytest.mark.parametrize("mn", sorted(K1_NEED))
def test_k1_smem_need(mn):
    need = 4 * K1_NEED[mn]
    assert fused_lp.smem_bytes(*mn) == need
    assert fused_lp.fits(*mn) == (need <= 232448)


def test_k1_refuses_xl_before_launch():
    """The xl shape is refused by the wrapper's pre-launch check (on meta
    tensors: nothing is allocated or launched), naming need and limit."""
    with pytest.raises(ValueError, match="305936 bytes.*232448 bytes"):
        fused_lp.check_fits(1664, 4096)
    B, m, n, H = 1, 1664, 4096, TLP.history_size
    t = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt, device="meta")
    a = fused_lp.WindowIn(
        E=t(B, m, n), fac=t(B, m, m), ete=None, b=t(B, n), rmask=t(B, m),
        x=t(B, n), z1=t(B, n), z2=t(B, n), z4=t(B, m), f_eff=t(B, m),
        free=t(B, n), ring=t(B, H), count=t(B, dt=torch.int32),
        done=t(B, dt=torch.int32), cur_obj=t(B), best_obj=t(B),
        best_sol=t(B, n))
    with pytest.raises(ValueError, match="305936 bytes.*232448 bytes"):
        fused_lp.window_cuda(a, TLP.replace(linsolve="woodbury"), 0, 100)


def test_l2f_refuses_unported_fix_rules():
    """Fixing rules the port does not carry refuse instead of being
    ignored."""
    _, tp = problems(ca_instances(3, 2))
    model = load_policy(CKPT["mha"], device="cpu")
    cfg = TLP.replace(linsolve="woodbury", incumbent_stride=8)
    with pytest.raises(ValueError, match="fix_agree_gate"):
        tl2f.l2f_solve_compact(tp, model, cfg,
                               TPC(net="mha", fix_agree_gate=1), ws=100,
                               max_iter=400, policy_windows=1)


def test_l2f_metrics_match_jax():
    from lpbox_admm_tpu.core import lp as jlp
    from torch_port_util import torch_state
    jp, tp = problems(ca_instances(7, 4))
    cfg = JLP.replace(linsolve="woodbury")
    js = jlp.init_state(jp, cfg)
    js, _ = jlp.solve_window(js, jp, cfg, 300, record=False, skip_cvg_at=0)
    oracle = np.asarray(jlp.objective(js)) * 1.01
    mj = jl2f.l2f_metrics(js, jp, jnp.asarray(oracle))
    mt = tl2f.l2f_metrics(torch_state(js), tp, torch.from_numpy(oracle))
    assert mt["iterations"] == int(mj["iterations"])
    for k in ("infeasible", "n_fixed"):
        np.testing.assert_array_equal(np_of(mt[k]), np.asarray(mj[k]))
    for k in ("obj", "obj_gap"):
        np.testing.assert_allclose(np_of(mt[k]), np.asarray(mj[k]),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("gate,floor", [(0.0, 0.0), (0.25, 0.0),
                                        (0.5, 0.5)])
def test_fix_margins_match_jax(gate, floor):
    rng = np.random.RandomState(4)
    b = -rng.rand(3, 40).astype(np.float32) * 100
    b[:, 35:] = 0.0                                   # padded variables
    mask = np.ones((3, 40), bool)
    mask[:, 35:] = False
    kw = dict(fix_confidence=0.98, damage_gate=gate, damage_rank_floor=floor)
    mj = jl2f.fix_margins(jnp.asarray(b), jnp.asarray(mask), JPC(**kw))
    mt = tl2f.fix_margins(torch.from_numpy(b), torch.from_numpy(mask),
                          TPC(**kw))
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("mode", ["chunk", "sliding"])
def test_tokens_and_fix_vector_match_jax(mode):
    rows = np.random.RandomState(5).rand(6, 100).astype(np.float32)
    tj = jl2f.traj_to_tokens(jnp.asarray(rows), JPC(window_mode=mode))
    tt = tl2f.traj_to_tokens(torch.from_numpy(rows), TPC(window_mode=mode))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    sig = rows[:, 0]
    np.testing.assert_array_equal(
        tl2f.scores_to_vec(torch.from_numpy(sig), 0.9).numpy(),
        np.asarray(jl2f.scores_to_vec(jnp.asarray(sig), 0.9)))
