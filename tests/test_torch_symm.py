"""The port's packed symmetric G^{-1} matvec (K4's plain version) and its
packing against the JAX package's ``ops/symm_xla.py`` and
``ops/pallas_symm.py`` (interpret mode), and the stream window's
triangular route against the JAX package's.

Tolerances: the matvec 1e-5 relative to max |ref| (the same products,
f32 sums in another order); the 20-iteration window 1e-3 in the units of
x (``torch_port_util.state_errors``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpbox_admm_tpu.config import LP_CONFIG as JLP_CONFIG
from lpbox_admm_tpu.core import lp as jlp
from lpbox_admm_tpu.ops import pallas_stream, pallas_symm, symm_xla
from lpbox_admm_tpu_torch.config import LP_CONFIG
from lpbox_admm_tpu_torch.core import lp as tlp
from lpbox_admm_tpu_torch.ops import fused_stream, symm

from torch_port_util import (ca_instances, np_of, problems, state_errors,
                             torch_state)

CFG = LP_CONFIG.replace(linsolve="woodbury")
JCFG = JLP_CONFIG.replace(linsolve="woodbury")


def _spd(rng, B, m):
    A = rng.randn(B, m, m).astype(np.float32) / np.sqrt(m)
    return (A @ A.transpose(0, 2, 1) + np.eye(m, dtype=np.float32)) \
        .astype(np.float32)


@pytest.mark.parametrize("m", [256, 384])
def test_symm_matvec_plain_matches_jax(m):
    rng = np.random.RandomState(m)
    G = _spd(rng, 2, m)
    v = rng.randn(2, m).astype(np.float32)
    Gp = symm.pack_tril(torch.from_numpy(G))
    T = m // 128
    assert tuple(Gp.shape) == (2, T * (T + 1) // 2, 128, 128)
    np.testing.assert_array_equal(np_of(Gp),
                                  np.asarray(symm_xla.pack_tril(G)))
    np.testing.assert_array_equal(
        np_of(Gp), np.asarray(pallas_symm.pack_tril_blocks(
            jnp.asarray(G))).transpose(1, 0, 2, 3))
    got = np_of(symm.symm_matvec(Gp, torch.from_numpy(v)))
    assert torch.equal(symm.symm_matvec(Gp, torch.from_numpy(v)),
                       symm.symm_matvec_plain(Gp, torch.from_numpy(v)))
    dense = np.einsum("bij,bj->bi", G.astype(np.float64), v)
    refs = {"dense": dense,
            "symm_xla": np.asarray(symm_xla.symm_matvec(
                jnp.asarray(symm_xla.pack_tril(G)), jnp.asarray(v))),
            "pallas_symm": np.asarray(pallas_symm.symm_matvec(
                pallas_symm.pack_tril_blocks(jnp.asarray(G)),
                jnp.asarray(v), interpret=True))}
    for name, ref in refs.items():
        err = np.abs(got - ref).max() / np.abs(ref).max()
        assert err <= 1e-5, (name, err)


def _packable_batch():
    jp, tp = problems(ca_instances(5, 2, n_items=100, n_bids=200))
    assert tuple(tp.E.shape) == (2, 256, 256)
    return jp, tp


def test_stream_packed_sym_matches_jax(monkeypatch):
    """20 iterations with ``ginv_apply="packed-sym"`` against the JAX
    package's (its XLA symm_xla route); ``LPBOX_SYMM=1`` takes the same
    route in the port (bit for bit), and the explicit argument does
    without the environment variable."""
    jp, tp = _packable_batch()
    js0 = jlp.init_state(jp, JCFG)
    ts0 = torch_state(js0)
    sym, jsym = (CFG.replace(ginv_apply="packed-sym"),
                 JCFG.replace(ginv_apply="packed-sym"))
    ref = pallas_stream.lp_window_stream(js0, jp, jsym, 20, skip_cvg_at=0,
                                         interpret=True)
    got = fused_stream.lp_window_stream(ts0, tp, sym, 20, skip_cvg_at=0)
    errs = state_errors(got, ref, CFG)
    assert max(errs.values()) <= 1e-3, errs
    assert got.it == int(ref.it) == 20

    explicit = fused_stream.lp_window_stream(ts0, tp, CFG, 20, skip_cvg_at=0,
                                             symm_apply=True)
    monkeypatch.setenv("LPBOX_SYMM", "1")
    env = fused_stream.lp_window_stream(ts0, tp, CFG, 20, skip_cvg_at=0)
    dense = fused_stream.lp_window_stream(ts0, tp, CFG, 20, skip_cvg_at=0,
                                          symm_apply=False)
    for f in ("x", "z1", "z2", "z4", "ex", "best_sol"):
        assert torch.equal(getattr(env, f), getattr(got, f)), f
        assert torch.equal(getattr(explicit, f), getattr(got, f)), f
    # the dense route sums in another order: not the same bits
    assert not all(torch.equal(getattr(dense, f), getattr(got, f))
                   for f in ("x", "z1", "z2", "z4", "ex"))
    assert max(state_errors(dense, ref, CFG).values()) <= 1e-3


def test_stream_refuses_packed_sym_with_bf16_ginv():
    jp, tp = _packable_batch()
    s0 = tlp.init_state(tp, CFG)
    bad = CFG.replace(ginv_apply="packed-sym", ginv_dtype="bfloat16")
    with pytest.raises(ValueError, match="packed-sym"):
        fused_stream.lp_window_stream(s0, tp, bad, 10, skip_cvg_at=0)
    js0 = jlp.init_state(jp, JCFG.replace(ginv_dtype="bfloat16"))
    with pytest.raises(ValueError, match="packed-sym"):
        pallas_stream.lp_window_stream(
            js0, jp, JCFG.replace(ginv_apply="packed-sym",
                                  ginv_dtype="bfloat16"), 10,
            skip_cvg_at=0, interpret=True)
