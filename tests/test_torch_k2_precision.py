"""K2's arithmetic and its kernel operand, on the CPU.

K2 (``csrc/policy.cu``) runs every dense layer of the policy forward on
the TF32 tensor cores in three passes.  ``tc_forward`` here is the plain
version's math with each of those products taken on TF32-split
operands (embedding, attention and the last two classifier layers stay
in f32, as in the kernel), products summed exactly in float64: the
CPU-side reason for three passes.  Two splits: ``rna`` rounds hi and lo
to nearest (``cvt.rna``, the host's split of the classifier weights);
``trunc`` truncates both, as the kernel's in-register split does (hi
with its low bits cleared, lo read by the tensor core's top 19 bits).  The kernel's
weights, ``fused_policy.policy_operand``, are plain torch: their layout
is checked here against ``PackedPolicy`` element by element, and the
wrapper's refusals are checked on meta tensors (nothing launches)."""

import numpy as np
import pytest
import torch

from lpbox_admm_tpu_torch.adapters import ca as tca
from lpbox_admm_tpu_torch.config import LP_CONFIG
from lpbox_admm_tpu_torch.core import lp as tlp
from lpbox_admm_tpu_torch.models import fused_policy
from lpbox_admm_tpu_torch.models.policy import build_policy
from lpbox_admm_tpu_torch.utils.checkpoint import load_policy

from torch_port_util import CKPT, ca_instances, tf32_rna

K2_TOL = 1e-4          # chip_smoke.K2_TOL: kernel against plain, sigmoids


def _rna(x):
    return torch.from_numpy(tf32_rna(x.detach().numpy()))


def _trunc(x):
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _mm(a, w, passes, split):
    """a @ w on TF32 operands: hi*hi (one pass) or lo*hi + hi*lo + hi*hi
    (three), products and sums in float64, the result rounded to f32."""
    lead = a.shape[:-1]
    a = a.reshape(-1, a.shape[-1])
    tf = _rna if split == "rna" else _trunc
    ah, wh = tf(a), tf(w)
    out = ah.double() @ wh.double()
    if passes == 3:
        al, wl = tf(a - ah), tf(w - wh)
        out = al.double() @ wh.double() + ah.double() @ wl.double() + out
    return out.float().reshape(*lead, w.shape[-1])


def tc_forward(pk, rows, stride, passes, split="rna"):
    """``policy_scores_plain`` with q|k|v, the out-projection, the
    feed-forward and the classifier's first two layers on TF32."""
    def mm(a, w):
        return _mm(a, w, passes, split)

    T, E = pk.peb.shape
    C, L, H = pk.w_top.shape[0], pk.wqkv.shape[0], 8
    x = rows.float()
    R = x.shape[0]
    tok = torch.stack([x[:, t * stride:t * stride + C] for t in range(T)], 1)
    h = tok @ pk.w_top + pk.peb
    for l in range(L):
        q, k, v = mm(h, pk.wqkv[l]).reshape(R, T, 3, H, E // H).unbind(2)
        attn = torch.softmax(
            torch.einsum("rthd,rshd->rhts", q, k) / (E // H) ** 0.5, dim=-1)
        heads = torch.einsum("rhts,rshd->rthd", attn, v).reshape(R, T, E)
        h1 = (h + mm(heads, pk.wo[l])) * pk.g1[l] + pk.c1[l]
        ff = mm(torch.relu(mm(h1, pk.w1[l]) + pk.b1[l]), pk.w2[l]) + pk.b2[l]
        h = (h1 + ff) * pk.g2[l] + pk.c2[l]
    z = torch.relu(mm(h.reshape(R, T * E), pk.wc0) + pk.bc0)
    z = torch.relu(mm(z, pk.wc1) + pk.bc1)
    z = torch.relu(z @ pk.wc2 + pk.bc2)
    return torch.sigmoid((z * pk.w3).sum(-1) + pk.b3)


@pytest.fixture(scope="module")
def traj_rows():
    """320 recorded trajectory rows (ws = 100) of a small CA solve, the
    policy's own input."""
    prob = tca.make_problem(ca_instances(3, 4), device="cpu")
    cfg = LP_CONFIG.replace(linsolve="woodbury")
    st = tlp.init_state(prob, cfg)
    st, traj = tlp.solve_window(st, prob, cfg, 100, record=True)
    return traj.reshape(-1, 100)[:320].contiguous()


@pytest.mark.parametrize("split", ["rna", "trunc"])
@pytest.mark.parametrize("net", ["mha", "mlp"])
def test_k2_needs_three_tf32_passes(net, split, traj_rows):
    """On the shipped checkpoints and these 320 rows, three TF32 passes
    stay within 1e-5 of the f32 plain version (rna: 5.1e-7 for the MHA
    policy, 1.5e-7 for the MLP one; trunc: 1.4e-6 and 2.4e-7); one pass
    is off by 4.3e-4 on the MHA policy (trunc: 1.9e-3), which misses
    K2's 1e-4 tolerance, and by 5.9e-5 on the MLP one (trunc: 3.2e-4).
    Products of TF32 values are exact in f64, so this is the operands'
    rounding alone; the card's f32 accumulation adds what an f32 sum
    adds."""
    pk = fused_policy.pack_policy_weights(load_policy(CKPT[net],
                                                      device="cpu"))
    plain = fused_policy.policy_scores_plain(pk, traj_rows, 5)
    three = (tc_forward(pk, traj_rows, 5, 3, split) - plain
             ).abs().max().item()
    one = (tc_forward(pk, traj_rows, 5, 1, split) - plain
           ).abs().max().item()
    assert three <= 1e-5
    assert one > 10 * three
    if net == "mha":
        assert one > K2_TOL


def test_tf32_split_is_the_cards_rounding():
    """The operand's split (torch, on the bits) rounds as the test
    helper's ``cvt.rna`` emulation, and hi + lo gives x to 2^-21."""
    rng = np.random.RandomState(0)
    x = np.concatenate([rng.randn(4096) * 10.0 ** rng.randint(-6, 6, 4096),
                        [1 + 2.0 ** -11, -(1 + 2.0 ** -11), 0.0, 3.0]]
                       ).astype(np.float32)
    hi, lo = fused_policy.tf32_split(torch.from_numpy(x))
    assert np.array_equal(hi.numpy(), tf32_rna(x))
    assert np.array_equal(lo.numpy(), tf32_rna(x - tf32_rna(x)))
    err = np.abs(x.astype(np.float64) - hi.numpy() - lo.numpy())
    assert np.all(err <= np.abs(x) * 2.0 ** -21)


def _unfrag(flat, K, N):
    """Inverse of the fragment order, by index arithmetic: entry i of
    lane 4g + t at (k-step ks, m-tile mt) is w[8ks + 2t + i // 2,
    16mt + g + 8 (i % 2)]."""
    a = np.asarray(flat).reshape(K // 8, N // 16, 32, 4)
    ks, mt, lane, i = np.meshgrid(np.arange(K // 8), np.arange(N // 16),
                                  np.arange(32), np.arange(4),
                                  indexing="ij")
    g, t = lane // 4, lane % 4
    w = np.full((K, N), np.nan, np.float32)
    w[8 * ks + 2 * t + i // 2, 16 * mt + g + 8 * (i % 2)] = a
    return w


def _split_blocks(flat, K, N):
    """hi and lo of a hi|lo operand: 128 hi values, then 128 lo values,
    per (k-step, m-tile)."""
    a = np.asarray(flat).reshape(K // 8, N // 16, 2, 128)
    return (_unfrag(a[:, :, 0], K, N), _unfrag(a[:, :, 1], K, N))


@pytest.fixture(scope="module", params=["mha", "mlp", "mha-T5-F256"])
def packed(request):
    if request.param == "mha-T5-F256":
        torch.manual_seed(0)
        model = build_policy("mha", node_size=5)
        for layer in model.layers:        # F = 256: one feed-forward half
            layer.ff[0] = torch.nn.Linear(128, 256)
            layer.ff[2] = torch.nn.Linear(256, 128)
        return fused_policy.pack_policy_weights(model.eval())
    return fused_policy.pack_policy_weights(
        load_policy(CKPT[request.param], device="cpu"))


def test_operand_maps_back_to_packed_weights(packed):
    """Every block of the kernel operand is a reordering of a
    ``PackedPolicy`` block (exactly), in the encoder's stream order, and
    the classifier's hi|lo pairs are TF32 values summing to the weights
    to TF32-split accuracy."""
    op = fused_policy.policy_operand(packed)
    L, E = packed.wqkv.shape[:2]
    F = packed.w1.shape[-1]
    assert tuple(op.enc.shape) == (L, 4 * E * E + 2 * E * F)
    for l in range(L):
        parts = [(packed.wqkv[l][:, :2 * E], E, 2 * E),
                 (packed.wqkv[l][:, 2 * E:], E, E), (packed.wo[l], E, E)]
        for f0 in range(0, F, 256):
            parts += [(packed.w1[l][:, f0:f0 + 256], E, 256),
                      (packed.w2[l][f0:f0 + 256], 256, E)]
        at = 0
        for w, K, N in parts:
            got = _unfrag(op.enc[l, at:at + K * N].numpy(), K, N)
            assert np.array_equal(got, w.numpy())
            at += K * N
        assert at == op.enc.shape[1]
    for name in ("wc0", "wc1"):
        w = getattr(packed, name).numpy()
        hi, lo = _split_blocks(getattr(op, name).numpy(), *w.shape)
        assert getattr(op, name).numel() == 2 * w.size
        assert np.array_equal(hi, tf32_rna(w))
        for t in (hi, lo):
            assert not (t.view(np.uint32) & np.uint32(0x1FFF)).any()
        err = np.abs(w.astype(np.float64) - hi - lo)
        assert np.all(err <= np.abs(w) * 2.0 ** -21)


def _meta_packed(T=20, E=128, F=512, L=2, C=5):
    shapes = dict(w_top=(C, E), peb=(T, E), wqkv=(L, E, 3 * E),
                  wo=(L, E, E), g1=(L, E), c1=(L, E), w1=(L, E, F),
                  b1=(L, F), w2=(L, F, E), b2=(L, E), g2=(L, E), c2=(L, E),
                  wc0=(T * E, 256), bc0=(256,), wc1=(256, 128), bc1=(128,),
                  wc2=(128, 16), bc2=(16,), w3=(16,), b3=(1,))
    return fused_policy.PackedPolicy(**{
        k: torch.empty(s, device="meta") for k, s in shapes.items()})


@pytest.mark.parametrize("kw,ws,stride,match", [
    (dict(E=64), 100, 5, "E=128"),
    (dict(T=21), 105, 5, "T<=20"),
    (dict(F=384), 100, 5, "F%256"),
    (dict(), 99, 5, "exceed"),
    (dict(), 23, 1, "exceed"),
], ids=["E64", "T21", "F384", "chunk-short", "sliding-short"])
def test_kernel_refuses_shapes_before_launch(kw, ws, stride, match):
    """Shapes K2 does not take are refused before any launch (meta
    tensors: nothing is allocated, no kernel is built)."""
    before = fused_policy.LAUNCHES
    rows = torch.empty(7, ws, device="meta")
    with pytest.raises(ValueError, match=match):
        fused_policy.policy_scores_cuda(_meta_packed(**kw), rows, stride)
    assert fused_policy.LAUNCHES == before
