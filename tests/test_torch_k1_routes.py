"""K1's E routes (``ops.fused_lp``), on the CPU.

The wrapper hands K1 an exact one-byte (int8) copy of E where every
entry is an integer in [-127, 127], made once per solve, and keeps
float32 / bfloat16 otherwise; the one-byte E is resident in a thread
block's shared memory where it fits beside the vectors
(``resident_bytes``), else streamed.  The kernels run only on the card
(``tests/test_torch_cuda.py`` holds each one-byte route against the
f32 route bit for bit); here: the exactness test, the copy, the sizes in
closed form, the route rule, that ``smem_bytes``, ``fits`` and the l2f
route are unchanged by it, and that the one-byte operand gives the plain
version's f32 bits exactly.
"""

import pytest
import torch

from lpbox_admm_tpu_torch.config import LP_CONFIG
from lpbox_admm_tpu_torch.core import lp
from lpbox_admm_tpu_torch.ops import fused_lp
from lpbox_admm_tpu_torch.train import l2f

from torch_port_util import ca_instances, problems

CFG = LP_CONFIG.replace(linsolve="woodbury")


def _ca_E():
    return problems(ca_instances(3, 4))[1].E


def test_one_byte_exact_on_ca_and_not_otherwise():
    E = _ca_E()
    assert E.dtype == torch.float32
    assert set(E.unique().tolist()) <= {0.0, 1.0}
    E8 = fused_lp.one_byte_exact(E)
    assert E8 is not None and E8.dtype == torch.int8
    assert torch.equal(E8.float(), E)
    for bad in (0.5, 200.0, -128.0, float("nan")):
        Eb = E.clone()
        Eb[1, 3, 5] = bad
        assert fused_lp.one_byte_exact(Eb) is None, bad
    Es = E.clone()
    Es[0, 0, 0], Es[1, 0, 0] = -127.0, 127.0
    assert torch.equal(fused_lp.one_byte_exact(Es).float(), Es)


@pytest.mark.parametrize("path", ["solve", "l2f"])
def test_one_byte_copy_is_made_once_per_solve(path, monkeypatch):
    """The owner of E makes the one-byte copy once and every window
    reuses it: once for the plain solve's windows, once for each l2f
    phase (the policy windows on E, the tail on the compacted E)."""
    calls = []
    exact = fused_lp.one_byte_exact
    monkeypatch.setattr(fused_lp, "one_byte_exact",
                        lambda E: calls.append(E.shape) or exact(E))
    _, tp = problems(ca_instances(3, 4))
    if path == "solve":
        st = fused_lp.solve_fused(tp, CFG, max_iters=300, window=100)
        assert st.it == 300                  # three windows
        assert calls == [tp.E.shape]
        return
    from lpbox_admm_tpu_torch.config import PolicyConfig
    from lpbox_admm_tpu_torch.utils.checkpoint import load_policy
    from torch_port_util import CKPT
    tm = {}
    _, out = l2f.l2f_solve_compact(
        tp, load_policy(CKPT["mha"], device="cpu"),
        CFG.replace(incumbent_stride=8),
        PolicyConfig(net="mha", fix_confidence=0.98, fix_windows=2,
                     damage_gate=0.25),
        ws=100, max_iter=1500, min_bucket=32, policy_windows=3,
        timings=tm)
    assert tm["policy_route"] == tm["tail_route"] == "k1"
    assert tm["policy_e_route"] == tm["tail_e_route"] == "int8-resident"
    assert out["iterations"] > 400       # policy windows and tail windows
    assert len(calls) == 2 and calls[0] == tp.E.shape


# (m, n) -> bytes of a resident block: smem_bytes(m, n) + m n
RESIDENT = {(256, 512): 4 * 13124 + 131072,
            (1664, 2048): 4 * 45764 + 3407872}


@pytest.mark.parametrize("mn", sorted(RESIDENT))
def test_resident_need_closed_form(mn):
    m, n = mn
    assert fused_lp.resident_bytes(m, n) == RESIDENT[mn]
    assert fused_lp.resident_bytes(m, n) == \
        fused_lp.smem_bytes(m, n) + m * n
    # CA-500 holds its one-byte E (183 568 <= 232 448); the xl tail not
    assert fused_lp.resident_fits(m, n) == (mn == (256, 512))
    # the carve-up and the l2f route rule do not move
    assert fused_lp.fits(m, n)
    assert l2f._route(m, n) == "k1"
    assert l2f._route(1664, 4096) == "windows"


def test_routes_follow_data_and_shape():
    _, tp = problems(ca_instances(3, 4))
    m, n = tp.m, tp.n
    route_of = lambda p, c: fused_lp.e_route(
        fused_lp.window_operand(p.E, c))
    assert route_of(tp, CFG) == "int8-resident"
    bf = CFG.replace(matvec_dtype="bfloat16")
    assert route_of(tp, bf) == "int8-resident"
    half = tp.replace(E=tp.E.clone())
    half.E[0, 0, 0] = 0.5
    assert route_of(half, CFG) == "f32-stream"
    assert route_of(half, bf) == "bf16-stream"
    big = torch.zeros(1, 1664, 2048, dtype=torch.int8)
    assert fused_lp.e_route(big) == "int8-stream"
    assert fused_lp.e_route(torch.zeros(1, m, n, dtype=torch.int8)) == \
        "int8-resident"
    with pytest.raises(TypeError, match="int8"):
        fused_lp.e_route(torch.zeros(1, m, n, dtype=torch.float16))


@pytest.mark.parametrize("mode", ["mside-record", "nside"])
def test_one_byte_operand_gives_f32_bits(mode):
    """The plain version on the one-byte operand and on E as stored: the
    same bits in every output (the entries, products and sums are the
    same)."""
    _, tp = problems(ca_instances(5, 3))
    s0 = lp.init_state(tp, CFG.replace(incumbent_stride=8))
    cfg = CFG.replace(incumbent_stride=8)
    kw = {"record": mode.endswith("record"), "skip_cvg_at": 0}
    if mode == "nside":
        from lpbox_admm_tpu_torch.ops import woodbury
        nf = woodbury.factorize_nside(tp.E, s0.free, 2.0)
        kw["nfactor"] = (nf.hinv, nf.ete)
    win = fused_lp.window_inputs(s0, tp, cfg, kw.get("nfactor"))
    assert win.E.dtype == torch.int8
    a = fused_lp.window_plain(win, cfg, 0, 12, 0, kw["record"])
    b = fused_lp.window_plain(win._replace(E=tp.E), cfg, 0, 12, 0,
                              kw["record"])
    for f in a._fields:
        if getattr(b, f) is not None:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
