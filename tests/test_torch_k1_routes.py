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

K1's clusters: the rule that spreads an instance over C blocks where few
are live (``split_plan``) in closed form, on the H100's answers and on
a card that holds more clusters; ``solve_fused_from``'s one read a
window, now the live count that the rule takes; the traced l2f solve's
record of each launch's (live, C); recorded windows on one block.
"""

import pytest
import torch

from lpbox_admm_tpu_torch.config import LP_CONFIG
from lpbox_admm_tpu_torch.core import lp
from lpbox_admm_tpu_torch.ops import fused_lp
from lpbox_admm_tpu_torch.train import l2f
from lpbox_admm_tpu_torch.utils import profiling

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
    assert l2f._route(m, n, CFG) == "k1"
    assert l2f._route(1664, 4096, CFG) == "windows"


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


def h100(route, smem, c):
    """The H100's answer (``cudaOccupancyMaxActiveClusters`` on an H100
    80GB HBM3, PERF.md section 6): clusters of C blocks at one block an
    SM, as the cluster kernel's shared memory spreads them."""
    return {2: 66, 4: 30, 8: 15}[c]


def roomy(route, smem, c):
    """A card that holds every cluster its 132 SMs can take."""
    return 132 // c


# (live, m, n, n side, route, card) -> (C, factor rows resident)
PLANS = [
    # the ca500 policy windows: 128 live fill the card at C = 1
    ((128, 256, 512, False, "int8-resident", roomy), (1, False)),
    # the xl tail's first window: C = 4 where the card holds 32 clusters
    # of 4 at one block an SM; the H100 holds 30, so C = 2
    ((32, 1664, 2048, False, "int8-stream", roomy), (4, False)),
    ((32, 1664, 2048, False, "int8-stream", h100), (2, False)),
    ((8, 1664, 2048, False, "int8-stream", h100), (8, False)),
    # the ca500 tail's last instance: 8 blocks of 32 rows, factor resident
    ((1, 256, 256, True, "int8-resident", h100), (8, True)),
    # a share under 32 rows: 128 rows take at most 4 blocks
    ((1, 128, 128, True, "int8-resident", roomy), (4, True)),
    ((1, 256, 128, True, "int8-resident", roomy), (4, True)),
    # the H100 holds 30 clusters of 4 and 15 of 8 at once; at C = 2 the
    # factor's rows (256 KB a block) stream
    ((30, 256, 256, True, "int8-resident", h100), (4, True)),
    ((31, 256, 256, True, "int8-resident", h100), (2, False)),
    ((16, 256, 256, True, "int8-resident", h100), (4, True)),
    ((15, 256, 256, True, "int8-resident", h100), (8, True)),
    # no count, none live, or a route without a cluster kernel: one
    # block an instance
    ((None, 256, 256, True, "int8-resident", h100), (1, False)),
    ((0, 256, 256, True, "int8-resident", h100), (1, False)),
    ((1, 256, 256, True, "f32-stream", h100), (1, False)),
    ((1, 256, 256, True, "bf16-stream", roomy), (1, False)),
]


@pytest.mark.parametrize("args,want", PLANS,
                         ids=[f"{a[0]}-{a[1]}x{a[2]}-{a[5].__name__}"
                              for a, _ in PLANS])
def test_split_rule_closed_form(args, want):
    live, m, n, nside, route, hw = args
    C = fused_lp.split_plan(live, m, n, nside, route, 132, hw)
    res = fused_lp.factor_resident(m, n, route, C, nside)
    assert (C, res) == want
    if C > 1:
        need = fused_lp.window_bytes(m, n, route, C, res, nside)
        assert need <= fused_lp._SMEM_MAX
        assert live * C <= 132 and live <= hw(route, need, C)
        assert (min(m, n) if nside else m) >= 32 * C


def test_split_bytes_closed_form():
    """Shared memory of a cluster's block: the carve-up, the cluster sum's
    slot and the block sums' buffers, E^T u's exchange (m side), the
    factor's rows and the one-byte E's rows."""
    carve = fused_lp.smem_bytes
    assert fused_lp.window_bytes(256, 256, "int8-resident") == \
        fused_lp.resident_bytes(256, 256)
    assert fused_lp.window_bytes(1664, 2048, "int8-stream") == \
        carve(1664, 2048)
    assert fused_lp.window_bytes(256, 256, "int8-resident", 8, True,
                                 True) == carve(256, 256) + 464 \
        + 2 * 32 * 256 * 4 + 32 * 256
    assert fused_lp.window_bytes(1664, 2048, "int8-stream", 2) == \
        carve(1664, 2048) + 464 + 2 * 2048 * 4
    assert fused_lp.window_bytes(256, 512, "int8-resident", 8, True) == \
        carve(256, 512) + 464 + 2 * 512 * 4 + 32 * 256 * 4 + 32 * 512
    assert [fused_lp.share_rows(r, c) for r, c in
            ((256, 8), (1664, 4), (1664, 8), (52, 8), (100, 1))] == \
        [32, 416, 208, 8, 100]


def _card(monkeypatch, min_rows=None):
    monkeypatch.setattr(fused_lp, "card",
                        lambda dev: fused_lp.Card(132, roomy))
    if min_rows is not None:
        monkeypatch.setattr(fused_lp, "MIN_SHARE_ROWS", min_rows)


def test_solve_reads_live_count_once_a_window(monkeypatch):
    """One ``fused_lp.done`` read a window, as before; it is now the live
    count, handed to the window, whose plan it sets."""
    _card(monkeypatch, min_rows=4)
    _, tp = problems(ca_instances(3, 4))
    s0 = lp.init_state(tp, CFG)
    s0 = s0.replace(done=torch.tensor([False, True, False, True]))
    seen = []
    fused = fused_lp.lp_window_fused

    def spy(state, *args, live=None, **kw):
        seen.append((live, int((~state.done).sum())))
        return fused(state, *args, live=live, **kw)
    monkeypatch.setattr(fused_lp, "lp_window_fused", spy)
    t = profiling.PhaseTimer("cpu")
    with t:
        st = fused_lp.solve_fused_from(s0, tp, CFG, max_iters=300,
                                       window=100)
    assert st.it == 300
    assert t.reads()["fused_lp.done"] == 3
    assert len(seen) == 3 and seen[0] == (2, 2)
    assert all(type(v) is int and v == want for v, want in seen)
    plans = [fused_lp.split_plan(v, tp.m, tp.n, False, "int8-resident",
                                 132, roomy) for v, _ in seen]
    assert t.notes["k1.split"] == [
        (v, c, 100.0 * v * c / 132) for (v, _), c in zip(seen, plans)]
    assert t.notes["k1.split"][0][1] > 1
    # every instance done: one read, no window
    t2 = profiling.PhaseTimer("cpu")
    with t2:
        fused_lp.solve_fused_from(s0.replace(done=s0.done | True), tp, CFG,
                                  max_iters=300)
    assert t2.reads()["fused_lp.done"] == 1 and len(seen) == 3


def test_recorded_windows_never_split(monkeypatch):
    """A recorded window runs one block an instance whatever its count;
    the same window unrecorded takes the plan's cluster."""
    _card(monkeypatch, min_rows=4)
    _, tp = problems(ca_instances(3, 4))
    s0 = lp.init_state(tp, CFG)
    got = []
    plain = fused_lp.window_plain
    monkeypatch.setattr(fused_lp, "window_plain",
                        lambda a, *r, **k: got.append(a.cluster)
                        or plain(a, *r, **k))
    t = profiling.PhaseTimer("cpu")
    with t:
        fused_lp.lp_window_fused(s0, tp, CFG, 5, record=True, live=1)
        fused_lp.lp_window_fused(s0, tp, CFG, 5, live=1)
    assert got[0] == 1 and got[1] > 1
    assert t.notes["k1.split"] == [(1, 1, 100.0 / 132),
                                   (1, got[1], 100.0 * got[1] / 132)]


def test_l2f_timings_carry_the_splits(monkeypatch):
    """The traced l2f solve records each K1 launch's (live, C, share of
    the card's SMs): the policy windows (recorded, no count: the batch,
    C = 1), then the tail's windows at the counts its reads gave; the
    launches with C > 1 and the mean share of the card's SMs that
    live * C blocks take."""
    _card(monkeypatch, min_rows=4)
    from lpbox_admm_tpu_torch.config import PolicyConfig
    from lpbox_admm_tpu_torch.utils.checkpoint import load_policy
    from torch_port_util import CKPT
    _, tp = problems(ca_instances(3, 4))
    tm = {}
    st, _ = l2f.l2f_solve_compact(
        tp, load_policy(CKPT["mha"], device="cpu"),
        CFG.replace(incumbent_stride=8),
        PolicyConfig(net="mha", fix_confidence=0.98, fix_windows=2,
                     damage_gate=0.25),
        ws=100, max_iter=1500, min_bucket=32, policy_windows=3,
        timings=tm)
    splits = tm["k1_splits"]
    assert splits[:3] == [(4, 1, 400.0 / 132)] * 3
    tail = splits[3:]
    # a read before each tail window, and one more where all were done
    # before the cap
    assert tail and tm["host_read_sites"]["fused_lp.done"] == \
        len(tail) + (st.it < 1500)
    assert all(1 <= live <= 4 and c > 1 and p == 100.0 * live * c / 132
               for live, c, p in tail)
    assert tm["k1_split_launches"] == len(tail)
    assert tm["k1_sm_pct"] == pytest.approx(100 * sum(
        min(132, live * c) for live, c, _ in splits) / (132 * len(splits)))


def test_no_card_notes_no_share():
    """Off a card there is no SM count: the notes carry None for the
    share, and the l2f ``timings`` leave ``k1_sm_pct`` out.  The share
    in closed form."""
    assert fused_lp.card(torch.device("cpu")) is None
    assert [fused_lp.sm_pct(live, c, 132) for live, c in
            ((128, 1), (32, 2), (1, 8), (200, 1))] == \
        [100.0 * 128 / 132, 100.0 * 64 / 132, 100.0 * 8 / 132, 100.0]
    _, tp = problems(ca_instances(3, 4))
    t = profiling.PhaseTimer("cpu")
    with t:
        fused_lp.lp_window_fused(lp.init_state(tp, CFG), tp, CFG, 5, live=3)
    assert t.notes["k1.split"] == [(3, 1, None)]
