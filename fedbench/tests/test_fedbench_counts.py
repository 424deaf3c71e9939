"""The frozen count functions against hand-worked values, and the shares
built on them bounded by 100% when a launch takes exactly its bound."""
import pytest

import _small  # noqa: F401  (the repo on the path)
from fedbench.counts import kernels as K
from fedbench.counts.models import logreg_step_flops
from fedbench.reference import mamba2 as ref_m


def test_bound_takes_the_larger_term():
    # 3.35e12 bytes is one second; 67e12 f32 flops is one second
    assert K.bound(3.35e12, 0.0) == pytest.approx(1.0)
    assert K.bound(0.0, 67e12) == pytest.approx(1.0)
    assert K.bound(3.35e12, 2 * 67e12) == pytest.approx(2.0)
    assert K.bound(0.0, 0.0, 33.5e12) == pytest.approx(1.0)


def test_kernel_counts_by_hand():
    C, D = 4, 8
    # server: read v and the due row, write v', the slot and 1 fired row
    assert K.server_bound(D, 1, arr=True, fired=1) == pytest.approx(
        max(4 * D * (2 + 3) / 3.35e12, (2 * D + D) / 67e12))
    # deliver: 2 of 4 rows taken
    assert K.deliver_bound(C, D, 2) == pytest.approx(
        (4 * (2 * D + 2 * D + D + C * D + C) + 9 * C) / 3.35e12)
    # the rows pass: 2 ring rows, 1 row done, 1 block
    assert K.rows_bound(C, D, 2, 1, 1) == pytest.approx(
        (4 * (2 * C * D + D + 2 * C + C + 2 * C * D + 2 * D) + C) / 3.35e12)
    assert K.finish_bound(3, 2, D) == pytest.approx(
        (4 * (3 * 2 * D + 2 * 2 * D) + 2) / 3.35e12)
    assert K.noise_bound(C, D, 2, clip=False) == pytest.approx(
        4 * (2 * C * D + 2 * D + 2 * C) / 3.35e12)
    # the in-kernel noise at one row: operations dominate
    hashed = D
    assert K.noise_prng_bound(1, D, 1) == pytest.approx(max(
        4 * (2 * D + 2) / 3.35e12, 16 * hashed / 67e12,
        119 * hashed / 33.5e12))


def test_model_flops_by_hand():
    assert logreg_step_flops(785) == 4710.0
    cfg = dict(n_layers=1, d_model=4, ssm_expand=2, ssm_head_dim=2,
               ssm_state=2, ssm_conv_width=2, vocab_size=10, ssm_chunk=2)
    # di 8, H 4, P 2, N 2, conv 12, proj 24; weights 4*24 + 8*4 + 12*2 + 10*4
    weights = 96 + 32 + 24 + 40
    # S 3 in chunks of 2 and 1: 3 + 1 causal pairs in a chunk, each
    # 2N + 2HP + 2H = 4 + 16 + 8; 3 tokens build and read the state of
    # N H P = 16 (64 each); 2 chunks carry it on (32 each)
    core = 4 * 28 + 3 * 64 + 2 * 32
    assert ref_m.step_flops(cfg, 1, 3) == pytest.approx(
        6 * weights * 3 + 3 * core)
    # two sequences: twice the work
    assert ref_m.step_flops(cfg, 2, 3) == pytest.approx(
        2 * ref_m.step_flops(cfg, 1, 3))


def test_mamba2_core_is_the_chunked_count_at_the_cells_size():
    """At mamba2-780m's widths, B 4 x S 2048 in chunks of 128: 16 chunks
    of 128 * 129 / 2 pairs, 16x fewer than the whole sequence's."""
    import json
    cfg = json.loads((_small.ROOT / "fedbench/configs/"
                      "mamba2_780m_l32.json").read_text())
    m = ref_m.dims(cfg)
    pairs = 4 * 16 * 128 * 129 / 2
    state = 128 * 48 * 64
    core = 32 * (pairs * (2 * 128 + 2 * 48 * 64 + 2 * 48)
                 + 8192 * 4 * state + 4 * 16 * 2 * state)
    weights = 32 * (1536 * m["proj"] + 3072 * 1536 + m["conv"] * 4) \
        + 50280 * 1536
    assert ref_m.step_flops(cfg, 4, 2048) == pytest.approx(
        6 * weights * 8192 + 3 * core)


class _Trace:
    def __init__(self, seconds):
        self.seconds = seconds
        self.ops = [(0, 1, "k")]
        self.window_s = 1.0
        self.busy_s = 1.0

    def seconds_matching(self, pattern):
        return self.seconds


def test_shares_reach_100_at_their_bound():
    from fedbench.metrics import mfu, tick_kernels_roofline as tkr
    launches = [("tick_deliver", dict(C=64, D=785, nt=64)),
                ("tick_scatter_rows", dict(C=64, D=785, G=2, nd=32, nblk=16)),
                ("server_apply", dict(D=785, A=1, arr=True, fired=1,
                                      hit=False, buffered=False,
                                      flush=False))]
    bound = sum(tkr._bound(k, a) for k, a in launches)
    share = tkr.read({"trace": _Trace(bound), "launches_host": launches})
    assert share == pytest.approx(100.0)
    assert tkr.read({"trace": _Trace(2 * bound),
                     "launches_host": launches}) == pytest.approx(50.0)
    # a window that does exactly the peak's flops in its wall
    ctx = {"useful_steps": 1000, "flops_per_step": 67e9, "wall_s": 1.0}
    assert mfu.read(ctx) == pytest.approx(100.0)
