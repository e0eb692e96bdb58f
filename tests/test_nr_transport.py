"""TS 38.212 transport-block chain: planning, interleaving, bit selection,
segmentation roundtrips, CRC-aided acceptance with filler spans."""
import numpy as np
import pytest

import jax.numpy as jnp

from myldpccppapi.codes.nr_transport import (
    FILLER_LLR,
    NRTransport,
    _selection_runs,
    deinterleave_llr,
    interleave_bits,
    plan_tb,
    select_base_graph,
)
from myldpccppapi.utils.config import DecoderConfig


def _bpsk_llr(bits, scale=4.0):
    return (1.0 - 2.0 * np.asarray(bits, np.float32)) * scale


# ---------------------------------------------------------------------------
# Planning (§5.2.2 / §7.2.2 / §5.4.2.1 parameters)
# ---------------------------------------------------------------------------

def test_select_base_graph_rules():
    assert select_base_graph(200, 0.9) == 2        # A <= 292
    assert select_base_graph(3000, 0.5) == 2       # A <= 3824, R <= 0.67
    assert select_base_graph(3000, 0.8) == 1
    assert select_base_graph(10000, 0.2) == 2      # R <= 0.25
    assert select_base_graph(10000, 0.5) == 1


def test_tb_crc_size_threshold():
    assert plan_tb(3824, 15296).tb_crc == "16"
    assert plan_tb(3825, 15300).tb_crc == "24A"


def test_plan_single_block_bg1():
    fmt = plan_tb(1000, 3000, bg=1)
    assert (fmt.c, fmt.cb_crc) == (1, None)
    assert fmt.tb_crc == "16" and fmt.b == 1016
    assert fmt.k_prime == 1016
    # Kb=22: smallest 38.212 Z with 22Z >= 1016 is 48
    assert fmt.z == 48 and fmt.k == 22 * 48
    assert fmt.f == fmt.k - fmt.k_prime
    assert fmt.e_r == (3000,)


def test_plan_segmented_bg1():
    fmt = plan_tb(16000, 32000, bg=1)
    assert fmt.tb_crc == "24A" and fmt.b == 16024
    assert fmt.c == 2 and fmt.cb_crc == "24B"
    assert fmt.k_prime == 8012 + 24
    assert fmt.z == 384 and fmt.k == 8448  # 22*368 < 8036 and 368 not a Z
    assert fmt.pad == 0
    assert sum(fmt.e_r) == 32000


def test_plan_er_split_uneven():
    # G/(nl*qm) = 10000 over C=3 blocks: gamma = 10000 % 3 = 1 -> the LAST
    # block gets the ceil share (§5.4.2.1)
    fmt = plan_tb(20000, 10000, bg=1, qm=1)
    assert fmt.c == 3
    base = 10000 // 3
    assert fmt.e_r == (base, base, base + 1)
    assert sum(fmt.e_r) == 10000


def test_plan_kb_rules_bg2():
    # Kb by B = A + 16: 8 for 192 < B <= 560, 6 below
    fmt = plan_tb(100, 400, bg=2)
    assert fmt.b == 116
    assert fmt.k == 10 * fmt.z
    z6 = fmt.z
    assert 6 * z6 >= 116 and all(
        6 * z < 116 for z in (2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 14, 16, 18)
        if z < z6
    )
    fmt8 = plan_tb(500, 2000, bg=2)
    assert 8 * fmt8.z >= 516


def test_plan_rejects_bad_g():
    with pytest.raises(ValueError):
        plan_tb(1000, 3001, qm=2)


def test_crc_span_config_validation():
    with pytest.raises(ValueError):
        DecoderConfig(crc_span=100)  # crc_span without crc
    DecoderConfig(crc="24B", crc_span=100)  # ok


# ---------------------------------------------------------------------------
# §5.4.2.2 interleaver
# ---------------------------------------------------------------------------

def test_interleaver_known_pattern():
    e = jnp.arange(8)
    f = interleave_bits(e, qm=2)
    # f_{i+j*Qm} = e_{i*(E/Qm)+j}: [e0, e4, e1, e5, e2, e6, e3, e7]
    assert f.tolist() == [0, 4, 1, 5, 2, 6, 3, 7]


@pytest.mark.parametrize("qm", [1, 2, 4, 6, 8])
def test_interleaver_roundtrip(qm):
    rng = np.random.default_rng(qm)
    e = rng.standard_normal((3, 24 * qm)).astype(np.float32)
    out = deinterleave_llr(interleave_bits(jnp.asarray(e), qm), qm)
    np.testing.assert_array_equal(np.asarray(out), e)


# ---------------------------------------------------------------------------
# §5.4.2.1 bit selection runs
# ---------------------------------------------------------------------------

def test_selection_runs_skip_and_wrap():
    runs = _selection_runs(n_cb=10, f_start=3, f_stop=5, k0=8, e=12)
    walked = np.concatenate([np.arange(s, t) for (s, t) in runs])
    expect = [8, 9, 0, 1, 2, 5, 6, 7, 8, 9, 0, 1]
    assert walked.tolist() == expect
    assert all(not (3 <= s < 5) for (s, t) in runs)


def test_selection_runs_no_fillers():
    runs = _selection_runs(n_cb=8, f_start=0, f_stop=0, k0=2, e=8)
    walked = np.concatenate([np.arange(s, t) for (s, t) in runs])
    assert walked.tolist() == [2, 3, 4, 5, 6, 7, 0, 1]


def test_selection_runs_k0_inside_fillers():
    runs = _selection_runs(n_cb=10, f_start=2, f_stop=8, k0=4, e=4)
    walked = np.concatenate([np.arange(s, t) for (s, t) in runs])
    assert walked.tolist() == [8, 9, 0, 1]


# ---------------------------------------------------------------------------
# End-to-end roundtrips (CPU jnp decode)
# ---------------------------------------------------------------------------

def _roundtrip(fmt, batch=4, seed=0, scale=6.0, noise=0.0):
    t = NRTransport(fmt)
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 2, size=(batch, fmt.a), dtype=np.int64)
    tx = np.asarray(t.encode(jnp.asarray(payload)))
    assert tx.shape == (batch, fmt.g)
    llr = _bpsk_llr(tx, scale)
    if noise:
        llr = llr + rng.normal(0, noise, llr.shape).astype(np.float32)
    res = t.receive(jnp.asarray(llr))
    return t, payload, res


def test_roundtrip_single_block_bg2_small():
    fmt = plan_tb(200, 960, qm=2)
    assert fmt.bg == 2 and fmt.c == 1 and fmt.cb_crc is None
    t, payload, res = _roundtrip(fmt)
    assert bool(np.all(np.asarray(res.tb_ok)))
    np.testing.assert_array_equal(np.asarray(res.payload), payload)
    assert res.cb_ok.shape == (4, 1)


def test_roundtrip_single_block_bg1():
    fmt = plan_tb(1000, 2400, bg=1, qm=4)
    t, payload, res = _roundtrip(fmt)
    assert bool(np.all(np.asarray(res.tb_ok)))
    np.testing.assert_array_equal(np.asarray(res.payload), payload)


def test_roundtrip_segmented_bg2():
    # B = 3924 > 3840: two code blocks with CRC24B, in-loop crc_span
    fmt = plan_tb(3900, 8000, bg=2, qm=2)
    assert fmt.c == 2 and fmt.cb_crc == "24B" and fmt.pad == 0
    assert fmt.tb_crc == "24A"
    t, payload, res = _roundtrip(fmt, batch=2)
    assert t.decoder.config.crc == "24B"
    assert t.decoder.config.crc_span == fmt.k_prime
    assert bool(np.all(np.asarray(res.tb_ok)))
    assert np.asarray(res.cb_ok).all() and np.asarray(res.converged).all()
    np.testing.assert_array_equal(np.asarray(res.payload), payload)


def test_roundtrip_segmented_with_pad():
    # B' not divisible by C: the last block's data is zero-padded
    fmt = plan_tb(3901, 8000, bg=2, qm=2)
    assert fmt.c == 2 and fmt.pad == 1
    t, payload, res = _roundtrip(fmt, batch=2, seed=3)
    assert bool(np.all(np.asarray(res.tb_ok)))
    np.testing.assert_array_equal(np.asarray(res.payload), payload)


def test_roundtrip_rv2_with_repetition():
    # e > non-filler buffer: the circular walk wraps and the receiver
    # accumulates repeated positions; rv=2 starts mid-buffer
    fmt = plan_tb(200, 2880, qm=2, rv=2)
    assert fmt.e_r[0] > fmt.n_cb - fmt.f
    t, payload, res = _roundtrip(fmt, seed=5)
    assert bool(np.all(np.asarray(res.tb_ok)))
    np.testing.assert_array_equal(np.asarray(res.payload), payload)


def test_roundtrip_noisy():
    fmt = plan_tb(1000, 4000, bg=1, qm=2)
    t, payload, res = _roundtrip(fmt, batch=8, seed=7, scale=2.0, noise=1.0)
    assert bool(np.all(np.asarray(res.tb_ok)))
    np.testing.assert_array_equal(np.asarray(res.payload), payload)


def test_garbage_llr_flagged_not_ok():
    fmt = plan_tb(3900, 8000, bg=2, qm=2)
    t = NRTransport(fmt)
    rng = np.random.default_rng(11)
    llr = rng.normal(0, 1, size=(2, fmt.g)).astype(np.float32)
    res = t.receive(jnp.asarray(llr))
    assert not np.asarray(res.tb_ok).any()


def test_fillers_never_transmitted():
    fmt = plan_tb(3900, 8000, bg=2, qm=2)
    t = NRTransport(fmt)
    fs, fe = t._filler
    assert fe - fs == fmt.f
    for e, runs in t._runs.items():
        for (s, stop) in runs:
            assert stop <= fs or s >= fe


def test_filler_llr_asserted():
    fmt = plan_tb(200, 960, qm=2)
    t = NRTransport(fmt)
    llr = jnp.zeros((1, fmt.g), jnp.float32)
    blocks = np.asarray(t.llr_to_blocks(llr))
    fs, fe = t._filler
    p = 2 * fmt.z
    np.testing.assert_array_equal(
        blocks[0, 0, p + fs:p + fe], FILLER_LLR
    )
    # punctured front is neutral
    np.testing.assert_array_equal(blocks[0, 0, :p], 0.0)


def test_crc_span_catches_wrong_block():
    # decode result for a corrupted code block must fail its CRC24B even
    # though fillers are forced correct
    fmt = plan_tb(3900, 8000, bg=2, qm=2)
    t = NRTransport(fmt)
    rng = np.random.default_rng(13)
    payload = rng.integers(0, 2, size=(1, fmt.a))
    tx = np.asarray(t.encode(jnp.asarray(payload)))
    llr = _bpsk_llr(tx)
    # erase the second block's segment entirely: decoder sees only filler
    # certainty there and cannot converge to the true codeword
    off = fmt.e_r[0]
    llr[:, off:] = rng.normal(0, 0.1, size=(1, fmt.g - off))
    res = t.receive(jnp.asarray(llr))
    cb_ok = np.asarray(res.cb_ok)
    assert cb_ok[0, 0] and not cb_ok[0, 1]
    assert not bool(np.asarray(res.tb_ok)[0])
