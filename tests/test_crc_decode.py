"""CRC-aided acceptance and early termination (DecoderConfig.crc).

The reference's only integrity oracle is the LDPC syndrome
(``decodeCL.c:88-108``), which accepts any valid codeword — including wrong
ones (ML-type errors of weak codes).  With a CRC attached to the
information block (TS 38.212 §5.1), acceptance requires syndrome AND CRC:
wrong-codeword convergence is detected, rejected, and the decoder keeps
iterating those frames.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from myldpccppapi import Decoder, DecoderConfig, wimax
from myldpccppapi.codes.crc import CRC_POLYS, crc_attach_fn
from myldpccppapi.codes.regular import regular
from myldpccppapi.ops.bp import crc_fail_fn, decode_qc
from myldpccppapi.ops.crc_accept import decode_with_crc_accept
from myldpccppapi.parallel.sim import matmul_encode_fn, sim_step


@pytest.fixture(scope="module")
def wimax12():
    return wimax(576, "1/2")


def _frames(code, crc_name, n_frames=4, seed=0):
    """(llr_good, llr_bad): clean LLRs of codewords whose info blocks have a
    valid / invalid CRC field.  The 'bad' ones are VALID LDPC codewords (a
    syndrome-only decoder accepts them instantly) with a broken CRC — the
    wrong-codeword-convergence shape."""
    k_msg = code.k_info - CRC_POLYS[crc_name][0]
    attach = crc_attach_fn(k_msg, crc_name)
    rng = np.random.default_rng(seed)
    msg = rng.integers(0, 2, (n_frames, k_msg)).astype(np.int8)
    u_good = np.asarray(attach(jnp.asarray(msg)))
    u_bad = u_good.copy()
    u_bad[:, 3] ^= 1  # message bit flip => CRC field no longer matches
    enc = matmul_encode_fn(code)
    to_llr = lambda u: jnp.asarray(
        (1.0 - 2.0 * np.asarray(enc(jnp.asarray(u)))) * 4.0, jnp.float32
    )
    return to_llr(u_good), to_llr(u_bad)


@pytest.mark.parametrize("impl", ["jnp", "edgelist"])
@pytest.mark.parametrize("schedule", ["layered", "flooding"])
def test_crc_rejects_wrong_codeword(wimax12, impl, schedule):
    """A valid LDPC codeword with an invalid CRC must NOT be accepted; a
    valid one must be accepted on the first iteration."""
    llr_good, llr_bad = _frames(wimax12, "16")
    cfg = DecoderConfig(schedule=schedule, crc="16", implementation=impl,
                        max_iters=12)
    dec = Decoder(wimax12, cfg)

    r = dec(llr_good)
    assert bool(jnp.all(r.accepted)) and bool(jnp.all(r.converged))
    assert bool(jnp.all(r.iterations == 1))
    assert bool(jnp.all(r.ok))

    r = dec(llr_bad)
    # the syndrome converges (the bits ARE a codeword) but the CRC catches
    # the wrong codeword: rejected, and the decoder kept iterating to cap
    assert not bool(jnp.any(r.accepted))
    assert bool(jnp.all(r.converged))
    assert bool(jnp.all(r.iterations == cfg.max_iters))


def test_crc_accept_wrapper_bit_identical(wimax12):
    """The kernel wrapper (syndrome-only inner + CRC-aware retry,
    ops/crc_accept.py) must equal the in-loop CRC decoder exactly — the
    guarantee that lets the fused kernel stay CRC-free."""
    llr_good, llr_bad = _frames(wimax12, "16", n_frames=6)
    llr = jnp.concatenate([llr_good, llr_bad])
    cfg = DecoderConfig(schedule="layered", crc="16", implementation="jnp",
                        max_iters=10)
    inner = jax.jit(partial(decode_qc, wimax12,
                            dataclasses.replace(cfg, crc=None)))
    retry = partial(decode_qc, wimax12, cfg)
    fail = crc_fail_fn(wimax12, "16")

    wrapped = jax.jit(
        lambda x: decode_with_crc_accept(inner, retry, fail, x, cap=8)
    )(llr)
    direct = jax.jit(partial(decode_qc, wimax12, cfg))(llr)
    np.testing.assert_array_equal(np.asarray(wrapped.bits),
                                  np.asarray(direct.bits))
    np.testing.assert_array_equal(np.asarray(wrapped.accepted),
                                  np.asarray(direct.accepted))
    np.testing.assert_array_equal(np.asarray(wrapped.converged),
                                  np.asarray(direct.converged))
    np.testing.assert_array_equal(np.asarray(wrapped.iterations),
                                  np.asarray(direct.iterations))


def test_crc_accept_wrapper_fallback_path(wimax12):
    """More rejected frames than the straggler cap -> full-batch CRC-aware
    fallback; results still identical to the direct CRC decoder."""
    _, llr_bad = _frames(wimax12, "16", n_frames=12)
    cfg = DecoderConfig(schedule="layered", crc="16", implementation="jnp",
                        max_iters=6)
    inner = jax.jit(partial(decode_qc, wimax12,
                            dataclasses.replace(cfg, crc=None)))
    retry = partial(decode_qc, wimax12, cfg)
    fail = crc_fail_fn(wimax12, "16")
    wrapped = jax.jit(
        lambda x: decode_with_crc_accept(inner, retry, fail, x, cap=4)
    )(llr_bad)  # 12 rejected > cap=4
    direct = jax.jit(partial(decode_qc, wimax12, cfg))(llr_bad)
    np.testing.assert_array_equal(np.asarray(wrapped.accepted),
                                  np.asarray(direct.accepted))
    np.testing.assert_array_equal(np.asarray(wrapped.bits),
                                  np.asarray(direct.bits))


def test_crc_with_triage(wimax12):
    """Triage keys its straggler compaction on acceptance (not bare
    syndrome) so CRC-rejected frames get the full budget."""
    llr_good, llr_bad = _frames(wimax12, "16")
    llr = jnp.concatenate([llr_good, llr_bad])
    cfg = DecoderConfig(schedule="layered", crc="16", implementation="jnp",
                        max_iters=10, triage_iters=2, triage_cap_frac=0.9)
    r = Decoder(wimax12, cfg)(llr)
    single = Decoder(wimax12, dataclasses.replace(cfg, triage_iters=0))(llr)
    np.testing.assert_array_equal(np.asarray(r.accepted),
                                  np.asarray(single.accepted))
    np.testing.assert_array_equal(np.asarray(r.bits), np.asarray(single.bits))
    assert list(np.asarray(r.accepted)) == [True] * 4 + [False] * 4


def test_sim_step_detected_undetected_split():
    """At the config-1 operating point (weak (3,6) code, 2 dB) a measurable
    fraction of frames converges to WRONG codewords; CRC-aided acceptance
    must catch them all (undetected -> 0, crc_rejected > 0)."""
    code = regular(648)
    base = dict(algorithm="sum-product", schedule="flooding",
                implementation="jnp")
    key, snr = jax.random.PRNGKey(1), jnp.float32(2.0)

    cfg0 = DecoderConfig(**base)
    s0 = jax.jit(partial(sim_step, code, cfg0, batch=256))(key, snr)
    assert int(s0.undetected_errors) > 0          # the syndrome-only hole
    assert int(s0.crc_rejected) == 0

    cfg1 = DecoderConfig(**base, crc="16")
    s1 = jax.jit(partial(sim_step, code, cfg1, batch=256))(key, snr)
    assert int(s1.undetected_errors) == 0         # CRC closes it
    assert int(s1.crc_rejected) > 0               # ... by catching them
    assert int(s1.frame_errors) >= int(s1.crc_rejected)


def test_sim_step_crc_clean_at_high_snr(wimax12):
    """CRC attachment must not break the encode/decode roundtrip."""
    cfg = DecoderConfig(schedule="layered", crc="24B", implementation="jnp")
    s = jax.jit(partial(sim_step, wimax12, cfg, batch=64))(
        jax.random.PRNGKey(0), jnp.float32(7.0)
    )
    assert int(s.frame_errors) == 0
    assert int(s.unconverged) == 0
    assert int(s.undetected_errors) == 0
    assert int(s.crc_rejected) == 0


def test_campaign_reports_split(tmp_path):
    """PointStats carries the detected/undetected/crc_rejected split through
    accumulation, checkpointing, and CSV."""
    from myldpccppapi.campaign import CampaignConfig, WaterfallCampaign
    from myldpccppapi.parallel.sim import SimStats

    def fake_step(seed, snr_db):
        z = np.int64(0)
        return SimStats(frames=np.int64(100), frame_errors=np.int64(10),
                        bit_errors=np.int64(40), info_bits=np.int64(10000),
                        iterations=np.int64(500), unconverged=np.int64(6),
                        undetected_errors=np.int64(1),
                        crc_rejected=np.int64(3))

    ccfg = CampaignConfig(snr_db=[1.0], batch_per_step=100,
                          min_frame_errors=20, max_frames=1000)
    ck = str(tmp_path / "ck.json")
    camp = WaterfallCampaign(ccfg, fake_step, frames_per_step=100,
                             fingerprint="t", checkpoint_path=ck)
    camp.run()
    p = camp.points[0]
    assert p.undetected_errors == 2 * 1 and p.crc_rejected == 2 * 3
    assert p.detected_errors == p.frame_errors - p.undetected_errors

    # resume from checkpoint preserves the split fields
    camp2 = WaterfallCampaign(ccfg, fake_step, frames_per_step=100,
                              fingerprint="t", checkpoint_path=ck)
    assert camp2.points[0].undetected_errors == p.undetected_errors
    assert camp2.points[0].crc_rejected == p.crc_rejected

    out = tmp_path / "wf.csv"
    camp.write_csv(str(out))
    header = out.read_text().splitlines()[0]
    assert "undetected_errors" in header and "crc_rejected" in header


def test_decoder_config_validates_crc():
    with pytest.raises(ValueError):
        DecoderConfig(crc="23Z")


def test_crc_fail_fn_needs_room():
    """crc_fail_fn rejects codes whose info block cannot hold the CRC."""
    class Tiny:
        k_info = 16
        info_positions = np.arange(16)

    with pytest.raises(ValueError):
        crc_fail_fn(Tiny(), "24A")


@pytest.mark.parametrize("batch", [1, 3])
def test_crc_small_batches(wimax12, batch):
    """Tiny batches through the CRC-aided path (wrapper cap exceeds the
    batch => full-batch fallback branch; lane padding in play)."""
    llr_good, llr_bad = _frames(wimax12, "16", n_frames=4)
    llr = jnp.concatenate([llr_bad[:1], llr_good])[:batch]
    cfg = DecoderConfig(schedule="layered", crc="16", implementation="jnp",
                        max_iters=8)
    r = Decoder(wimax12, cfg)(llr)
    acc = np.asarray(r.accepted)
    assert acc.shape == (batch,)
    assert not acc[0]              # the forged frame
    if batch > 1:
        assert acc[1:].all()


def test_crc_without_early_exit(wimax12):
    """early_exit=False + CRC: the loop runs the full budget but the
    acceptance latch (and per-frame iteration counts) still reflect
    syndrome AND CRC."""
    llr_good, llr_bad = _frames(wimax12, "16")
    llr = jnp.concatenate([llr_good, llr_bad])
    cfg = DecoderConfig(schedule="layered", crc="16", implementation="jnp",
                        max_iters=6, early_exit=False)
    r = Decoder(wimax12, cfg)(llr)
    acc = np.asarray(r.accepted)
    assert acc[:4].all() and not acc[4:].any()
    assert (np.asarray(r.iterations)[:4] == 1).all()
    assert np.asarray(r.converged).all()   # all are valid codewords


# ---------------------------------------------------------------------------
# Outer-code (BCH) in-loop acceptance: DecoderConfig.outer
# ---------------------------------------------------------------------------


def _bch_frames(code, m, t, n_frames=4, seed=0):
    """(llr_good, llr_bad): clean LLRs of valid LDPC codewords whose info
    blocks carry a consistent / broken outer-BCH parity field."""
    from myldpccppapi.codes.bch import bch_attach_fn, bch_matrix

    par = bch_matrix(1, m, t).shape[1]
    k_msg = code.k_info - par
    attach = bch_attach_fn(k_msg, m, t)
    rng = np.random.default_rng(seed)
    msg = rng.integers(0, 2, (n_frames, k_msg)).astype(np.int8)
    u_good = np.asarray(attach(jnp.asarray(msg)))
    u_bad = u_good.copy()
    u_bad[:, 5] ^= 1  # message flip => parity field no longer matches
    enc = matmul_encode_fn(code)
    to_llr = lambda u: jnp.asarray(
        (1.0 - 2.0 * np.asarray(enc(jnp.asarray(u)))) * 4.0, jnp.float32
    )
    return to_llr(u_good), to_llr(u_bad)


@pytest.mark.parametrize("impl", ["jnp", "edgelist"])
def test_outer_bch_rejects_wrong_codeword(wimax12, impl):
    """cfg.outer folds the EN 302 307 BCH detection into the acceptance
    latch exactly like cfg.crc: a valid LDPC codeword with a broken BCHFEC
    is rejected and keeps decoding; a consistent one accepts in one
    iteration."""
    m, t = 9, 2
    llr_good, llr_bad = _bch_frames(wimax12, m, t)
    cfg = DecoderConfig(schedule="layered", outer=("bch", m, t),
                        implementation=impl, max_iters=12)
    dec = Decoder(wimax12, cfg)

    r = dec(llr_good)
    assert bool(jnp.all(r.accepted)) and bool(jnp.all(r.converged))
    assert bool(jnp.all(r.iterations == 1))

    r = dec(llr_bad)
    assert not bool(jnp.any(r.accepted))
    assert bool(jnp.all(r.converged))
    assert bool(jnp.all(r.iterations == cfg.max_iters))


def test_outer_bch_wrapper_matches_inloop(wimax12):
    """The fused-kernel wrapper path (syndrome-only inner + outer-aware
    retry) must equal the in-loop outer-aided jnp decoder exactly."""
    from myldpccppapi.ops.bp import accept_fail_fn
    from myldpccppapi.ops.crc_accept import decode_with_crc_accept

    m, t = 9, 2
    llr_good, llr_bad = _bch_frames(wimax12, m, t, n_frames=6)
    llr = jnp.concatenate([llr_good, llr_bad])
    cfg = DecoderConfig(schedule="layered", outer=("bch", m, t),
                        implementation="jnp", max_iters=10)
    ref = decode_qc(wimax12, cfg, llr)
    inner_cfg = dataclasses.replace(cfg, outer=None)
    inner = partial(decode_qc, wimax12, inner_cfg)
    retry = partial(decode_qc, wimax12, cfg)
    fail = accept_fail_fn(wimax12, cfg)
    res = decode_with_crc_accept(inner, retry, fail, llr, cap=8)
    np.testing.assert_array_equal(np.asarray(res.bits), np.asarray(ref.bits))
    np.testing.assert_array_equal(
        np.asarray(res.accepted), np.asarray(ref.accepted)
    )
    np.testing.assert_array_equal(
        np.asarray(res.iterations), np.asarray(ref.iterations)
    )


def test_sim_step_cfg_outer_reports_split(wimax12):
    """sim_step with cfg.outer attaches the BCHFEC and the undetected/
    rejected split comes from the decoder's own latch."""
    from myldpccppapi.parallel.sim import sim_step

    cfg = DecoderConfig(schedule="layered", normalization=0.75,
                        outer=("bch", 9, 2), implementation="jnp",
                        max_iters=20)
    stats = jax.jit(
        lambda k, s: sim_step(wimax12, cfg, k, s, 64)
    )(jax.random.PRNGKey(0), jnp.float32(6.0))
    assert int(stats.frames) == 64
    assert int(stats.frame_errors) == 0
    assert int(stats.undetected_errors) == 0


def test_cfg_crc_and_outer_compose(wimax12):
    """Both integrity checks may be configured; acceptance requires both."""
    from myldpccppapi.ops.bp import accept_fail_fn

    cfg = DecoderConfig(crc="16", outer=("bch", 9, 2))
    fail = accept_fail_fn(wimax12, cfg)
    bits = jnp.zeros((3, wimax12.n), jnp.uint8)  # all-zeros: both pass
    assert not bool(jnp.any(fail(bits)))
    bad = bits.at[:, 7].set(1)  # breaks both fields' consistency
    assert bool(jnp.all(fail(bad)))
