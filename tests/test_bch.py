"""Outer BCH code (codes/bch.py): field construction, matmul attach/check,
host-side Berlekamp-Massey correction, and the DVB-S2 concatenated flow."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from myldpccppapi.codes.bch import (
    _minimal_poly,
    bch_attach_fn,
    bch_check_fn,
    bch_correct,
    bch_generator,
    bch_params_dvbs2,
    bch_syndromes,
    smallest_primitive_poly,
)


def test_primitive_poly_and_minimal_polys():
    # classic smallest primitive polynomials
    assert smallest_primitive_poly(4) == 0b10011          # x^4+x+1
    assert smallest_primitive_poly(6) == 0b1000011        # x^6+x+1
    p = smallest_primitive_poly(6)
    # the minimal polynomial of alpha IS the primitive polynomial
    assert _minimal_poly(1, p, 6) == p
    # conjugates share a minimal polynomial
    assert _minimal_poly(2, p, 6) == p


def test_generator_degree_matches_standard_parity_sizes():
    """EN 302 307 Table 5a/5b BCH parity sizes: t errors cost exactly m*t
    parity bits for these fields (the standard's numbers)."""
    assert bch_params_dvbs2(16200, "1/2") == (14, 12, 168)
    assert bch_params_dvbs2(64800, "1/2") == (16, 12, 192)
    assert bch_params_dvbs2(64800, "2/3") == (16, 10, 160)
    assert bch_params_dvbs2(64800, "8/9") == (16, 8, 128)


def test_attach_check_roundtrip_and_detection():
    k, m, t = 40, 6, 2  # n = 52 <= 2^6 - 1 (shortened)
    att, chk = bch_attach_fn(k, m, t), bch_check_fn(k, m, t)
    rng = np.random.default_rng(0)
    u = rng.integers(0, 2, (16, k)).astype(np.int8)
    cw = np.asarray(att(jnp.asarray(u)))
    assert bool(jnp.all(chk(jnp.asarray(cw))))
    assert not bch_syndromes(cw, m, t).any()
    # any 1..2t-bit error pattern within the BCH distance is detected
    bad = cw.copy()
    bad[:, [3, 17, 40]] ^= 1
    assert not bool(jnp.any(chk(jnp.asarray(bad))))


@pytest.mark.parametrize("nerr", [1, 2])
def test_correct_up_to_t(nerr):
    k, m, t = 40, 6, 2
    att = bch_attach_fn(k, m, t)
    rng = np.random.default_rng(1)
    u = rng.integers(0, 2, (8, k)).astype(np.int8)
    cw = np.asarray(att(jnp.asarray(u)))
    bad = cw.copy()
    for r in range(8):
        pos = rng.choice(cw.shape[1], size=nerr, replace=False)
        bad[r, pos] ^= 1
    fixed, ok = bch_correct(bad, m, t)
    assert ok.all()
    np.testing.assert_array_equal(fixed, cw)


def test_overload_flagged_or_stays_a_codeword():
    """>t errors: BM either flags failure or miscorrects to a valid
    codeword (whose syndromes are zero) — never returns an inconsistent
    word claiming success."""
    k, m, t = 40, 6, 2
    att = bch_attach_fn(k, m, t)
    rng = np.random.default_rng(2)
    u = rng.integers(0, 2, (8, k)).astype(np.int8)
    cw = np.asarray(att(jnp.asarray(u)))
    bad = cw.copy()
    for r in range(8):
        bad[r, rng.choice(cw.shape[1], size=t + 2, replace=False)] ^= 1
    fixed, ok = bch_correct(bad, m, t)
    syn = bch_syndromes(fixed[ok], m, t)
    assert not syn.any()


@pytest.mark.slow
def test_dvbs2_short_frame_t12_correction():
    """Real DVB-S2 short-frame outer code: BCH(7200, 7032) t=12 over
    GF(2^14) — correct a full-weight-12 pattern exactly."""
    m, t, par = bch_params_dvbs2(16200, "1/2")
    k = 7200 - par
    att = bch_attach_fn(k, m, t)
    rng = np.random.default_rng(3)
    u = rng.integers(0, 2, (2, k)).astype(np.int8)
    cw = np.asarray(att(jnp.asarray(u)))
    bad = cw.copy()
    for r in range(2):
        bad[r, rng.choice(7200, size=12, replace=False)] ^= 1
    fixed, ok = bch_correct(bad, m, t)
    assert ok.all()
    np.testing.assert_array_equal(fixed, cw)


@pytest.mark.slow
def test_concatenated_dvbs2_flow():
    """The full DVB-S2 receive chain on the mini scale: message -> BCH
    attach -> LDPC encode -> AWGN -> LDPC decode -> BCH detect; a residual
    error pattern (unconverged LDPC frame) is repaired by the host BCH
    corrector when within t."""
    from myldpccppapi import Decoder, DecoderConfig
    from myldpccppapi.codes.dvbs2 import dvbs2, ira_encode_numpy

    code = dvbs2(16200, "1/2")   # k_ldpc = 7200 = n_bch
    m, t, par = bch_params_dvbs2(16200, "1/2")
    k_msg = code.k - par
    att = bch_attach_fn(k_msg, m, t)
    chk = bch_check_fn(k_msg, m, t)
    rng = np.random.default_rng(4)
    msg = rng.integers(0, 2, (4, k_msg)).astype(np.int8)
    u = np.asarray(att(jnp.asarray(msg)))            # BCHFEC = k_ldpc bits
    cw = ira_encode_numpy(code, u)
    sigma = 10 ** (-2.2 / 20)
    y = (1.0 - 2.0 * cw.astype(np.float32)) + rng.normal(
        0, sigma, cw.shape
    ).astype(np.float32)
    dec = Decoder(code, DecoderConfig(schedule="layered", normalization=0.85,
                                      max_iters=25))
    res = dec(jnp.asarray(2.0 * y / sigma**2))
    inner = np.asarray(res.bits)[:, : code.k]
    assert bool(jnp.all(chk(jnp.asarray(inner))))    # clean at 2.2 dB
    np.testing.assert_array_equal(inner[:, :k_msg], msg)

    # inject a residual 5-bit pattern (an IRA trapping-set shape) into one
    # decoded frame: BCH detects it and the host corrector repairs it
    dirty = inner.copy()
    dirty[0, rng.choice(code.k, size=5, replace=False)] ^= 1
    ok_mask = np.asarray(chk(jnp.asarray(dirty)))
    assert not ok_mask[0] and ok_mask[1:].all()
    fixed, ok = bch_correct(dirty[:1], m, t)
    assert ok.all()
    np.testing.assert_array_equal(fixed[0], inner[0])


def test_sim_step_outer_bch():
    """Campaign-level concatenated flow: sim_step(outer=("bch", m, t))
    attaches the BCHFEC parity and acceptance requires syndrome AND BCH
    detection (the --bch waterfall path)."""
    from functools import partial

    from myldpccppapi import DecoderConfig
    from myldpccppapi.codes.dvbs2 import dvbs2
    from myldpccppapi.parallel.sim import sim_step

    code = dvbs2(16200, "1/2")
    cfg = DecoderConfig(schedule="layered", normalization=0.85, max_iters=25)
    m, t, _ = bch_params_dvbs2(16200, "1/2")
    step = jax.jit(partial(sim_step, code, cfg, batch=8,
                           outer=("bch", m, t)))
    s = step(jax.random.PRNGKey(0), jnp.float32(2.4))
    assert int(s.frames) == 8
    assert int(s.frame_errors) == 0 and int(s.undetected_errors) == 0
    assert int(s.crc_rejected) == 0

    # cfg.crc and an outer code are mutually exclusive
    import pytest as _pytest

    with _pytest.raises(ValueError):
        sim_step(code, DecoderConfig(schedule="layered", crc="16"),
                 jax.random.PRNGKey(0), jnp.float32(3.0), 4,
                 outer=("bch", m, t))
