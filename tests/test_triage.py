"""Two-phase straggler triage must be bit-identical to single-pass decode."""
import pytest
import jax
import jax.numpy as jnp
import numpy as np

from myldpccppapi import Decoder, DecoderConfig, Encoder, wimax
from myldpccppapi.codes import encode_numpy
from myldpccppapi.ops.channel import transmit


def _llr(code, batch, snr_db, seed=0):
    enc = Encoder(code)
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, size=(batch, code.k), dtype=np.uint8)
    c = encode_numpy(enc.mats, u)
    llr, _ = transmit(jax.random.PRNGKey(seed), jnp.asarray(c), snr_db=snr_db)
    return llr


def _assert_same(r0, r1):
    assert (np.asarray(r0.bits) == np.asarray(r1.bits)).all()
    assert (np.asarray(r0.converged) == np.asarray(r1.converged)).all()
    assert (np.asarray(r0.iterations) == np.asarray(r1.iterations)).all()


@pytest.mark.slow
def test_triage_identical_at_operating_point():
    code = wimax(576, "3/4B")
    llr = _llr(code, 64, snr_db=4.5)
    base = Decoder(code, DecoderConfig(schedule="layered", normalization=0.75))
    tri = Decoder(
        code, DecoderConfig(schedule="layered", normalization=0.75, triage_iters=4)
    )
    r0, r1 = base(llr), tri(llr)
    # the point must actually exercise the retry path: some stragglers
    assert 0 < (~np.asarray(r0.converged)).sum() <= 8  # < cap (64/8)
    _assert_same(r0, r1)


@pytest.mark.slow
def test_triage_fallback_when_over_capacity():
    """Far below threshold (>cap frames fail fast pass) the wrapper must
    fall back to the full-batch decode and still match exactly."""
    code = wimax(576, "3/4B")
    llr = _llr(code, 32, snr_db=0.5, seed=1)
    base = Decoder(code, DecoderConfig(schedule="layered"))
    tri = Decoder(code, DecoderConfig(schedule="layered", triage_iters=4))
    r0, r1 = base(llr), tri(llr)
    assert (~np.asarray(r0.converged)).sum() > 4  # over the cap of 32/8
    _assert_same(r0, r1)


def test_triage_noop_when_cap_covers_batch():
    code = wimax(576, "1/2")
    llr = _llr(code, 8, snr_db=4.0, seed=2)
    tri = Decoder(
        code,
        DecoderConfig(schedule="layered", triage_iters=4, triage_cap_frac=2.0),
    )
    base = Decoder(code, DecoderConfig(schedule="layered"))
    _assert_same(base(llr), tri(llr))


def test_triage_applies_to_edgelist():
    """triage_iters must not be silently dropped on the edge-list path:
    results stay bit-identical to single-pass (regression: the wrapper was
    gated to the fused kernels and jnp only)."""
    import dataclasses

    import jax.numpy as jnp

    from myldpccppapi import Decoder, DecoderConfig
    from myldpccppapi.codes.dvbs2 import dvbs2_oracle

    code = dvbs2_oracle(16200, "8/9")
    rng = np.random.default_rng(2)
    u = rng.integers(0, 2, size=(8, code.k), dtype=np.uint8)
    c = code.encode_numpy(u)
    sigma = 10 ** (-6.0 / 20)
    y = (1.0 - 2.0 * c.astype(np.float32)) + rng.normal(
        0, sigma, c.shape
    ).astype(np.float32)
    llr = jnp.asarray(2.0 * y / sigma**2)
    cfg = DecoderConfig(schedule="layered", normalization=0.8, max_iters=20,
                        triage_iters=3, triage_cap_frac=0.9)
    dec = Decoder(code, cfg)
    assert dec.implementation == "edgelist"
    r = dec(llr)
    single = Decoder(code, dataclasses.replace(cfg, triage_iters=0))(llr)
    np.testing.assert_array_equal(np.asarray(r.bits), np.asarray(single.bits))
    np.testing.assert_array_equal(np.asarray(r.iterations),
                                  np.asarray(single.iterations))
