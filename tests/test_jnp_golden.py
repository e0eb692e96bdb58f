"""The jnp decode path against the native C++ golden decoders on small
random QC codes: plain and odd lifting sizes, multi-edge base cells and
row-masked partial circulants (the DVB-S2 accumulator shapes), per-frame
early-exit latching, batch independence, and latched soft output."""
import jax.numpy as jnp
import numpy as np
import pytest

from myldpccppapi import Decoder, DecoderConfig, native
from myldpccppapi.codes.qc import QCCode
from myldpccppapi.ops.bp import decode_qc

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native lib not built")


def _random_qc(z, m_b=4, n_b=9, seed=7, extra=False, masked=False):
    """Small QC code with a staircase parity part (BP parity tests decode
    random LLRs, not codewords)."""
    rng = np.random.default_rng(seed)
    k_b = n_b - m_b
    base = np.full((m_b, n_b), -1, dtype=np.int32)
    for i in range(m_b):
        for j in rng.choice(k_b, size=3, replace=False):
            base[i, j] = int(rng.integers(0, z))
        base[i, k_b + i] = 0
        if i + 1 < m_b:
            base[i + 1, k_b + i] = int(rng.integers(0, z))
    extra_blocks = masked_rows = None
    if extra:
        # a second circulant inside an existing base cell (multi-edge block)
        i, j = 1, int(np.nonzero(base[1][:k_b] >= 0)[0][0])
        extra_blocks = ((i, j, (int(base[i, j]) + 5) % z),)
    if masked:
        # a partial circulant: the DVB-S2 wrap-block shape (one row short)
        i, j, s = 0, k_b + m_b - 1, z - 1
        base[i, j] = s
        masked_rows = (((i, j, s), (0,)),)
    return QCCode(name=f"test_z{z}", base=base, z=z,
                  extra_blocks=extra_blocks, masked_rows=masked_rows)


def _llr(code, batch, seed=0, mean=0.8):
    rng = np.random.default_rng(seed)
    return rng.normal(mean, 2.0, (batch, code.n)).astype(np.float32)


def _golden(code, cfg, llr):
    fn = (native.decode_golden_layered_native if cfg.schedule == "layered"
          else native.decode_golden_flooding_native)
    return fn(code, llr, max_iters=cfg.max_iters,
              normalization=cfg.normalization, offset=cfg.offset)


def _assert_golden(res, gold):
    gb, gc, gi = gold
    np.testing.assert_array_equal(np.asarray(res.converged), gc)
    np.testing.assert_array_equal(np.asarray(res.iterations), gi)
    np.testing.assert_array_equal(np.asarray(res.bits), gb)


@pytest.mark.parametrize("z", [128, 150])
def test_jnp_matches_golden_random_qc(z):
    """A lifting size that is a power of two and one that is not."""
    code = _random_qc(z)
    cfg = DecoderConfig(schedule="layered", normalization=0.75, max_iters=12)
    llr = _llr(code, batch=16)
    _assert_golden(decode_qc(code, cfg, jnp.asarray(llr)),
                   _golden(code, cfg, llr))


def test_jnp_batch_independence():
    """A frame decodes the same alone, in a small batch, and in a larger
    one (no padding or batch coupling leaks into per-frame results)."""
    code = _random_qc(128)
    cfg = DecoderConfig(schedule="layered", max_iters=10)
    llr = _llr(code, batch=16, seed=3)
    full = decode_qc(code, cfg, jnp.asarray(llr))
    part = decode_qc(code, cfg, jnp.asarray(llr[:5]))
    for f in ("bits", "converged", "iterations"):
        np.testing.assert_array_equal(np.asarray(getattr(part, f)),
                                      np.asarray(getattr(full, f))[:5])
    _assert_golden(part, _golden(code, cfg, llr[:5]))


@pytest.mark.parametrize("schedule", ["layered", "flooding"])
def test_jnp_multi_edge_and_masked_blocks(schedule):
    """Multi-edge base cells + row-masked partial circulants decode
    bit-identically to the golden in both schedules."""
    code = _random_qc(150, extra=True, masked=True)
    assert code.num_blocks == np.count_nonzero(code.base >= 0) + 1
    assert code.num_edges == code.num_blocks * code.z - 1
    cfg = DecoderConfig(schedule=schedule, normalization=0.8, max_iters=12)
    llr = _llr(code, batch=8, seed=5)
    _assert_golden(decode_qc(code, cfg, jnp.asarray(llr)),
                   _golden(code, cfg, llr))


def test_jnp_early_exit_latching():
    """A converged codeword's bits/iterations latch while stragglers keep
    iterating, and its syndrome stays satisfied."""
    code = _random_qc(128, seed=11)
    cfg = DecoderConfig(schedule="layered", max_iters=15)
    llr = _llr(code, batch=8, seed=9, mean=2.5)
    res = decode_qc(code, cfg, jnp.asarray(llr))
    _assert_golden(res, _golden(code, cfg, llr))
    conv = np.asarray(res.converged)
    assert 0 < conv.sum() < len(conv), "need both converged and stragglers"
    assert int(res.total_iters) == cfg.max_iters
    assert not code.syndrome(np.asarray(res.bits)[conv]).any()


@pytest.mark.parametrize("structure", ["plain", "multi_edge_masked"])
def test_jnp_soft_output_latched(structure):
    """Posterior output latched at each frame's convergence: the hard
    trajectory is the golden's, the posterior signs are the bits, and a
    converged frame's posterior is the one a decode capped at that frame's
    iteration count ends with."""
    extra = masked = structure != "plain"
    code = _random_qc(150 if extra else 128, extra=extra, masked=masked)
    cfg = DecoderConfig(schedule="layered", normalization=0.75, max_iters=10,
                        soft_output=True)
    llr = _llr(code, batch=16, mean=2.5 if extra else 3.25)
    res = Decoder(code, cfg)(jnp.asarray(llr))
    _assert_golden(res, _golden(code, cfg, llr))
    post = np.asarray(res.posteriors)
    assert post.shape == (16, code.n)
    np.testing.assert_array_equal((post <= 0).astype(np.uint8),
                                  np.asarray(res.bits))
    iters = np.asarray(res.iterations)
    conv = np.asarray(res.converged)
    assert 0 < conv.sum() < len(conv), "need both converged and stragglers"
    for t in sorted(set(iters[conv].tolist()))[:2]:
        capped = Decoder(code, DecoderConfig(
            schedule="layered", normalization=0.75, max_iters=t,
            soft_output=True))(jnp.asarray(llr))
        sel = conv & (iters == t)
        np.testing.assert_array_equal(post[sel],
                                      np.asarray(capped.posteriors)[sel])
