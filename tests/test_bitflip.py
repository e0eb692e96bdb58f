"""Noisy-GDBF bit-flipping decoder: convergence, latch semantics, and the
syndrome-validity contract (converged => valid codeword)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from myldpccppapi import Encoder, wimax
from myldpccppapi.codes import encode_numpy, rs_ldpc
from myldpccppapi.ops.bitflip import GDBFConfig, decode_gdbf
from myldpccppapi.ops.channel import transmit


def _case(code, batch, snr_db, seed=0, mats=None):
    enc = Encoder(code, mats)
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, size=(batch, enc.k), dtype=np.uint8)
    c = encode_numpy(enc.mats, u)
    llr, _ = transmit(jax.random.PRNGKey(seed), jnp.asarray(c), snr_db=snr_db)
    return u, c, jnp.asarray(llr)


def test_noiseless_converges_first_iteration():
    code = wimax(576, "1/2")
    u, c, _ = _case(code, 8, 8.0)
    llr = jnp.asarray((1.0 - 2.0 * c) * 4.0, jnp.float32)
    res = decode_gdbf(code, GDBFConfig(), llr)
    assert np.asarray(res.converged).all()
    assert (np.asarray(res.iterations) == 1).all()
    assert (np.asarray(res.bits)[:, : code.k] == u).all()


def test_awgn_high_snr_recovers():
    code = wimax(576, "1/2")
    u, c, llr = _case(code, 64, 7.0, seed=1)
    res = decode_gdbf(code, GDBFConfig(), llr, key=jax.random.PRNGKey(7))
    conv = np.asarray(res.converged)
    assert conv.mean() > 0.95
    got = np.asarray(res.bits)[:, : code.k]
    assert (got[conv] == u[conv]).mean() > 0.999


def test_converged_means_valid_codeword():
    code = wimax(576, "1/2")
    _, _, llr = _case(code, 64, 5.0, seed=2)  # below GDBF's comfort zone
    res = decode_gdbf(code, GDBFConfig(max_iters=40), llr)
    bits = np.asarray(res.bits)
    conv = np.asarray(res.converged)
    h = code.h_dense().astype(np.int64)
    syn = (bits.astype(np.int64) @ h.T) % 2
    assert not syn[conv].any()            # converged => syndrome clean
    if (~conv).any():
        assert syn[~conv].any(axis=1).all()  # unconverged => some check fails


def test_rs_ldpc_gdbf():
    # the classic bit-flipping application: the 10GBASE-T-class RS-LDPC
    code = rs_ldpc(s=4, gamma=4, rho=8)
    u, c, llr = _case(code, 32, 8.0, seed=3, mats=code.encoder_matrices)
    res = decode_gdbf(code, GDBFConfig(), llr, key=jax.random.PRNGKey(1))
    conv = np.asarray(res.converged)
    assert conv.mean() > 0.9
    got = np.asarray(res.bits)[:, np.asarray(code.info_positions)]
    np.testing.assert_array_equal(got[conv], u[conv])


def test_noise_escapes_stalls():
    # deterministic multi-flip GDBF oscillates on some patterns; the noisy
    # variant must converge strictly more frames at a mid-SNR point
    code = wimax(576, "1/2")
    _, _, llr = _case(code, 128, 6.0, seed=4)
    det = decode_gdbf(code, GDBFConfig(noise_scale=0.0, max_iters=60), llr)
    noisy = decode_gdbf(code, GDBFConfig(noise_scale=0.6, max_iters=60), llr,
                        key=jax.random.PRNGKey(3))
    assert (np.asarray(noisy.converged).sum()
            >= np.asarray(det.converged).sum())


def test_early_exit_false_runs_full_budget():
    code = wimax(576, "1/2")
    _, c, _ = _case(code, 4, 8.0, seed=5)
    llr = jnp.asarray((1.0 - 2.0 * c) * 4.0, jnp.float32)  # noiseless
    res = decode_gdbf(code, GDBFConfig(early_exit=False, max_iters=12), llr)
    assert int(res.total_iters) == 12
    assert np.asarray(res.converged).all()
    assert (np.asarray(res.iterations) == 1).all()  # latched at convergence

# ---------------------------------------------------------------------------
# user-surface wiring: Decoder facade + Coder "BF" decode type
# ---------------------------------------------------------------------------

def test_decoder_facade_gdbf():
    from myldpccppapi import Decoder

    code = wimax(576, "1/2")
    u, c, llr = _case(code, 32, 7.5, seed=6)
    dec = Decoder(code, GDBFConfig(max_iters=60))
    assert dec.implementation == "gdbf"
    res = dec(llr)
    conv = np.asarray(res.converged)
    assert conv.mean() > 0.95
    assert (np.asarray(dec.info_bits(res))[conv] == u[conv]).all()


def test_decoder_facade_gdbf_rejects_edgelist_codes():
    from myldpccppapi import Decoder
    from myldpccppapi.codes.dvbs2 import dvbs2_oracle

    with pytest.raises(ValueError, match="block-structured"):
        Decoder(dvbs2_oracle(16200, "1/2"), GDBFConfig())


def test_coder_bf_decode_type_roundtrip():
    from myldpccppapi import Coder

    coder = Coder(288, 576, "1/2")
    coder.for_encoder()
    coder.for_decoder(16)
    coder.add_decode_type("BF")
    src = np.arange(16 * coder._kb, dtype=np.uint8)
    prior = coder.encode(src)
    post = coder.test(prior, sigma=0.21, seed=0)  # ~7.5 dB: BF territory
    out = coder.decode(post, len(src), de_type="BF")
    np.testing.assert_array_equal(np.asarray(out), src)


def test_coder_bf_rejects_crc():
    from myldpccppapi import make_codec

    coder = make_codec("wimax", 576, "1/2", crc="16")
    coder.for_decoder(8)
    with pytest.raises(ValueError, match="BP-path"):
        coder.add_decode_type("BF")
