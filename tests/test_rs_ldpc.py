"""RS-based LDPC (802.3an family): construction invariants, girth, the
(2048, 1723) dimension check, and the end-to-end edge-list decode."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from myldpccppapi import Decoder, DecoderConfig
from myldpccppapi.codes.encoder import Encoder, encode_numpy
from myldpccppapi.codes.rs_ldpc import gf2m_tables, rs_ldpc
from myldpccppapi.ops.channel import transmit


def _small():
    # GF(16), (4, 8)-regular n=128: every structural property of the big
    # code at test-friendly size
    return rs_ldpc(s=4, gamma=4, rho=8)


def test_gf_tables_are_a_field():
    exp, log = gf2m_tables(4)
    q = 16
    assert sorted(exp[: q - 1].tolist()) == list(range(1, q))
    for v in range(1, q):
        assert exp[log[v]] == v


def test_construction_regular_and_girth6():
    code = _small()
    h = code.h_dense()
    assert (h.sum(axis=0) == code.gamma).all()
    assert (h.sum(axis=1) == code.rho).all()
    # no 4-cycles: any two rows share at most one column
    hi = h.astype(np.int64)
    overlap = hi @ hi.T
    np.fill_diagonal(overlap, 0)
    assert overlap.max() <= 1


def test_shift_4cycle_identity():
    # the additive QC condition the docstring proves:
    # (b1+b2)(x1+x2) != 0 <=> block-shift XOR sum nonzero
    code = _small()
    s = code.shifts
    for i1 in range(code.gamma):
        for i2 in range(i1 + 1, code.gamma):
            for j1 in range(code.rho):
                for j2 in range(j1 + 1, code.rho):
                    assert (s[i1, j1] ^ s[i1, j2] ^ s[i2, j2] ^ s[i2, j1]) != 0


def test_standard_dimensions_2048_1723():
    code = rs_ldpc()  # GF(64), (6, 32)-regular
    assert (code.n, code.m) == (2048, 384)
    assert code.k_info == 1723  # rank 325: the 802.3an (2048, 1723)


def test_encode_decode_roundtrip_noiseless():
    code = _small()
    enc = Encoder(code, code.encoder_matrices)
    rng = np.random.default_rng(0)
    u = rng.integers(0, 2, size=(8, code.k_info), dtype=np.uint8)
    cw = encode_numpy(code.encoder_matrices, u)
    assert not code.syndrome(cw).any()
    dec = Decoder(code, DecoderConfig(schedule="flooding"))
    assert dec.implementation == "jnp"  # block-structured XOR-align path
    llr = jnp.asarray((1.0 - 2.0 * cw) * 8.0, jnp.float32)
    res = dec(llr)
    assert np.asarray(res.converged).all()
    got = np.asarray(res.bits)[:, np.asarray(code.info_positions)]
    np.testing.assert_array_equal(got, u)


def test_decode_awgn():
    code = _small()
    enc = Encoder(code, code.encoder_matrices)
    rng = np.random.default_rng(1)
    u = rng.integers(0, 2, size=(32, code.k_info), dtype=np.uint8)
    cw = encode_numpy(code.encoder_matrices, u)
    llr, _ = transmit(jax.random.PRNGKey(0), jnp.asarray(cw), snr_db=6.0)
    dec = Decoder(code, DecoderConfig(schedule="flooding", normalization=0.75))
    res = dec(llr)
    got = np.asarray(res.bits)[:, np.asarray(code.info_positions)]
    conv = np.asarray(res.converged)
    assert conv.mean() > 0.9
    np.testing.assert_array_equal(got[conv], u[conv])


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_jnp_xor_path_matches_edgelist(schedule):
    code = _small()
    enc = Encoder(code, code.encoder_matrices)
    rng = np.random.default_rng(2)
    u = rng.integers(0, 2, size=(24, code.k_info), dtype=np.uint8)
    cw = encode_numpy(code.encoder_matrices, u)
    llr, _ = transmit(jax.random.PRNGKey(3), jnp.asarray(cw), snr_db=4.5)
    cfg = DecoderConfig(schedule=schedule, normalization=0.75)
    ref = Decoder(code, cfg, implementation="edgelist")(llr)
    res = Decoder(code, cfg, implementation="jnp")(llr)
    conv_r, conv_j = np.asarray(ref.converged), np.asarray(res.converged)
    np.testing.assert_array_equal(conv_r, conv_j)
    both = conv_r & conv_j
    np.testing.assert_array_equal(
        np.asarray(ref.bits)[both], np.asarray(res.bits)[both]
    )
    np.testing.assert_array_equal(
        np.asarray(ref.iterations), np.asarray(res.iterations)
    )


def test_byte_stream_codec():
    from myldpccppapi.coder import make_codec

    c = make_codec("rs_ldpc", 1024)
    c.for_encoder()
    c.for_decoder(16)
    c.add_decode_type("TDMPCL")
    src = (b"rs-ldpc byte stream " * 12)[:200]
    prior = c.encode(src)
    noisy = c.test(prior, sigma=0.3, seed=2)
    out = c.decode(noisy, len(src), "TDMPCL")
    assert bytes(out[: len(src)]) == src


def test_validation_errors():
    with pytest.raises(ValueError):
        rs_ldpc(s=4, gamma=16, rho=8)  # gamma must be < q
    with pytest.raises(ValueError):
        rs_ldpc(s=4, gamma=4, rho=8, slopes=np.array([0, 1, 2, 3]))
    with pytest.raises(ValueError):
        rs_ldpc(s=4, gamma=4, rho=8,
                points=np.array([1, 1, 2, 3, 4, 5, 6, 7]))


# ---------------------------------------------------------------------------
# round-4 review regressions
# ---------------------------------------------------------------------------

def test_rs_ldpc_from_n_validates():
    from myldpccppapi.codes.rs_ldpc import rs_ldpc_from_n

    code = rs_ldpc_from_n(2048)
    assert (code.n, code.k_info) == (2048, 1723)
    with pytest.raises(ValueError, match="32"):
        rs_ldpc_from_n(2000)


def test_make_codec_rs_ldpc_rejects_explicit_rate():
    from myldpccppapi import make_codec

    with pytest.raises(ValueError, match="fixed"):
        make_codec("rs_ldpc", 2048, "1/3")


def test_xor_code_iter_weights_dispatch_to_jnp():
    # per-iteration learned schedules have no fused-kernel serving; xor
    # codes must route to jnp like cyclic ones
    from myldpccppapi.decoder import select_implementation
    from myldpccppapi.utils.config import DecoderConfig

    code = rs_ldpc(s=4, gamma=4, rho=8)
    cfg = DecoderConfig(normalization=((0.7,) * 4, (0.8,) * 4))
    assert select_implementation(code, cfg) == "jnp"


