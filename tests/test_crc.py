"""GF(2) CRC (TS 38.212 polynomials): LFSR vs matrix, device attach/check,
CRC-aided acceptance on a decoded NR block."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from myldpccppapi.codes.crc import (
    CRC_POLYS, crc_attach_fn, crc_check_fn, crc_matrix, crc_numpy,
)


@pytest.mark.parametrize("name", sorted(CRC_POLYS))
def test_matrix_matches_lfsr(name):
    rng = np.random.default_rng(12)
    k = 97
    u = rng.integers(0, 2, size=(5, k), dtype=np.uint8)
    ref = crc_numpy(u, name)
    mat = (u.astype(np.int64) @ crc_matrix(k, name).astype(np.int64)) % 2
    assert (ref == mat).all()


def test_crc16_xmodem_vector():
    """CRC-16/XMODEM published check value: ASCII "123456789" -> 0x31C3
    (poly 0x1021, zero init, no reflection/xorout — the exact 38.212 CRC16
    convention), pinning the LFSR bit order against an external vector."""
    msg = b"123456789"
    bits = np.unpackbits(np.frombuffer(msg, np.uint8))  # MSB-first per byte
    crc = crc_numpy(bits, "16")
    val = int("".join(map(str, crc)), 2)
    assert val == 0x31C3


def test_attach_check_device():
    k = 128
    rng = np.random.default_rng(3)
    u = jnp.asarray(rng.integers(0, 2, size=(16, k), dtype=np.uint8))
    attach = jax.jit(crc_attach_fn(k, "24B"))
    check = jax.jit(crc_check_fn(k, "24B"))
    blocks = attach(u)
    assert blocks.shape == (16, k + 24)
    assert np.asarray(check(blocks)).all()
    # any single flipped bit must be detected
    bad = np.asarray(blocks).copy()
    for i in range(8):
        bad[i, (37 * i) % (k + 24)] ^= 1
    assert not np.asarray(check(jnp.asarray(bad)))[:8].any()
    # numpy LFSR agrees with the device attachment
    assert (crc_numpy(np.asarray(u), "24B") == np.asarray(blocks)[:, k:]).all()


@pytest.mark.slow
def test_crc_aided_nr_decode():
    """38.212-style flow: CRC24B-attached payload fills the NR code block;
    after LDPC decode the CRC accepts exactly the correctly decoded frames."""
    from myldpccppapi import Decoder, DecoderConfig
    from myldpccppapi.codes.nr import nr_code, triangular_encode_fn

    code = nr_code(z=16, bg=1)
    k_payload = code.k - 24
    rng = np.random.default_rng(5)
    u = jnp.asarray(rng.integers(0, 2, size=(8, k_payload), dtype=np.uint8))
    blocks = crc_attach_fn(k_payload, "24B")(u)
    cw = jax.jit(triangular_encode_fn(code))(blocks)
    sigma = 10 ** (-2.0 / 20)
    noise = sigma * jax.random.normal(jax.random.PRNGKey(0), cw.shape)
    llr = 2.0 * ((1.0 - 2.0 * cw.astype(jnp.float32)) + noise) / sigma**2
    dec = Decoder(code, DecoderConfig(schedule="layered", normalization=0.8,
                                      max_iters=25))
    res = dec(llr)
    ok = np.asarray(crc_check_fn(k_payload, "24B")(res.bits[:, : code.k]))
    correct = (np.asarray(res.bits)[:, :k_payload] == np.asarray(u)).all(axis=1)
    assert (ok == correct).all()
    assert ok.any()  # the operating point decodes at least some frames
