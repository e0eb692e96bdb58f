"""Bit-packing contract tests: LSB-first within each byte, matching the
reference (``MyLdpc.cpp:643-646``, ``decodeCL.c:188-199``)."""
import jax.numpy as jnp
import numpy as np

from myldpccppapi.ops.packing import (
    pack_bits,
    pack_bits_np,
    unpack_bits,
    unpack_bits_np,
)


def test_lsb_first_convention():
    data = np.array([0b00000001, 0b10000000], dtype=np.uint8)
    bits = unpack_bits_np(data)
    assert bits.tolist() == [1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1]


def test_roundtrip_np(rng):
    data = rng.integers(0, 256, size=(3, 17), dtype=np.uint8)
    assert (pack_bits_np(unpack_bits_np(data)) == data).all()


def test_jax_matches_numpy(rng):
    data = rng.integers(0, 256, size=(4, 9), dtype=np.uint8)
    assert (np.asarray(unpack_bits(jnp.asarray(data))) == unpack_bits_np(data)).all()
    bits = rng.integers(0, 2, size=(4, 72), dtype=np.uint8)
    assert (np.asarray(pack_bits(jnp.asarray(bits))) == pack_bits_np(bits)).all()
