"""Encoder tests: H @ c = 0 for every rate, RU split, jnp/NumPy agreement."""
import jax.numpy as jnp
import numpy as np
import pytest

from myldpccppapi.codes import Encoder, encode_numpy, ru_precompute, wimax, wifi
from myldpccppapi.codes.base_matrices import WIMAX_SEEDS


@pytest.mark.parametrize("rate", sorted(WIMAX_SEEDS))
def test_wimax_encode_valid_codewords(rate, rng):
    code = wimax(576, rate)
    mats = ru_precompute(code)
    assert mats.gap == code.z  # RU split with g=z must succeed for 802.16e
    u = rng.integers(0, 2, size=(8, code.k), dtype=np.uint8)
    c = encode_numpy(mats, u)
    assert (c[:, : code.k] == u).all()  # systematic
    assert code.syndrome(c).sum() == 0


@pytest.mark.parametrize("maker", [lambda: wimax(1152, "1/2"), lambda: wifi(1944, "5/6")])
def test_jax_encoder_matches_numpy(maker, rng):
    code = maker()
    enc = Encoder(code)
    u = rng.integers(0, 2, size=(16, code.k), dtype=np.uint8)
    c_np = encode_numpy(enc.mats, u)
    c_jax = np.asarray(enc(jnp.asarray(u)))
    assert (c_np == c_jax).all()


def test_encoder_linear(rng):
    # GF(2) linearity: enc(a ^ b) == enc(a) ^ enc(b)
    code = wimax(576, "3/4B")
    enc = Encoder(code)
    a = rng.integers(0, 2, size=(4, code.k), dtype=np.uint8)
    b = rng.integers(0, 2, size=(4, code.k), dtype=np.uint8)
    ca = np.asarray(enc(jnp.asarray(a)))
    cb = np.asarray(enc(jnp.asarray(b)))
    cab = np.asarray(enc(jnp.asarray(a ^ b)))
    assert (cab == (ca ^ cb)).all()


def test_zero_maps_to_zero():
    code = wimax(576, "1/2")
    enc = Encoder(code)
    z = np.zeros((1, code.k), dtype=np.uint8)
    assert np.asarray(enc(jnp.asarray(z))).sum() == 0
