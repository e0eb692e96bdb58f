"""Channel tests: BPSK mapping, noise statistics, sigma convention."""
import jax
import jax.numpy as jnp
import numpy as np

from myldpccppapi.ops.channel import (
    awgn,
    bpsk_modulate,
    channel_llr,
    sigma_from_snr_db,
    transmit,
)


def test_bpsk_mapping():
    # bit 0 -> +1.0, bit 1 -> -1.0 (MyLdpc.cpp:1066-1070)
    bits = jnp.array([0, 1, 1, 0], dtype=jnp.uint8)
    assert np.allclose(np.asarray(bpsk_modulate(bits)), [1.0, -1.0, -1.0, 1.0])


def test_sigma_convention():
    # sigma = 10^(-snr/20) (Test.cpp:57)
    assert np.isclose(float(sigma_from_snr_db(0.0)), 1.0)
    assert np.isclose(float(sigma_from_snr_db(20.0)), 0.1)


def test_noise_statistics():
    key = jax.random.PRNGKey(0)
    x = jnp.zeros((200_000,))
    y = np.asarray(awgn(key, x, 0.5))
    assert abs(y.mean()) < 5e-3
    assert abs(y.std() - 0.5) < 5e-3


def test_llr_sign_and_scale():
    y = jnp.array([0.5, -0.25])
    llr = np.asarray(channel_llr(y, sigma=0.5))  # 2/sigma^2 = 8
    assert np.allclose(llr, [4.0, -2.0])
    # raw-channel compat mode (reference min-sum convention)
    raw = np.asarray(channel_llr(y, sigma=0.5, llr_scale=1.0))
    assert np.allclose(raw, np.asarray(y))


def test_transmit_shapes():
    key = jax.random.PRNGKey(1)
    bits = jnp.zeros((64, 24), dtype=jnp.uint8)
    llr, sigma = transmit(key, bits, snr_db=6.0)
    assert llr.shape == (64, 24)
    # at 6 dB nearly all LLRs of the all-zero word should be positive
    assert (np.asarray(llr) > 0).mean() > 0.95
