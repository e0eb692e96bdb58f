"""BPSK modulation, AWGN channel, and LLR computation.

JAX analogue of the reference's self-test channel (``Coder::test``,
``MyLdpc.cpp:1061-1078``: bit 1 -> -1.0, bit 0 -> +1.0, plus Box-Muller
Gaussian noise of standard deviation sigma).

LLR conventions
---------------
The decoders consume log-likelihood ratios with **positive LLR => bit 0**
(same sign convention as the reference, which feeds the raw channel value
y = +/-1 + noise straight into its min-sum as the LLR).  The proper LLR for
BPSK/AWGN is ``2 y / sigma^2``; ``llr_scale`` lets callers reproduce the
reference's quirks exactly:

* reference min-sum / TDMP: ``llr_scale = 1.0`` (raw channel value)
* reference sum-product:    hardcodes ``exp(8 y)`` i.e. assumes sigma^2 = 0.25
  (``decodeCL.c:9``) — equivalent to ``llr_scale = 8.0``
* correct:                  ``llr_scale = 2 / sigma^2`` (the default)
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "sigma_from_snr_db",
    "snr_db_from_ebn0_db",
    "bpsk_modulate",
    "awgn",
    "channel_llr",
    "transmit",
]


def sigma_from_snr_db(snr_db) -> jnp.ndarray:
    """Noise sigma from SNR in dB, matching the reference CLI's convention
    sigma = 10^(-snr/20) (``Test.cpp:57``), i.e. Es/N0 with Es = 1."""
    return 10.0 ** (-jnp.asarray(snr_db, dtype=jnp.float32) / 20.0)


def snr_db_from_ebn0_db(ebn0_db, rate: float, bits_per_symbol: int = 1) -> jnp.ndarray:
    """Convert Eb/N0 (dB) to the Es/N0-style SNR used above, for a given
    code rate and modulation order (Es = rate * bits_per_symbol * Eb)."""
    return jnp.asarray(ebn0_db, dtype=jnp.float32) + 10.0 * jnp.log10(
        rate * bits_per_symbol
    )


def bpsk_modulate(bits: jax.Array) -> jax.Array:
    """0 -> +1.0, 1 -> -1.0 (float32)."""
    return 1.0 - 2.0 * bits.astype(jnp.float32)


def awgn(key: jax.Array, symbols: jax.Array, sigma) -> jax.Array:
    return symbols + sigma * jax.random.normal(key, symbols.shape, dtype=symbols.dtype)


def channel_llr(received: jax.Array, sigma, llr_scale=None) -> jax.Array:
    """LLR(bit=0 vs 1) of the received symbols.  Default: 2 y / sigma^2."""
    if llr_scale is None:
        llr_scale = 2.0 / (jnp.asarray(sigma, dtype=jnp.float32) ** 2)
    return received * llr_scale


def transmit(key: jax.Array, bits: jax.Array, snr_db, llr_scale=None):
    """bits -> BPSK -> AWGN -> LLRs.  Returns (llr, sigma)."""
    sigma = sigma_from_snr_db(snr_db)
    y = awgn(key, bpsk_modulate(bits), sigma)
    return channel_llr(y, sigma, llr_scale), sigma
