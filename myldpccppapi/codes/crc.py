"""GF(2) CRC attach/check as int8 matmuls (TS 38.212 §5.1 polynomials).

5G NR attaches CRC24A to transport blocks and CRC24B to the code blocks
fed into the BG1/BG2 LDPC encoder; receivers use the CRC both for block
error detection and for CRC-aided early termination.  The reference
framework has no CRC machinery (its only integrity check is the LDPC
syndrome, ``decodeCL.c:88-108``); this module supplies the standard NR
companion capability in batched form.

With the all-zero register initialization TS 38.212 specifies, the CRC of
a message is GF(2)-LINEAR in the message bits, so the whole computation is
one bit-matrix product: ``crc(u) = u @ C mod 2`` with ``C[k, L]``
precomputed by clocking the LFSR once per unit vector (numpy, cached).
Attach and check are then int8 matmuls with int32 accumulation over the
batch (exact on every backend) — the same pattern as the systematic LDPC
encoder (``codes/encoder.py``) — instead of a bit-serial LFSR loop that
could never vectorize.
"""
from __future__ import annotations

import functools

import numpy as np

__all__ = [
    "CRC_POLYS",
    "crc_numpy",
    "crc_matrix",
    "crc_attach_fn",
    "crc_check_fn",
]

#: Generator polynomials, MSB-first coefficient lists EXCLUDING the leading
#: x^L term (i.e. the low L coefficients), as integers.  TS 38.212
#: Section 5.1 names: 24A/24B attach to transport/code blocks, 24C to
#: polar-coded control, 16 to small transport blocks.
CRC_POLYS = {
    "24A": (24, 0x864CFB),
    "24B": (24, 0x800063),
    "24C": (24, 0xB2B117),
    "16": (16, 0x1021),
}


def _poly_bits(name: str) -> tuple[int, np.ndarray]:
    length, poly = CRC_POLYS[name]
    bits = np.array([(poly >> (length - 1 - i)) & 1 for i in range(length)],
                    dtype=np.uint8)
    return length, bits


def crc_numpy(u: np.ndarray, name: str = "24A") -> np.ndarray:
    """Bit-serial LFSR reference: ``u`` [..., k] 0/1 -> [..., L] CRC bits
    (MSB first), zero initialization, no final XOR (the 38.212 convention).
    Ground truth for :func:`crc_matrix`; use the matmul forms in hot paths.
    """
    length, taps = _poly_bits(name)
    u = np.asarray(u, dtype=np.uint8) & 1
    reg = np.zeros(u.shape[:-1] + (length,), dtype=np.uint8)
    for i in range(u.shape[-1]):
        fb = reg[..., 0] ^ u[..., i]
        reg = np.roll(reg, -1, axis=-1)
        reg[..., -1] = 0
        reg ^= fb[..., None] * taps
    return reg


def _clock_matrix(k: int, taps: np.ndarray) -> np.ndarray:
    """[k, L] uint8 parity matrix of the zero-init MSB-first LFSR with the
    given taps (L = len(taps)): row i is ``x^(L + k - 1 - i) mod g``, i.e.
    the parity of unit vector e_i.  Built bottom-up in O(k*L): the last
    row is ``x^L mod g = taps`` and each earlier row is the next one
    multiplied by x and reduced.  Shared by the CRCs here and the BCH
    generator (codes/bch.py)."""
    length = len(taps)
    rows = np.empty((k, length), dtype=np.uint8)
    r = taps.astype(np.uint8).copy()  # x^L mod g, MSB-first
    rows[k - 1] = r
    for i in range(k - 2, -1, -1):
        carry = r[0]
        r = np.roll(r, -1)
        r[-1] = 0
        if carry:
            r ^= taps
        rows[i] = r
    return rows


@functools.lru_cache(maxsize=None)
def crc_matrix(k: int, name: str = "24A") -> np.ndarray:
    """[k, L] uint8 matrix with ``crc(u) == (u @ C) % 2`` for any [., k] u.

    Row i is the CRC of the i-th unit vector; linearity over GF(2) (zero
    init, no final XOR) makes the superposition exact.
    """
    _, taps = _poly_bits(name)
    return _clock_matrix(k, taps)


def crc_attach_fn(k: int, name: str = "24A"):
    """Jittable ``u[B, k] int -> [B, k+L] int8`` (message || CRC), the
    38.212 code-block attachment."""
    import jax.numpy as jnp
    from jax import lax

    c_t = jnp.asarray(crc_matrix(k, name), jnp.int8)

    def attach(u):
        acc = lax.dot_general(
            u.astype(jnp.int8), c_t, (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32,
        )
        return jnp.concatenate([u.astype(jnp.int8), (acc & 1).astype(jnp.int8)],
                               axis=-1)

    return attach


def crc_check_fn(k: int, name: str = "24A"):
    """Jittable ``bits[B, k+L] -> bool[B]`` (True = CRC passes).

    Checking is the same linear map: recompute the CRC of the message part
    and compare with the received CRC field — usable on device as a
    CRC-aided acceptance test alongside the LDPC syndrome.
    """
    import jax.numpy as jnp
    from jax import lax

    length, _ = CRC_POLYS[name]
    c_t = jnp.asarray(crc_matrix(k, name), jnp.int8)

    def check(bits):
        u = bits[..., :k].astype(jnp.int8)
        rx = bits[..., k:k + length].astype(jnp.int32)
        acc = lax.dot_general(
            u, c_t, (((u.ndim - 1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32,
        )
        return jnp.all((acc & 1) == rx, axis=-1)

    return check
