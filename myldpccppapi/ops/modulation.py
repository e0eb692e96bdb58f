"""Higher-order modulation: Gray QAM/PSK/APSK mapping and soft demapping.

The reference's channel is BPSK-only (``Coder::test``, ``MyLdpc.cpp:1061-1078``);
a real receiver for the code families this framework ships (5G NR data
channels, DVB-S2) sees QPSK/16/64/256-QAM (TS 38.211 §5.1) or
QPSK/8PSK/16APSK/32APSK (EN 302 307 §5.4).  This module provides those
constellations plus max-log and exact soft demappers, designed for batched
accelerator execution:

* ``modulate`` is one gather through a 2^m-entry lookup table (bits are
  grouped m-at-a-time, first bit = LSB of the label integer);
* ``demap_llr`` scans the M constellation points carrying running per-bit
  minima (max-log) or log-sum-exp accumulators (exact) — O(batch * symbols
  * bits_per_symbol) memory regardless of M, all fused elementwise work,
  no [., M] distance tensor is ever materialized.

Bit-to-symbol conventions
-------------------------
Consecutive coded bits map to one symbol (bit ``i`` of symbol ``s`` is coded
bit ``s*m + i``), matching TS 38.211 §5.1.  LLR sign convention matches the
decoders: **positive LLR => bit 0**.

Provenance (see PROVENANCE.md)
------------------------------
The NR QAM constellations are the closed-form Gray expressions of TS 38.211
§5.1.3-5.1.6 (self-validating: unit energy + Gray adjacency are tested).
The PSK/APSK constellations use the EN 302 307 §5.4 *geometry* (ring sizes,
angles, rate-dependent radius ratios) with a binary-reflected-Gray /
quasi-Gray labeling: any ring-Gray relabeling is performance-equivalent
under rotationally-symmetric AWGN, but the exact Figure 10/12/13 label
assignment fails the transcription-safety criterion in this offline
environment.  Labelings are data — pass ``labels=`` to drop in the
normative tables.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "Modulation",
    "bpsk",
    "qpsk",
    "psk8",
    "qam16",
    "qam64",
    "qam256",
    "apsk16",
    "apsk32",
    "make_modulation",
    "MODULATIONS",
    "APSK16_GAMMA",
    "APSK32_GAMMA",
    "modulate",
    "demap_llr",
]


@dataclasses.dataclass(frozen=True)
class Modulation:
    """A labeled complex constellation, normalized to unit average energy.

    ``points[p]`` is the complex point carrying bit label ``labels[p, :]``
    (``labels[p, i]`` = value of coded bit ``i`` within the symbol).
    """

    name: str
    points: np.ndarray  # [M] complex64, mean |x|^2 == 1
    labels: np.ndarray  # [M, m] uint8 in {0, 1}
    #: For separable (square Gray QAM) constellations: the per-axis PAM
    #: alphabet as (levels [L] float32, labels [L, m/2] uint8), where bit
    #: 2j+axis of the symbol is bit j of the component's PAM label (the
    #: TS 38.211 even/odd I/Q split).  Lets the demapper work per
    #: component — L instead of L^2 points — EXACTLY (the other axis's
    #: distance terms cancel in both max-log and true LLRs).  None for
    #: non-product constellations (PSK/APSK).
    pam: "tuple | None" = None

    def __post_init__(self):
        pts = np.asarray(self.points, dtype=np.complex64)
        labs = np.asarray(self.labels, dtype=np.uint8)
        if pts.ndim != 1 or labs.ndim != 2 or labs.shape[0] != pts.shape[0]:
            raise ValueError("points [M] and labels [M, m] required")
        m = labs.shape[1]
        if pts.shape[0] != 2**m:
            raise ValueError(f"{pts.shape[0]} points but {m} bits/symbol")
        ints = labs.astype(np.int64) @ (1 << np.arange(m, dtype=np.int64))
        if len(set(ints.tolist())) != pts.shape[0]:
            raise ValueError("labels are not a permutation of {0,1}^m")
        es = float(np.mean(np.abs(pts) ** 2))
        if abs(es - 1.0) > 1e-5:
            raise ValueError(f"constellation energy {es} != 1")
        object.__setattr__(self, "points", pts)
        object.__setattr__(self, "labels", labs)

    @property
    def bits_per_symbol(self) -> int:
        return self.labels.shape[1]

    @property
    def order(self) -> int:
        return self.points.shape[0]

    def lut(self) -> np.ndarray:
        """[2^m] complex64 lookup table indexed by the label integer
        (bit i of the symbol = bit i of the index)."""
        m = self.bits_per_symbol
        ints = self.labels.astype(np.int64) @ (1 << np.arange(m, dtype=np.int64))
        out = np.empty(2**m, dtype=np.complex64)
        out[ints] = self.points
        return out


def _gray(k: np.ndarray) -> np.ndarray:
    return k ^ (k >> 1)


def _bits_of(ints: np.ndarray, m: int) -> np.ndarray:
    """[P] ints -> [P, m] bits, bit i = (x >> i) & 1."""
    return ((ints[:, None] >> np.arange(m)[None, :]) & 1).astype(np.uint8)


# ---------------------------------------------------------------------------
# NR constellations (TS 38.211 §5.1.3-5.1.6, closed-form Gray expressions)
# ---------------------------------------------------------------------------


def bpsk() -> Modulation:
    """Real BPSK as a 1-bit constellation: 0 -> +1, 1 -> -1 (the reference's
    map, ``MyLdpc.cpp:1064``)."""
    return Modulation("bpsk", np.array([1.0, -1.0], dtype=np.complex64),
                      np.array([[0], [1]], dtype=np.uint8))


def _nr_qam(m: int, name: str) -> Modulation:
    """TS 38.211 Gray QAM: I from even-indexed bits, Q from odd-indexed.

    §5.1.4 (16QAM): x = [(1-2b0)(2-(1-2b2)) + j(1-2b1)(2-(1-2b3))]/sqrt(10);
    §5.1.5/§5.1.6 extend the same nesting to 64/256QAM (norm sqrt(42)/sqrt(170)).
    """
    half = m // 2
    ints = np.arange(2**m)
    b = _bits_of(ints, m)  # bit i of the label integer
    s = 1 - 2 * b.astype(np.float64)  # (1 - 2*b_i)

    def pam(sign_bits):  # sign_bits: [P, half] = (s0, s2, ...) resp. odd bits
        # innermost nesting first: amp = 2 - s_last, then 4 - s*(prev), ...
        amp = np.ones(sign_bits.shape[0])
        for j in range(half - 1, 0, -1):
            amp = (2.0 ** (half - j)) - sign_bits[:, j] * amp
        return sign_bits[:, 0] * amp

    i_amp = pam(s[:, 0::2])
    q_amp = pam(s[:, 1::2])
    pts = (i_amp + 1j * q_amp).astype(np.complex64)
    es = np.mean(np.abs(pts) ** 2)
    scale = 1.0 / np.sqrt(es)
    pts = (pts * scale).astype(np.complex64)
    # per-axis PAM alphabet for the separable demapper
    ints_h = np.arange(2**half)
    bh = _bits_of(ints_h, half)
    levels = (pam(1 - 2 * bh.astype(np.float64)) * scale).astype(np.float32)
    return Modulation(name, pts, b, pam=(levels, bh))


def qpsk() -> Modulation:
    """Gray QPSK (TS 38.211 §5.1.3; DVB-S2's Figure 9 is a relabeling)."""
    return _nr_qam(2, "qpsk")


def qam16() -> Modulation:
    return _nr_qam(4, "16qam")


def qam64() -> Modulation:
    return _nr_qam(6, "64qam")


def qam256() -> Modulation:
    return _nr_qam(8, "256qam")


# ---------------------------------------------------------------------------
# DVB-S2 constellations (EN 302 307 §5.4 geometry; quasi-Gray labels)
# ---------------------------------------------------------------------------


def psk8(labels: Optional[np.ndarray] = None) -> Modulation:
    """8PSK, points at angles pi/4 * k.  Default labeling: binary-reflected
    Gray around the ring (performance-equivalent to EN 302 307 Figure 10's
    relabeling; pass ``labels`` for the normative assignment)."""
    k = np.arange(8)
    pts = np.exp(1j * (2 * np.pi * k / 8 + np.pi / 8)).astype(np.complex64)
    if labels is None:
        labels = _bits_of(_gray(k), 3)
    return Modulation("8psk", pts, labels)


#: EN 302 307 Table 9 ring-radius ratios gamma = R2/R1 by LDPC rate
#: (best-effort transcription; geometry-level data, see PROVENANCE.md).
APSK16_GAMMA = {
    "2/3": 3.15, "3/4": 2.85, "4/5": 2.75, "5/6": 2.70,
    "8/9": 2.60, "9/10": 2.57,
}

#: EN 302 307 Table 10 (gamma1, gamma2) = (R2/R1, R3/R1) by LDPC rate.
APSK32_GAMMA = {
    "3/4": (2.84, 5.27), "4/5": (2.72, 4.87), "5/6": (2.64, 4.64),
    "8/9": (2.54, 4.33), "9/10": (2.53, 4.30),
}


def _apsk(rings, name: str, labels: Optional[np.ndarray]) -> Modulation:
    """rings: sequence of (count, radius, phase_offset)."""
    pts = []
    for count, radius, phase in rings:
        ang = 2 * np.pi * np.arange(count) / count + phase
        pts.append(radius * np.exp(1j * ang))
    pts = np.concatenate(pts)
    pts = (pts / np.sqrt(np.mean(np.abs(pts) ** 2))).astype(np.complex64)
    m = int(np.log2(len(pts)))
    if labels is None:
        labels = _apsk_quasi_gray(pts, m)
    return Modulation(name, pts, labels)


def _apsk_quasi_gray(pts: np.ndarray, m: int) -> np.ndarray:
    """Deterministic quasi-Gray labeling: start from index order, then
    greedy pairwise label swaps minimizing sum over nearest-neighbor point
    pairs of (Hamming distance - 1).  Labelings are data, not normative."""
    n = len(pts)
    # nearest-neighbor graph: each point's 3 closest other points
    d = np.abs(pts[:, None] - pts[None, :])
    np.fill_diagonal(d, np.inf)
    nbrs = np.argsort(d, axis=1)[:, :3]
    lab = np.arange(n)

    def cost(lab):
        h = np.zeros(n)
        for i in range(n):
            for j in nbrs[i]:
                h[i] += bin(int(lab[i]) ^ int(lab[j])).count("1") - 1
        return float(h.sum())

    best = cost(lab)
    improved = True
    while improved:
        improved = False
        for i in range(n):
            for j in range(i + 1, n):
                lab[i], lab[j] = lab[j], lab[i]
                c = cost(lab)
                if c < best - 1e-12:
                    best = c
                    improved = True
                else:
                    lab[i], lab[j] = lab[j], lab[i]
    return _bits_of(lab, m)


def apsk16(gamma: float = 2.85, labels: Optional[np.ndarray] = None) -> Modulation:
    """16APSK: 4+12 rings (inner at pi/4 + k*pi/2, outer at pi/12 + k*pi/6),
    EN 302 307 §5.4.3 geometry.  ``gamma`` = R2/R1 (Table 9 via
    ``APSK16_GAMMA``; default = the 3/4-rate ratio)."""
    return _apsk(
        [(4, 1.0, np.pi / 4), (12, gamma, np.pi / 12)], "16apsk", labels
    )


def apsk32(gamma1: float = 2.84, gamma2: float = 5.27,
           labels: Optional[np.ndarray] = None) -> Modulation:
    """32APSK: 4+12+16 rings (EN 302 307 §5.4.4 geometry); default ratios =
    the 3/4-rate row of Table 10 (``APSK32_GAMMA``)."""
    return _apsk(
        [(4, 1.0, np.pi / 4), (12, gamma1, np.pi / 12),
         (16, gamma2, np.pi / 16)],
        "32apsk", labels,
    )


MODULATIONS = {
    "bpsk": bpsk,
    "qpsk": qpsk,
    "8psk": psk8,
    "16qam": qam16,
    "64qam": qam64,
    "256qam": qam256,
    "16apsk": apsk16,
    "32apsk": apsk32,
}


def make_modulation(name: str, rate: Optional[str] = None) -> Modulation:
    """Build a modulation by name; for APSK, pick the EN 302 307 ring ratio
    for ``rate`` when it has a table row."""
    key = name.lower()
    if key not in MODULATIONS:
        raise ValueError(f"unknown modulation {name!r}; have {sorted(MODULATIONS)}")
    if key == "16apsk" and rate in APSK16_GAMMA:
        return apsk16(APSK16_GAMMA[rate])
    if key == "32apsk" and rate in APSK32_GAMMA:
        return apsk32(*APSK32_GAMMA[rate])
    return MODULATIONS[key]()


# ---------------------------------------------------------------------------
# Mapping / demapping
# ---------------------------------------------------------------------------


def modulate(bits: jax.Array, mod: Modulation) -> jax.Array:
    """[..., S*m] bits -> [..., S] complex symbols (one LUT gather).

    Bit ``s*m + i`` is bit ``i`` of symbol ``s`` (TS 38.211 §5.1 ordering).
    """
    m = mod.bits_per_symbol
    if bits.shape[-1] % m:
        raise ValueError(
            f"{bits.shape[-1]} coded bits not divisible by {m} bits/symbol"
        )
    lut = jnp.asarray(mod.lut())
    b = bits.reshape(bits.shape[:-1] + (-1, m)).astype(jnp.int32)
    idx = jnp.sum(b << jnp.arange(m, dtype=jnp.int32), axis=-1)
    return lut[idx]


def demap_llr(y: jax.Array, n0, mod: Modulation, method: str = "maxlog",
              prior: "jax.Array | None" = None) -> jax.Array:
    """Soft-demap [..., S] received symbols -> [..., S*m] LLRs (positive =>
    bit 0), for complex AWGN with total noise variance ``n0`` per symbol
    (per-component variance n0/2).

    ``method="maxlog"``: LLR_i = (min_{b_i=1}|y-x|^2 - min_{b_i=0}|y-x|^2)/n0.
    ``method="exact"``:  LLR_i = logsumexp_{b_i=0}(-|y-x|^2/n0)
                                - logsumexp_{b_i=1}(-|y-x|^2/n0).

    ``prior``: optional per-bit a priori LLRs [..., S*m] (same sign
    convention) — the BICM-ID inner step (demapInit analogue the reference
    lacks; SURVEY §2.2 covers one-shot demap only).  Each point's metric
    gains its label's prior mass, ``M(x) = |y-x|^2/n0 + sum_j b_j(x)
    prior_j``, and the returned LLRs are the **APP** (= prior +
    extrinsic); subtract ``prior`` for the extrinsic fed onward.  With
    ``prior=None`` the metric is the plain distance (identical programs).

    Scans the M points carrying per-bit accumulators — no [., M] tensor.
    """
    m = mod.bits_per_symbol
    inv_n0 = 1.0 / jnp.asarray(n0, dtype=jnp.float32)
    if prior is not None:
        # [..., S*m] -> [..., S, m] per-symbol prior columns
        prior = prior.reshape(prior.shape[:-1] + (-1, m)).astype(jnp.float32)

    # The loop over constellation points is a PYTHON loop (static M <= 256):
    # XLA fuses all per-point distance/accumulator updates into one
    # elementwise pass over the symbols, keeping the per-bit accumulators in
    # registers.  A lax.scan here materializes the [.., m] carry pair to HBM
    # every step (measured ~30 ms extra per 16.6M-symbol dispatch at M=16).
    def per_bit_llrs(obs, pts, labels, nbits, pri):
        def metric(p_idx):
            d = jnp.square(jnp.abs(obs - pts[p_idx])) * inv_n0
            if pri is not None:
                # sum of this label's set-bit priors: -log P(x) up to const
                for i in range(nbits):
                    if labels[p_idx, i]:
                        d = d + pri[..., i]
            return d

        def accumulate(update, init):
            acc0 = [init] * nbits
            acc1 = [init] * nbits
            for p_idx in range(len(pts)):
                d = metric(p_idx)
                for i in range(nbits):
                    if labels[p_idx, i]:
                        acc1[i] = update(acc1[i], d)
                    else:
                        acc0[i] = update(acc0[i], d)
            return acc0, acc1

        if method == "maxlog":
            m0, m1 = accumulate(jnp.minimum, jnp.inf)
            return [b - a for a, b in zip(m0, m1)]
        if method == "exact":
            # logsumexp of -M via running logaddexp (stable)
            def lse(acc, d):
                return jnp.logaddexp(acc, -d)

            l0, l1 = accumulate(lse, -jnp.inf)
            return [a - b for a, b in zip(l0, l1)]
        raise ValueError(f"method must be 'maxlog' or 'exact', got {method!r}")

    if mod.pam is not None:
        # separable square QAM: demap I and Q against the L-level PAM
        # alphabet instead of all L^2 points.  EXACT for both methods,
        # priors included: |y-x|^2 = dI + dQ and the label bits partition
        # by axis (TS 38.211 Gray QAM: even bits from I, odd from Q), so
        # M(x) = MI(xi) + MQ(xq) and the unconstrained axis's min
        # (max-log) / logsumexp (exact) is common to both bit hypotheses
        # and cancels.
        levels, plabs = mod.pam
        axis_llrs = [
            per_bit_llrs(comp, levels, plabs, plabs.shape[1],
                         None if prior is None else prior[..., a::2])
            for a, comp in enumerate((jnp.real(y), jnp.imag(y)))
        ]
        bit_llrs = [axis_llrs[i % 2][i // 2] for i in range(m)]
    else:
        bit_llrs = per_bit_llrs(y, np.asarray(mod.points), mod.labels, m,
                                prior)
    llr = jnp.stack(bit_llrs, axis=-1)  # [..., S, m]
    return llr.reshape(y.shape[:-1] + (-1,))
