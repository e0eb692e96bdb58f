"""Error-impulse probing: find low-weight codewords / error-floor structure
with batched decodes.

The round-4 DVB-S2 design work showed why this tool must exist: PEXIT
(asymptotic) approved a profile whose finite-length structure floored at
FER 9e-2 — a defect that one batched decode would have exposed.  The
error-impulse method (Berrou & Vaton 2002) turns the decoder itself into a
minimum-distance probe: start from the all-zero codeword at high channel
confidence, flip a few positions to strong wrong-sign LLRs, and decode.  A
BP decoder pulled to a NONZERO valid codeword has found a low-weight
codeword — its Hamming weight upper-bounds d_min, and its support names the
offending bit groups (exactly the diagnosis the design loop needs).

Batched shape: every impulse pattern is one row of a [B, n] LLR batch,
so an entire probe sweep is a handful of batched decode dispatches on the
production decode path.  QC symmetry cuts the space by z: one lane per base
column represents its whole circulant orbit (singles), and pair patterns
need only relative lane offsets.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["ImpulseReport", "impulse_probe"]


@dataclasses.dataclass(frozen=True)
class ImpulseReport:
    #: smallest nonzero-codeword weight found (None = no impulse broke
    #: through: d_min is beyond this probe's reach)
    min_weight: Optional[int]
    #: codeword support (bit positions) achieving min_weight
    support: Optional[np.ndarray]
    #: base columns of that support (the design-level diagnosis)
    support_cols: Optional[np.ndarray]
    #: number of probes that converged to a nonzero codeword
    breaches: int
    probes: int
    #: per-probe description of breaches: (impulse positions, weight)
    found: Tuple[Tuple[Tuple[int, ...], int], ...]
    #: probes the decoder could NOT resolve within the budget — trapped
    #: sets (the BP error-floor mechanism that is not a codeword): tuple
    #: of (impulse positions, residual wrong-bit count at exit)
    trapped: Tuple[Tuple[Tuple[int, ...], int], ...]


def _decode_batch(code, cfg, llr_rows):
    import jax.numpy as jnp

    from ..decoder import Decoder

    dec = Decoder(code, cfg)
    res = dec(jnp.asarray(np.stack(llr_rows), dtype=jnp.float32))
    bits = np.asarray(res.bits)
    conv = np.asarray(res.converged)
    return bits, conv


def _structured_pairs(code, max_patterns: int, rng) -> list:
    """Impulse pairs aligned so the two bits SHARE at least one check:
    for every two blocks (l, g1, s1), (l, g2, s2) in the same base row
    class, lanes (g1, 0) and (g2, (s1 - s2) mod z) meet in check
    (l, s1).  These are the highest-risk two-bit patterns — blind lane
    offsets essentially never share a check and probe nothing."""
    z = code.z
    br, bc, sh = code.blocks
    rows = {}
    for e in range(len(br)):
        rows.setdefault(int(br[e]), []).append((int(bc[e]), int(sh[e])))
    pats = []
    for entries in rows.values():
        for i in range(len(entries)):
            g1, s1 = entries[i]
            for j in range(i + 1, len(entries)):
                g2, s2 = entries[j]
                t = (s1 - s2) % z
                if g1 == g2 and t == 0:
                    continue
                pats.append((g1 * z, g2 * z + t))
    if len(pats) > max_patterns:
        idx = rng.choice(len(pats), size=max_patterns, replace=False)
        pats = [pats[int(i)] for i in idx]
    return pats


def impulse_probe(
    code,
    cfg=None,
    amplitude: float = 8.0,
    base_llr: float = 1.0,
    max_pair_patterns: int = 4096,
    columns: Optional[Sequence[int]] = None,
    batch: int = 1024,
    seed: int = 0,
) -> ImpulseReport:
    """Probe ``code`` for low-weight codewords / trapped sets with single
    impulses (one per base column — the circulant orbit representative)
    and STRUCTURED pair impulses (two bits sharing a check; see
    :func:`_structured_pairs`).

    ``amplitude`` is the wrong-sign impulse magnitude relative to
    ``base_llr`` (the correct-sign confidence everywhere else).  The
    defaults put the decoder near its correction radius: weak structures
    break through (to a codeword, or into a trapped set), healthy columns
    decode back to zero.

    The decode runs on whatever implementation ``cfg`` dispatches to —
    the probe exercises the production decode path by construction.
    """
    from ..utils.config import DecoderConfig

    if cfg is None:
        cfg = DecoderConfig(schedule="layered", normalization=0.9,
                            max_iters=60)
    n, z = code.n, code.z
    n_b = code.n_b
    rng = np.random.default_rng(seed)

    cols = set(range(n_b)) if columns is None else set(int(c) for c in columns)
    patterns = [(g * z,) for g in sorted(cols)]
    pairs = [
        p for p in _structured_pairs(code, 10**9, rng)
        if (p[0] // z) in cols or (p[1] // z) in cols
    ]
    if len(pairs) > max_pair_patterns:
        idx = rng.choice(len(pairs), size=max_pair_patterns, replace=False)
        pairs = [pairs[int(i)] for i in idx]
    patterns += pairs

    found, trapped = [], []
    min_w, min_support = None, None
    n_probes = len(patterns)
    for lo in range(0, n_probes, batch):
        chunk = patterns[lo: lo + batch]
        rows = []
        for pat in chunk:
            llr = np.full(n, base_llr, dtype=np.float32)
            for p in pat:
                llr[p] = -amplitude * base_llr
            rows.append(llr)
        bits, conv = _decode_batch(code, cfg, rows)
        w = bits.sum(axis=1)
        breach = conv & (w > 0)
        for j in np.flatnonzero(breach):
            wt = int(w[j])
            found.append((chunk[j], wt))
            if min_w is None or wt < min_w:
                min_w = wt
                min_support = np.flatnonzero(bits[j])
        for j in np.flatnonzero(~conv):
            trapped.append((chunk[j], int(w[j])))
    return ImpulseReport(
        min_weight=min_w,
        support=min_support,
        support_cols=(np.unique(min_support // z)
                      if min_support is not None else None),
        breaches=len(found),
        probes=n_probes,
        found=tuple(found),
        trapped=tuple(trapped),
    )
