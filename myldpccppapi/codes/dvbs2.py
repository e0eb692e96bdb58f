"""DVB-S2 IRA LDPC codes (EN 302 307; n = 64800 / 16200).

The ONE user-facing constructor is :func:`dvbs2` (equivalently
:func:`dvbs2_ira_qc`): the exact EN 302 307 H structure — information bits
addressed in groups of 360 with q-periodic row spreading plus a bidiagonal
parity accumulator — expressed as a z=360 quasi-cyclic :class:`QCCode`
under the classic row-residue permutation, so it rides the block-structured
layered decoder (BASELINE config 3's path) with O(n) accumulator encoding
(:func:`ira_encode_fn`).

:func:`dvbs2_oracle` builds the same code in the standard (un-permuted)
domain as a :class:`DVBS2Code` consumed by the generic edge-list decoder —
kept as the independent test oracle that pins the QC transformation
(tests/test_dvbs2.py::test_ira_qc_matches_standard_domain_h), not as a
production path.

The per-rate *address tables are synthetic*: deterministic girth-aware
draws with the standard's group structure and per-rate degree profile
(Table 5a/5b), NOT the EN 302 307 Annex B/C tables — so not
bit-interoperable with DVB hardware.  The table is plain data
(``addresses``): substituting the standard's values via
:func:`parse_address_table` upgrades to full interoperability with no code
change (see PROVENANCE.md for the policy).

Layered decoding groups rows by residue class mod q (360 rows/layer): the
q-periodic spreading makes intra-layer column conflicts rare, the classic
DVB-S2 layered schedule.
"""
from __future__ import annotations

import dataclasses
import functools
from functools import cached_property
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["DVBS2Code", "dvbs2", "dvbs2_ira_qc", "dvbs2_oracle",
           "parse_address_table", "std_interleave",
           "bit_interleave", "bit_deinterleave", "BIT_INTERLEAVER_COLS",
           "ira_encode_fn", "ira_encode_numpy"]

_GROUP = 360


@dataclasses.dataclass(frozen=True, eq=False)
class DVBS2Code:
    """IRA code: H = [H_info | H_acc], accumulator bidiagonal parity."""

    name: str
    n: int
    k: int
    #: per info-group address lists: addresses[g] = row indices of bit g*360
    addresses: Tuple[Tuple[int, ...], ...]

    @property
    def m(self) -> int:
        return self.n - self.k

    @property
    def q(self) -> int:
        return self.m // _GROUP

    @property
    def rate(self) -> float:
        return self.k / self.n

    @property
    def k_info(self) -> int:
        return self.k

    @property
    def info_positions(self) -> np.ndarray:
        return np.arange(self.k, dtype=np.int64)

    @cached_property
    def info_edges(self) -> Tuple[np.ndarray, np.ndarray]:
        """(rows, cols) of the information part of H."""
        m, q = self.m, self.q
        rows, cols = [], []
        for g, addrs in enumerate(self.addresses):
            j = np.arange(_GROUP, dtype=np.int64)
            for a in addrs:
                rows.append((a + j * q) % m)
                cols.append(g * _GROUP + j)
        return np.concatenate(rows), np.concatenate(cols)

    def h_coo(self) -> Tuple[np.ndarray, np.ndarray]:
        """Full H edge list (info part + accumulator), row-major sorted."""
        ir, ic = self.info_edges
        m = self.m
        acc_rows = np.concatenate([np.arange(m), np.arange(1, m)])
        acc_cols = np.concatenate(
            [self.k + np.arange(m), self.k + np.arange(m - 1)]
        )
        rows = np.concatenate([ir, acc_rows])
        cols = np.concatenate([ic, acc_cols])
        order = np.lexsort((cols, rows))
        return rows[order], cols[order]

    @cached_property
    def edge_index(self):
        """Padded edge tables with mod-q layered grouping (360 rows/layer)."""
        from ..ops.bp_edgelist import build_edge_index

        rows, cols = self.h_coo()
        layer = (np.arange(self.m) % self.q).astype(np.int32)
        return build_edge_index(rows, cols, self.n, self.m, layer)

    # -- encoding ----------------------------------------------------------
    def encode_numpy(self, u: np.ndarray) -> np.ndarray:
        """[..., k] info bits -> [..., n]: scatter + prefix-XOR accumulator."""
        u = np.asarray(u)
        rows, cols = self.info_edges
        flat_u = u.reshape(-1, self.k).astype(np.int64)
        flat_lam = np.zeros((flat_u.shape[0], self.m), dtype=np.int64)
        np.add.at(flat_lam.T, rows, flat_u.T[cols])
        p = np.cumsum(flat_lam, axis=-1) & 1
        out = np.concatenate([flat_u & 1, p], axis=-1).astype(u.dtype)
        return out.reshape(*u.shape[:-1], self.n)

    def encode_fn(self):
        """jnp encoder: [B, k] -> [B, n] (jit/shard-safe)."""
        rows, cols = self.info_edges
        rows_j = jnp.asarray(rows, jnp.int32)
        cols_j = jnp.asarray(cols, jnp.int32)
        m, k = self.m, self.k

        def encode(u: jax.Array) -> jax.Array:
            ue = u.astype(jnp.int32)[:, cols_j]  # [B, E_info]
            lam = jnp.zeros((u.shape[0], m), jnp.int32).at[:, rows_j].add(ue)
            p = jnp.cumsum(lam, axis=-1) & 1
            return jnp.concatenate([u.astype(jnp.int32) & 1, p], axis=-1)

        return encode

    def syndrome(self, cw: np.ndarray) -> np.ndarray:
        """H @ c mod 2 via the edge list (numpy, for tests)."""
        rows, cols = self.h_coo()
        cw = np.asarray(cw)
        flat = cw.reshape(-1, self.n).astype(np.int64)
        syn = np.zeros((flat.shape[0], self.m), dtype=np.int64)
        np.add.at(syn.T, rows, flat.T[cols])
        return (syn & 1).reshape(*cw.shape[:-1], self.m)

    def describe(self) -> str:
        e = len(self.info_edges[0]) + 2 * self.m - 1
        return (
            f"DVBS2Code({self.name}: n={self.n}, k={self.k}, q={self.q}, "
            f"rate={self.rate:.3f}, edges~{e})"
        )


# EN 302 307 Table 5b: short-frame (n=16200) k_ldpc per nominal rate — the
# effective rate differs from the label (e.g. "1/2" short is k=7200).
_SHORT_K_LDPC = {
    "1/4": 3240, "1/3": 5400, "2/5": 6480, "1/2": 7200, "3/5": 9720,
    "2/3": 10800, "3/4": 11880, "4/5": 12600, "5/6": 13320, "8/9": 14400,
}


# ---------------------------------------------------------------------------
# Standard-structure IRA code in QC form (EN 302 307 Annex B/C layout)
# ---------------------------------------------------------------------------
#
# EN 302 307 defines the LDPC code by per-group parity-accumulator address
# tables: information bit m of group g (360 bits/group) accumulates into
# parity addresses (a + (m % 360) * q) mod (n - k); parity bits are then the
# running XOR (bidiagonal accumulator).  Under the classic row-residue /
# column-twist permutation (rows and parity bits reordered by residue mod q)
# this H is exactly quasi-cyclic with z = 360:
#
# * info address a of group g  ->  block (a % q, g), shift (-(a // q)) % 360
#   (two addresses of one group may share a residue class: a MULTI-EDGE
#   block, two circulants in one base cell);
# * accumulator row i          ->  parity block-column (i % q) carries the
#   dual diagonal: blocks (a, kb+a) and (a+1, kb+a), both shift 0;
# * the accumulator's wrap     ->  block (0, kb+q-1) with shift z-1, MINUS
#   its first check row (parity bit m-1 has no successor) — a row-masked
#   partial circulant.
#
# The synthetic default tables below keep the standard's exact group/degree
# structure; the genuine Annex B/C integer tables are pure data for
# :func:`parse_address_table` (they could not be embedded here because this
# build environment has no network access to the published standard, and
# transcribing thousands of table constants from memory would risk silently
# corrupt codes — the honest failure mode is a documented synthetic table,
# not a fabricated "standard" one).

#: EN 302 307 Table 5a/5b information-node degree profiles (degree of the
#: heavy groups, count of heavy groups) per (n, rate); the remaining groups
#: have degree 3.  Used to make the synthetic tables structurally faithful.
_DEGREE_PROFILES = {
    (64800, "1/4"): (12, 15), (64800, "1/3"): (12, 20),
    (64800, "2/5"): (12, 24), (64800, "1/2"): (8, 36),
    (64800, "3/5"): (12, 36), (64800, "2/3"): (13, 12),
    (64800, "3/4"): (12, 15), (64800, "4/5"): (11, 18),
    (64800, "5/6"): (13, 15), (64800, "8/9"): (4, 20),
    (64800, "9/10"): (4, 18),
    (16200, "1/2"): (8, 20), (16200, "1/3"): (12, 12),
    (16200, "2/3"): (13, 3), (16200, "3/4"): (12, 3),
    (16200, "4/5"): (3, 0), (16200, "5/6"): (13, 5),
    (16200, "8/9"): (4, 9),
}


def parse_address_table(text: str) -> Tuple[Tuple[int, ...], ...]:
    """Parse an EN 302 307 Annex B/C address table: one line per bit
    group of parity-accumulator addresses.  Returns the ``addresses``
    tuple accepted by :func:`dvbs2_ira_qc` and :func:`dvbs2` — dropping in
    the standard's table yields the bit-true standard code.

    Accepted real-world formats (VERDICT r4 item 8): addresses separated
    by whitespace, commas, or semicolons (the ETSI annex prints them
    comma-separated); ``#`` / ``%`` comments, inline too; non-numeric
    header lines skipped.  Group degrees may vary by row (the standard's
    tables mix degree-8/3 groups); negative addresses raise.  Verify a
    transcription against a registered fingerprint with
    :func:`.tables.verify`."""
    rows = []
    for line in text.strip().splitlines():
        for c in "#%":
            line = line.split(c, 1)[0]
        line = line.replace(",", " ").replace(";", " ").strip()
        if not line:
            continue
        toks = line.split()
        try:
            int(toks[0])
        except ValueError:
            continue  # header line
        row = tuple(int(tok) for tok in toks)
        if any(a < 0 for a in row):
            raise ValueError(f"negative accumulator address in line {line!r}")
        rows.append(row)
    if not rows:
        raise ValueError("no address-table rows found")
    return tuple(rows)


def _count_std_4cycles(addresses, k: int, m: int) -> int:
    """Exact 4-cycle count of the lifted standard-domain H (info spreading
    + parity accumulator): a column pair sharing c >= 2 rows contributes
    C(c, 2) cycles.  Girth >= 6 iff this returns 0; the exact multiplicity
    also ranks candidates on the least-cyclic fallback path."""
    import itertools
    from collections import Counter, defaultdict

    q = m // _GROUP
    rows = defaultdict(list)
    for g, addrs in enumerate(addresses):
        for t in range(_GROUP):
            col = g * _GROUP + t
            for a in addrs:
                rows[(a + t * q) % m].append(col)
    for p in range(m):  # accumulator: parity col p checks rows p, p+1
        rows[p].append(k + p)
        if p + 1 < m:
            rows[p + 1].append(k + p)
    pair_rows = Counter()
    for r in range(m):
        for pair in itertools.combinations(sorted(set(rows[r])), 2):
            pair_rows[pair] += 1
    return sum(c * (c - 1) // 2 for c in pair_rows.values() if c >= 2)


@functools.lru_cache(maxsize=None)
def synthetic_address_table(n: int, rate: str,
                            seed: int = 0) -> Tuple[Tuple[int, ...], ...]:
    """Deterministic address table with the standard's group structure and
    degree profile (NOT the Annex B/C values — see module comment).

    Drawn girth-aware: candidate tables are redrawn until the lifted H has
    no 4-cycles (:func:`_count_std_4cycles`), matching the published
    tables' girth >= 6 — measured on the NR family, unconstrained random
    tables cost 4-23x in FER (BENCH_NOTES / benchmarks/nr_table_select.py).
    Very dense high-rate short frames (e.g. 16200 r5/6: 46k edges on
    m=2880 rows) cannot always reach girth 6 under the standard's group
    structure; then the least-cyclic of the 24 draws is kept and a
    ``UserWarning`` reports the residual exact 4-cycle count (also
    queryable via :func:`table_4cycles`).  Of the shipped grid, r1/2 at
    both frame sizes — the BASELINE configs — reach 0 (pinned by tests).
    """
    num, den = map(int, rate.split("/"))
    k = _SHORT_K_LDPC[rate] if n == 16200 else n * num // den
    m = n - k
    groups = k // _GROUP
    deg_heavy, n_heavy = _DEGREE_PROFILES.get((n, rate), (8, groups // 3))
    best, best_cycles = None, None
    for attempt in range(24):
        rng = np.random.default_rng(302307 + n + 100 * num + den
                                    + 7919 * attempt + 104729 * seed)
        addrs = []
        for g in range(groups):
            deg = deg_heavy if g < n_heavy else 3
            a = rng.choice(m, size=deg, replace=False)
            addrs.append(tuple(int(x) for x in a))
        cycles = _count_std_4cycles(addrs, k, m)
        if cycles == 0:
            return tuple(addrs)
        if best_cycles is None or cycles < best_cycles:
            best, best_cycles = tuple(addrs), cycles
    import warnings

    warnings.warn(
        f"dvbs2 n={n} rate={rate}: no girth-6 table in 24 draws; using the "
        f"least-cyclic candidate ({best_cycles} residual 4-cycles)",
        stacklevel=2,
    )
    return best


def table_4cycles(n: int, rate: str, seed: int = 0) -> int:
    """Exact 4-cycle count of the synthetic default table for (n, rate) —
    0 means the shipped table is girth >= 6."""
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        addrs = synthetic_address_table(n, rate, seed)
    num, den = map(int, rate.split("/"))
    k = _SHORT_K_LDPC[rate] if n == 16200 else n * num // den
    return _count_std_4cycles(addrs, k, n - k)


def dvbs2_ira_qc(n: int = 64800, rate: str = "1/2",
                 addresses: "Tuple[Tuple[int, ...], ...] | None" = None):
    """EN 302 307-structured IRA code as a z=360 :class:`QCCode`.

    Exact standard H structure (accumulator parity, multi-edge blocks,
    masked wrap circulant) in the row-residue-permuted QC domain; pass the
    published Annex B/C ``addresses`` (via :func:`parse_address_table`) for
    the bit-true standard code, or omit for the synthetic default table —
    the PEXIT-designed one where it exists (:mod:`.dvbs2_designed`: the
    16200 low-rate profiles, whose recall measured >1.3 dB from capacity;
    BENCH_NOTES round 4), else the profile-recall synthetic
    (``addresses="legacy"`` forces the latter).
    Use :func:`std_interleave` to map between the standard's transmitted
    bit order and this internal QC order, and :func:`ira_encode_fn` /
    :func:`ira_encode_numpy` for O(n) encoding.
    """
    from .qc import QCCode

    if addresses is None:
        from .dvbs2_designed import DESIGNED_ADDRESSES

        addresses = DESIGNED_ADDRESSES.get((n, rate))
        if addresses is None:
            addresses = synthetic_address_table(n, rate)
    elif isinstance(addresses, str):
        if addresses != "legacy":
            raise ValueError(f"unknown addresses {addresses!r}")
        addresses = synthetic_address_table(n, rate)
    num, den = map(int, rate.split("/"))
    k = _SHORT_K_LDPC[rate] if n == 16200 else n * num // den
    m = n - k
    if k != len(addresses) * _GROUP:
        raise ValueError(
            f"address table has {len(addresses)} groups, expected {k // _GROUP}"
        )
    q = m // _GROUP
    kb = k // _GROUP
    z = _GROUP
    base = np.full((q, kb + q), -1, dtype=np.int32)
    extra = []
    for g, addrs in enumerate(addresses):
        for a in addrs:
            if not 0 <= a < m:
                raise ValueError(f"group {g}: address {a} out of [0, {m})")
            l, s = a % q, (-(a // q)) % z
            if base[l, g] < 0:
                base[l, g] = s
            elif base[l, g] == s:
                raise ValueError(
                    f"group {g}: duplicate address residue (l={l}, s={s}); "
                    "coincident circulants cancel over GF(2)"
                )
            else:
                extra.append((l, g, s))
    # accumulator dual diagonal (all shift 0) + masked wrap block
    for a in range(q):
        base[a, kb + a] = 0
        if a + 1 < q:
            base[a + 1, kb + a] = 0
    wrap = (0, kb + q - 1, z - 1)
    base[wrap[0], wrap[1]] = wrap[2]
    return QCCode(
        name=f"dvbs2ira_n{n}_r{num}{den}",
        base=base,
        z=z,
        extra_blocks=tuple(extra) if extra else None,
        masked_rows=((wrap, (0,)),),
    )


def std_interleave(n: int, k: int) -> np.ndarray:
    """``perm[p_std] = p_internal``: where standard codeword position
    ``p_std`` lives in the internal QC order.

    Information bits keep their order; standard parity bit i (position
    k+i) lives in internal parity block (i % q) at lane (i // q).  Usage:
    ``std = internal[..., perm]`` and ``internal = std[..., argsort(perm)]``
    (same maps apply to LLRs on the receive side).
    """
    m = n - k
    q = m // _GROUP
    perm = np.empty(n, dtype=np.int64)
    perm[:k] = np.arange(k)
    i = np.arange(m)
    perm[k:] = k + (i % q) * _GROUP + i // q
    return perm


#: EN 302 307 §5.3.3 bit-interleaver column counts per constellation
#: (QPSK is not interleaved).
BIT_INTERLEAVER_COLS = {"8psk": 3, "16apsk": 4, "32apsk": 5}


def bit_interleave(bits, nc: int, col_order=None):
    """EN 302 307 §5.3.3 block bit interleaver: the FECFRAME is written
    COLUMN by column into an ``N/nc x nc`` array and read ROW by row, so
    each transmitted symbol takes one bit from each column (= one bit from
    each of ``nc`` equal spans of the codeword — mixing the IRA code's
    weak accumulator tail across constellation bit levels).

    ``col_order``: optional column WRITE order — the standard's 8PSK
    rate-3/5 case uses a non-identity order (Table 8); that permutation is
    drop-in data here, like the other normative tables (PROVENANCE.md).
    Works on bits and LLR tensors alike ([..., N]).
    """
    import jax.numpy as jnp

    lead, n = bits.shape[:-1], bits.shape[-1]
    if n % nc:
        raise ValueError(f"frame length {n} not divisible by {nc} columns")
    m = bits.reshape(*lead, nc, n // nc)
    if col_order is not None:
        if sorted(col_order) != list(range(nc)):
            raise ValueError(f"col_order must permute 0..{nc - 1}")
        inv = np.argsort(np.asarray(col_order))
        m = m[..., jnp.asarray(inv), :]
    return m.swapaxes(-1, -2).reshape(*lead, n)


def bit_deinterleave(llr, nc: int, col_order=None):
    """Inverse of :func:`bit_interleave` (receive side, applied to LLRs)."""
    import jax.numpy as jnp

    lead, n = llr.shape[:-1], llr.shape[-1]
    if n % nc:
        raise ValueError(f"frame length {n} not divisible by {nc} columns")
    m = llr.reshape(*lead, n // nc, nc).swapaxes(-1, -2)
    if col_order is not None:
        if sorted(col_order) != list(range(nc)):
            raise ValueError(f"col_order must permute 0..{nc - 1}")
        m = m[..., jnp.asarray(np.asarray(col_order)), :]
    return m.reshape(*lead, n)


def ira_encode_numpy(code, u: np.ndarray) -> np.ndarray:
    """O(n) encode for :func:`dvbs2_ira_qc` codes: blockwise info row sums,
    prefix-XOR accumulator in standard row order, residue-permuted back to
    the internal QC parity layout.  Output is the INTERNAL-order codeword
    (H @ c = 0 for the QCCode's H); apply :func:`std_interleave` for the
    transmitted standard order."""
    u = np.asarray(u)
    z = code.z
    q = code.m_b
    kb = code.k // z
    flat = np.ascontiguousarray(u.reshape(-1, code.k) & 1, dtype=np.uint8)
    b = flat.shape[0]
    ub = flat.reshape(b, kb, z)
    # lam_int[l, u_pos] = XOR over info circulants of layer l; contiguous
    # uint8 per-layer buffers (a strided in-place XOR on a [b, q, z] slab
    # is ~50x slower in numpy)
    br, bc, sh = code.blocks
    lams = [np.zeros((b, z), np.uint8) for _ in range(q)]
    for e in range(len(br)):
        l, g, s = int(br[e]), int(bc[e]), int(sh[e])
        if g >= kb:
            continue  # accumulator blocks are not info contributions
        lams[l] ^= np.roll(ub[:, g, :], -s, axis=-1)
    lam = np.stack(lams, axis=1)  # [b, q, z]
    # standard row order: i = u_pos * q + l  ->  transpose
    lam_std = np.ascontiguousarray(lam.transpose(0, 2, 1)).reshape(b, q * z)
    p_std = np.bitwise_xor.accumulate(lam_std, axis=-1)
    p_int = np.ascontiguousarray(
        p_std.reshape(b, z, q).transpose(0, 2, 1)
    ).reshape(b, q * z)
    out = np.concatenate([flat, p_int], axis=-1).astype(u.dtype)
    return out.reshape(*u.shape[:-1], code.n)


def ira_encode_fn(code):
    """jnp version of :func:`ira_encode_numpy` (jit/shard-safe)."""
    z = code.z
    q = code.m_b
    kb = code.k // z
    br, bc, sh = code.blocks
    entries = [
        (int(br[e]), int(bc[e]), int(sh[e]))
        for e in range(len(br)) if int(bc[e]) < kb
    ]
    per_layer = [[(g, s) for (l, g, s) in entries if l == lay] for lay in range(q)]

    def encode(u: jax.Array) -> jax.Array:
        ub = u.reshape(*u.shape[:-1], kb, z).astype(jnp.int32)
        lams = []
        for lay in range(q):
            acc = jnp.zeros(u.shape[:-1] + (z,), jnp.int32)
            for (g, s) in per_layer[lay]:
                acc = acc ^ jnp.roll(ub[..., g, :], -s, axis=-1)
            lams.append(acc)
        lam = jnp.stack(lams, axis=-2)  # [..., q, z]
        lam_std = jnp.swapaxes(lam, -1, -2).reshape(*u.shape[:-1], q * z)
        p_std = jnp.cumsum(lam_std & 1, axis=-1) & 1
        p_int = jnp.swapaxes(
            p_std.reshape(*u.shape[:-1], z, q), -1, -2
        ).reshape(*u.shape[:-1], q * z)
        return jnp.concatenate([u.astype(jnp.int32) & 1, p_int], axis=-1)

    return encode


def dvbs2(n: int = 64800, rate: str = "1/2",
          addresses: "Tuple[Tuple[int, ...], ...] | None" = None):
    """The blessed DVB-S2 constructor: the EN 302 307 IRA structure in
    z=360 QC form (alias of :func:`dvbs2_ira_qc`) — O(n) accumulator
    encoding via :func:`ira_encode_fn`, block-structured jnp decode.
    Supported n: 64800 (normal FECFRAME), 16200 (short)."""
    return dvbs2_ira_qc(n, rate, addresses)


def dvbs2_oracle(n: int = 64800, rate: str = "1/2") -> DVBS2Code:
    """Standard-domain (un-permuted) DVB-S2 code on the generic edge-list
    path — the INDEPENDENT TEST ORACLE for :func:`dvbs2`'s QC
    transformation (same default address tables, designed or synthetic),
    not a production decoder.  Use :func:`dvbs2` everywhere else."""
    num, den = map(int, rate.split("/"))
    if n == 16200:
        if rate not in _SHORT_K_LDPC:
            raise ValueError(f"unknown short-frame rate {rate!r}")
        k = _SHORT_K_LDPC[rate]
    else:
        k = n * num // den
    if (n - k) % _GROUP or k % _GROUP:
        raise ValueError(f"n={n} rate={rate}: k and m must be multiples of 360")
    from .dvbs2_designed import DESIGNED_ADDRESSES

    return DVBS2Code(
        name=f"dvbs2_n{n}_r{num}{den}",
        n=n,
        k=k,
        addresses=DESIGNED_ADDRESSES.get((n, rate))
        or synthetic_address_table(n, rate),
    )
