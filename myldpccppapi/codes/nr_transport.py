"""TS 38.212 transport-block processing: segmentation, rate matching,
interleaving, and the batched receive chain.

The reference framework codes one LDPC block at a time (``Coder::encode``
chunks a byte stream into codewords, ``MyLdpc.cpp:554-569``); an NR
transmitter/receiver works on *transport blocks*: a payload of A bits gets
a TB-level CRC (§7.2.1: CRC24A, or CRC16 for A <= 3824), is segmented into
C code blocks each with its own CRC24B and known-zero filler bits
(§5.2.2), LDPC-encoded per block (§5.3.2), circular-buffer rate-matched
with filler skipping (§5.4.2.1), bit-interleaved by modulation order
(§5.4.2.2), and concatenated (§5.5).  This module implements that chain
end-to-end in batched form:

* all per-block structure (segment boundaries, filler ranges, circular-
  buffer selection order) is resolved to **static numpy index runs** at
  plan time, so the jitted encode/receive functions contain only static
  slices, reshapes and one matmul per CRC — no dynamic control flow;
* the C code blocks of a transport block decode as ONE batch of shape
  [B*C, n] on the fused kernels (the reference's batch axis, reused);
* CRC24B acceptance inside the decode loop uses ``DecoderConfig.crc`` with
  ``crc_span=K'`` so the filler tail is excluded (the 38.212 layout).

Segmentation parameters follow §5.2.2 exactly: K_cb = 8448/3840,
K_b selection by B, Z = the smallest 38.212 lifting size with
K_b * Z >= K', K = 22Z (BG1) / 10Z (BG2), fillers F = K - K'.  For
payload sizes whose B' is not divisible by C (the standard's TBS
quantization always makes it divisible) the last code block's data is
zero-padded up to the common K' before its CRC24B — the receiver truncates
the reassembled stream back to A bits.

The base-graph shift *values* default to this package's synthetic girth-6
tables (see ``codes/nr.py`` and PROVENANCE.md); pass ``table=`` with the
parsed published tables for the bit-interoperable standard code.
"""
from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .nr import NR_LIFTING_SETS, nr_code, rv_start, triangular_encode_fn
from .crc import CRC_POLYS, crc_attach_fn, crc_check_fn

__all__ = [
    "TBFormat",
    "TBResult",
    "NRTransport",
    "plan_tb",
    "select_base_graph",
    "interleave_bits",
    "deinterleave_llr",
]

#: §5.2.2 maximum code block size per base graph.
KCB = {1: 8448, 2: 3840}
#: LLR asserted for known-zero filler bits at the receiver (bit 0 => +).
FILLER_LLR = 127.0
#: §7.2.1: transport blocks above this payload size use CRC24A, else CRC16.
TB_CRC16_MAX_A = 3824

_ALL_Z = sorted(z for zs in NR_LIFTING_SETS for z in zs)


def select_base_graph(a: int, rate: float) -> int:
    """TS 38.212 §7.2.2 base-graph selection from payload size and target
    code rate."""
    if a <= 292 or (a <= 3824 and rate <= 0.67) or rate <= 0.25:
        return 2
    return 1


def _kb(bg: int, b: int) -> int:
    """§5.2.2 K_b (the column count used for lifting-size selection)."""
    if bg == 1:
        return 22
    if b > 640:
        return 10
    if b > 560:
        return 9
    if b > 192:
        return 8
    return 6


def _min_lifting(k_min: int, kb: int) -> int:
    for z in _ALL_Z:
        if kb * z >= k_min:
            return z
    raise ValueError(
        f"K'={k_min} exceeds the largest lifting size (K_b={kb}, Zmax=384)"
    )


@dataclasses.dataclass(frozen=True)
class TBFormat:
    """Static plan of one transport-block configuration (hashable, usable
    as a jit static argument).  Build with :func:`plan_tb`."""

    a: int                     #: payload bits
    g: int                     #: total rate-matched bits across the TB
    bg: int                    #: base graph (1 or 2)
    qm: int = 1                #: modulation order (bits/symbol) for §5.4.2.2
    nl: int = 1                #: number of transmission layers
    rv: int = 0                #: redundancy version (Table 5.4.2.1-2)
    tb_crc: str = "24A"        #: TB-level CRC name (24A, or 16 for small A)
    cb_crc: Optional[str] = None  #: per-code-block CRC (24B when C > 1)
    c: int = 1                 #: number of code blocks
    k_prime: int = 0           #: bits per code block incl. CB CRC (§5.2.2 K')
    z: int = 0                 #: lifting size Zc
    k: int = 0                 #: info bits per code block (22Z / 10Z)
    f: int = 0                 #: filler bits per code block (K - K')
    pad: int = 0               #: zero-pad bits in the last block's data
    e_r: Tuple[int, ...] = ()  #: rate-matched length per code block

    @property
    def n_cb(self) -> int:
        """Circular-buffer length N (66Z for BG1, 50Z for BG2; no LBRM)."""
        return (66 if self.bg == 1 else 50) * self.z

    @property
    def tb_crc_len(self) -> int:
        return CRC_POLYS[self.tb_crc][0]

    @property
    def cb_crc_len(self) -> int:
        return CRC_POLYS[self.cb_crc][0] if self.cb_crc else 0

    @property
    def b(self) -> int:
        """Payload + TB CRC bits."""
        return self.a + self.tb_crc_len

    @property
    def data_per_block(self) -> int:
        """Data bits per code block (before the CB CRC)."""
        return self.k_prime - self.cb_crc_len

    def describe(self) -> str:
        return (
            f"TB A={self.a} G={self.g} BG{self.bg} Qm={self.qm}: "
            f"C={self.c} K'={self.k_prime} Z={self.z} K={self.k} "
            f"F={self.f} E={sorted(set(self.e_r))}"
        )


def plan_tb(a: int, g: int, *, bg: Optional[int] = None, qm: int = 1,
            nl: int = 1, rv: int = 0,
            rate: Optional[float] = None) -> TBFormat:
    """Resolve the §5.2.2/§5.4.2.1 parameters of one transport block.

    ``a``: payload bits; ``g``: total bits available for its transmission
    (must be a multiple of ``nl * qm``); ``bg`` defaults to the §7.2.2
    selection at code rate ``rate`` (default a/g).
    """
    if a <= 0 or g <= 0:
        raise ValueError("a and g must be positive")
    if g % (nl * qm):
        raise ValueError(f"g={g} must be a multiple of nl*qm={nl * qm}")
    if bg is None:
        bg = select_base_graph(a, a / g if rate is None else rate)
    if bg not in (1, 2):
        raise ValueError(f"bg must be 1 or 2, got {bg}")

    tb_crc = "16" if a <= TB_CRC16_MAX_A else "24A"
    b = a + CRC_POLYS[tb_crc][0]
    kcb = KCB[bg]
    if b <= kcb:
        c, cb_crc, lcb = 1, None, 0
        k_prime = b
    else:
        lcb = 24
        c = math.ceil(b / (kcb - lcb))
        cb_crc = "24B"
        k_prime = math.ceil(b / c) + lcb
    pad = c * (k_prime - lcb) - b
    kb = _kb(bg, b)
    z = _min_lifting(k_prime, kb)
    k = (22 if bg == 1 else 10) * z
    f = k - k_prime

    # §5.4.2.1 per-block rate-matched lengths E_r
    unit = nl * qm
    base = g // (unit * c)
    gamma = (g // unit) % c
    e_r = tuple(
        unit * (base + (1 if r >= c - gamma else 0)) for r in range(c)
    )
    assert sum(e_r) == g
    return TBFormat(a=a, g=g, bg=bg, qm=qm, nl=nl, rv=rv, tb_crc=tb_crc,
                    cb_crc=cb_crc, c=c, k_prime=k_prime, z=z, k=k, f=f,
                    pad=pad, e_r=e_r)


# ---------------------------------------------------------------------------
# §5.4.2.2 bit interleaver: f_{i + j*Qm} = e_{i*(E/Qm) + j}
# ---------------------------------------------------------------------------

def interleave_bits(e: jax.Array, qm: int) -> jax.Array:
    """[..., E] rate-matched bits -> [..., E] interleaved (§5.4.2.2)."""
    if qm == 1:
        return e
    lead, n = e.shape[:-1], e.shape[-1]
    return e.reshape(*lead, qm, n // qm).swapaxes(-1, -2).reshape(*lead, n)


def deinterleave_llr(f: jax.Array, qm: int) -> jax.Array:
    """Inverse of :func:`interleave_bits` (applied to received LLRs)."""
    if qm == 1:
        return f
    lead, n = f.shape[:-1], f.shape[-1]
    return f.reshape(*lead, n // qm, qm).swapaxes(-1, -2).reshape(*lead, n)


# ---------------------------------------------------------------------------
# §5.4.2.1 bit selection as static slice runs
# ---------------------------------------------------------------------------

def _selection_runs(n_cb: int, f_start: int, f_stop: int, k0: int,
                    e: int) -> Tuple[Tuple[int, int], ...]:
    """The circular-buffer walk from ``k0`` skipping filler positions
    [f_start, f_stop), compressed to half-open (start, stop) index runs
    totaling ``e`` positions.  Wholly numpy at plan time; the jitted
    encode/receive paths turn each run into one static slice."""
    order = (k0 + np.arange(n_cb)) % n_cb
    keep = (order < f_start) | (order >= f_stop)
    seq = order[keep]
    if seq.size == 0:
        raise ValueError("fillers cover the whole circular buffer")
    reps = -(-e // seq.size)
    seq = np.tile(seq, reps)[:e]
    # compress consecutive +1 increments into runs
    cuts = np.flatnonzero(np.diff(seq) != 1) + 1
    starts = np.concatenate([[0], cuts])
    stops = np.concatenate([cuts, [e]])
    return tuple(
        (int(seq[s]), int(seq[s] + (t - s))) for s, t in zip(starts, stops)
    )


class TBResult(NamedTuple):
    """Decoded transport block plus per-code-block statistics."""

    payload: jax.Array     #: [B, A] uint8 decoded payload bits
    tb_ok: jax.Array       #: [B] bool: every CB accepted AND TB CRC passes
    tb_crc_ok: jax.Array   #: [B] bool: TB-level CRC over the payload
    cb_ok: jax.Array       #: [B, C] bool: per-CB acceptance (syndrome+CRC)
    converged: jax.Array   #: [B, C] bool: per-CB LDPC syndrome satisfied
    iterations: jax.Array  #: [B, C] int32 BP iterations per code block


class NRTransport:
    """Batched TS 38.212 transport-block codec bound to one :class:`TBFormat`.

    >>> fmt = plan_tb(a=8448, g=25344, qm=2)
    >>> t = NRTransport(fmt)
    >>> tx = t.encode(payload)            # [B, A] 0/1 -> [B, G] int8
    >>> res = t.receive(llr)              # [B, G] float -> TBResult
    ``decoder_config`` defaults to layered normalized min-sum with in-loop
    CRC24B acceptance when the TB is segmented.
    """

    def __init__(self, fmt: TBFormat, table: Optional[np.ndarray] = None,
                 decoder_config=None):
        from ..decoder import Decoder
        from ..utils.config import DecoderConfig

        self.fmt = fmt
        self.code = nr_code(fmt.z, fmt.bg, table)
        assert self.code.k == fmt.k and self.code.punctured_front == 2 * fmt.z
        if decoder_config is None:
            decoder_config = DecoderConfig(normalization=0.75)
        if fmt.cb_crc and decoder_config.crc is None:
            decoder_config = dataclasses.replace(
                decoder_config, crc=fmt.cb_crc, crc_span=fmt.k_prime
            )
        self.decoder = Decoder(self.code, decoder_config)

        # static plan: per-distinct-E selection runs (fillers are uniform
        # across blocks by construction — the pad lives inside the last
        # block's data)
        k0 = rv_start(self.code, fmt.rv, fmt.n_cb)
        fs = fmt.k_prime - 2 * fmt.z
        fe = fmt.k - 2 * fmt.z
        if fs <= 0:
            raise ValueError("K' <= 2Z: filler range reaches the punctured "
                             "front (unsupported corner)")
        self._runs = {
            e: _selection_runs(fmt.n_cb, fs, fe, k0, e)
            for e in set(fmt.e_r)
        }
        self._filler = (fs, fe)
        self._tb_attach = crc_attach_fn(fmt.a, fmt.tb_crc)
        self._tb_check = crc_check_fn(fmt.a, fmt.tb_crc)
        if fmt.cb_crc:
            self._cb_attach = crc_attach_fn(fmt.data_per_block, fmt.cb_crc)
            self._cb_check = crc_check_fn(fmt.data_per_block, fmt.cb_crc)
        self._encode_cw = triangular_encode_fn(self.code)
        self.encode = jax.jit(self._encode)
        self.segment = jax.jit(self._segment)
        self._receive = jax.jit(self._receive_impl)

    # -- transmit -----------------------------------------------------------

    def _segment(self, payload: jax.Array) -> jax.Array:
        """[B, A] payload bits -> [B, C, K] code-block info bits (§5.2.2)."""
        fmt = self.fmt
        if payload.shape[-1] != fmt.a:
            raise ValueError(f"payload must be [..., {fmt.a}]")
        b = payload.shape[0]
        tbb = self._tb_attach(payload.astype(jnp.int8))  # [B, b]
        if fmt.pad:
            tbb = jnp.concatenate(
                [tbb, jnp.zeros((b, fmt.pad), jnp.int8)], axis=-1
            )
        blocks = tbb.reshape(b, fmt.c, fmt.data_per_block)
        if fmt.cb_crc:
            blocks = self._cb_attach(
                blocks.reshape(b * fmt.c, fmt.data_per_block)
            ).reshape(b, fmt.c, fmt.k_prime)
        fill = jnp.zeros((b, fmt.c, fmt.f), jnp.int8)
        return jnp.concatenate([blocks, fill], axis=-1)  # [B, C, K]

    def _encode(self, payload: jax.Array) -> jax.Array:
        """[B, A] payload bits -> [B, G] transmitted bits."""
        fmt = self.fmt
        cbs = self._segment(payload)                      # [B, C, K]
        cw = self._encode_cw(cbs)                         # [B, C, n]
        buf = cw[..., 2 * fmt.z:]                         # [B, C, N_cb]
        outs = []
        for r, e in enumerate(fmt.e_r):
            sel = jnp.concatenate(
                [buf[:, r, s:t] for (s, t) in self._runs[e]], axis=-1
            )
            outs.append(interleave_bits(sel, fmt.qm))
        return jnp.concatenate(outs, axis=-1).astype(jnp.int8)

    # -- receive ------------------------------------------------------------

    def llr_to_blocks(self, llr: jax.Array) -> jax.Array:
        """[B, G] received LLRs -> [B, C, n] decoder inputs: deinterleave,
        de-rate-match (repeats accumulate), assert fillers, zero the
        punctured front."""
        fmt = self.fmt
        if llr.shape[-1] != fmt.g:
            raise ValueError(f"llr must be [..., {fmt.g}]")
        b = llr.shape[0]
        fs, fe = self._filler
        bufs = []
        off = 0
        for r, e in enumerate(fmt.e_r):
            seg = deinterleave_llr(llr[:, off:off + e], fmt.qm)
            off += e
            buf = jnp.zeros((b, fmt.n_cb), llr.dtype)
            pos = 0
            for (s, t) in self._runs[e]:
                buf = buf.at[:, s:t].add(seg[:, pos:pos + (t - s)])
                pos += t - s
            buf = buf.at[:, fs:fe].set(FILLER_LLR)
            bufs.append(buf)
        buf = jnp.stack(bufs, axis=1)                     # [B, C, N_cb]
        front = jnp.zeros((b, fmt.c, 2 * fmt.z), llr.dtype)
        return jnp.concatenate([front, buf], axis=-1)     # [B, C, n]

    def _receive_impl(self, llr: jax.Array) -> TBResult:
        fmt = self.fmt
        b = llr.shape[0]
        blocks = self.llr_to_blocks(llr).reshape(b * fmt.c, -1)
        res = self.decoder(blocks)
        info = res.bits[:, : fmt.k].reshape(b, fmt.c, fmt.k)
        cb_ok = res.ok.reshape(b, fmt.c)
        if fmt.cb_crc:
            # post-decode CB CRC recheck: keeps cb_ok = syndrome AND CRC24B
            # even under a custom decoder_config without in-loop CRC
            # acceptance (idempotent when the in-loop latch is active)
            cb_bits = info[..., : fmt.k_prime].reshape(
                b * fmt.c, fmt.k_prime
            )
            cb_ok = cb_ok & self._cb_check(cb_bits.astype(jnp.int8)).reshape(
                b, fmt.c
            )
        data = info[..., : fmt.data_per_block]            # drop CB CRC+fill
        stream = data.reshape(b, fmt.c * fmt.data_per_block)
        tbb = stream[:, : fmt.b]                          # drop the pad
        tb_crc_ok = self._tb_check(tbb.astype(jnp.int8))
        return TBResult(
            payload=tbb[:, : fmt.a].astype(jnp.uint8),
            tb_ok=jnp.all(cb_ok, axis=-1) & tb_crc_ok,
            tb_crc_ok=tb_crc_ok,
            cb_ok=cb_ok,
            converged=res.converged.reshape(b, fmt.c),
            iterations=res.iterations.reshape(b, fmt.c),
        )

    def receive(self, llr: jax.Array) -> TBResult:
        """[B, G] received LLRs (positive => bit 0) -> :class:`TBResult`."""
        return self._receive(llr.astype(jnp.float32))
