"""End-to-end Monte-Carlo simulation steps, single-chip and mesh-sharded.

The batched replacement for the reference's CLI roundtrip harness
(``Test.cpp:15-118``: plaintext -> encode -> BPSK/AWGN -> decode -> error
count), redesigned as a pure function of a PRNG key so it can be jitted,
vmapped over SNR points, and sharded over a device mesh with ``psum``'d
error statistics — the multi-host campaign the reference has no analogue of
(SURVEY.md §2.3).

A "step" simulates one batch: sample random info bits, encode (int8 matmul
for systematic QC codes, or a family-specific jnp ``encode_fn`` — NR
triangular back-substitution, DVB-S2 accumulator), BPSK+AWGN, decode, and
count bit/frame errors against the known truth.  Statistics are exact
integers so campaign accumulation is associative.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..utils.config import DecoderConfig
from ..ops.channel import sigma_from_snr_db, channel_llr
from .mesh import DATA_AXIS

__all__ = [
    "SimStats",
    "matmul_encode_fn",
    "make_decode_fn",
    "sim_step",
    "make_sharded_campaign_step",
    "serial_campaign_step",
]


class SimStats(NamedTuple):
    """Exact error statistics for one simulated batch (per SNR point).

    ``frame_errors`` counts every frame with info-bit errors; the
    detected/undetected split distinguishes errors the receiver KNOWS about
    (frame not accepted: unconverged, or CRC-rejected under CRC-aided
    acceptance) from silently wrong accepted frames:
    ``detected = frame_errors - undetected_errors``.
    """

    frames: jax.Array        # codewords simulated
    frame_errors: jax.Array  # codewords with >=1 info-bit error
    bit_errors: jax.Array    # wrong info bits
    info_bits: jax.Array     # info bits simulated (frames * k_info)
    iterations: jax.Array    # total BP iterations used (sum over frames)
    unconverged: jax.Array   # frames that hit the iteration cap
    #: frames ACCEPTED (syndrome, and CRC when configured) yet wrong — the
    #: receiver cannot see these errors
    undetected_errors: jax.Array = np.int64(0)
    #: frames whose syndrome converged but the CRC rejected them (wrong-
    #: codeword convergence caught by CRC-aided acceptance; 0 without CRC)
    crc_rejected: jax.Array = np.int64(0)


def matmul_encode_fn(code, encoder=None) -> Callable[[jax.Array], jax.Array]:
    """[B, k] info bits (int8) -> [B, n] codeword bits, via an int8 matmul
    with int32 accumulation — exact on every backend (systematic or
    information-set permuted, per the code's Encoder)."""
    from ..codes.encoder import Encoder

    enc = encoder if encoder is not None else Encoder(code)
    w_t = jnp.asarray(enc.mats.w.T, dtype=jnp.int8)
    inv_perm = None
    if enc.mats.perm is not None:
        inv = np.empty(len(enc.mats.perm), dtype=np.int64)
        inv[enc.mats.perm] = np.arange(len(enc.mats.perm))
        inv_perm = jnp.asarray(inv)

    def encode(u: jax.Array) -> jax.Array:
        acc = jax.lax.dot_general(
            u.astype(jnp.int8), w_t, (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32,
        )
        stacked = jnp.concatenate([u.astype(jnp.int32), acc & 1], axis=-1)
        return stacked if inv_perm is None else stacked[:, inv_perm]

    return encode


def make_decode_fn(code, cfg: DecoderConfig):
    """The implementation-dispatched decode callable (traceable).

    Uses the Decoder facade so campaigns pick up the same dispatch as
    everything else (decoder.select_implementation): the fused CUDA kernel
    (+ triage) where it serves the code on a GPU, jnp otherwise, edge-list
    for non-QC codes.
    """
    from ..decoder import Decoder

    return Decoder(code, cfg)


def sim_step(
    code,
    cfg: DecoderConfig,
    key: jax.Array,
    snr_db: jax.Array,
    batch: int,
    encode_fn: Optional[Callable] = None,
    decode_fn: Optional[Callable] = None,
    llr_scale: Optional[float] = None,
    outer: "Optional[tuple]" = None,
    mod=None,
    demap: str = "maxlog",
    id_outer: int = 0,
) -> SimStats:
    """Simulate one batch at one SNR point.  Pure; jit/vmap/shard-safe.

    ``snr_db``: scalar (may be traced).  Noise sigma follows the reference
    CLI convention sigma = 10^(-snr/20) (``Test.cpp:57``).

    ``mod`` (an ``ops.modulation.Modulation``, default BPSK) selects the
    constellation: non-BPSK symbols go through complex AWGN with
    per-component sigma (so ``snr_db`` stays Es/sigma^2 in dB, the same
    convention as the BPSK path) and the ``demap`` soft demapper
    ("maxlog"/"exact") produces the decoder LLRs.

    ``id_outer > 0`` (non-BPSK only) runs BICM-ID: that many
    demapper<->decoder extrinsic exchanges after the first pass
    (:mod:`..ops.bicm_id`), replacing the one-shot ``decode_fn``.

    When ``cfg.crc`` is set, random MESSAGE bits are drawn and the CRC is
    attached (TS 38.212 §5.1 code-block layout) before encoding, so the
    decoder's CRC-aided acceptance sees consistent frames; errors are still
    counted over the full information block (message + CRC field).

    ``outer=("bch", m, t)`` instead runs the EN 302 307 concatenated flow:
    the BCH parity (codes/bch.py) fills the last m*t' info bits, and frame
    acceptance is syndrome AND BCH-detection — post-decode, matching the
    DVB receiver (which repairs residuals with BCH rather than iterating
    the LDPC).  Outer-rejected frames count into ``crc_rejected``.
    """
    if encode_fn is None:
        encode_fn = matmul_encode_fn(code)
    if decode_fn is None:
        decode_fn = make_decode_fn(code, cfg)
    info_pos = jnp.asarray(code.info_positions)
    kbits = len(info_pos)
    k_u, k_n = jax.random.split(key)
    outer_check = None
    if cfg.crc and (outer is not None or cfg.outer):
        raise ValueError("choose either cfg.crc or an outer code, not both")
    if cfg.outer:
        if outer is not None and tuple(outer) != tuple(cfg.outer):
            raise ValueError(
                f"outer={outer} disagrees with cfg.outer={cfg.outer}"
            )
        # in-loop outer acceptance: the decoder's latch already requires
        # BCH detection (DecoderConfig.outer); the sim only attaches
        outer = cfg.outer
    if cfg.crc:
        from ..codes.crc import CRC_POLYS, crc_attach_fn

        k_msg = kbits - CRC_POLYS[cfg.crc][0]
        attach = crc_attach_fn(k_msg, cfg.crc)
        msg = jax.random.bernoulli(k_u, 0.5, (batch, k_msg)).astype(jnp.int8)
        u = attach(msg)  # [B, kbits] message || CRC
    elif outer is not None:
        kind, m, t = outer
        if kind != "bch":
            raise ValueError(f"unknown outer code {kind!r}")
        from ..codes.bch import bch_attach_fn, bch_check_fn, bch_matrix

        par = bch_matrix(1, m, t).shape[1]
        k_msg = kbits - par
        attach = bch_attach_fn(k_msg, m, t)
        if not cfg.outer:
            # post-decode acceptance (the DVB receiver's flow); with
            # cfg.outer the decoder's own latch requires BCH detection
            outer_check = bch_check_fn(k_msg, m, t)
        msg = jax.random.bernoulli(k_u, 0.5, (batch, k_msg)).astype(jnp.int8)
        u = attach(msg)  # [B, kbits] message || BCH parity (BCHFEC)
    else:
        u = jax.random.bernoulli(k_u, 0.5, (batch, kbits)).astype(jnp.int8)
    cw = encode_fn(u)  # [B, n] 0/1 ints
    sigma = sigma_from_snr_db(snr_db)
    if mod is None or mod.name == "bpsk":
        if id_outer:
            raise ValueError("id_outer (BICM-ID) needs a non-BPSK mod")
        sym = 1.0 - 2.0 * cw.astype(jnp.float32)
        y = sym + sigma * jax.random.normal(k_n, sym.shape, dtype=jnp.float32)
        llr = channel_llr(y, sigma, llr_scale)
        res = decode_fn(llr)
    else:
        if llr_scale is not None:
            raise ValueError("llr_scale is a BPSK-path quirk knob; the "
                             "soft demapper computes true LLRs")
        from ..ops.modulation import demap_llr, modulate

        sym = modulate(cw, mod)
        noise = jax.random.normal(k_n, sym.shape + (2,), dtype=jnp.float32)
        y = sym + sigma * jax.lax.complex(noise[..., 0], noise[..., 1])
        n0 = 2.0 * sigma * sigma
        if id_outer:
            from ..ops.bicm_id import make_bicm_id_receive

            rx = make_bicm_id_receive(code, cfg, mod, n_outer=id_outer,
                                      method=demap)
            res = rx(y, n0)
        else:
            res = decode_fn(demap_llr(y, n0, mod, demap))
    decoded_info = res.bits[:, info_pos].astype(jnp.int8)
    bit_err = jnp.sum((decoded_info != u).astype(jnp.int32), axis=-1)  # [B]
    accepted = res.ok  # syndrome, and CRC when CRC-aided
    if outer_check is not None:
        accepted = accepted & outer_check(decoded_info)
    i64 = jnp.int64 if jax.config.read("jax_enable_x64") else jnp.int32
    return SimStats(
        frames=jnp.asarray(batch, i64),
        frame_errors=jnp.sum(bit_err > 0).astype(i64),
        bit_errors=jnp.sum(bit_err).astype(i64),
        info_bits=jnp.asarray(batch * kbits, i64),
        iterations=jnp.sum(res.iterations).astype(i64),
        unconverged=jnp.sum(~res.converged).astype(i64),
        undetected_errors=jnp.sum((bit_err > 0) & accepted).astype(i64),
        crc_rejected=jnp.sum(res.converged & ~accepted).astype(i64),
    )


def _shard_stats(code, cfg, key, shard, snr_local, batch, encode_fn,
                 decode_fn, llr_scale, outer, mod, demap, id_outer):
    """One shard's SNR points: every shard simulates independent noise,
    keyed by its position ``shard = data_index * n_snr_shards +
    snr_index`` in the mesh, one split key per local SNR point."""
    key = jax.random.fold_in(key, shard)

    def one(args):
        i, k = args
        return sim_step(
            code, cfg, k, snr_local[i], batch, encode_fn, decode_fn,
            llr_scale, outer=outer, mod=mod, demap=demap, id_outer=id_outer,
        )

    keys = jax.random.split(key, snr_local.shape[0])
    return jax.lax.map(one, (jnp.arange(snr_local.shape[0]), keys))


def serial_campaign_step(
    code,
    cfg: DecoderConfig,
    key: jax.Array,
    snr_db: jax.Array,
    n_data: int,
    n_snr_shards: int,
    batch_per_device: int,
    encode_fn: Optional[Callable] = None,
    decode_fn: Optional[Callable] = None,
    llr_scale: Optional[float] = None,
    outer: "Optional[tuple]" = None,
    mod=None,
    demap: str = "maxlog",
    id_outer: int = 0,
) -> SimStats:
    """The sharded campaign step's statistics, computed shard by shard on
    the default device: the same keys, SNR points and batches as
    :func:`make_sharded_campaign_step` over a mesh with ``n_data`` data
    shards and ``n_snr_shards`` SNR shards, summed over the data axis.
    The reference a mesh run is checked against."""
    if encode_fn is None:
        encode_fn = matmul_encode_fn(code)
    num_snr = snr_db.shape[0]
    per = num_snr // n_snr_shards
    step = jax.jit(lambda k, shard, snr_local: _shard_stats(
        code, cfg, k, shard, snr_local, batch_per_device, encode_fn,
        decode_fn, llr_scale, outer, mod, demap, id_outer))
    parts = []
    for s in range(n_snr_shards):
        snr_local = snr_db[s * per:(s + 1) * per]
        shards = [step(key, d * n_snr_shards + s, snr_local)
                  for d in range(n_data)]
        parts.append(jax.tree.map(lambda *xs: sum(xs[1:], xs[0]), *shards))
    return jax.tree.map(lambda *xs: jnp.concatenate(xs), *parts)


def make_sharded_campaign_step(
    code,
    cfg: DecoderConfig,
    mesh: Mesh,
    batch_per_device: int,
    num_snr: int,
    encode_fn: Optional[Callable] = None,
    decode_fn: Optional[Callable] = None,
    llr_scale: Optional[float] = None,
    data_axis: str = DATA_AXIS,
    snr_axis: Optional[str] = None,
    outer: "Optional[tuple]" = None,
    mod=None,
    demap: str = "maxlog",
    id_outer: int = 0,
):
    """Build the sharded campaign step: (key, snr_db[num_snr]) -> SimStats
    with leading SNR axis [num_snr].

    The codeword batch is sharded over ``data_axis``; if ``snr_axis`` is a
    mesh axis, the SNR grid is additionally sharded over it (the BASELINE
    config-5 layout).  Per-SNR statistics are ``psum``'d over the data axis
    on-device — the reference's host-side error count (``Test.cpp:105-110``)
    becomes one collective.  Total frames simulated per call:
    ``num_snr * batch_per_device * mesh.shape[data_axis]``.
    :func:`serial_campaign_step` replays the same shards on one device.
    """
    snr_axis = snr_axis if snr_axis and snr_axis in mesh.axis_names else None
    n_snr_shards = mesh.shape[snr_axis] if snr_axis else 1
    if num_snr % n_snr_shards:
        raise ValueError(
            f"num_snr={num_snr} not divisible by snr mesh axis {n_snr_shards}"
        )
    if encode_fn is None:
        encode_fn = matmul_encode_fn(code)

    snr_spec = P(snr_axis) if snr_axis else P()

    def local_step(key, snr_local):
        d = jax.lax.axis_index(data_axis)
        s = jax.lax.axis_index(snr_axis) if snr_axis else 0
        stats = _shard_stats(
            code, cfg, key, d * n_snr_shards + s, snr_local,
            batch_per_device, encode_fn, decode_fn, llr_scale, outer, mod,
            demap, id_outer,
        )
        return jax.tree.map(lambda x: jax.lax.psum(x, data_axis), stats)

    return shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(), snr_spec),
        out_specs=snr_spec,
        check_vma=False,
    )
