"""Belief-propagation decoders for QC-LDPC codes, pure jnp/XLA path.

Batched redesign of the reference's OpenCL decode kernels
(``decodeCL.c``: SP family 3-108, MS family 113-199, TDMP family 203-300):

* The per-edge linked-list walks become **static cyclic rotations** of
  contiguous ``[z, batch]`` tiles — the quasi-cyclic structure makes every
  Tanner-graph gather/scatter a ``jnp.roll`` with a compile-time shift.
* The host-synchronized iteration loop with per-iteration flag readback
  (``MyLdpc.cpp:803-833``) becomes an on-device ``lax.while_loop`` whose
  convergence test is a masked ``jnp.all`` — zero host<->device crossings.
* Per-codeword early-termination semantics match the reference
  (``decodeCL.c:27-28,296-300``): converged codewords latch their output
  while the batch continues.
* Base-matrix layers/blocks are unrolled statically at trace time; the batch
  axis is the trailing (vectorized) axis and the mesh-sharding axis.

Internal tensor layout: LLR/posterior ``[n_b, z, B]``; per-edge messages
``[E_b, z, B]`` row-aligned (see codes/qc.py for the alignment convention).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..codes.qc import QCCode
from ..utils.config import DecoderConfig

__all__ = ["DecodeResult", "decode_qc", "decode_flooding", "decode_layered"]

_PHI_MIN = 1e-7   # clamp for the sum-product phi transform
_PHI_MAX = 30.0


class DecodeResult(NamedTuple):
    """Decoded hard bits plus convergence statistics."""

    bits: jax.Array        # [B, n] uint8 hard decisions (full codeword)
    converged: jax.Array   # [B] bool: syndrome == 0
    iterations: jax.Array  # [B] int32: iterations used per codeword
    total_iters: jax.Array  # scalar int32: batch iterations executed
    #: [B] bool when CRC-aided acceptance is configured (DecoderConfig.crc):
    #: syndrome AND CRC both pass.  None = syndrome-only decode, where
    #: acceptance is :attr:`converged` (use :attr:`ok`).
    accepted: "jax.Array | None" = None
    #: [B, n] float posterior LLRs (positive => bit 0), latched at each
    #: frame's convergence like :attr:`bits`; None unless
    #: ``DecoderConfig.soft_output`` (jnp / edge-list paths).
    posteriors: "jax.Array | None" = None

    @property
    def ok(self) -> jax.Array:
        """Frame acceptance: ``accepted`` when CRC-aided, else ``converged``."""
        return self.converged if self.accepted is None else self.accepted


def _to_blocks(llr: jax.Array, n_b: int, z: int) -> jax.Array:
    """[B, n] -> [n_b, z, B]."""
    return llr.T.reshape(n_b, z, llr.shape[0])


def _from_blocks(x: jax.Array) -> jax.Array:
    """[n_b, z, B] -> [B, n]."""
    n_b, z, b = x.shape
    return x.reshape(n_b * z, b).T


def _row_align(x: jax.Array, shift: int) -> jax.Array:
    """Column-aligned [z, B] tile -> row-aligned (value at check row r is the
    variable (r + shift) % z)."""
    return jnp.roll(x, -shift, axis=0) if shift else x


def _col_align(x: jax.Array, shift: int) -> jax.Array:
    return jnp.roll(x, shift, axis=0) if shift else x


def _aligners(code):
    """(row_align, col_align) for the code's block group.

    QC circulants ("cyclic", the default) align by compile-time rolls.
    RS-LDPC additive blocks (``code.group == "xor"``, codes/rs_ldpc.py)
    align by the permutation ``y[i] = x[i ^ c]`` — self-inverse, so row
    and column alignment coincide; lowered as one static gather.
    """
    if getattr(code, "group", "cyclic") != "xor":
        return _row_align, _col_align
    z = code.z

    def xor_align(x: jax.Array, c: int) -> jax.Array:
        return x[np.arange(z) ^ c] if c else x

    return xor_align, xor_align


def _check_update_minsum(qs: jax.Array, alpha, beta) -> jax.Array:
    """Min-sum check-node update with self-exclusion over axis 0.

    Vectorization of the first/second-minimum trick the reference's fused
    kernel uses per-thread (``decodeCL.c:348-379``): the excluding-self min is
    m2 where this edge is the argmin, else m1; the excluding-self sign is the
    total sign parity XOR the edge's own sign.

    ``alpha``/``beta`` may be Python floats (static, branches elided at
    trace time) or traced scalars (learned per-iteration weights,
    ops/learned.py).
    """
    a = jnp.abs(qs)
    neg = (qs < 0).astype(jnp.int32)
    m1 = jnp.min(a, axis=0)
    am = jnp.argmin(a, axis=0)
    is_min = jax.lax.broadcasted_iota(jnp.int32, qs.shape, 0) == am[None]
    m2 = jnp.min(jnp.where(is_min, jnp.inf, a), axis=0)
    mag = jnp.where(is_min, m2[None], m1[None])
    # weight-1 rows (single edge: excluding-self min over nothing) would
    # give mag=inf and then inf-inf=NaN in the posterior update; clamp to
    # the masked-row magnitude like bp_edgelist._check_update does
    mag = jnp.minimum(mag, _Q_INF)
    if isinstance(alpha, (int, float)) and isinstance(beta, (int, float)):
        if beta:
            mag = jnp.maximum(mag - beta, 0.0)
        if alpha != 1.0:
            mag = alpha * mag
    else:
        mag = jnp.maximum(mag - beta, 0.0) * alpha
    sign_excl = (jnp.sum(neg, axis=0) & 1)[None] ^ neg
    return jnp.where(sign_excl == 1, -mag, mag).astype(qs.dtype)


def _check_update_sumproduct(qs: jax.Array, alpha: float, beta: float) -> jax.Array:
    """Log-domain sum-product check update with self-exclusion.

    Uses the self-inverse transform phi(x) = -log(tanh(x/2)):
    |R_e| = phi( sum_j phi(|Q_j|) - phi(|Q_e|) ).  Numerically stable
    replacement for the reference's probability-domain q0/q1 products
    (``decodeCL.c:25-41``).  Computed in f32 even for bf16 messages: phi's
    precision drives the decoder's threshold.
    """
    del alpha, beta

    def phi(x):
        x = jnp.clip(x, _PHI_MIN, _PHI_MAX)
        # -log(tanh(x/2)) = log((1 + e^-x) / (1 - e^-x))
        ex = jnp.exp(-x)
        return jnp.log1p(ex) - jnp.log1p(-ex)

    a = jnp.abs(qs).astype(jnp.float32)
    neg = (qs < 0).astype(jnp.int32)
    ph = phi(a)
    total = jnp.sum(ph, axis=0, keepdims=True)
    mag = phi(total - ph)
    sign_excl = (jnp.sum(neg, axis=0) & 1)[None] ^ neg
    return jnp.where(sign_excl == 1, -mag, mag).astype(qs.dtype)


_Q_INF = 1e30  # masked-row q magnitude: the min-sum / phi identity


def _layers(code: QCCode):
    """Static per-layer structure: list of (edge_slice, entries) where each
    entry is (e, j, shift, live_rows) and ``live_rows`` is a bool[z] numpy
    mask of real check rows (None = full circulant — the common case)."""
    br, bc, sh = code.blocks
    masks = code.block_row_masks
    ptr = code.layer_ptr
    out = []
    for i in range(code.m_b):
        p0, p1 = int(ptr[i]), int(ptr[i + 1])
        entries = [
            (e, int(bc[e]), int(sh[e]), masks[e]) for e in range(p0, p1)
        ]
        out.append(((p0, p1), entries))
    return out


def _mask_col(mask) -> jax.Array:
    """bool[z] live-row mask -> [z, 1] jnp array broadcastable over [z, B]."""
    return jnp.asarray(mask[:, None])


def _syndrome_fail(bits_blocks: jax.Array, layers,
                   row_align=_row_align) -> jax.Array:
    """[n_b, z, B] hard bits (bool) -> [B] bool, True where any check fails."""
    fails = []
    for (_, entries) in layers:
        par = None
        for (_, j, s, mask) in entries:
            contrib = row_align(bits_blocks[j], s).astype(jnp.int32)
            if mask is not None:
                contrib = jnp.where(_mask_col(mask), contrib, 0)
            par = contrib if par is None else par + contrib
        fails.append(jnp.any((par & 1) == 1, axis=0))  # [B]
    return jnp.any(jnp.stack(fails), axis=0)


def crc_fail_fn(code, crc: str, span: "int | None" = None):
    """[B, n]-bits -> bool[B] "CRC fails" check for CRC-aided acceptance.

    The CRC field occupies the last L bits of the first ``span`` bits of
    the code's information block — ``span`` defaults to the whole block
    (the TS 38.212 code-block layout: message || CRC is what the LDPC
    encoder sees); segmented transport blocks pass span = K' so the
    known-zero filler bits after the CRC24B (§5.2.2) are excluded.  One
    int8 matmul per call (codes/crc.py).
    """
    from ..codes.crc import CRC_POLYS, crc_check_fn

    length = CRC_POLYS[crc][0]
    k_info = code.k_info
    if span is None:
        span = k_info
    if not (length < span <= k_info):
        raise ValueError(
            f"CRC{crc} span must be in ({length}, {k_info}], got {span}"
        )
    pos = jnp.asarray(np.asarray(code.info_positions)[:span])
    check = crc_check_fn(span - length, crc)

    def fail(bits_flat: jax.Array) -> jax.Array:
        return ~check(bits_flat[:, pos].astype(jnp.int8))

    return fail


def outer_fail_fn(code, outer):
    """[B, n]-bits -> bool[B] "outer code fails" check (DecoderConfig.outer).

    ``("bch", m, t)``: the EN 302 307 outer BCH parity occupies the last
    m*t' bits of the information block (codes/bch.py); detection is one
    int8 bit-matmul, so it rides the acceptance latch exactly like the
    CRC (the in-loop variant of the DVB receiver's BCH check).
    """
    kind, m, t = outer
    if kind != "bch":
        raise ValueError(f"unknown outer code {kind!r}")
    from ..codes.bch import bch_check_fn, bch_matrix

    par = bch_matrix(1, m, t).shape[1]
    k_info = code.k_info
    if k_info <= par:
        raise ValueError(
            f"outer BCH needs k_info > {par}, code has k_info={k_info}"
        )
    pos = jnp.asarray(np.asarray(code.info_positions))
    check = bch_check_fn(k_info - par, m, t)

    def fail(bits_flat: jax.Array) -> jax.Array:
        return ~check(bits_flat[:, pos].astype(jnp.int8))

    return fail


def accept_fail_fn(code, cfg: DecoderConfig):
    """The combined integrity check of cfg.crc and cfg.outer:
    [B, n]-bits -> bool[B] "rejected" (or None when neither is set)."""
    fails = []
    if cfg.crc:
        fails.append(crc_fail_fn(code, cfg.crc, cfg.crc_span))
    if cfg.outer:
        fails.append(outer_fail_fn(code, cfg.outer))
    if not fails:
        return None
    if len(fails) == 1:
        return fails[0]
    return lambda bits: fails[0](bits) | fails[1](bits)


def _crc_fail_blocks(code, cfg: DecoderConfig):
    """cfg.crc/cfg.outer -> callable on [n_b, z, B] hard bits (or None)."""
    fail = accept_fail_fn(code, cfg)
    if fail is None:
        return None
    return lambda bits_blocks: fail(_from_blocks(bits_blocks))


def canon_weights(w, n_layers: int):
    """Canonicalize a DecoderConfig.normalization/offset value.

    Returns ``("scalar", x)``, ``("layer", (x_0..x_{L-1}))`` for a flat
    tuple (one static weight per base row), or ``("iter", ((x_00..),..))``
    for a nested tuple (outer = iteration, inner = per-layer; an inner
    scalar or length-1 tuple broadcasts over layers).  Learned weights from
    ops/learned.py arrive here via ``LearnedWeights.config_values()``.
    """
    if isinstance(w, (int, float)):
        return ("scalar", float(w))
    if all(isinstance(x, (int, float)) for x in w):
        if len(w) != n_layers:
            raise ValueError(
                f"per-layer weights need one value per base row "
                f"({n_layers}), got {len(w)}"
            )
        return ("layer", tuple(float(x) for x in w))
    rows = []
    for row in w:
        if isinstance(row, (int, float)):
            rows.append((float(row),) * n_layers)
        elif len(row) == 1:
            rows.append((float(row[0]),) * n_layers)
        elif len(row) == n_layers:
            rows.append(tuple(float(x) for x in row))
        else:
            raise ValueError(
                f"per-iteration weight rows must have 1 or {n_layers} "
                f"entries, got {len(row)}"
            )
    return ("iter", tuple(rows))


def weights_mode(cfg: DecoderConfig, n_layers: int) -> str:
    """Granularity of the config's min-sum weight schedule: "scalar",
    "layer" (static per-base-row), or "iter" (per-iteration x per-layer).
    Drives implementation dispatch: fused kernels serve scalar/layer, the
    jnp path serves everything."""
    order = {"scalar": 0, "layer": 1, "iter": 2}
    am, _ = canon_weights(cfg.normalization, n_layers)
    bm, _ = canon_weights(cfg.offset, n_layers)
    return am if order[am] >= order[bm] else bm


def _select_check_update(cfg: DecoderConfig, n_layers: int):
    """Check-update callable ``fn(qs, layer_idx, t)`` honoring scalar,
    per-layer, or per-iteration x per-layer (learned) min-sum weights.
    ``t`` is the traced iteration counter; iterations beyond the weight
    schedule reuse its last row."""
    if cfg.algorithm != "min-sum":
        return lambda qs, li, t: _check_update_sumproduct(qs, 1.0, 0.0)
    am, av = canon_weights(cfg.normalization, n_layers)
    bm, bv = canon_weights(cfg.offset, n_layers)
    if am == "scalar" and bm == "scalar":
        return lambda qs, li, t: _check_update_minsum(qs, av, bv)
    if am != "iter" and bm != "iter":
        a_l = av if am == "layer" else (av,) * n_layers
        b_l = bv if bm == "layer" else (bv,) * n_layers
        return lambda qs, li, t: _check_update_minsum(qs, a_l[li], b_l[li])

    def to_mat(mode, v):
        if mode == "scalar":
            return np.full((1, n_layers), v, np.float32)
        if mode == "layer":
            return np.asarray(v, np.float32)[None, :]
        return np.asarray(v, np.float32)

    a_mat = jnp.asarray(to_mat(am, av))
    b_mat = jnp.asarray(to_mat(bm, bv))

    def fn(qs, li, t):
        ta = jnp.minimum(t, a_mat.shape[0] - 1)
        tb = jnp.minimum(t, b_mat.shape[0] - 1)
        return _check_update_minsum(qs, a_mat[ta, li], b_mat[tb, li])

    return fn


# ---------------------------------------------------------------------------
# Flooding schedule
# ---------------------------------------------------------------------------

def decode_flooding(code: QCCode, cfg: DecoderConfig, llr: jax.Array) -> DecodeResult:
    """Flooding-schedule BP over the whole batch.  llr: [B, n] float."""
    n_b, z = code.n_b, code.z
    bsz = llr.shape[0]
    dtype = llr.dtype
    layers = _layers(code)
    check_update = _select_check_update(cfg, code.m_b)
    crc_fail = _crc_fail_blocks(code, cfg)
    row_align, col_align = _aligners(code)

    chan = _to_blocks(llr, n_b, z)  # [n_b, z, B]

    def masked_q(x, mask):
        return x if mask is None else jnp.where(_mask_col(mask), x, _Q_INF)

    # initial variable->check messages: channel LLR gathered per edge
    q0 = jnp.stack(
        [
            masked_q(row_align(chan[j], s), mask)
            for (_, entries) in layers
            for (_, j, s, mask) in entries
        ]
    )  # [E_b, z, B]

    bits0 = jnp.zeros((n_b, z, bsz), dtype=jnp.bool_)
    done0 = jnp.zeros((bsz,), dtype=jnp.bool_)
    iters0 = jnp.zeros((bsz,), dtype=jnp.int32)
    soft = cfg.soft_output
    # latched posterior (soft output); a [1]*3 dummy when off so the carry
    # structure is static
    post0 = chan if soft else jnp.zeros((1, 1, 1), dtype)

    def body(carry):
        q, bits_out, post_out, done, iters, t = carry
        # check-node update, layer by layer (each a contiguous static slice)
        r = jnp.concatenate(
            [
                check_update(q[p0:p1], li, t)
                for li, ((p0, p1), _) in enumerate(layers)
            ],
            axis=0,
        )
        # posterior: channel + column-aligned scatter of R (masked rows of a
        # partial circulant contribute nothing)
        post = chan
        for (_, entries) in layers:
            for (e, j, s, mask) in entries:
                contrib = r[e]
                if mask is not None:
                    contrib = jnp.where(_mask_col(mask), contrib, 0.0)
                post = post.at[j].add(col_align(contrib, s))
        bits = post <= 0  # reference: bit = !(posterior > 0)
        # next Q and row-aligned bits share the same rolled posterior
        q_next = []
        fails = []
        for (_, entries) in layers:
            par = None
            qs_layer = []
            for (e, j, s, mask) in entries:
                post_ra = row_align(post[j], s)
                if mask is None:
                    qs_layer.append(post_ra - r[e])
                    contrib = (post_ra <= 0).astype(jnp.int32)
                else:
                    mcol = _mask_col(mask)
                    qs_layer.append(
                        jnp.where(mcol, post_ra - r[e], _Q_INF)
                    )
                    contrib = jnp.where(mcol, post_ra <= 0, False).astype(jnp.int32)
                par = contrib if par is None else par + contrib
            q_next.extend(qs_layer)
            fails.append(jnp.any((par & 1) == 1, axis=0))
        q_next = jnp.stack(q_next)
        if cfg.self_correction:
            # SCMS (Savin 2008): erase (send 0) any variable->check message
            # whose sign flipped vs the previously SENT message; a message
            # erased last iteration (q == 0) propagates its new value.
            # Masked entries sit at _Q_INF in both q and q_next, so the
            # rule never fires there.
            flip = (q != 0.0) & (jnp.signbit(q_next) != jnp.signbit(q))
            q_next = jnp.where(flip, 0.0, q_next)
        fail = jnp.any(jnp.stack(fails), axis=0)  # [B]

        keep = done[None, None, :]
        bits_out = jnp.where(keep, bits_out, bits)
        if soft:
            post_out = jnp.where(keep, post_out, post)
        iters = jnp.where(done, iters, t + 1)
        # acceptance latch: syndrome-clean, and CRC-clean when CRC-aided —
        # a frame converged to a wrong codeword keeps decoding (38.212 §5.1)
        accept = ~fail if crc_fail is None else ~fail & ~crc_fail(bits)
        done = done | accept
        return q_next, bits_out, post_out, done, iters, t + 1

    def cond(carry):
        _, _, _, done, _, t = carry
        c = t < cfg.max_iters
        if cfg.early_exit:
            c = c & ~jnp.all(done)
        return c

    q, bits_out, post_out, done, iters, t = jax.lax.while_loop(
        cond, body, (q0, bits0, post0, done0, iters0, jnp.int32(0))
    )
    if crc_fail is None:
        conv, accepted = done, None
    else:
        # done latched on syndrome AND CRC; report syndrome validity of the
        # final bits separately so the detected-wrong-codeword split is
        # observable (converged & ~accepted = CRC caught a wrong codeword)
        conv, accepted = ~_syndrome_fail(bits_out, layers, row_align), done
    return DecodeResult(
        bits=_from_blocks(bits_out).astype(jnp.uint8),
        converged=conv,
        iterations=iters,
        total_iters=t,
        accepted=accepted,
        posteriors=_from_blocks(post_out) if soft else None,
    )


# ---------------------------------------------------------------------------
# Layered (TDMP) schedule
# ---------------------------------------------------------------------------

def decode_layered(code: QCCode, cfg: DecoderConfig, llr: jax.Array) -> DecodeResult:
    """Layered/TDMP BP: the posterior is refreshed after each base row,
    roughly halving iterations-to-convergence vs flooding (the reference's
    DecodeTDMP / fused decodeOnceTDMP, ``decodeCL.c:203-300,307-426``)."""
    n_b, z = code.n_b, code.z
    bsz = llr.shape[0]
    layers = _layers(code)
    check_update = _select_check_update(cfg, code.m_b)
    crc_fail = _crc_fail_blocks(code, cfg)
    row_align, col_align = _aligners(code)

    chan = _to_blocks(llr, n_b, z)
    r0 = jnp.zeros((code.num_blocks, z, bsz), dtype=llr.dtype)
    bits0 = jnp.zeros((n_b, z, bsz), dtype=jnp.bool_)
    done0 = jnp.zeros((bsz,), dtype=jnp.bool_)
    iters0 = jnp.zeros((bsz,), dtype=jnp.int32)
    soft = cfg.soft_output
    post_out0 = chan if soft else jnp.zeros((1, 1, 1), llr.dtype)

    def body(carry):
        r, post, bits_out, post_out, done, iters, t = carry
        for li, ((p0, p1), entries) in enumerate(layers):
            qs = []
            for (e, j, s, mask) in entries:
                q = row_align(post[j], s) - r[e]
                if mask is not None:
                    q = jnp.where(_mask_col(mask), q, _Q_INF)
                qs.append(q)
            r_new = check_update(jnp.stack(qs), li, t)
            # delta-accumulate writeback: post[j] += col_align(r_new - r_old).
            # Equivalent to col_align(q + r_new) for single-edge blocks but
            # also correct when one base block holds several circulants or a
            # layer touches a column twice (DVB-S2 standard tables); every
            # layered implementation uses this exact expression so the fused
            # kernels stay bit-identical to this path.
            for idx, (e, j, s, mask) in enumerate(entries):
                delta = r_new[idx] - r[e]
                if mask is not None:
                    delta = jnp.where(_mask_col(mask), delta, 0.0)
                post = post.at[j].add(col_align(delta, s))
            r = jax.lax.dynamic_update_slice_in_dim(r, r_new, p0, axis=0)
        bits = post <= 0
        fail = _syndrome_fail(bits, layers, row_align)
        keep = done[None, None, :]
        bits_out = jnp.where(keep, bits_out, bits)
        if soft:
            post_out = jnp.where(keep, post_out, post)
        iters = jnp.where(done, iters, t + 1)
        # acceptance latch: syndrome AND (when CRC-aided) CRC — see
        # decode_flooding
        accept = ~fail if crc_fail is None else ~fail & ~crc_fail(bits)
        done = done | accept
        return r, post, bits_out, post_out, done, iters, t + 1

    def cond(carry):
        *_, done, _, t = carry
        c = t < cfg.max_iters
        if cfg.early_exit:
            c = c & ~jnp.all(done)
        return c

    r, post, bits_out, post_out, done, iters, t = jax.lax.while_loop(
        cond, body, (r0, chan, bits0, post_out0, done0, iters0, jnp.int32(0))
    )
    if crc_fail is None:
        conv, accepted = done, None
    else:
        conv, accepted = ~_syndrome_fail(bits_out, layers, row_align), done
    return DecodeResult(
        bits=_from_blocks(bits_out).astype(jnp.uint8),
        converged=conv,
        iterations=iters,
        total_iters=t,
        accepted=accepted,
        posteriors=_from_blocks(post_out) if soft else None,
    )


def decode_qc(code: QCCode, cfg: DecoderConfig, llr: jax.Array) -> DecodeResult:
    """Dispatch on schedule.  ``llr``: [B, n] float, positive => bit 0."""
    if cfg.msg_dtype == "bfloat16":
        llr = llr.astype(jnp.bfloat16)
    if cfg.schedule == "layered":
        return decode_layered(code, cfg, llr)
    return decode_flooding(code, cfg, llr)
