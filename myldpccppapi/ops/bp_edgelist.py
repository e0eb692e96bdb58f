"""Edge-list belief propagation for arbitrary (non-QC) parity-check matrices.

Generalizes the decoders to codes without circulant structure — DVB-S2's
accumulator chain, MacKay random constructions — using the padded dense
index layout SURVEY.md §7.1 prescribes in place of the reference's per-edge
linked lists (``Coder::forDecoder``, ``MyLdpc.cpp:171-224``):

* ``row_edges [M, dr_max]`` — edge ids per check row, padded with the
  sentinel ``E`` (gathers through a padded view supply the reduction
  identity; scatters to the sentinel are dropped);
* ``edge_col [E]``          — variable column of each edge;
* ``col_edges [N, dc_max]`` — edge ids per variable column, same sentinel.

Message state lives in ``[E, B]`` arrays (batch = trailing axis); all
Tanner-graph traffic is XLA gathers/scatters over the padded tables.  The
iteration loop is the same host-sync-free ``lax.while_loop`` as ops/bp.py,
with identical per-codeword early-termination/latching semantics.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.config import DecoderConfig
from .bp import DecodeResult

__all__ = ["EdgeIndex", "build_edge_index", "decode_edgelist"]

_INF = 1e30


@dataclasses.dataclass(frozen=True, eq=False)
class EdgeIndex:
    """Padded edge-index tables for one H (host-built, device-constant)."""

    n: int
    m: int
    edge_col: np.ndarray     # [E] int32
    row_edges: np.ndarray    # [M, dr_max] int32, pad = E
    col_edges: np.ndarray    # [N, dc_max] int32, pad = E
    row_layer: np.ndarray    # [M] int32: layer id per row (for layered sched)

    @property
    def num_edges(self) -> int:
        return len(self.edge_col)

    @cached_property
    def num_layers(self) -> int:
        return int(self.row_layer.max()) + 1 if len(self.row_layer) else 1


def build_edge_index(
    rows: np.ndarray,
    cols: np.ndarray,
    n: int,
    m: int,
    row_layer: "np.ndarray | None" = None,
) -> EdgeIndex:
    """Build padded tables from an (edge rows, edge cols) COO list."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    e = len(rows)
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    row_deg = np.bincount(rows, minlength=m)
    col_deg = np.bincount(cols, minlength=n)
    dr, dc = int(row_deg.max()), int(col_deg.max())
    row_edges = np.full((m, dr), e, dtype=np.int32)
    col_edges = np.full((n, dc), e, dtype=np.int32)
    # vectorized fill: position of each edge within its row / column
    rpos = np.arange(e) - np.concatenate([[0], np.cumsum(row_deg)])[rows]
    row_edges[rows, rpos] = np.arange(e)
    corder = np.lexsort((rows, cols))
    csorted = cols[corder]
    cpos = np.arange(e) - np.concatenate([[0], np.cumsum(col_deg)])[csorted]
    col_edges[csorted, cpos] = corder
    if row_layer is None:
        row_layer = np.zeros(m, dtype=np.int32)
    return EdgeIndex(
        n=n,
        m=m,
        edge_col=cols.astype(np.int32),
        row_edges=row_edges,
        col_edges=col_edges,
        row_layer=np.asarray(row_layer, dtype=np.int32),
    )


def _check_update(qr: jax.Array, cfg: DecoderConfig) -> jax.Array:
    """Check-node update on gathered row messages [M, dr, B] (pad = +_INF)."""
    a = jnp.abs(qr)
    neg = (qr < 0).astype(jnp.int32)
    if cfg.algorithm == "min-sum":
        m1 = jnp.min(a, axis=1, keepdims=True)
        am = jnp.argmin(a, axis=1)
        is_min = (
            jax.lax.broadcasted_iota(jnp.int32, qr.shape, 1) == am[:, None, :]
        )
        m2 = jnp.min(jnp.where(is_min, jnp.inf, a), axis=1, keepdims=True)
        mag = jnp.where(is_min, m2, m1)
        if cfg.offset:
            mag = jnp.maximum(mag - cfg.offset, 0.0)
        if cfg.normalization != 1.0:
            mag = cfg.normalization * mag
        mag = jnp.minimum(mag, _INF)  # a lone real edge in a row gets m2=inf
    else:  # sum-product, log domain

        def phi(x):
            # clamp constants shared with ops/bp.py so the two paths stay
            # bit-identical in f32 (crc_accept's replay argument needs it)
            from .bp import _PHI_MAX, _PHI_MIN

            x = jnp.clip(x, _PHI_MIN, _PHI_MAX)
            ex = jnp.exp(-x)
            return jnp.log1p(ex) - jnp.log1p(-ex)

        # phi in f32 even for bf16 messages (its precision drives the
        # decoder threshold — same policy as ops/bp.py)
        a = a.astype(jnp.float32)
        ph = phi(a)  # pad edges: phi(clip 30) ~ 0, the sum identity
        total = jnp.sum(ph, axis=1, keepdims=True)
        mag = phi(total - ph)
    sgn = (jnp.sum(neg, axis=1, keepdims=True) & 1) ^ neg  # pad sign: positive
    return jnp.where(sgn == 1, -mag, mag).astype(qr.dtype)


def decode_edgelist(idx: EdgeIndex, cfg: DecoderConfig, llr: jax.Array,
                    crc_fail=None) -> DecodeResult:
    """Decode [B, n] LLRs for an arbitrary H given by its EdgeIndex.

    Min-sum weights must be scalars here: the padded-row layout has no
    per-base-layer structure to index a weight schedule by (QC codes with
    learned weights use the circulant paths, ops/bp.py).

    schedule="flooding": classic full sweep.  schedule="layered": row groups
    given by ``idx.row_layer`` are processed sequentially with the posterior
    refreshed between groups (grouped TDMP; concurrent column updates within
    one group accumulate additively).

    ``crc_fail``: optional [B, n]-bits -> bool[B] CRC-fail check
    (ops/bp.crc_fail_fn) for CRC-aided acceptance; the Decoder facade builds
    it from ``cfg.crc``.  When given, the early-exit latch requires syndrome
    AND CRC, and the result carries ``accepted``.
    """
    if not isinstance(cfg.normalization, (int, float)) or not isinstance(
        cfg.offset, (int, float)
    ):
        raise NotImplementedError(
            "edge-list decoding supports scalar min-sum weights only"
        )
    b = llr.shape[0]
    dt = jnp.bfloat16 if cfg.msg_dtype == "bfloat16" else jnp.float32
    chan = llr.astype(dt).T  # [n, B]
    e = idx.num_edges
    edge_col = jnp.asarray(idx.edge_col)
    edge_col_pad = jnp.concatenate([edge_col, jnp.asarray([idx.n], jnp.int32)])
    row_edges = jnp.asarray(idx.row_edges)
    col_edges = jnp.asarray(idx.col_edges)

    def gather_pad(arr, idxs, fill):
        """arr [E, B] gathered at idxs (pad id E -> fill)."""
        padded = jnp.concatenate(
            [arr, jnp.full((1, b), fill, arr.dtype)], axis=0
        )
        return padded[idxs]

    layered = cfg.schedule == "layered" and idx.num_layers > 1
    if layered:
        # stack per-layer row-edge tables into one uniform [L, Ml, dr]
        # tensor (pad short layers with all-sentinel rows) so the layer
        # sweep is a fori_loop, not L inlined copies — keeps compile time
        # flat in the layer count (DVB-S2: 90 layers)
        per_layer = [idx.row_edges[idx.row_layer == l] for l in range(idx.num_layers)]
        ml = max(p.shape[0] for p in per_layer)
        dr = idx.row_edges.shape[1]
        stack = np.full((idx.num_layers, ml, dr), e, dtype=np.int32)
        for l, p in enumerate(per_layer):
            stack[l, : p.shape[0]] = p
        re_stack = jnp.asarray(stack)

    def syndrome_fail(post):
        # int8 end to end: the [M, dr, B] gather is the biggest transient of
        # the decode on long codes (DVB-S2: 32400 x ~10 x B)
        bits = (post <= 0.0).astype(jnp.int8)  # [n, B]
        bits_e = bits[edge_col]  # [E, B]
        par = jnp.sum(
            gather_pad(bits_e, row_edges, jnp.int8(0)), axis=1,
            dtype=jnp.int32,
        ) & 1  # [M, B]
        return jnp.any(par == 1, axis=0)  # [B]

    def layer_update(l, rp):
        """One grouped-TDMP layer: gather ONLY this layer's edges."""
        r, post = rp
        flat = re_stack[l].reshape(-1)  # pad id E -> dropped on scatter
        cols_l = edge_col_pad[flat]  # pad -> n (out of bounds)
        post_l = post.at[cols_l].get(mode="fill", fill_value=_INF)
        r_l = r.at[flat].get(mode="fill", fill_value=0.0)
        qr = (post_l - r_l).reshape(re_stack.shape[1], re_stack.shape[2], b)
        rn = _check_update(qr, cfg)
        rn_flat = rn.reshape(-1, b)
        post = post.at[cols_l].add(rn_flat - r_l, mode="drop")
        r = r.at[flat].set(rn_flat, mode="drop")
        return r, post

    soft = cfg.soft_output
    post_out0 = chan if soft else jnp.zeros((1, 1), dt)

    def body(carry):
        r, post, bits_out, post_out, done, iters, t = carry
        if layered:
            r, post = jax.lax.fori_loop(
                0, idx.num_layers, layer_update, (r, post)
            )
        else:
            q_e = post[edge_col] - r
            rn = _check_update(gather_pad(q_e, row_edges, _INF), cfg)
            r = r.at[row_edges.reshape(-1)].set(
                rn.reshape(-1, b), mode="drop"
            )
            post = chan + jnp.sum(gather_pad(r, col_edges, 0.0), axis=1)
        bits = post <= 0.0
        fail = syndrome_fail(post)
        keep = done[None, :]
        bits_out = jnp.where(keep, bits_out, bits)
        if soft:
            post_out = jnp.where(keep, post_out, post)
        iters = jnp.where(done, iters, t + 1)
        # acceptance latch: syndrome AND (when CRC-aided) CRC — see ops/bp.py
        accept = ~fail if crc_fail is None else ~fail & ~crc_fail(bits.T)
        done = done | accept
        return r, post, bits_out, post_out, done, iters, t + 1

    def cond(carry):
        *_, done, _, t = carry
        c = t < cfg.max_iters
        if cfg.early_exit:
            c = c & ~jnp.all(done)
        return c

    carry0 = (
        jnp.zeros((e, b), dt),
        chan,
        jnp.zeros((idx.n, b), jnp.bool_),
        post_out0,
        jnp.zeros((b,), jnp.bool_),
        jnp.zeros((b,), jnp.int32),
        jnp.int32(0),
    )
    _, post, bits_out, post_out, done, iters, t = jax.lax.while_loop(
        cond, body, carry0
    )
    if crc_fail is None:
        conv, accepted = done, None
    else:
        # done latched on syndrome AND CRC; non-done frames carry the final
        # posterior's bits, so their syndrome validity comes from post
        conv, accepted = done | ~syndrome_fail(post), done
    return DecodeResult(
        bits=bits_out.T.astype(jnp.uint8),
        converged=conv,
        iterations=iters,
        total_iters=t,
        accepted=accepted,
        posteriors=post_out.T if soft else None,
    )
