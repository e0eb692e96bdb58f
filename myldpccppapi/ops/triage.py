"""Two-phase (triage) decoding: fast pass + compacted straggler re-decode.

With batched decoding, one unconverged codeword holds its whole batch (or,
in the fused kernel, its thread block) at the iteration cap: at a 1%
frame-error operating point almost every batch contains a straggler, so the
loop runs ~max_iters even though the mean codeword needs ~3 iterations (the
same pathology as the reference's whole-batch host loop waiting for the
slowest codeword, MyLdpc.cpp:826-833).

The triage wrapper runs a short first pass (``triage_iters``), compacts the
unconverged frames into a small static buffer (``cap`` frames), and re-decodes
only those at the full iteration budget.  Because codewords are decoded
independently and BP is deterministic, a from-scratch re-decode reproduces exactly
the trajectory the single-pass decode would have taken, so results are
bit-identical to the single-pass decoder.  If more than ``cap`` frames fail
the fast pass (far off the design operating point), the wrapper falls back
to a full-batch full-budget decode via ``lax.cond`` — same results, no
semantic cliff.
"""
from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from .bp import DecodeResult

__all__ = ["decode_two_phase"]


def decode_two_phase(
    decode_fast: Callable[[jax.Array], DecodeResult],
    decode_cap: Callable[[jax.Array], DecodeResult],
    decode_full: Callable[[jax.Array], DecodeResult],
    llr: jax.Array,
    cap: int,
) -> DecodeResult:
    """Triage-decode [B, n] LLRs.

    ``decode_fast``: short-budget decoder for the full batch.
    ``decode_cap``:  full-budget decoder for a [cap, n] batch.
    ``decode_full``: full-budget decoder for the full batch (fallback).
    """
    b = llr.shape[0]
    res1 = decode_fast(llr)
    bad = ~res1.ok  # [B]: not accepted (syndrome, and CRC when CRC-aided)
    n_bad = jnp.sum(bad.astype(jnp.int32))

    def retry(_):
        # stable partition: indices of unconverged frames first
        order = jnp.argsort(~bad)  # False sorts first; ~bad is False for bad
        sel = order[:cap]
        res2 = decode_cap(llr[sel])
        take = bad[sel]  # guard: sel may include converged frames as filler
        bits = res1.bits.at[sel].set(
            jnp.where(take[:, None], res2.bits, res1.bits[sel])
        )
        converged = res1.converged.at[sel].set(
            jnp.where(take, res2.converged, res1.converged[sel])
        )
        iterations = res1.iterations.at[sel].set(
            jnp.where(take, res2.iterations, res1.iterations[sel])
        )
        accepted = None
        if res1.accepted is not None:
            accepted = res1.accepted.at[sel].set(
                jnp.where(take, res2.accepted, res1.accepted[sel])
            )
        return DecodeResult(
            bits=bits,
            converged=converged,
            iterations=iterations,
            total_iters=jnp.maximum(res1.total_iters, res2.total_iters),
            accepted=accepted,
        )

    def fallback(_):
        return decode_full(llr)

    return jax.lax.cond(n_bad <= cap, retry, fallback, None)
