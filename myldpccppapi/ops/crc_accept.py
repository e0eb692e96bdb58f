"""CRC-aided acceptance around syndrome-only (fused-kernel) decoders.

The fused CUDA kernel early-exits on the LDPC syndrome alone — the
reference's only oracle (``decodeCL.c:88-108``), which admits wrong-codeword
convergence.  Rather than adding a per-sweep CRC check to the kernel, this
wrapper keeps it lean and handles the rare CRC-rejected frames on the
general path:

1. run the kernel (syndrome early exit) over the whole batch;
2. CRC-check the decoded information blocks (one int8 matmul);
3. frames whose syndrome converged but CRC failed are compacted and
   re-decoded by the bit-exact jnp CRC-aware decoder at the full budget.

Because every implementation shares one trajectory (f32 paths are pinned
bit-identical by tests), the from-scratch CRC-aware re-decode replays the
kernel's exact iterations up to the wrong-codeword convergence point and
then *continues* past it — so the composite is semantically identical to a
kernel with the CRC folded into its early-exit latch, at zero cost to the
clean-frame fast path (the retry branch is a ``lax.cond``: nothing runs
when no frame is CRC-rejected).
"""
from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from .bp import DecodeResult

__all__ = ["decode_with_crc_accept"]


def decode_with_crc_accept(
    inner: Callable[[jax.Array], DecodeResult],
    retry_full: Callable[[jax.Array], DecodeResult],
    crc_fail: Callable[[jax.Array], jax.Array],
    llr: jax.Array,
    cap: int,
) -> DecodeResult:
    """CRC-aided decode of [B, n] LLRs.

    ``inner``:      syndrome-only decoder for the full batch (fused kernel,
                    possibly triage-wrapped); its ``accepted`` is None.
    ``retry_full``: CRC-aware decoder (jnp path, ``cfg.crc`` set) for any
                    batch size — used for the compacted rejected frames and
                    as the full-batch fallback.
    ``crc_fail``:   [B, n] hard bits -> bool[B] (ops/bp.crc_fail_fn).
    ``cap``:        straggler-buffer capacity (frames).
    """
    b = llr.shape[0]
    res1 = inner(llr)
    ok1 = res1.converged & ~crc_fail(res1.bits)
    # only syndrome-converged frames that fail the CRC behave differently
    # under a CRC-aware decode; syndrome-unconverged frames would replay the
    # identical trajectory to the same cap
    bad = res1.converged & ~ok1
    n_bad = jnp.sum(bad.astype(jnp.int32))

    def fast(_):
        return DecodeResult(
            bits=res1.bits,
            converged=res1.converged,
            iterations=res1.iterations,
            total_iters=res1.total_iters,
            accepted=ok1,
            posteriors=res1.posteriors,
        )

    def retry(_):
        order = jnp.argsort(~bad)  # rejected frames first
        sel = order[:cap]
        res2 = retry_full(llr[sel])
        take = bad[sel]
        bits = res1.bits.at[sel].set(
            jnp.where(take[:, None], res2.bits, res1.bits[sel])
        )
        converged = res1.converged.at[sel].set(
            jnp.where(take, res2.converged, res1.converged[sel])
        )
        iterations = res1.iterations.at[sel].set(
            jnp.where(take, res2.iterations, res1.iterations[sel])
        )
        accepted = ok1.at[sel].set(jnp.where(take, res2.accepted, ok1[sel]))
        posteriors = res1.posteriors
        if posteriors is not None:
            posteriors = posteriors.at[sel].set(
                jnp.where(take[:, None],
                          res2.posteriors.astype(posteriors.dtype),
                          posteriors[sel])
            )
        return DecodeResult(
            bits=bits,
            converged=converged,
            iterations=iterations,
            total_iters=jnp.maximum(res1.total_iters, res2.total_iters),
            accepted=accepted,
            posteriors=posteriors,
        )

    def fallback(_):
        return retry_full(llr)

    def slow(_):
        if cap >= b:
            return fallback(None)
        return jax.lax.cond(n_bad <= cap, retry, fallback, None)

    return jax.lax.cond(n_bad == 0, fast, slow, None)
