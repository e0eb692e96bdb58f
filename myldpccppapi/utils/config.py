"""Dataclass configuration objects.

Replaces the reference's positional-argv + compile-time-constant configuration
(``Test.cpp:19-26,35-104``; iteration caps hardcoded at ``MyLdpc.cpp:24`` and
``decodeCL.c:344,479``) with explicit, hashable configs usable as jit static
arguments.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["DecoderConfig", "RunConfig"]


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """Belief-propagation decoder configuration.

    algorithm:    "min-sum" or "sum-product"
    schedule:     "flooding" (all checks each iteration) or "layered" (TDMP)
    max_iters:    iteration cap (reference uses 40; its fused MS kernel 120)
    normalization: alpha for normalized min-sum (1.0 = plain min-sum, the
                  reference's choice; 0.75 is the classic normalized variant)
    offset:       beta for offset min-sum (0.0 = none)
    early_exit:   stop when every codeword in the (local) batch satisfies all
                  parity checks — the on-device replacement for the
                  reference's per-iteration flag readback (MyLdpc.cpp:818-833)
    implementation: "auto" | "jnp" | "cuda" | "edgelist"
                  (auto = decoder.select_implementation decides; jnp =
                  block-structured jnp/XLA path, every config; cuda = fused
                  shared-memory min-sum kernel for short QC codes on a GPU,
                  ops/cuda_bp.py; edgelist = generic gather/scatter path for
                  codes without block structure)
    """

    algorithm: str = "min-sum"
    schedule: str = "layered"
    max_iters: int = 40
    #: min-sum correction weights.  Besides a scalar, each accepts a flat
    #: tuple (one static weight per base row / layer — honored by the jnp
    #: paths AND the fused CUDA kernel) or a nested tuple (outer =
    #: iteration, inner = per-layer; iterations beyond the schedule reuse
    #: the last row — jnp path only).
    #: Train them with ops/learned.py (differentiable unrolled decoding).
    normalization: "float | tuple" = 1.0
    offset: "float | tuple" = 0.0
    early_exit: bool = True
    implementation: str = "auto"
    #: Two-phase straggler triage (ops/triage.py): when > 0, decode the full
    #: batch with this short iteration budget first, then re-decode only the
    #: unconverged frames (compacted to a small buffer) at max_iters.
    #: Bit-identical to single-pass decoding; it pays where a few frames
    #: would otherwise hold the whole batch's loop at the iteration cap.
    triage_iters: int = 0
    #: Capacity of the straggler buffer as a fraction of the batch; if more
    #: frames fail the fast pass, the wrapper falls back to a full-batch
    #: full-budget decode.  Also sizes the CRC/outer-aided retry buffer of
    #: the fused-kernel acceptance wrapper (ops/crc_accept.py) — rejected
    #: frames beyond it trigger the same full-batch fallback.
    triage_cap_frac: float = 0.125
    #: Self-corrected min-sum (Savin 2008): a variable->check message whose
    #: sign flips between iterations is ERASED (sent as 0) instead of
    #: propagated — sign oscillation marks unreliable messages, and a
    #: 0-magnitude input makes the min-sum check update neutralize the
    #: affected checks.  Needs no tuned constant (unlike
    #: normalization/offset).  min-sum + flooding only (the classic
    #: formulation; the erasure memory is the flooding loop's q carry);
    #: served by the jnp path.
    self_correction: bool = False
    #: Message/posterior dtype: "float32" (exact) or "bfloat16" (halves the
    #: decode state's bytes; ~0.05 dB BER cost typical for min-sum, which
    #: only compares magnitudes and adds).  jnp / edge-list paths.
    msg_dtype: str = "float32"
    #: CRC-aided acceptance (TS 38.212 §5.1): name of a CRC from
    #: codes/crc.py (``"24A"``/``"24B"``/``"24C"``/``"16"``) whose field
    #: occupies the LAST L bits of the code's information block.  When set,
    #: a frame is *accepted* (and early-terminates) only when the LDPC
    #: syndrome AND the CRC both pass — the standard NR receiver flow.  The
    #: reference's only oracle is the syndrome (``decodeCL.c:88-108``),
    #: which admits undetected wrong-codeword convergence; with a CRC the
    #: decoder keeps iterating such frames and reports them as detected
    #: errors (``DecodeResult.accepted``).  None = syndrome-only acceptance
    #: (the reference semantics).
    crc: Optional[str] = None
    #: Number of leading information bits covered by message||CRC when
    #: :attr:`crc` is set (TS 38.212 K'): the CRC field then occupies bits
    #: [crc_span - L, crc_span) of the information block instead of its
    #: tail.  Needed for segmented transport blocks whose code blocks carry
    #: F = K - K' known-zero filler bits AFTER the CRC24B (§5.2.2).  None =
    #: the CRC sits at the end of the information block (the unsegmented
    #: layout).
    crc_span: Optional[int] = None
    #: Outer-code-aided acceptance, same latch semantics as :attr:`crc`
    #: but for a GF(2)-linear outer code filling the tail of the
    #: information block: ``("bch", m, t)`` requires the EN 302 307 outer
    #: BCH detection (codes/bch.py) to pass before a frame is accepted —
    #: the in-loop variant of the DVB receiver's post-decode BCH check,
    #: detecting wrong-codeword convergence exactly like the NR CRC flow.
    #: Composable with :attr:`crc` (both must pass).
    outer: Optional[Tuple[str, int, int]] = None
    #: Return per-bit posterior LLRs alongside the hard decisions
    #: (``DecodeResult.posteriors``, latched at each frame's convergence
    #: like the bits).  Soft output feeds iterative demapping / turbo
    #: equalization / outer soft decoders — the reference is hard-decision
    #: only (``decodeCL.c:188-199``).  Served by the jnp/edge-list paths.
    soft_output: bool = False

    def __post_init__(self):
        # coerce (possibly nested) weight lists/arrays to hashable tuples
        for f in ("normalization", "offset"):
            w = getattr(self, f)
            if not isinstance(w, (int, float)):
                w = tuple(
                    x if isinstance(x, (int, float)) else tuple(x) for x in w
                )
                object.__setattr__(self, f, w)
        if self.algorithm not in ("min-sum", "sum-product"):
            raise ValueError(f"unknown algorithm {self.algorithm!r}")
        if self.schedule not in ("flooding", "layered"):
            raise ValueError(f"unknown schedule {self.schedule!r}")
        if self.implementation not in ("auto", "jnp", "cuda", "edgelist"):
            raise ValueError(f"unknown implementation {self.implementation!r}")
        if self.msg_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown msg_dtype {self.msg_dtype!r}")
        if self.algorithm == "sum-product" and (
            self.normalization != 1.0 or self.offset != 0.0
        ):
            raise ValueError(
                "normalization/offset are min-sum knobs; the sum-product "
                "check update has no such correction (they would be "
                "silently ignored)"
            )
        if self.self_correction:
            if self.algorithm != "min-sum" or self.schedule != "flooding":
                raise ValueError(
                    "self_correction is the SCMS rule for min-sum FLOODING "
                    f"(got {self.algorithm!r}/{self.schedule!r}); layered "
                    "schedules have no per-iteration message memory to "
                    "compare against"
                )
        if self.crc is not None:
            from ..codes.crc import CRC_POLYS

            if self.crc not in CRC_POLYS:
                raise ValueError(
                    f"unknown crc {self.crc!r}; choose from {sorted(CRC_POLYS)}"
                )
        if self.crc_span is not None:
            if self.crc is None:
                raise ValueError("crc_span requires crc to be set")
            if self.crc_span <= 0:
                raise ValueError(f"crc_span must be positive, got {self.crc_span}")
        if self.outer is not None:
            if (
                len(self.outer) != 3
                or self.outer[0] != "bch"
                or not all(isinstance(x, int) for x in self.outer[1:])
            ):
                raise ValueError(
                    f'outer must be ("bch", m, t), got {self.outer!r}'
                )


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """A benchmark / campaign run specification."""

    batch_size: int = 1024
    snr_db: Tuple[float, ...] = (2.0,)
    seed: int = 0
    mesh_shape: Optional[Tuple[int, ...]] = None  # None = single device
    mesh_axes: Tuple[str, ...] = ("data",)
