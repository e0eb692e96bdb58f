"""High-level decoder facade.

The counterpart of the reference's ``Coder::forDecoder`` +
``addDecodeType`` + ``decode`` arming/streaming split (``MyLdpc.cpp:167-618``):
construction does all precompute and jit-compilation wiring once; calls then
decode arbitrary batches.  Algorithm variants are configuration, not separate
buffer/kernel plumbing.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

import numpy as np

from .codes.qc import QCCode
from .ops.bp import DecodeResult, decode_qc
from .utils.config import DecoderConfig

__all__ = ["Decoder", "DecodeResult", "select_implementation"]


def select_implementation(code, cfg: DecoderConfig) -> str:
    """The one platform dispatch: which decode path serves (code, cfg).

    ``auto`` picks the fused CUDA kernel (ops/cuda_bp.py) on a GPU when it
    serves the code and config, the generic edge-list path for codes
    without block structure, and the jnp/XLA path otherwise.  An explicit
    request the platform or the kernel cannot serve raises.
    """
    platform = jax.devices()[0].platform
    impl = cfg.implementation
    if impl == "auto":
        if not hasattr(code, "blocks"):
            return "edgelist"
        if platform == "gpu":
            from .ops import cuda_bp

            if cuda_bp.unsupported_reason(code, cfg) is None:
                return "cuda"
        return "jnp"
    if impl == "cuda":
        from .ops import cuda_bp

        if platform != "gpu":
            raise ValueError(
                f'implementation="cuda" needs a GPU (this platform: '
                f'{platform}); use implementation="auto" or "jnp"')
        reason = cuda_bp.unsupported_reason(code, cfg)
        if reason is not None:
            raise ValueError(
                f'implementation="cuda" cannot serve {getattr(code, "name", code)}: '
                f'{reason}; use implementation="auto" for dispatch')
    return impl


class Decoder:
    """Batched LDPC decoder bound to one code + one configuration.

    Accepts a :class:`QCCode` (fast circulant-roll paths: jnp/XLA or the
    fused CUDA kernel) or any object exposing ``n``/``m``/``h_coo()`` (generic
    edge-list path — DVB-S2, random constructions).

    >>> dec = Decoder(wimax(576, "3/4B"), DecoderConfig(schedule="layered"))
    >>> result = dec(llr)          # llr: [B, n] float, positive => bit 0
    >>> info = dec.info_bits(result)
    """

    def __init__(self, code, config: DecoderConfig | None = None, **overrides):
        if config is None:
            config = DecoderConfig()
        if overrides:
            import dataclasses

            config = dataclasses.replace(config, **overrides)
        from .ops.bitflip import GDBFConfig

        if isinstance(config, GDBFConfig):
            # bit-flipping tier: message-free noisy GDBF (ops/bitflip.py) —
            # ~4 vector ops/edge at a ~1.5 dB SNR cost vs BP; the decoder
            # class extreme-rate links deploy.  Deterministic under jit
            # (fixed perturbation key); call ops.bitflip.decode_gdbf
            # directly to supply fresh keys per batch.
            from .ops.bitflip import decode_gdbf

            if not hasattr(code, "blocks"):
                raise ValueError(
                    "GDBF runs on block-structured (QC / XOR-group) codes; "
                    "use a BP DecoderConfig for edge-list codes"
                )
            self.code = code
            self.config = config
            self.implementation = "gdbf"
            self._edge_idx = None
            self._fn = jax.jit(partial(decode_gdbf, code, config))
            return
        self.code = code
        self.config = config
        impl = select_implementation(code, config)
        if config.soft_output and config.triage_iters > 0:
            raise ValueError(
                "soft_output + triage is not supported: the two-phase "
                "wrapper merges hard outputs only"
            )
        if config.self_correction and impl == "edgelist":
            raise ValueError(
                "self_correction (SCMS) is served by the jnp QC path "
                '(requested implementation="edgelist"); use '
                'implementation="auto" or "jnp"'
            )
        self.implementation = impl
        self._edge_idx = None
        self._fn = self._build_fn(config)
        if config.triage_iters > 0:
            self._fn = self._make_triage()
        if (config.crc or config.outer) and impl == "cuda":
            # the fused kernel early-exits on the syndrome alone; CRC/outer-
            # aided acceptance wraps it (ops/crc_accept.py) — semantically
            # identical to an in-kernel latch because the bit-exact jnp
            # re-decode replays the kernel's trajectory and continues
            self._fn = self._make_crc_accept()

    def _build_fn(self, cfg: DecoderConfig):
        """The base decode callable for the resolved implementation under
        ``cfg`` (used at construction AND by the triage wrapper to build
        its short-budget fast pass)."""
        impl = self.implementation
        if impl == "cuda":
            from .ops import cuda_bp

            return partial(cuda_bp.decode_qc_cuda, self.code, cfg)
        if impl == "edgelist":
            from .ops.bp_edgelist import build_edge_index, decode_edgelist

            if self._edge_idx is None:
                idx = getattr(self.code, "edge_index", None)
                if idx is None:
                    rows, cols = self.code.h_coo()
                    layer = (
                        np.arange(self.code.m, dtype=np.int32) // self.code.z
                        if hasattr(self.code, "z")
                        else None
                    )
                    idx = build_edge_index(rows, cols, self.code.n,
                                           self.code.m, layer)
                self._edge_idx = idx
            from .ops.bp import accept_fail_fn

            crc_fail = accept_fail_fn(self.code, cfg)
            return jax.jit(
                partial(decode_edgelist, self._edge_idx, cfg,
                        crc_fail=crc_fail)
            )
        # jnp: decode_qc handles cfg.crc natively (CRC folded into the
        # early-exit latch)
        return jax.jit(partial(decode_qc, self.code, cfg))

    def _make_triage(self):
        """Wrap the decoder in the two-phase straggler triage
        (ops/triage.py): fast short pass, then full-budget re-decode of the
        compacted unaccepted frames.  Bit-identical to single-pass; applies
        to every implementation (the wrapper only needs opaque callables)."""
        import dataclasses

        cfg = self.config
        from .ops.triage import decode_two_phase

        fast = self._build_fn(dataclasses.replace(
            cfg, max_iters=cfg.triage_iters, triage_iters=0))
        full = self._build_fn(dataclasses.replace(cfg, triage_iters=0))

        @jax.jit
        def fn(llr):
            b = llr.shape[0]
            cap = max(8, int(b * cfg.triage_cap_frac))
            if cap >= b:
                return full(llr)
            return decode_two_phase(fast, full, full, llr, cap)

        return fn

    def _make_crc_accept(self):
        """Wrap the (kernel, possibly triage-wrapped) decoder with CRC- /
        outer-code-aided acceptance: syndrome-converged frames failing the
        integrity check are re-decoded by the bit-exact check-aware jnp
        path at the full budget (ops/crc_accept.py)."""
        import dataclasses

        from .ops.bp import accept_fail_fn
        from .ops.crc_accept import decode_with_crc_accept

        cfg = self.config
        fail = accept_fail_fn(self.code, cfg)
        retry_cfg = dataclasses.replace(
            cfg, implementation="jnp", triage_iters=0
        )
        retry_full = partial(decode_qc, self.code, retry_cfg)
        inner = self._fn

        @jax.jit
        def fn(llr):
            cap = max(8, int(llr.shape[0] * cfg.triage_cap_frac))
            return decode_with_crc_accept(inner, retry_full, fail, llr, cap)

        return fn

    def __call__(self, llr: jax.Array) -> DecodeResult:
        if llr.ndim != 2 or llr.shape[-1] != self.code.n:
            raise ValueError(
                f"expected llr of shape [batch, {self.code.n}], got {llr.shape}"
            )
        return self._fn(llr.astype(jnp.float32))

    def info_bits(self, result: DecodeResult) -> jax.Array:
        """Information bits of the decoded codewords: [B, k_info]."""
        pos = getattr(self.code, "info_positions", None)
        if pos is None:
            return result.bits[:, : self.code.k]
        return result.bits[:, jnp.asarray(pos)]

    def lower(self, batch_size: int):
        """Lower/compile for a fixed batch size (for AOT benchmarking)."""
        shape = jax.ShapeDtypeStruct((batch_size, self.code.n), jnp.float32)
        fn = self._fn if hasattr(self._fn, "lower") else jax.jit(self._fn)
        return fn.lower(shape)
