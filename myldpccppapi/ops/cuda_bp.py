"""Fused min-sum decoder for short QC codes on NVIDIA Hopper (CUDA via FFI).

Host side of ``myldpccppapi/cuda/minsum_decoder.cu``: one thread block keeps
a few codewords' posterior and compressed check messages in shared memory
for the whole decode, so a batch costs one kernel launch that reads the LLRs
once and writes the bits once, whatever the iteration count.  Results are
those of :func:`myldpccppapi.ops.bp.decode_qc` (same arithmetic, same
per-frame latching); the jnp path stays the reference and the fallback.

Scope: min-sum, layered or flooding, scalar or per-layer normalization /
offset, float32, on cyclic QC codes without masked rows whose layers touch
each block column at most once and whose row degree is at most 32 (802.16e,
802.11n, regular QC, NR with small lifting sizes).  Anything else — SCMS,
soft output, bf16, sum-product, per-iteration weights, RS-LDPC XOR blocks,
DVB-S2 tables — runs on the jnp path.

The library is built from the tracked source with ``nvcc`` on first use
(``make -C myldpccppapi/cuda``, into ``myldpccppapi/cuda/build/``).
"""
from __future__ import annotations

import ctypes
import functools
import os
import subprocess

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.config import DecoderConfig

__all__ = [
    "unsupported_reason", "kernel_tables", "kernel_weights",
    "frames_per_block", "smem_bytes", "decode_qc_cuda",
]

_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "cuda")
_SO = os.path.join(_DIR, "build", "libldpc_cuda.so")
_TARGET = "myldpc_minsum_decode"

#: dynamic shared memory one block may use on Hopper (227 KB)
SMEM_LIMIT = 232_448
#: threads per block the frames-per-block choice aims for
_TARGET_THREADS = 256
_MAX_THREADS = 1024
_MAX_ROW_DEGREE = 32   # outgoing signs of a check row live in one u32


def _round_up(x: int, a: int) -> int:
    return (x + a - 1) // a * a


def _bank_stride(length: int, z: int) -> int:
    return length + ((z - length) % 32 + 32) % 32


def smem_bytes(code, frames: int) -> int:
    """Dynamic shared memory of one block holding ``frames`` codewords —
    the kernel's ``make_layout`` in Python (checked against the library's
    own copy when it loads)."""
    n_e = code.num_blocks
    tab_len = (code.m_b + 1) + 2 * n_e + (code.n_b + 1) + 2 * n_e
    ps = _bank_stride(code.n, code.z)
    ms = _bank_stride(code.m, code.z)
    return (_round_up(tab_len * 4, 16) + _round_up(2 * code.m_b * 4, 16)
            + _round_up(2 * frames * 4, 16) + _round_up(frames * ps * 4, 16)
            + 3 * _round_up(frames * ms * 4, 16) + _round_up(frames * ms, 16))


def frames_per_block(code) -> int:
    """Codewords per thread block (one thread per check row of each): about
    256 threads, within 1024 threads and the shared-memory limit; 0 when
    not even one codeword fits."""
    z = code.z
    if z > _MAX_THREADS or smem_bytes(code, 1) > SMEM_LIMIT:
        return 0
    g = max(1, _TARGET_THREADS // z)
    while g > 1 and (g * z > _MAX_THREADS or smem_bytes(code, g) > SMEM_LIMIT):
        g -= 1
    return g


def unsupported_reason(code, cfg: DecoderConfig) -> "str | None":
    """Why the kernel cannot serve (code, cfg), or None when it can."""
    from .bp import weights_mode

    if not hasattr(code, "blocks"):
        return "the code has no block structure"
    if getattr(code, "group", "cyclic") != "cyclic":
        return "XOR-group (RS-LDPC) blocks are served by the jnp path"
    if code.masked_rows:
        return "partial (row-masked) circulants are served by the jnp path"
    br, bc, _ = code.blocks
    if len(set(zip(br.tolist(), bc.tolist()))) != len(br):
        return "a layer touches one block column twice (multi-edge blocks)"
    if code.max_row_degree > _MAX_ROW_DEGREE:
        return f"row degree {code.max_row_degree} > {_MAX_ROW_DEGREE}"
    if cfg.algorithm != "min-sum":
        return "sum-product is served by the jnp path"
    if cfg.self_correction:
        return "SCMS (self_correction) is served by the jnp path"
    if cfg.soft_output:
        return "soft_output is served by the jnp path"
    if cfg.msg_dtype != "float32":
        return "bfloat16 messages are served by the jnp path"
    if weights_mode(cfg, code.m_b) == "iter":
        return "per-iteration weight schedules are served by the jnp path"
    if cfg.max_iters < 1:
        return "max_iters < 1"
    if frames_per_block(code) == 0:
        return "one codeword's state exceeds a block's shared memory"
    return None


def kernel_tables(code) -> np.ndarray:
    """The kernel's int32 base-graph table: ``layer_ptr[m_b+1] |
    edge_col[E] | edge_shift[E] | col_ptr[n_b+1] | col_edge[E] |
    edge_layer[E]`` with edges in the code's row-major block order and
    ``col_edge`` grouping edge ids by block column in ascending order (the
    flooding posterior's summation order, ops/bp.py)."""
    br, bc, sh = code.blocks
    col_edge = np.argsort(bc, kind="stable")
    col_ptr = np.concatenate(
        [[0], np.cumsum(np.bincount(bc, minlength=code.n_b))])
    return np.concatenate([
        code.layer_ptr, bc, sh, col_ptr, col_edge, br,
    ]).astype(np.int32)


def kernel_weights(cfg: DecoderConfig, m_b: int) -> np.ndarray:
    """float32 ``alpha[m_b] | beta[m_b]`` from a scalar or per-layer
    normalization/offset."""
    from .bp import canon_weights

    out = []
    for w in (cfg.normalization, cfg.offset):
        mode, v = canon_weights(w, m_b)
        if mode == "iter":
            raise ValueError("per-iteration weights are served by the jnp path")
        out.append(np.full(m_b, v, np.float32) if mode == "scalar"
                   else np.asarray(v, np.float32))
    return np.concatenate(out)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """Build (``make`` is a no-op when up to date), load, and register the
    FFI target; raises when the toolchain or the card is missing."""
    env = dict(os.environ, PYTHON=os.environ.get("PYTHON", "python3"))
    proc = subprocess.run(["make", "-s", "-C", _DIR], capture_output=True,
                          text=True, env=env, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(
            "building the CUDA decoder failed (make -C myldpccppapi/cuda):\n"
            + proc.stdout + proc.stderr)
    lib = ctypes.CDLL(_SO)
    lib.ldpc_minsum_smem_bytes.restype = ctypes.c_size_t
    lib.ldpc_minsum_smem_bytes.argtypes = [ctypes.c_int] * 5
    jax.ffi.register_ffi_target(
        _TARGET, jax.ffi.pycapsule(lib.LdpcMinSumDecode), platform="CUDA")
    return lib


def _check_layout(code, frames: int) -> None:
    lib = _library()
    got = lib.ldpc_minsum_smem_bytes(code.z, code.n_b, code.m_b,
                                     code.num_blocks, frames)
    if got != smem_bytes(code, frames):
        raise RuntimeError(
            f"shared-memory layout mismatch: library {got} B, "
            f"python {smem_bytes(code, frames)} B")


@functools.partial(jax.jit, static_argnums=(0, 1))
def decode_qc_cuda(code, cfg: DecoderConfig, llr: jax.Array):
    """Decode [B, n] channel LLRs with the fused kernel; returns the same
    :class:`~myldpccppapi.ops.bp.DecodeResult` as ``bp.decode_qc``."""
    from .bp import DecodeResult

    reason = unsupported_reason(code, cfg)
    if reason is not None:
        raise ValueError(f"cuda decoder: {reason}")
    frames = frames_per_block(code)
    _check_layout(code, frames)
    b = llr.shape[0]
    call = jax.ffi.ffi_call(
        _TARGET,
        (jax.ShapeDtypeStruct((b, code.n), jnp.uint8),
         jax.ShapeDtypeStruct((b,), jnp.int32),
         jax.ShapeDtypeStruct((b,), jnp.uint8)),
    )
    bits, iters, conv = call(
        llr.astype(jnp.float32),
        jnp.asarray(kernel_tables(code)),
        jnp.asarray(kernel_weights(cfg, code.m_b)),
        z=np.int32(code.z), n_b=np.int32(code.n_b), m_b=np.int32(code.m_b),
        n_e=np.int32(code.num_blocks), frames_per_block=np.int32(frames),
        max_iters=np.int32(cfg.max_iters),
        layered=np.int32(cfg.schedule == "layered"),
    )
    if cfg.early_exit:
        # every block stops at its slowest codeword, so the batch ran as
        # many sweeps as its slowest frame needed
        total = jnp.max(iters, initial=0)
    else:
        total = jnp.int32(cfg.max_iters)
    return DecodeResult(bits=bits, converged=conv > 0, iterations=iters,
                        total_iters=total)
