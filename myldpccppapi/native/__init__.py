"""ctypes loader for the native host kernels (libmyldpc_native.so).

Runs ``make`` on first use (a no-op when the object is up to date), so the
library is only ever built from the tracked sources on this machine;
``make`` + g++ are part of the supported toolchain.  Every consumer falls
back to the pure NumPy implementation when the library is unavailable, so
the framework remains importable on minimal systems.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import weakref
from typing import Optional

import numpy as np

__all__ = ["load", "available", "pack_bits", "unpack_bits", "rref_packed",
           "inv_packed", "matmul_packed", "pack_rows", "unpack_rows",
           "decode_golden_native", "decode_golden_layered_native",
           "decode_golden_sp_ref_native"]

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "libmyldpc_native.so")
_LIB: "ctypes.CDLL | None | bool" = None  # None = not tried, False = failed


def _build() -> bool:
    try:
        subprocess.run(
            ["make", "-C", _DIR, "-s"],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return os.path.exists(_SO)
    except Exception:
        return False


def load() -> Optional[ctypes.CDLL]:
    global _LIB
    if _LIB is False:
        return None
    if _LIB is not None:
        return _LIB
    if not _build():
        _LIB = False
        return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        _LIB = False
        return None
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i64 = ctypes.c_int64
    lib.pack_bits_lsb.argtypes = [u8p, u8p, i64]
    lib.unpack_bits_lsb.argtypes = [u8p, u8p, i64]
    lib.gf2_rref_packed.argtypes = [u64p, i64, i64, i64, i64p]
    lib.gf2_rref_packed.restype = i64
    lib.gf2_inv_packed.argtypes = [u64p, u64p, i64, i64]
    lib.gf2_inv_packed.restype = i64
    lib.gf2_matmul_packed.argtypes = [u64p, u64p, u64p, i64, i64, i64, i64, i64]
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.decode_golden_minsum.argtypes = [
        i64p, i32p, i64, i64, i64, f32p, i64, ctypes.c_int32,
        ctypes.c_float, ctypes.c_float, u8p, u8p, i32p,
    ]
    lib.decode_golden_layered.argtypes = [
        i64p, i32p, i32p, i64p, i64, i64, i64, i64, f32p, i64,
        ctypes.c_int32, ctypes.c_float, ctypes.c_float, u8p, u8p, i32p,
    ]
    lib.decode_golden_sp_ref.argtypes = [
        i64p, i32p, i64p, i32p, i64, i64, i64, f32p, i64,
        ctypes.c_int32, ctypes.c_float, u8p, u8p, i32p,
    ]
    lib.decode_golden_flooding.argtypes = [
        i64p, i32p, i32p, i64, i64, i64, f32p, i64, ctypes.c_int32,
        ctypes.c_float, ctypes.c_float, ctypes.c_int32, u8p, u8p, i32p,
    ]
    _LIB = lib
    return lib


def available() -> bool:
    return load() is not None


# -- packed-row helpers (numpy side) ----------------------------------------

def pack_rows(m: np.ndarray) -> np.ndarray:
    """[r, c] 0/1 -> [r, ceil(c/64)] uint64, bit c in word c//64 pos c%64."""
    m = np.asarray(m, dtype=np.uint8) & 1
    r, c = m.shape
    pad = (-c) % 64
    if pad:
        m = np.concatenate([m, np.zeros((r, pad), np.uint8)], axis=1)
    by = np.packbits(m.reshape(r, -1, 8), axis=-1, bitorder="little")[..., 0]
    return by.reshape(r, -1, 8).view(np.uint64).reshape(r, -1).copy()


def unpack_rows(p: np.ndarray, cols: int) -> np.ndarray:
    """Inverse of :func:`pack_rows` -> [r, cols] bool."""
    r = p.shape[0]
    by = p.view(np.uint8).reshape(r, -1)
    bits = np.unpackbits(by, axis=-1, bitorder="little")
    return bits[:, :cols].astype(np.bool_)


# -- public ops with numpy fallback -----------------------------------------

def pack_bits(bits: np.ndarray) -> np.ndarray:
    """[..., L*8] 0/1 -> [..., L] uint8, LSB-first."""
    lib = load()
    bits = np.ascontiguousarray(np.asarray(bits, np.uint8))
    if lib is None:
        return np.packbits(
            bits.reshape(*bits.shape[:-1], -1, 8), axis=-1, bitorder="little"
        )[..., 0]
    n_bytes = bits.size // 8
    out = np.empty(bits.shape[:-1] + (bits.shape[-1] // 8,), np.uint8)
    lib.pack_bits_lsb(bits.reshape(-1), out.reshape(-1), n_bytes)
    return out


def unpack_bits(data: np.ndarray) -> np.ndarray:
    """[..., L] uint8 -> [..., L*8] 0/1, LSB-first."""
    lib = load()
    data = np.ascontiguousarray(np.asarray(data, np.uint8))
    if lib is None:
        bits = np.unpackbits(data[..., :, None], axis=-1, bitorder="little")
        return bits.reshape(*data.shape[:-1], data.shape[-1] * 8)
    out = np.empty(data.shape[:-1] + (data.shape[-1] * 8,), np.uint8)
    lib.unpack_bits_lsb(data.reshape(-1), out.reshape(-1), data.size)
    return out


def rref_packed(m: np.ndarray):
    """RREF of a 0/1 matrix via the packed kernel.  Returns
    (rref [rank, c] bool, pivot_cols [rank] int64) or None if unavailable."""
    lib = load()
    if lib is None:
        return None
    mb = np.asarray(m)
    r, c = mb.shape
    p = pack_rows(mb)
    piv = np.zeros(r, dtype=np.int64)
    rank = lib.gf2_rref_packed(p, r, c, p.shape[1], piv)
    return unpack_rows(p[:rank], c), piv[:rank]


def inv_packed(m: np.ndarray):
    """GF(2) inverse via the packed kernel, or None if unavailable/singular
    signalling left to caller (raises np.linalg.LinAlgError on singular)."""
    lib = load()
    if lib is None:
        return None
    mb = np.asarray(m)
    n = mb.shape[0]
    p = pack_rows(mb)
    ident = pack_rows(np.eye(n, dtype=np.uint8))
    rc = lib.gf2_inv_packed(p, ident, n, p.shape[1])
    if rc != 0:
        raise np.linalg.LinAlgError("matrix is singular over GF(2)")
    return unpack_rows(ident, n)


def decode_golden_native(code, llr: np.ndarray, max_iters: int = 40,
                         normalization: float = 1.0, offset: float = 0.0):
    """C++ flooding min-sum golden decode (the compiled decodeCPU analogue).

    Returns (bits [B, n] uint8, converged [B] bool, iters [B] int32), or
    None if the native library is unavailable.
    """
    lib = load()
    if lib is None:
        return None
    rows, cols = code.h_coo()
    order = np.argsort(rows, kind="stable")
    rows, cols = rows[order], cols[order]
    m, n = code.m, code.n
    row_ptr = np.concatenate(
        [[0], np.cumsum(np.bincount(rows, minlength=m))]
    ).astype(np.int64)
    cols32 = np.ascontiguousarray(cols, dtype=np.int32)
    llr = np.ascontiguousarray(np.atleast_2d(llr), dtype=np.float32)
    b = llr.shape[0]
    bits = np.empty((b, n), np.uint8)
    conv = np.empty(b, np.uint8)
    iters = np.empty(b, np.int32)
    lib.decode_golden_minsum(
        row_ptr, cols32, m, n, len(cols32), llr.reshape(-1), b,
        np.int32(max_iters), np.float32(normalization), np.float32(offset),
        bits.reshape(-1), conv, iters,
    )
    return bits, conv.astype(bool), iters


#: plans keyed by the code object itself (weakly): an id() key would hand a
#: dead code's plan to a new code that reuses its address
_LAYERED_PLANS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _layered_plan(code):
    """Edge-order plan for the layered golden, matching ops/bp.py exactly.

    Enumerates the code's edges in (layer, block entry, check row) order —
    bp.py's writeback order — then stable-sorts by global check row to get
    the CSR the check update walks (within a row, stable sort preserves
    block-entry order, so min-tie-breaking matches ``jnp.argmin``).
    Returns (row_ptr int64[m+1], cols int32[E], wb_perm int32[E],
    layer_row_ptr int64[m_b+1]).
    """
    hit = _LAYERED_PLANS.get(code)
    if hit is not None:
        return hit
    br, bc, sh = code.blocks
    masks = code.block_row_masks
    ptr = np.asarray(code.layer_ptr)
    z = code.z
    rows_en, cols_en = [], []
    for li in range(code.m_b):
        for e in range(int(ptr[li]), int(ptr[li + 1])):
            r = np.arange(z)
            if masks[e] is not None:
                r = r[np.asarray(masks[e])]
            rows_en.append(li * z + r)
            cols_en.append(int(bc[e]) * z + (r + int(sh[e])) % z)
    rows_en = np.concatenate(rows_en).astype(np.int64)
    cols_en = np.concatenate(cols_en).astype(np.int64)
    order = np.argsort(rows_en, kind="stable")
    inv = np.empty(len(order), np.int64)
    inv[order] = np.arange(len(order))
    row_ptr = np.concatenate(
        [[0], np.cumsum(np.bincount(rows_en, minlength=code.m))]
    ).astype(np.int64)
    plan = (
        row_ptr,
        np.ascontiguousarray(cols_en[order], np.int32),
        np.ascontiguousarray(inv, np.int32),
        (np.arange(code.m_b + 1, dtype=np.int64) * z),
    )
    _LAYERED_PLANS[code] = plan
    return plan


def decode_golden_layered_native(code, llr: np.ndarray, max_iters: int = 40,
                                 normalization: float = 1.0,
                                 offset: float = 0.0):
    """C++ layered (TDMP) min-sum golden decode — the independent native pin
    for the framework's layered schedule (same layer order and
    delta-writeback expression as ops/bp.py::decode_layered, bit-exact in
    f32).  Returns (bits [B, n] uint8, converged [B] bool, iters [B] int32),
    or None if the native library is unavailable.  QC codes only (layers are
    base rows)."""
    lib = load()
    if lib is None or not hasattr(code, "blocks"):
        return None
    row_ptr, cols, wb_perm, layer_row_ptr = _layered_plan(code)
    llr = np.ascontiguousarray(np.atleast_2d(llr), dtype=np.float32)
    b = llr.shape[0]
    n = code.n
    bits = np.empty((b, n), np.uint8)
    conv = np.empty(b, np.uint8)
    iters = np.empty(b, np.int32)
    lib.decode_golden_layered(
        row_ptr, cols, wb_perm, layer_row_ptr, code.m_b, code.m, n,
        len(cols), llr.reshape(-1), b, np.int32(max_iters),
        np.float32(normalization), np.float32(offset),
        bits.reshape(-1), conv, iters,
    )
    return bits, conv.astype(bool), iters


def decode_golden_flooding_native(code, llr: np.ndarray, max_iters: int = 40,
                                  normalization: float = 1.0,
                                  offset: float = 0.0,
                                  self_correction: bool = False):
    """C++ flooding min-sum golden in the framework's EXACT f32 accumulation
    order (posterior adds block by block, (layer, entry, row) — the layered
    plan's wb_perm) — the independent native pin for the FLOODING schedule,
    bit-exact vs ops/bp.py::decode_flooding and the fused kernel.  With
    ``self_correction`` it pins the SCMS (Savin 2008) trajectory the same
    way.  Returns (bits, converged, iters) or None if unavailable.  QC
    codes only (uses the layered edge plan)."""
    lib = load()
    if lib is None or not hasattr(code, "blocks"):
        return None
    row_ptr, cols, wb_perm, _ = _layered_plan(code)
    llr = np.ascontiguousarray(np.atleast_2d(llr), dtype=np.float32)
    b = llr.shape[0]
    n = code.n
    bits = np.empty((b, n), np.uint8)
    conv = np.empty(b, np.uint8)
    iters = np.empty(b, np.int32)
    lib.decode_golden_flooding(
        row_ptr, cols, wb_perm, code.m, n, len(cols), llr.reshape(-1), b,
        np.int32(max_iters), np.float32(normalization), np.float32(offset),
        np.int32(1 if self_correction else 0), bits.reshape(-1), conv, iters,
    )
    return bits, conv.astype(bool), iters


def decode_golden_sp_ref_native(code, llr: np.ndarray, max_iters: int = 40,
                                scale: float = 8.0):
    """C++ probability-domain flooding sum-product with the REFERENCE's
    exact arithmetic and channel quirk (``exp(scale * y)`` init with scale
    defaulting to the hardcoded 8 = 2/sigma^2 of ``decodeCL.c:9``) — the
    parity baseline for the reference's SP path (``decodeCL.c:3-108``,
    ``MyLdpc.cpp:977-1059``).  Returns (bits, converged, iters) or None."""
    lib = load()
    if lib is None:
        return None
    rows, cols = code.h_coo()
    order = np.argsort(rows, kind="stable")
    rows, cols = rows[order], cols[order]
    m, n = code.m, code.n
    row_ptr = np.concatenate(
        [[0], np.cumsum(np.bincount(rows, minlength=m))]
    ).astype(np.int64)
    # column adjacency in the reference's linked-list order: edges appended
    # row-major (MyLdpc.cpp:188-220), i.e. ascending edge index per column
    col_order = np.argsort(cols, kind="stable")
    col_ptr = np.concatenate(
        [[0], np.cumsum(np.bincount(cols, minlength=n))]
    ).astype(np.int64)
    col_edges = np.ascontiguousarray(col_order, np.int32)
    cols32 = np.ascontiguousarray(cols, dtype=np.int32)
    llr = np.ascontiguousarray(np.atleast_2d(llr), dtype=np.float32)
    b = llr.shape[0]
    bits = np.empty((b, n), np.uint8)
    conv = np.empty(b, np.uint8)
    iters = np.empty(b, np.int32)
    lib.decode_golden_sp_ref(
        row_ptr, cols32, col_ptr, col_edges, m, n, len(cols32),
        llr.reshape(-1), b, np.int32(max_iters), np.float32(scale),
        bits.reshape(-1), conv, iters,
    )
    return bits, conv.astype(bool), iters


def matmul_packed(a: np.ndarray, b: np.ndarray):
    """(a @ b) mod 2 via the packed kernel, or None if unavailable."""
    lib = load()
    if lib is None:
        return None
    a = np.asarray(a)
    b = np.asarray(b)
    ra, ca = a.shape
    cb = b.shape[1]
    pa = pack_rows(a)
    pb = pack_rows(b)
    pc = np.zeros((ra, pb.shape[1]), dtype=np.uint64)
    lib.gf2_matmul_packed(pa, pb, pc, ra, ca, cb, pa.shape[1], pb.shape[1])
    return unpack_rows(pc, cb)
