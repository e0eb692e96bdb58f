"""Dense GF(2) linear algebra on NumPy bool arrays.

Used only for one-time encoder precompute on the host (the analogue of the
Eigen-based helpers the reference injects into the ``Eigen`` namespace,
``MyLdpc.h:240-337``).  The hot batched encode path runs on the device as an
integer matmul mod 2 (see :mod:`myldpccppapi.codes.encoder`).

Every function transparently dispatches to the bit-packed native C++ kernels
(myldpccppapi/native, ~10x faster elimination) when the shared library
is available, with a pure-NumPy fallback otherwise.
"""
from __future__ import annotations

import numpy as np

from .. import native as _native

__all__ = ["gf2_matmul", "gf2_inv", "gf2_solve", "gf2_rank", "gf2_rref"]


def _as_bool(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype != np.bool_:
        a = (a % 2).astype(np.bool_)
    return a


def gf2_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(a @ b) mod 2 for dense 0/1 matrices, returned as bool."""
    a = _as_bool(a)
    b = _as_bool(b)
    if a.ndim == 2 and b.ndim == 2 and a.size * b.shape[1] > 1 << 22:
        out = _native.matmul_packed(a, b)
        if out is not None:
            return out
    # int32 accumulate keeps this exact for any inner dim < 2**31
    return (a.astype(np.int32) @ b.astype(np.int32)) % 2 == 1


def gf2_inv(m: np.ndarray) -> np.ndarray:
    """Invert a square matrix over GF(2) via Gauss-Jordan elimination.

    Raises ``np.linalg.LinAlgError`` if singular.  Equivalent in effect to the
    reference's ``Eigen::inverse`` (``MyLdpc.h:250-294``) but with row
    pivoting so it works on any invertible input.
    """
    m = _as_bool(m).copy()
    n = m.shape[0]
    if m.shape != (n, n):
        raise ValueError(f"expected square matrix, got {m.shape}")
    if n >= 256:
        out = _native.inv_packed(m)  # raises LinAlgError if singular
        if out is not None:
            return out
    inv = np.eye(n, dtype=np.bool_)
    for col in range(n):
        pivots = np.nonzero(m[col:, col])[0]
        if pivots.size == 0:
            raise np.linalg.LinAlgError(f"matrix is singular over GF(2) at column {col}")
        p = col + pivots[0]
        if p != col:
            m[[col, p]] = m[[p, col]]
            inv[[col, p]] = inv[[p, col]]
        # eliminate this column from every other row (vectorized row XOR)
        rows = m[:, col].copy()
        rows[col] = False
        m[rows] ^= m[col]
        inv[rows] ^= inv[col]
    return inv


def gf2_solve(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Solve a @ x = b over GF(2) for square invertible ``a``."""
    return gf2_matmul(gf2_inv(a), b)


def gf2_rref(m: np.ndarray):
    """Reduced row-echelon form over GF(2).

    Returns ``(rref, pivot_cols)`` where ``rref`` is [rank, cols] bool (zero
    rows dropped) and ``pivot_cols`` the pivot column index per row.  Used to
    build encoders for arbitrary (possibly rank-deficient) parity-check
    matrices: pivot columns become parity positions, free columns carry
    information, and the row space — hence the code — is unchanged.
    """
    if min(np.asarray(m).shape) >= 256:
        out = _native.rref_packed(m)
        if out is not None:
            return out
    m = _as_bool(m).copy()
    rows, cols = m.shape
    rank = 0
    pivot_cols = []
    for col in range(cols):
        pivots = np.nonzero(m[rank:, col])[0]
        if pivots.size == 0:
            continue
        p = rank + pivots[0]
        if p != rank:
            m[[rank, p]] = m[[p, rank]]
        sel = m[:, col].copy()
        sel[rank] = False
        m[sel] ^= m[rank]
        pivot_cols.append(col)
        rank += 1
        if rank == rows:
            break
    return m[:rank], np.asarray(pivot_cols, dtype=np.int64)


def gf2_rank(m: np.ndarray) -> int:
    """Rank of a dense 0/1 matrix over GF(2)."""
    m = _as_bool(m).copy()
    rank = 0
    rows, cols = m.shape
    for col in range(cols):
        pivots = np.nonzero(m[rank:, col])[0]
        if pivots.size == 0:
            continue
        p = rank + pivots[0]
        if p != rank:
            m[[rank, p]] = m[[p, rank]]
        sel = m[:, col].copy()
        sel[rank] = False
        m[sel] ^= m[rank]
        rank += 1
        if rank == rows:
            break
    return rank
