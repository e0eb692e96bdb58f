// Native host-side kernels: bit-packed GF(2) linear algebra + byte-stream
// bit (un)packing.
//
// This is the framework's counterpart of the reference's native host layer
// (MyLdpc.cpp host orchestration + the Eigen GF(2) helpers in
// MyLdpc.h:240-337): the accelerator does the message-passing math, while one-time
// encoder precompute (Richardson-Urbanke / information-set reduction) and
// the streaming byte<->bit framing (MyLdpc.cpp:643-646, decodeCL.c:188-199)
// run here.  Rows are packed 64 bits/word, so elimination runs ~64x the
// bool-matrix flop rate; loaded from Python via ctypes (no pybind11 in this
// toolchain).
//
// Build: make -C myldpccppapi/native   (produces libmyldpc_native.so)

#include <cstdint>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// Bit packing, LSB-first within each byte (the reference's contract).
// ---------------------------------------------------------------------------

void pack_bits_lsb(const uint8_t* bits, uint8_t* bytes, int64_t n_bytes) {
  for (int64_t i = 0; i < n_bytes; ++i) {
    const uint8_t* b = bits + i * 8;
    bytes[i] = static_cast<uint8_t>(
        (b[0] & 1) | ((b[1] & 1) << 1) | ((b[2] & 1) << 2) |
        ((b[3] & 1) << 3) | ((b[4] & 1) << 4) | ((b[5] & 1) << 5) |
        ((b[6] & 1) << 6) | ((b[7] & 1) << 7));
  }
}

void unpack_bits_lsb(const uint8_t* bytes, uint8_t* bits, int64_t n_bytes) {
  for (int64_t i = 0; i < n_bytes; ++i) {
    uint8_t v = bytes[i];
    uint8_t* b = bits + i * 8;
    for (int j = 0; j < 8; ++j) b[j] = (v >> j) & 1;
  }
}

// ---------------------------------------------------------------------------
// Bit-packed GF(2) elimination.  Matrix: rows x words uint64, bit c of a row
// lives in word c/64, bit position c%64.
// ---------------------------------------------------------------------------

static inline int get_bit(const uint64_t* row, int64_t c) {
  return (row[c >> 6] >> (c & 63)) & 1;
}

// In-place reduced row echelon form.  Returns rank; writes the pivot column
// of each of the first `rank` rows into pivot_cols.
int64_t gf2_rref_packed(uint64_t* m, int64_t rows, int64_t cols,
                        int64_t words, int64_t* pivot_cols) {
  int64_t rank = 0;
  for (int64_t col = 0; col < cols && rank < rows; ++col) {
    int64_t pivot = -1;
    for (int64_t r = rank; r < rows; ++r) {
      if (get_bit(m + r * words, col)) { pivot = r; break; }
    }
    if (pivot < 0) continue;
    if (pivot != rank) {
      for (int64_t w = 0; w < words; ++w) {
        uint64_t t = m[pivot * words + w];
        m[pivot * words + w] = m[rank * words + w];
        m[rank * words + w] = t;
      }
    }
    const uint64_t* prow = m + rank * words;
    const int64_t w0 = col >> 6;  // pivot row is zero left of the pivot col
    for (int64_t r = 0; r < rows; ++r) {
      if (r == rank) continue;
      uint64_t* row = m + r * words;
      if ((row[w0] >> (col & 63)) & 1) {
        for (int64_t w = w0; w < words; ++w) row[w] ^= prow[w];
      }
    }
    pivot_cols[rank++] = col;
  }
  return rank;
}

// Gauss-Jordan inverse of a square matrix (both operands bit-packed).
// Returns 0 on success, -1 if singular.  `inv` must be the packed identity
// on entry (same rows/words layout).
int64_t gf2_inv_packed(uint64_t* m, uint64_t* inv, int64_t n, int64_t words) {
  for (int64_t col = 0; col < n; ++col) {
    int64_t pivot = -1;
    for (int64_t r = col; r < n; ++r) {
      if (get_bit(m + r * words, col)) { pivot = r; break; }
    }
    if (pivot < 0) return -1;
    if (pivot != col) {
      for (int64_t w = 0; w < words; ++w) {
        uint64_t t = m[pivot * words + w];
        m[pivot * words + w] = m[col * words + w];
        m[col * words + w] = t;
        t = inv[pivot * words + w];
        inv[pivot * words + w] = inv[col * words + w];
        inv[col * words + w] = t;
      }
    }
    const uint64_t* pm = m + col * words;
    const uint64_t* pi = inv + col * words;
    const int64_t w0 = col >> 6;
    for (int64_t r = 0; r < n; ++r) {
      if (r == col) continue;
      uint64_t* rm = m + r * words;
      if ((rm[w0] >> (col & 63)) & 1) {
        uint64_t* ri = inv + r * words;
        for (int64_t w = w0; w < words; ++w) rm[w] ^= pm[w];
        for (int64_t w = 0; w < words; ++w) ri[w] ^= pi[w];
      }
    }
  }
  return 0;
}

// C = A @ B over GF(2).  A: [ra x ca] packed (wa words/row); B: [ca x cb]
// packed (wb words/row); C: [ra x cb] packed (wb words/row), zeroed here.
void gf2_matmul_packed(const uint64_t* a, const uint64_t* b, uint64_t* c,
                       int64_t ra, int64_t ca, int64_t cb, int64_t wa,
                       int64_t wb) {
  std::memset(c, 0, static_cast<size_t>(ra) * wb * sizeof(uint64_t));
  for (int64_t i = 0; i < ra; ++i) {
    const uint64_t* arow = a + i * wa;
    uint64_t* crow = c + i * wb;
    for (int64_t kw = 0; kw < wa; ++kw) {
      uint64_t bits = arow[kw];
      while (bits) {
        const int64_t k = (kw << 6) + __builtin_ctzll(bits);
        bits &= bits - 1;
        if (k >= ca) break;
        const uint64_t* brow = b + k * wb;
        for (int64_t w = 0; w < wb; ++w) crow[w] ^= brow[w];
      }
    }
  }
}

}  // extern "C"
