// Fused min-sum decoder for short quasi-cyclic LDPC codes, one kernel per
// batch: channel LLRs in, hard bits + per-frame convergence out.
//
// The GPU shape of the reference's fused OpenCL decoders (decodeOnceTDMP /
// decodeOnceMS, decodeCL.c:307-567): one thread block holds G codewords'
// whole decode state in shared memory for every iteration, and one thread
// owns check row r of its codeword (it walks the base-matrix layers in
// order).  Per codeword the block keeps
//
//   * the posterior P[n] (f32), and
//   * the check-to-variable messages in min-sum's compressed form, one
//     record per check row: the two smallest |q| after correction (m1, m2),
//     the position of the smallest, and the sign of every outgoing message.
//     A message is rebuilt as sign_k * (k == argmin ? m2 : m1), which is
//     exactly the value ops/bp.py stores, so the arithmetic below follows
//     bp.py's layered and flooding sweeps operation for operation:
//       layered:  q = P[v] - r_old;  P[v] = P[v] + (r_new - r_old)
//       flooding: q = P[v] - r_old;  P[v] = chan[v] + sum_e r_e (edge order)
//
// A codeword whose syndrome passes after a sweep stops (its P is frozen, so
// its bits and iteration count are latched there); the block stops once
// none of its codewords is live.
//
// Tables (int32, built by ops/cuda_bp.py:kernel_tables):
//   layer_ptr[m_b+1] | edge_col[E] | edge_shift[E] | col_ptr[n_b+1] |
//   col_edge[E] (edge ids grouped by block column, ascending) | edge_layer[E]
// Weights (f32): alpha[m_b] | beta[m_b].
//
// Build: make -C myldpccppapi/cuda  (needs nvcc; sm_90a).
#include <cstdint>
#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr float kQInf = 1e30f;  // clamp of the excluding-self magnitude
#define kInf __int_as_float(0x7f800000)

struct Geometry {
  int z, n_b, m_b, n_e, frames, max_iters, layered;
  int n, m, tab_len, pstride, mstride;
};

__host__ __device__ inline int round_up(int x, int a) { return (x + a - 1) / a * a; }

// Codeword strides in shared memory: congruent to z mod 32, so the rows of
// consecutive codewords in one warp fall into consecutive banks.
__host__ __device__ inline int bank_stride(int len, int z) {
  return len + ((z - len) % 32 + 32) % 32;
}

__host__ __device__ inline Geometry make_geometry(int z, int n_b, int m_b,
                                                  int n_e, int frames,
                                                  int max_iters, int layered) {
  Geometry g;
  g.z = z; g.n_b = n_b; g.m_b = m_b; g.n_e = n_e; g.frames = frames;
  g.max_iters = max_iters; g.layered = layered;
  g.n = n_b * z;
  g.m = m_b * z;
  g.tab_len = (m_b + 1) + 2 * n_e + (n_b + 1) + 2 * n_e;
  g.pstride = bank_stride(g.n, z);
  g.mstride = bank_stride(g.m, z);
  return g;
}

// Shared memory layout, in bytes, 16-aligned sections:
//   tab | weights | flags[2*G] | P[G*pstride] | M1 | M2 | SG | AM (u8)
struct Layout {
  size_t tab, w, flags, p, m1, m2, sg, am, total;
};

__host__ __device__ inline Layout make_layout(const Geometry& g) {
  Layout l;
  size_t off = 0;
  l.tab = off;   off += round_up(g.tab_len * 4, 16);
  l.w = off;     off += round_up(2 * g.m_b * 4, 16);
  l.flags = off; off += round_up(2 * g.frames * 4, 16);
  l.p = off;     off += round_up(g.frames * g.pstride * 4, 16);
  l.m1 = off;    off += round_up(g.frames * g.mstride * 4, 16);
  l.m2 = off;    off += round_up(g.frames * g.mstride * 4, 16);
  l.sg = off;    off += round_up(g.frames * g.mstride * 4, 16);
  l.am = off;    off += round_up(g.frames * g.mstride, 16);
  l.total = off;
  return l;
}

// Stored message of edge k of a check row.
__device__ __forceinline__ float message(float m1, float m2, uint32_t sg,
                                         int am, int k) {
  float mag = (k == am) ? m2 : m1;
  return ((sg >> k) & 1u) ? -mag : mag;
}

__global__ void minsum_decode_kernel(const float* __restrict__ llr,
                                     const int32_t* __restrict__ tab_g,
                                     const float* __restrict__ w_g,
                                     uint8_t* __restrict__ bits_out,
                                     int32_t* __restrict__ iters_out,
                                     uint8_t* __restrict__ conv_out,
                                     int batch, Geometry g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = make_layout(g);
  int32_t* tab = reinterpret_cast<int32_t*>(smem + L.tab);
  float* w = reinterpret_cast<float*>(smem + L.w);
  int32_t* flags = reinterpret_cast<int32_t*>(smem + L.flags);
  float* P_all = reinterpret_cast<float*>(smem + L.p);
  float* M1_all = reinterpret_cast<float*>(smem + L.m1);
  float* M2_all = reinterpret_cast<float*>(smem + L.m2);
  uint32_t* SG_all = reinterpret_cast<uint32_t*>(smem + L.sg);
  uint8_t* AM_all = smem + L.am;

  const int z = g.z, n = g.n, m_b = g.m_b, n_b = g.n_b, G = g.frames;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int c = tid / z;   // codeword within the block
  const int r = tid % z;   // check row within each layer
  const int cw0 = blockIdx.x * G;
  const int cw = cw0 + c;

  for (int i = tid; i < g.tab_len; i += nthreads) tab[i] = tab_g[i];
  for (int i = tid; i < 2 * m_b; i += nthreads) w[i] = w_g[i];
  for (int i = tid; i < 2 * G; i += nthreads) flags[i] = 0;
  for (int i = tid; i < G * n; i += nthreads) {
    int cc = i / n, v = i - cc * n;
    P_all[cc * g.pstride + v] = (cw0 + cc < batch) ? llr[(size_t)(cw0 + cc) * n + v] : 0.f;
  }
  for (int i = tid; i < G * g.mstride; i += nthreads) {
    M1_all[i] = 0.f; M2_all[i] = 0.f; SG_all[i] = 0u; AM_all[i] = 0;
  }
  __syncthreads();

  const int32_t* layer_ptr = tab;
  const int32_t* edge_col = layer_ptr + (m_b + 1);
  const int32_t* edge_shift = edge_col + g.n_e;
  const int32_t* col_ptr = edge_shift + g.n_e;
  const int32_t* col_edge = col_ptr + (n_b + 1);
  const int32_t* edge_layer = col_edge + g.n_e;

  float* P = P_all + c * g.pstride;
  float* M1 = M1_all + c * g.mstride;
  float* M2 = M2_all + c * g.mstride;
  uint32_t* SG = SG_all + c * g.mstride;
  uint8_t* AM = AM_all + c * g.mstride;

  bool live = cw < batch;
  bool conv = false;
  int iters = 0;

  // check-node update of row (li, r): new compressed record from
  // q_k = P[v_k] - r_old_k; the layered schedule also writes P back
  auto check_row = [&](int li, bool write_back) {
    const int p0 = layer_ptr[li];
    const int d = layer_ptr[li + 1] - p0;
    const int row = li * z + r;
    const float o1 = M1[row], o2 = M2[row];
    const uint32_t osg = SG[row];
    const int oam = AM[row];
    float mn1 = kInf, mn2 = kInf;
    int am = 0;
    uint32_t neg = 0u;
    for (int k = 0; k < d; ++k) {
      int x = r + edge_shift[p0 + k];
      if (x >= z) x -= z;
      const float q = __fsub_rn(P[edge_col[p0 + k] * z + x], message(o1, o2, osg, oam, k));
      const float a = fabsf(q);
      if (a < mn1) { mn2 = mn1; mn1 = a; am = k; }
      else if (a < mn2) { mn2 = a; }
      neg |= (q < 0.f ? 1u : 0u) << k;
    }
    const float alpha = w[li], beta = w[m_b + li];
    const float n1 = __fmul_rn(fmaxf(__fsub_rn(fminf(mn1, kQInf), beta), 0.f), alpha);
    const float n2 = __fmul_rn(fmaxf(__fsub_rn(fminf(mn2, kQInf), beta), 0.f), alpha);
    const uint32_t mask = (d >= 32) ? 0xffffffffu : ((1u << d) - 1u);
    const uint32_t sg = (__popc(neg) & 1) ? (~neg & mask) : neg;
    if (write_back) {
      for (int k = 0; k < d; ++k) {
        int x = r + edge_shift[p0 + k];
        if (x >= z) x -= z;
        const int v = edge_col[p0 + k] * z + x;
        const float delta = __fsub_rn(message(n1, n2, sg, am, k), message(o1, o2, osg, oam, k));
        P[v] = __fadd_rn(P[v], delta);
      }
    }
    M1[row] = n1; M2[row] = n2; SG[row] = sg; AM[row] = (uint8_t)am;
  };

  for (int t = 0; t < g.max_iters; ++t) {
    if (g.layered) {
      for (int li = 0; li < m_b; ++li) {
        if (live) check_row(li, true);
        __syncthreads();
      }
    } else {
      if (live) {
        for (int li = 0; li < m_b; ++li) check_row(li, false);
      }
      __syncthreads();
      if (live) {
        // posterior = channel + column-aligned messages, in edge order
        for (int j = 0; j < n_b; ++j) {
          const int v = j * z + r;
          float acc = __ldg(&llr[(size_t)cw * n + v]);
          for (int i = col_ptr[j]; i < col_ptr[j + 1]; ++i) {
            const int e = col_edge[i];
            const int li = edge_layer[e];
            int row = r - edge_shift[e];
            if (row < 0) row += z;
            row += li * z;
            acc = __fadd_rn(acc, message(M1[row], M2[row], SG[row], AM[row], e - layer_ptr[li]));
          }
          P[v] = acc;
        }
      }
      __syncthreads();
    }
    // syndrome of the hard decisions (bit = P <= 0), one flag per codeword
    bool bad = false;
    if (live) {
      for (int li = 0; li < m_b && !bad; ++li) {
        const int p0 = layer_ptr[li], p1 = layer_ptr[li + 1];
        int par = 0;
        for (int e = p0; e < p1; ++e) {
          int x = r + edge_shift[e];
          if (x >= z) x -= z;
          par ^= (P[edge_col[e] * z + x] <= 0.f) ? 1 : 0;
        }
        bad = par != 0;
      }
    }
    if (bad) flags[(t & 1) * G + c] = 1;
    if (r == 0) flags[((t + 1) & 1) * G + c] = 0;
    __syncthreads();
    if (live) {
      iters = t + 1;
      if (flags[(t & 1) * G + c] == 0) { live = false; conv = true; }
    }
    if (!__syncthreads_or(live)) break;
  }

  for (int i = tid; i < G * n; i += nthreads) {
    int cc = i / n, v = i - cc * n;
    if (cw0 + cc < batch)
      bits_out[(size_t)(cw0 + cc) * n + v] = P_all[cc * g.pstride + v] <= 0.f ? 1 : 0;
  }
  if (r == 0 && cw < batch) {
    iters_out[cw] = iters;
    conv_out[cw] = conv ? 1 : 0;
  }
}

ffi::Error MinSumDecodeImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> llr,
                            ffi::Buffer<ffi::S32> tab, ffi::Buffer<ffi::F32> weights,
                            ffi::ResultBuffer<ffi::U8> bits,
                            ffi::ResultBuffer<ffi::S32> iters,
                            ffi::ResultBuffer<ffi::U8> conv, int32_t z, int32_t n_b,
                            int32_t m_b, int32_t n_e, int32_t frames_per_block,
                            int32_t max_iters, int32_t layered) {
  auto dims = llr.dimensions();
  if (dims.size() != 2) return ffi::Error::InvalidArgument("llr must be [batch, n]");
  const int batch = static_cast<int>(dims[0]);
  const Geometry g = make_geometry(z, n_b, m_b, n_e, frames_per_block, max_iters, layered);
  if (dims[1] != g.n) return ffi::Error::InvalidArgument("llr width != n_b * z");
  if (static_cast<int64_t>(tab.element_count()) != g.tab_len)
    return ffi::Error::InvalidArgument("table length does not match the geometry");
  if (batch == 0) return ffi::Error::Success();
  const Layout L = make_layout(g);
  const int threads = frames_per_block * z;
  if (threads > 1024) return ffi::Error::InvalidArgument("frames_per_block * z > 1024");
  cudaError_t err = cudaFuncSetAttribute(minsum_decode_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L.total));
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  const int blocks = (batch + frames_per_block - 1) / frames_per_block;
  minsum_decode_kernel<<<blocks, threads, L.total, stream>>>(
      llr.typed_data(), tab.typed_data(), weights.typed_data(), bits->typed_data(),
      iters->typed_data(), conv->typed_data(), batch, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(LdpcMinSumDecode, MinSumDecodeImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::U8>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::U8>>()
                                  .Attr<int32_t>("z")
                                  .Attr<int32_t>("n_b")
                                  .Attr<int32_t>("m_b")
                                  .Attr<int32_t>("n_e")
                                  .Attr<int32_t>("frames_per_block")
                                  .Attr<int32_t>("max_iters")
                                  .Attr<int32_t>("layered"));

// Shared-memory bytes one block needs; ops/cuda_bp.py checks its own copy
// of this layout against it after loading the library.
extern "C" size_t ldpc_minsum_smem_bytes(int z, int n_b, int m_b, int n_e, int frames) {
  return make_layout(make_geometry(z, n_b, m_b, n_e, frames, 0, 1)).total;
}
