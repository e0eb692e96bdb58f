// Runs the fused decoder kernel (myldpccppapi/cuda/minsum_decoder.cu) on the
// host under the emulation in cuda_runtime.h: one block at a time, one
// std::thread per CUDA thread.  tests/test_cuda_decoder.py builds it with
// g++ and compares its output with ops/bp.py.
//
//   harness DIR z n_b m_b n_e frames max_iters layered batch
//
// reads DIR/{llr,tab,w}.bin, writes DIR/{bits,iters,conv}.out.
#include <cstdio>
#include <cstdlib>
#include <fstream>
#include <string>

#include "kernel.inc"

template <class T>
static std::vector<T> read_all(const std::string& path, size_t n) {
  std::vector<T> v(n);
  std::ifstream(path, std::ios::binary).read(reinterpret_cast<char*>(v.data()), n * sizeof(T));
  return v;
}

template <class T>
static void write_all(const std::string& path, const std::vector<T>& v) {
  std::ofstream(path, std::ios::binary).write(reinterpret_cast<const char*>(v.data()),
                                              v.size() * sizeof(T));
}

int main(int argc, char** argv) {
  if (argc != 10) {
    std::fprintf(stderr, "usage: harness DIR z n_b m_b n_e frames max_iters layered batch\n");
    return 2;
  }
  const std::string dir = argv[1];
  const int z = atoi(argv[2]), n_b = atoi(argv[3]), m_b = atoi(argv[4]), n_e = atoi(argv[5]);
  const int frames = atoi(argv[6]), max_iters = atoi(argv[7]), layered = atoi(argv[8]);
  const int batch = atoi(argv[9]);
  const Geometry g = make_geometry(z, n_b, m_b, n_e, frames, max_iters, layered);
  const auto llr = read_all<float>(dir + "/llr.bin", static_cast<size_t>(batch) * g.n);
  const auto tab = read_all<int32_t>(dir + "/tab.bin", g.tab_len);
  const auto w = read_all<float>(dir + "/w.bin", 2 * m_b);
  std::vector<uint8_t> bits(static_cast<size_t>(batch) * g.n), conv(batch);
  std::vector<int32_t> iters(batch);
  const Layout L = make_layout(g);
  const int blocks = (batch + frames - 1) / frames, threads = frames * z;
  blockDim.x = threads;
  for (int b = 0; b < blocks; ++b) {
    std::vector<unsigned char> smem(L.total);
    g_smem = smem.data();
    std::barrier<> bar(threads);
    g_bar = &bar;
    std::vector<std::thread> pool;
    for (int t = 0; t < threads; ++t)
      pool.emplace_back([&, t, b] {
        threadIdx.x = t;
        blockIdx.x = b;
        minsum_decode_kernel(llr.data(), tab.data(), w.data(), bits.data(), iters.data(),
                             conv.data(), batch, g);
      });
    for (auto& th : pool) th.join();
  }
  write_all(dir + "/bits.out", bits);
  write_all(dir + "/iters.out", iters);
  write_all(dir + "/conv.out", conv);
  return 0;
}
