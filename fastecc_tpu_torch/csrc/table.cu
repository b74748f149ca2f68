// The table multiply of the sharded codec for Hopper (sm_90a), with a
// plain C interface loaded through ctypes (kernels/_build.py builds it;
// parallel/ntt_dist.py _mul_table and _scale launch it on a CUDA tensor):
//
//   out[m, l] = x[m, l] * t[m * table_stride] mod p
//
// over x [rows, lanes] u32 (the caller's leading axes flattened into the
// rows), t a prepared table of a word a row (table_stride 1) or one
// constant for every row (table_stride 0). Prepared as gf.cuh states: GF32
// constants Montgomery-prepared, so mul_full<kGF32>(x, prep(c)) = x * c
// mod p (the Solinas REDC); GF16 constants plain, with the full Fermat
// multiply, since four-step, coset and scale tables can hold 0x10000.
//
// It replaces no TPU kernel: fastecc_tpu/parallel/ntt_dist.py computes
// these multiplies (the four-step twiddle, the coset table, the decode's
// l(w^j), x*d/dx and Forney tables, the 1/N scale) in jnp outside any
// Pallas kernel. The port's plain version, ntt.mul_prepared's int64 torch
// ops in row chunks, still runs on CPU tensors.
//
// What bounds it on the H100: bytes. A rank of the four-card encode
// multiplies [131072, 8192] words three times a call: 4 GiB in and 4 GiB
// out each, 2.56 ms at 3.35 TB/s, against ~4 multiplies' worth of integer
// work a 16-byte vector. The table (at most a few hundred KB) stays in L2.
//
// What this design does about it (K13's copy, microbench.cu, with the
// multiply in the middle):
//   * each thread moves one 16-byte vector of 4 lanes (uint4) where the
//     lanes divide by 4 and both pointers are 16-byte aligned, one word
//     otherwise, so every load is issued before its thread's store and
//     the grid sets the bytes in flight;
//   * a thread loads its row's table word once; the threads of a warp
//     share the row (or, below 32 vectors a row, neighbouring rows), so
//     the load is one broadcast from L1 or L2;
//   * rows on gridDim.x (a rank has up to 2^17 and more, above gridDim.y's
//     65,535), the lanes' vectors on gridDim.y and threadIdx.x, and a
//     block of 256 threads covers 256 / blockDim.x whole rows when a row
//     is short, so small lane counts still fill the block;
//   * element offsets are 64-bit (a rank's slab is 2^30 words);
//   * the loads and stores carry the streaming hint (ld/st .cs), as K13's:
//     gigabytes that nothing reads again before they leave L2.

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "gf.cuh"

namespace {

using fecc::kGF16;
using fecc::kGF32;
using fecc::mul_full;

constexpr int kThreads = 256;
constexpr unsigned kMaxGridY = 65535u;

template <int F>
__device__ __forceinline__ uint32_t mul(uint32_t a, uint32_t t) {
  return mul_full<F>(a, t);
}

template <int F>
__device__ __forceinline__ uint4 mul(uint4 a, uint32_t t) {
  return make_uint4(mul_full<F>(a.x, t), mul_full<F>(a.y, t),
                    mul_full<F>(a.z, t), mul_full<F>(a.w, t));
}

// W words a vector: 4 (uint4) or 1; a row holds `vecs` vectors. Thread
// (threadIdx.x, threadIdx.y) of block (bx, by) multiplies vector
// by * blockDim.x + threadIdx.x of row bx * blockDim.y + threadIdx.y.
template <int F, int W>
__global__ void __launch_bounds__(kThreads) mul_table_kernel(
    const uint32_t* __restrict__ x, uint32_t* __restrict__ out, int rows,
    int vecs, const uint32_t* __restrict__ table, int table_stride) {
  using T = typename std::conditional<W == 4, uint4, uint32_t>::type;
  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  const int v = blockIdx.y * blockDim.x + threadIdx.x;
  if (row >= rows || v >= vecs) return;
  const uint32_t t = __ldg(table + (size_t)row * table_stride);
  const size_t i = (size_t)row * vecs + v;
  __stcs(reinterpret_cast<T*>(out) + i,
         mul<F>(__ldcs(reinterpret_cast<const T*>(x) + i), t));
}

template <int F>
cudaError_t launch(const uint32_t* x, uint32_t* out, int rows, int lanes,
                   const uint32_t* table, int table_stride, cudaStream_t s) {
  const bool vec = lanes % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  const int vecs = vec ? lanes / 4 : lanes;
  unsigned tx = 1;
  while (tx < (unsigned)vecs && tx < (unsigned)kThreads) tx <<= 1;
  const dim3 block(tx, kThreads / tx);
  const dim3 grid((rows + block.y - 1) / block.y, (vecs + tx - 1) / tx);
  if (grid.y > kMaxGridY) return cudaErrorInvalidValue;
  if (vec)
    mul_table_kernel<F, 4><<<grid, block, 0, s>>>(x, out, rows, vecs, table,
                                                  table_stride);
  else
    mul_table_kernel<F, 1><<<grid, block, 0, s>>>(x, out, rows, vecs, table,
                                                  table_stride);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out = x * table mod p on x [rows, lanes] u32 (out of place; out may not
// overlap x); table: a prepared u32 word at table[m * table_stride] for
// row m (table_stride 0: one constant for every row).
int fecc_mul_table(int field, const void* x, void* out, int rows, int lanes,
                   const void* table, int table_stride, void* stream) {
  if (rows < 0 || lanes < 0 || table_stride < 0 ||
      (field != kGF32 && field != kGF16))
    return (int)cudaErrorInvalidValue;
  if (rows == 0 || lanes == 0) return 0;
  const auto* xi = (const uint32_t*)x;
  auto* o = (uint32_t*)out;
  const auto* t = (const uint32_t*)table;
  const auto s = (cudaStream_t)stream;
  return (int)(field == kGF32
                   ? launch<kGF32>(xi, o, rows, lanes, t, table_stride, s)
                   : launch<kGF16>(xi, o, rows, lanes, t, table_stride, s));
}

}  // extern "C"
