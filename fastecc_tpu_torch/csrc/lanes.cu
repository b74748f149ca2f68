// The one-pass encode pair for Hopper (sm_90a): kernels K11 and K12 of the
// port, with a plain C interface loaded through ctypes
// (fastecc_tpu_torch/kernels/_build.py builds it beside ntt_mfa.cu;
// kernels/ntt_mfa.py wraps it).
//
// Replaces these Pallas TPU kernels of fastecc_tpu/kernels/ntt_mfa.py:
//   K11 fecc_pair_lanes        <- _pair_lanes_kernel (ntt_pair_lanes_pallas):
//       the RS-encode pair NTT_g-coset(iNTT(x)) over [k, L] u32 with whole
//       k-point columns resident: unscaled inverse stages, x g^m k^-1 (the
//       prepared mid table), forward stages
//   K12 fecc_pair_lanes_wire16 <- _pair_lanes_wire16_kernel: K11 on
//       lo = x & 0xFFFF and hi = x >> 16 of [k, Wu] u32 pairs of LE u16 wire
//       words, then K10's epilogue: stored = lo16 | hi16 << 16 (0x10000
//       stored as 0) and the escape bitmap [k, Wu / 8]
// They compute what the Pallas kernels compute: natural order in and out,
// canonical residues, so the bits equal the three-pass pair's (K1 -> K2 ->
// K3, K8 -> K9 -> K10). The reference's stage checkpointing and its
// radix-2 tail below a = 32 were Mosaic workarounds, not ported; the
// stages are stages.cuh's (radix 4, one leading radix-2 stage when log2 k
// is odd), which give the same canonical bits.
//
// Each block owns the [k, TL] column of TL lanes in shared memory for the
// whole pair, so the pair moves each element through device memory once
// in and once out, where the three-pass route moves it three times. What
// bounds it on the H100: at the GF32 batch encode ([2^10, 65536], 512 MiB
// in and out) 0.160 ms of bytes against 0.088 ms of multiplies; at the GF16
// wire shape ([2^13, 16384] pairs, 512 MiB in, 512 MiB stored, 64 MiB of
// bitmap) 0.341 ms of bytes against 0.225 ms. The stage loop sets its pace
// in practice: one round of a shared-memory stage costs ~0.42 ms per 2^29
// elements on its own (K15), and the pair runs two k-point transforms.
//
// Shared memory sets the tile: TL = 8192 / k lanes, clamped to [2, 32].
// K11 ping-pongs two [k, TL] buffers, K12 parks lo's result in a third
// while hi runs (as K10 does). At k = 2^13, TL = 2: 128 KB (K11) and
// 192 KB (K12) of the 227 KB a block may hold, one block per SM; at k <=
// 2^12 two or three blocks share an SM. A simple first version: no TMA,
// cp.async ring or registers carried across stages yet (later work).
// Ragged lane edges are masked (K12 takes Wu % 8 == 0).
//
// K12's bitmap at TL < 8: a bitmap word covers 8 lanes (bit 2t lo, bit
// 2t + 1 hi of lane 8g + t), so 8 / TL blocks share one word. The entry
// zeroes the bitmap on the stream and every block ORs its nonzero bits in
// with atomicOr; the blocks' bits are disjoint, so the words equal K10's.
// Escapes are rare (a value is 0x10000 about once in 2^16), so the
// atomics are few.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "gf.cuh"
#include "stages.cuh"

namespace {

using fecc::mul_full;

constexpr int kThreads = 512;
constexpr int kTileWords = 8192;  // k * TL words per buffer, TL >= 2
constexpr int kMinLaneTile = 2;
constexpr int kMaxLaneTile = 32;
constexpr int kMaxK = 1 << 13;

struct LanesArgs {
  const uint32_t* x;     // [k, L] input (K12: u32 pairs of LE u16 words)
  uint32_t* out;         // [k, L] output (K12: the stored words)
  uint32_t* bitmap;      // [k, L / 8] escape words (K12)
  int k, log_k;          // transform length along axis 0
  int L;                 // lanes (axis 1)
  int log_tl;            // lane tile TL = 2^log_tl
  const uint32_t* tw_i;  // packed stage tables, inverse transform
  const uint32_t* w3_i;  // packed radix-4 w^3j tables, inverse transform
  const uint32_t* tw_f;  // forward transform
  const uint32_t* w3_f;
  const uint32_t* mid;   // [k] prepared g^m * k^-1
};

// The pair on the [k, TL] tile in `src`: inverse stages (unscaled), x
// mid[m], forward stages. Returns the buffer that holds the result (`src`
// or `dst`). Callers synchronise before; run_stages ends synchronised.
template <int F>
__device__ uint32_t* pair_stages(uint32_t* src, uint32_t* dst,
                                 const LanesArgs& p) {
  uint32_t* y = run_stages<F>(src, dst, p.k, p.log_k, p.log_tl, p.tw_i,
                              p.w3_i);
  const int tile = p.k << p.log_tl;
  for (int e = threadIdx.x; e < tile; e += blockDim.x)
    y[e] = mul_full<F>(y[e], p.mid[e >> p.log_tl]);
  __syncthreads();
  return run_stages<F>(y, y == src ? dst : src, p.k, p.log_k, p.log_tl,
                       p.tw_f, p.w3_f);
}

// K11: lanes [l0, l0 + TL) of x, the pair, natural-order write.
template <int F>
__global__ void __launch_bounds__(kThreads) pair_lanes_kernel(LanesArgs p) {
  extern __shared__ uint32_t smem[];
  const int tile = p.k << p.log_tl;
  const int tl_mask = (1 << p.log_tl) - 1;
  const int l0 = blockIdx.x << p.log_tl;
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    int l = e & tl_mask, a = e >> p.log_tl;
    smem[e] = l0 + l < p.L ? p.x[(size_t)a * p.L + l0 + l] : 0u;
  }
  __syncthreads();
  const uint32_t* y = pair_stages<F>(smem, smem + tile, p);
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    int l = e & tl_mask, a = e >> p.log_tl;
    if (l0 + l < p.L) p.out[(size_t)a * p.L + l0 + l] = y[e];
  }
}

// K12: the pair on lo and on hi of lanes [l0, l0 + TL), then the stored
// words and the escape bits (GF16 values are <= 0x10000, so v >> 16 is the
// escape flag).
__global__ void __launch_bounds__(kThreads) pair_lanes_wire16_kernel(
    LanesArgs p) {
  constexpr int F = fecc::kGF16;
  extern __shared__ uint32_t smem[];
  const int tile = p.k << p.log_tl;
  const int tl_mask = (1 << p.log_tl) - 1;
  const int l0 = blockIdx.x << p.log_tl;
  uint32_t* buf0 = smem;
  uint32_t* buf1 = smem + tile;
  uint32_t* buf2 = smem + 2 * tile;
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    int l = e & tl_mask, a = e >> p.log_tl;
    uint32_t v = l0 + l < p.L ? p.x[(size_t)a * p.L + l0 + l] : 0u;
    buf0[e] = v & 0xFFFFu;
    buf2[e] = v >> 16;
  }
  __syncthreads();
  const uint32_t* lo = pair_stages<F>(buf0, buf1, p);
  const uint32_t* hi = pair_stages<F>(buf2, lo == buf0 ? buf1 : buf0, p);
  // a u32 shift drops hi's bit 16, so 0x10000 is stored as 0 in either half
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    int l = e & tl_mask, a = e >> p.log_tl;
    if (l0 + l < p.L)
      p.out[(size_t)a * p.L + l0 + l] = (lo[e] & 0xFFFFu) | (hi[e] << 16);
  }
  // one piece of a bitmap word per (row, group of gl = min(TL, 8) tile
  // lanes); L % 8 == 0, so a piece is wholly inside or past the edge
  const int log_gl = p.log_tl < 3 ? p.log_tl : 3;
  const int log_groups = p.log_tl - log_gl;
  const int gl = 1 << log_gl;
  const int words = p.L >> 3;
  for (int e = threadIdx.x; e < (p.k << log_groups); e += blockDim.x) {
    int g = e & ((1 << log_groups) - 1), a = e >> log_groups;
    int lane = l0 + (g << log_gl);
    if (lane >= p.L) continue;
    int e0 = (a << p.log_tl) + (g << log_gl);
    uint32_t bits = 0;
    for (int q = 0; q < gl; ++q) {
      int t = (lane + q) & 7;
      bits |= (lo[e0 + q] >> 16) << (2 * t) | (hi[e0 + q] >> 16) << (2 * t + 1);
    }
    if (bits) atomicOr(&p.bitmap[(size_t)a * words + (lane >> 3)], bits);
  }
}

int log2_exact(int v) {
  int t = 0;
  while ((1 << t) < v) ++t;
  return (1 << t) == v ? t : -1;
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int bufs, LanesArgs p, cudaStream_t s) {
  int tl = kTileWords / p.k;
  if (tl < kMinLaneTile) tl = kMinLaneTile;
  if (tl > kMaxLaneTile) tl = kMaxLaneTile;
  p.log_tl = log2_exact(tl);
  size_t smem = (size_t)bufs * ((size_t)p.k << p.log_tl) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  unsigned blocks = (unsigned)((p.L + tl - 1) / tl);
  kernel<<<blocks, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

// Shared argument checks and table pointers of both entries.
bool lanes_args(LanesArgs& p, const void* x, void* out, int k, int L,
                const void* tw_i, const void* w3_i, const void* tw_f,
                const void* w3_f, const void* mid) {
  p = LanesArgs{};
  p.x = (const uint32_t*)x;
  p.out = (uint32_t*)out;
  p.k = k;
  p.log_k = log2_exact(k);
  p.L = L;
  p.tw_i = (const uint32_t*)tw_i;
  p.w3_i = (const uint32_t*)w3_i;
  p.tw_f = (const uint32_t*)tw_f;
  p.w3_f = (const uint32_t*)w3_f;
  p.mid = (const uint32_t*)mid;
  return p.log_k >= 1 && k <= kMaxK && L >= 1;
}

}  // namespace

extern "C" {

// K11: [k, L] -> [k, L]; NTT(mid * iNTT_unscaled(x)) along axis 0.
int fecc_pair_lanes(int field, const void* x, void* out, int k, int L,
                    const void* tw_i, const void* w3_i, const void* tw_f,
                    const void* w3_f, const void* mid, void* stream) {
  LanesArgs p;
  if (!lanes_args(p, x, out, k, L, tw_i, w3_i, tw_f, w3_f, mid))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = field == fecc::kGF32
                      ? launch(pair_lanes_kernel<fecc::kGF32>, 2, p, s)
                      : launch(pair_lanes_kernel<fecc::kGF16>, 2, p, s);
  return (int)e;
}

// K12: [k, L] u32 pairs -> stored [k, L] and bitmap [k, L / 8]; GF16 only,
// L % 8 == 0.
int fecc_pair_lanes_wire16(int field, const void* x, void* stored,
                           void* bitmap, int k, int L, const void* tw_i,
                           const void* w3_i, const void* tw_f,
                           const void* w3_f, const void* mid, void* stream) {
  LanesArgs p;
  if (field != fecc::kGF16 || L % 8 != 0 ||
      !lanes_args(p, x, stored, k, L, tw_i, w3_i, tw_f, w3_f, mid))
    return (int)cudaErrorInvalidValue;
  p.bitmap = (uint32_t*)bitmap;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(
      bitmap, 0, (size_t)k * (size_t)(L / 8) * sizeof(uint32_t), s);
  if (e != cudaSuccess) return (int)e;
  return (int)launch(pair_lanes_wire16_kernel, 3, p, s);
}

}  // extern "C"
