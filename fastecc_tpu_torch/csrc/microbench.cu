// Microbenchmark kernels for Hopper (sm_90a): K13-K15 of the port, with a
// plain C interface loaded through ctypes (kernels/_build.py builds it;
// kernels/microbench.py wraps it and turns their times into the card's
// own peaks for utils/profiling.py).
//
// Replaces these Pallas TPU kernels of fastecc_tpu/kernels/microbench.py:
//   K13 fecc_copy        <- _copy_kernel        (tiled copy)
//   K14 fecc_chain       <- _chain_kernel       (`depth` dependent
//                           applications of one _VARIANTS step to every
//                           element of x, second operand z)
//   K15 fecc_fused_chain <- _fused_chain_kernel (`depth` chained c-point
//                           forward NTTs on a tile held on chip)
// Each gives the reference's bits; how it gets there is the port's own.
//
// K13 is bound by device memory: it reads and writes every word once.
// The grid covers the whole array and each thread moves one element: a
// 16-byte vector of 4 words when both pointers are 16-byte aligned (block
// 0 then copies the last n % 4 words), a single word otherwise. So every
// load is issued before its thread's store, and the bytes in flight are
// set by the grid (4 KB a block of 256 threads), not by how far the
// compiler unrolls a grid-stride loop. The loads and stores carry the
// streaming hint (ld/st .cs: evict first), so 2 GiB of traffic that
// nothing reads again does not churn L2. Two or four vectors a thread,
// other block sizes, other hints and a TMA bulk copy through shared
// memory were each measured and lost to this (PERF.md, section 6).
//
// K14 is bound by the integer pipes: `depth` dependent steps per element
// against one read and one write. A single dependent chain per thread
// would measure the steps' latency, so each thread carries kIlp = 4
// independent elements, and 16 M elements (the 64 MiB default) keep every
// SM full. The steps are the reference's: raw u32 multiply and add,
// GF32 addmod, the Solinas REDC (two multiplies) and the generic REDC
// (four, what the passes call), their mask-select forms, the GF16
// multiplies, and five composites that permute rows inside a 512-row tile
// (the reference's _TS): one Stockham interleave plus an add, and
// radix-2 / radix-4 stages in either field with the passes' own add, sub
// and mul_tw. The "*-bcast" variants and the stage composites take
// z[row, 0] of the [rows, 128] array, the reference's z[:, :1] of a
// 128-lane tile. A composite block holds a [512, 8] tile in two shared
// buffers (32 KB). The raw add and multiply are inline PTX, which the
// compiler cannot fold: a plain loop of y += z becomes y + depth * z.
// The raw add also adds a zero that only the launch knows: ptxas fuses two
// dependent two-input adds into one three-input IADD3, and y + z + 0 keeps
// one IADD3 per step.
//
// K15 is the passes' stage loop (stages.cuh run_stages) applied `depth`
// times to a [c, TL] tile in shared memory: after one load it is bound by
// the stage rounds, which is what it measures. c reaches 2048, above the
// passes' longest transform (1024), so it has its own limits; TL = 8192 / c
// lanes (4 at c = 2048) keeps both buffers at 32 KB, as in the passes.

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "gf.cuh"
#include "stages.cuh"

namespace {

using fecc::kGF16;
using fecc::kGF32;

constexpr int kThreads = 256;

// ---------------------------------------------------------------------------
// K13: copy.
// ---------------------------------------------------------------------------

// W words an element: 4 (uint4) or 1. Thread i of the grid moves element
// i; block 0 also copies the last n % W words.
template <int W>
__global__ void __launch_bounds__(kThreads) copy_kernel(
    const uint32_t* __restrict__ x, uint32_t* __restrict__ out, size_t n) {
  using T = typename std::conditional<W == 4, uint4, uint32_t>::type;
  const size_t ne = n / W;
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (i < ne)
    __stcs(reinterpret_cast<T*>(out) + i,
           __ldcs(reinterpret_cast<const T*>(x) + i));
  if (W > 1 && blockIdx.x == 0 && threadIdx.x < n % W)
    out[ne * W + threadIdx.x] = x[ne * W + threadIdx.x];
}

// ---------------------------------------------------------------------------
// K14: dependent chains. The order is fastecc_tpu/kernels/microbench.py's
// _VARIANTS; the wrapper passes the index.
// ---------------------------------------------------------------------------

enum Variant : int {
  kRawMul, kRawAdd, kAddmod, kAddmodMasksel, kSolinas, kSolinasBcast,
  kSolinasMasksel, kGeneric, kGf16, kGf16Bcast, kGf16Tw, kInterleave,
  kStageR2, kStageR4, kStageR2Gf16, kStageR4Gf16, kNumVariants
};

constexpr int kLanes = 128;       // the arrays are [rows, 128] u32
constexpr int kIlp = 4;           // independent elements per thread
constexpr int kChainUnroll = 8;   // depth-loop unroll of the elementwise
constexpr int kTileRows = 512;    // composites permute inside 512 rows
constexpr int kTileLanes = 8;     // lanes of a composite block's tile
constexpr int kTileElems = kTileRows * kTileLanes;
constexpr int kPerThread = kTileElems / kThreads;

__host__ __device__ constexpr bool is_composite(int v) {
  return v >= kInterleave;
}

__host__ __device__ constexpr bool is_bcast(int v) {
  return v == kSolinasBcast || v == kGf16Bcast || v == kGf16Tw ||
         v >= kStageR2;
}

struct ChainArgs {
  const uint32_t* x;
  const uint32_t* z;
  uint32_t* out;
  size_t n;      // rows * 128
  int depth;
  uint32_t zero; // 0, opaque to the compiler (the raw add's third input)
};

template <int V>
__device__ __forceinline__ uint32_t step(uint32_t y, uint32_t z,
                                         uint32_t zero) {
  if constexpr (V == kRawMul) {
    asm volatile("mul.lo.u32 %0, %0, %1;" : "+r"(y) : "r"(z));
    return y;
  } else if constexpr (V == kRawAdd) {
    asm volatile("add.u32 %0, %0, %1;\n\tadd.u32 %0, %0, %2;"
                 : "+r"(y) : "r"(z), "r"(zero));
    return y;
  } else if constexpr (V == kAddmod) {
    return fecc::add<kGF32>(y, z);
  } else if constexpr (V == kAddmodMasksel) {
    return fecc::add_masksel(y, z);
  } else if constexpr (V == kSolinas || V == kSolinasBcast) {
    return fecc::mul_solinas(y, z);
  } else if constexpr (V == kSolinasMasksel) {
    return fecc::mul_solinas_masksel(y, z);
  } else if constexpr (V == kGeneric) {
    return fecc::mul_full<kGF32>(y, z);
  } else if constexpr (V == kGf16 || V == kGf16Bcast) {
    return fecc::mul_full<kGF16>(y, z);
  } else {
    static_assert(V == kGf16Tw, "not an elementwise variant");
    return fecc::mul_tw<kGF16>(y, z);
  }
}

// Elementwise variants: element e = (block * kIlp + k) * 256 + thread, so
// each of a thread's kIlp loads is coalesced across the warp.
template <int V>
__global__ void __launch_bounds__(kThreads) chain_kernel(ChainArgs a) {
  uint32_t y[kIlp], w[kIlp];
  const size_t base = (size_t)blockIdx.x * kIlp * blockDim.x + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kIlp; ++k) {
    const size_t e = base + (size_t)k * blockDim.x;
    const size_t ze = is_bcast(V) ? e & ~(size_t)(kLanes - 1) : e;
    y[k] = e < a.n ? a.x[e] : 0u;
    w[k] = e < a.n ? a.z[ze] : 0u;
  }
  // unrolled 8 times: the loop control is 3 instructions per 32 steps,
  // and `sass_check.py --ops` divides the loop body by kChainUnroll *
  // kIlp to count a step's instructions
#pragma unroll kChainUnroll
  for (int d = 0; d < a.depth; ++d) {
#pragma unroll
    for (int k = 0; k < kIlp; ++k) y[k] = step<V>(y[k], w[k], a.zero);
  }
#pragma unroll
  for (int k = 0; k < kIlp; ++k) {
    const size_t e = base + (size_t)k * blockDim.x;
    if (e < a.n) a.out[e] = y[k];
  }
}

// Composite variants: block = (512-row tile, 8-lane tile); tile element
// e = r * 8 + l. Row r of the reference's [512, 128] block is row r here.
template <int V>
__global__ void __launch_bounds__(kThreads) chain_tile_kernel(ChainArgs a) {
  constexpr int F = (V == kStageR2Gf16 || V == kStageR4Gf16) ? kGF16 : kGF32;
  __shared__ uint32_t buf[2][kTileElems];
  __shared__ uint32_t zcol[kTileRows];   // z[row, 0] (the stage variants)
  constexpr int lane_tiles = kLanes / kTileLanes;
  const size_t row0 = (size_t)(blockIdx.x / lane_tiles) * kTileRows;
  const int l0 = (blockIdx.x % lane_tiles) * kTileLanes;
  uint32_t zr[kPerThread];               // z at this thread's outputs
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int e = threadIdx.x + j * kThreads;
    const size_t g = (row0 + e / kTileLanes) * kLanes + l0 + e % kTileLanes;
    buf[0][e] = a.x[g];
    if constexpr (V == kInterleave) zr[j] = a.z[g];
  }
  if constexpr (V != kInterleave) {
    for (int r = threadIdx.x; r < kTileRows; r += kThreads)
      zcol[r] = a.z[(row0 + r) * kLanes];
  }
  __syncthreads();
  int cur = 0;
  for (int d = 0; d < a.depth; ++d) {
    const uint32_t* src = buf[cur];
    uint32_t* dst = buf[cur ^ 1];
    if constexpr (V == kInterleave) {
      // out[2i] = y[i], out[2i + 1] = y[256 + i], then + z
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const int e = threadIdx.x + j * kThreads;
        const int r = e / kTileLanes, l = e % kTileLanes;
        const int sr = (r >> 1) + (r & 1) * (kTileRows / 2);
        dst[e] = src[sr * kTileLanes + l] + zr[j];
      }
    } else if constexpr (V == kStageR2 || V == kStageR2Gf16) {
      constexpr int h = kTileRows / 2;
      for (int e = threadIdx.x; e < h * kTileLanes; e += kThreads) {
        const int i = e / kTileLanes, l = e % kTileLanes;
        const uint32_t u = src[e], v = src[e + h * kTileLanes];
        dst[(2 * i) * kTileLanes + l] = fecc::add<F>(u, v);
        dst[(2 * i + 1) * kTileLanes + l] =
            fecc::mul_tw<F>(fecc::sub<F>(u, v), zcol[i]);
      }
    } else {
      static_assert(V == kStageR4 || V == kStageR4Gf16, "composite");
      constexpr int q = kTileRows / 4;
      constexpr int qe = q * kTileLanes;
      for (int e = threadIdx.x; e < qe; e += kThreads) {
        const int i = e / kTileLanes, l = e % kTileLanes;
        const uint32_t x0 = src[e], x1 = src[e + qe];
        const uint32_t x2 = src[e + 2 * qe], x3 = src[e + 3 * qe];
        const uint32_t w = zcol[i];
        const uint32_t s0 = fecc::add<F>(x0, x2), s1 = fecc::add<F>(x1, x3);
        const uint32_t d0 = fecc::sub<F>(x0, x2);
        const uint32_t d1 = fecc::mul_tw<F>(fecc::sub<F>(x1, x3), w);
        const int o = (4 * i) * kTileLanes + l;
        dst[o] = fecc::add<F>(s0, s1);
        dst[o + kTileLanes] = fecc::mul_tw<F>(fecc::add<F>(d0, d1), w);
        dst[o + 2 * kTileLanes] = fecc::mul_tw<F>(fecc::sub<F>(s0, s1), w);
        dst[o + 3 * kTileLanes] = fecc::mul_tw<F>(fecc::sub<F>(d0, d1), w);
      }
    }
    __syncthreads();
    cur ^= 1;
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int e = threadIdx.x + j * kThreads;
    a.out[(row0 + e / kTileLanes) * kLanes + l0 + e % kTileLanes] =
        buf[cur][e];
  }
}

template <int V>
cudaError_t launch_chain(const ChainArgs& a, cudaStream_t stream) {
  if constexpr (is_composite(V)) {
    unsigned blocks = (unsigned)(a.n / kTileElems);
    chain_tile_kernel<V><<<blocks, kThreads, 0, stream>>>(a);
  } else {
    size_t per_block = (size_t)kIlp * kThreads;
    unsigned blocks = (unsigned)((a.n + per_block - 1) / per_block);
    chain_kernel<V><<<blocks, kThreads, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

template <int V>
cudaError_t dispatch_chain(int v, const ChainArgs& a, cudaStream_t stream) {
  if constexpr (V == kNumVariants) {
    return cudaErrorInvalidValue;
  } else {
    return v == V ? launch_chain<V>(a, stream)
                  : dispatch_chain<V + 1>(v, a, stream);
  }
}

// ---------------------------------------------------------------------------
// K15: chained transforms on the passes' stage loop.
// ---------------------------------------------------------------------------

constexpr int kFusedTileWords = 8192;  // c * TL words per buffer (32 KB)
constexpr int kFusedMaxLaneTile = 32;
constexpr int kFusedMaxLen = 2048;

// Block b holds columns [b * TL, (b + 1) * TL) of x viewed [c, L].
template <int F>
__global__ void __launch_bounds__(kThreads) fused_chain_kernel(
    const uint32_t* __restrict__ x, uint32_t* __restrict__ out, int A,
    int log_a, int L, int log_tl, const uint32_t* __restrict__ tw,
    const uint32_t* __restrict__ w3, int depth) {
  extern __shared__ uint32_t smem[];
  const int tile = A << log_tl;
  const int tl_mask = (1 << log_tl) - 1;
  const int l0 = blockIdx.x << log_tl;
  uint32_t* buf0 = smem;
  uint32_t* buf1 = smem + tile;
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    int l = e & tl_mask, a = e >> log_tl;
    buf0[e] = l0 + l < L ? x[(size_t)a * L + l0 + l] : 0u;
  }
  __syncthreads();
  uint32_t* y = buf0;
  for (int d = 0; d < depth; ++d)
    y = run_stages<F>(y, y == buf0 ? buf1 : buf0, A, log_a, log_tl, tw, w3);
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    int l = e & tl_mask, a = e >> log_tl;
    if (l0 + l < L) out[(size_t)a * L + l0 + l] = y[e];
  }
}

template <int F>
cudaError_t launch_fused(const uint32_t* x, uint32_t* out, int A, int log_a,
                         int L, int log_tl, const uint32_t* tw,
                         const uint32_t* w3, int depth, cudaStream_t stream) {
  size_t smem = 2 * ((size_t)A << log_tl) * sizeof(uint32_t);
  auto kernel = fused_chain_kernel<F>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  unsigned blocks = (unsigned)((L + (1 << log_tl) - 1) >> log_tl);
  kernel<<<blocks, kThreads, smem, stream>>>(x, out, A, log_a, L, log_tl, tw,
                                             w3, depth);
  return cudaGetLastError();
}

int log2_exact(long long v) {
  int t = 0;
  while ((1LL << t) < v) ++t;
  return (1LL << t) == v ? t : -1;
}

}  // namespace

extern "C" {

// K13: out[i] = x[i] for i < n (u32 words).
int fecc_copy(const void* x, void* out, long long n, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const bool vec = ((uintptr_t)x % 16 == 0) && ((uintptr_t)out % 16 == 0);
  const size_t ne = vec ? (size_t)n / 4 : (size_t)n;
  // at least one block: block 0 copies the tail when n < 4
  const unsigned blocks =
      (unsigned)((ne + kThreads - 1) / kThreads + (ne == 0 ? 1 : 0));
  cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    copy_kernel<4><<<blocks, kThreads, 0, s>>>((const uint32_t*)x,
                                              (uint32_t*)out, (size_t)n);
  else
    copy_kernel<1><<<blocks, kThreads, 0, s>>>((const uint32_t*)x,
                                              (uint32_t*)out, (size_t)n);
  return (int)cudaGetLastError();
}

// K14: out = step^depth(x, z) on [rows, 128] u32, rows % 512 == 0;
// `variant` indexes the reference's _VARIANTS.
int fecc_chain(int variant, const void* x, const void* z, void* out,
               int rows, int depth, void* stream) {
  if (rows < 1 || rows % kTileRows != 0 || depth < 0)
    return (int)cudaErrorInvalidValue;
  ChainArgs a{(const uint32_t*)x, (const uint32_t*)z, (uint32_t*)out,
              (size_t)rows * kLanes, depth, 0u};
  return (int)dispatch_chain<0>(variant, a, (cudaStream_t)stream);
}

// K15: `depth` forward c-point transforms along axis 0 of x [c, L] u32
// (tw, w3: the packed forward stage tables of length c).
int fecc_fused_chain(int field, const void* x, void* out, int c, int L,
                     const void* tw, const void* w3, int depth,
                     void* stream) {
  const int log_a = log2_exact(c);
  if (log_a < 1 || c > kFusedMaxLen || L < 1 || depth < 0)
    return (int)cudaErrorInvalidValue;
  int tl = kFusedTileWords / c;
  if (tl > kFusedMaxLaneTile) tl = kFusedMaxLaneTile;
  const int log_tl = log2_exact(tl);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e =
      field == fecc::kGF32
          ? launch_fused<kGF32>((const uint32_t*)x, (uint32_t*)out, c, log_a,
                                L, log_tl, (const uint32_t*)tw,
                                (const uint32_t*)w3, depth, s)
          : launch_fused<kGF16>((const uint32_t*)x, (uint32_t*)out, c, log_a,
                                L, log_tl, (const uint32_t*)tw,
                                (const uint32_t*)w3, depth, s);
  return (int)e;
}

}  // extern "C"
