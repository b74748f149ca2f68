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
// GF32 addmod, the Solinas REDC (only a * b multiplies; what the passes
// call) and the generic REDC (four multiplies, gf.cuh mul_generic), their
// mask-select forms, the GF16 multiplies, and five composites that
// permute rows inside a 512-row tile (the reference's _TS): one Stockham
// interleave plus an add, and radix-2 / radix-4 stages in either field
// with the passes' own add, sub and mul_tw. The "*-bcast" variants and the
// stage composites take z[row, 0] of the [rows, 128] array, the
// reference's z[:, :1] of a 128-lane tile. A composite block holds a
// [512, 8] tile in two shared buffers (32 KB). The raw add and multiply
// are inline PTX, which the compiler cannot fold: a plain loop of y += z
// becomes y + depth * z.
// The raw add also adds a zero that only the launch knows: ptxas fuses two
// dependent two-input adds into one three-input IADD3, and y + z + 0 keeps
// one IADD3 per step. The Solinas steps (gf.cuh mul_solinas, its product
// in C, and its masksel form) are one asm block each: REDC with the
// negated Montgomery factor, whose one carry rides the flag from an LEA
// into an IADD3.X, ~8 SASS instructions a step against the generic
// REDC's 10.2 (`sass_check.py --ops` counts them by pipe).
//
// K15 is `depth` c-point transforms on the register-stage engine of the
// passes (regstages.cuh: K1-K6 and K7-sel run on it), so it measures the
// rate of their own stages: after one load of a [c, TL] lane tile and the
// [A2, A1] inner-twiddle table (cp.async, one wait) each transform is the
// A1-point DIF in registers, the inner twiddles, one exchange through
// shared memory and the A2-point DIFs, and the next transform takes the
// registers where this one left them (col.cu's seam hand-off): no store
// between transforms, one at the end, straight from registers in natural
// order. The length is a template parameter, c = 2 .. 2048 in both fields
// (11 splits; RegSplit<11> is A1 = 64, A2 = 32, TL = 8, 256 threads, a
// 16,640-word exchange and a 2,080-word table, ~73 KB); the entry refuses
// any other length. Handing the registers over through shared memory in
// natural order instead (two more barriers a transform) ran 16% slower at
// c = 2048 (option sweep). What bounds it: at the row's [2048, 512,
// 128], depth 2, it moves 1 GiB (0.32 ms at 3.35 TB/s) but issues ~89
// SASS instructions an element a transform, ~60 of them on the ALU pipe:
// 2^28 element-transforms x 60 at 1.67e13 a second is ~0.97 ms, so the
// integer pipes bound it, as they bound the passes.

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "gf.cuh"
#include "regstages.cuh"

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
    return fecc::mul_generic(y, z);
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
// K15: chained transforms on the register-stage engine.
// ---------------------------------------------------------------------------

constexpr int kFusedMaxLog = 11;  // c = 2048, above the passes' 1024

// Block = lane tile [l0, l0 + TL) of x viewed [c, L]; thread = (t = n2,
// lane l). The tile and the [A2, A1] inner table are copied in with
// cp.async before one wait. The registers hold the column in the order a
// transform leaves it: r[j A2 + bitrev(k2)] = element t + A2 j + A1 k2,
// which is element n1 A2 + t of step 1 for n1 = j + (A1 / A2) k2 (col.cu's
// seam hand-off). So the tile is read into that order, each transform
// renames its registers into step 1's order (A1 moves at run time) and
// runs on them, and the store writes them back to the same rows: depth 0
// is a copy.
template <int F, int LA>
__device__ __forceinline__ void fused_chain(const uint32_t* __restrict__ x,
                                            uint32_t* __restrict__ out,
                                            int L, int vec,
                                            const uint32_t* __restrict__ tw,
                                            int depth) {
  using S = fecc::RegSplit<LA>;
  constexpr int kRho = S::A1 / S::A2;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* tile = smem;
  uint32_t* tws = smem + S::kExchWords;
  const int l0 = blockIdx.x * S::TL;
  fecc::load_tile_async<S>(tile, x, 1, L, 0, l0, vec != 0);
  fecc::load_twiddles_async<S>(tws, tw);
  fecc::cp_async_wait_all();
  __syncthreads();

  const int l = threadIdx.x % S::TL, t = threadIdx.x / S::TL;
  uint32_t r[S::A1];
  fecc::static_for<S::A1>([&](auto nc) {
    constexpr int n1 = decltype(nc)::value;
    r[n1 % kRho * S::A2 + fecc::bitrev(n1 / kRho, S::LA2)] =
        tile[(n1 * S::A2 + t) * S::TL + l];
  });
  for (int d = 0; d < depth; ++d) {
    uint32_t y[S::A1];
    fecc::static_for<S::A1>([&](auto nc) {
      constexpr int n1 = decltype(nc)::value;
      y[n1] = r[n1 % kRho * S::A2 + fecc::bitrev(n1 / kRho, S::LA2)];
    });
    fecc::reg_transform_regs<F, false, S>(y, tile, tws, t, l);
    fecc::static_for<S::A1>([&](auto i) {
      r[decltype(i)::value] = y[decltype(i)::value];
    });
  }
  if (l0 + l >= L) return;
  // natural order: out[t + A2 j + A1 k2, l0 + l] of [c, L]
  uint32_t* o = out + l0 + l;
  fecc::static_for<S::A1 / S::A2>([&](auto jc) {
    constexpr int j = decltype(jc)::value;
    fecc::static_for<S::A2>([&](auto k2c) {
      constexpr int k2 = decltype(k2c)::value;
      o[(size_t)(t + S::A2 * j + S::A1 * k2) * L] =
          r[j * S::A2 + fecc::bitrev(k2, S::LA2)];
    });
  });
}

template <int F, int LA>
__global__ void __launch_bounds__(fecc::RegSplit<LA>::kThreads)
    fused_chain_kernel(const uint32_t* __restrict__ x,
                       uint32_t* __restrict__ out, int L, int vec,
                       const uint32_t* __restrict__ tw, int depth) {
  fused_chain<F, LA>(x, out, L, vec, tw, depth);
}

// From c = 512 on (kFusedBoundLog) K15 is held to two blocks an SM.
// Unasked, ptxas gives it 76-78 registers at 512 and 1024 (one block of
// 512 threads an SM) and 122-127 at 2048; held, it takes 64 and 128 with
// 8-48 bytes of spills, and runs 11-13% faster at c = 512 and 2048, but
// 3-6% slower at c = 256 (option sweep, PERF.md section 6).
constexpr int kFusedBoundLog = 9;

template <int F, int LA>
__global__ void __launch_bounds__(fecc::RegSplit<LA>::kThreads, 2)
    fused_chain_kernel_lb2(const uint32_t* __restrict__ x,
                           uint32_t* __restrict__ out, int L, int vec,
                           const uint32_t* __restrict__ tw, int depth) {
  fused_chain<F, LA>(x, out, L, vec, tw, depth);
}

template <int F, int LA>
cudaError_t launch_fused(const uint32_t* x, uint32_t* out, int L,
                         const uint32_t* tw, int depth, cudaStream_t stream) {
  using S = fecc::RegSplit<LA>;
  const size_t smem = (size_t)S::kSmemWords * sizeof(uint32_t);
  void (*kernel)(const uint32_t*, uint32_t*, int, int, const uint32_t*, int);
  if constexpr (LA >= kFusedBoundLog)
    kernel = fused_chain_kernel_lb2<F, LA>;
  else
    kernel = fused_chain_kernel<F, LA>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int vec = ((uintptr_t)x % 16 == 0) && (L % 4 == 0);
  const unsigned blocks = (unsigned)((L + S::TL - 1) / S::TL);
  kernel<<<blocks, S::kThreads, smem, stream>>>(x, out, L, vec, tw, depth);
  return cudaGetLastError();
}

template <int LA>
cudaError_t dispatch_fused(int la, int field, const uint32_t* x,
                           uint32_t* out, int L, const uint32_t* tw,
                           int depth, cudaStream_t s) {
  if constexpr (LA > kFusedMaxLog) {
    return cudaErrorInvalidValue;
  } else {
    if (la != LA)
      return dispatch_fused<LA + 1>(la, field, x, out, L, tw, depth, s);
    return field == kGF32
               ? launch_fused<kGF32, LA>(x, out, L, tw, depth, s)
               : launch_fused<kGF16, LA>(x, out, L, tw, depth, s);
  }
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

// K15: `depth` forward c-point transforms along axis 0 of x [c, L] u32, c
// = 2 .. 2048 (tw: the [A2, A1] inner twiddles of kernels/ntt_mfa.py
// _row_inner_twiddles, forward, length c).
int fecc_fused_chain(int field, const void* x, void* out, int c, int L,
                     const void* tw, int depth, void* stream) {
  const int log_a = log2_exact(c);
  if (log_a < 1 || log_a > kFusedMaxLog || L < 1 || depth < 0)
    return (int)cudaErrorInvalidValue;
  return (int)dispatch_fused<1>(log_a, field, (const uint32_t*)x,
                                (uint32_t*)out, L, (const uint32_t*)tw,
                                depth, (cudaStream_t)stream);
}

}  // extern "C"
