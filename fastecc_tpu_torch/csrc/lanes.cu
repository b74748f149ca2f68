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
// radix-2 tail below a = 32 were Mosaic workarounds, not ported; any
// correct schedule gives the same canonical bits.
//
// K11: each block owns the [k, TL] column of TL lanes in shared memory
// for the whole pair, so the pair moves each element through device
// memory once in and once out, where the three-pass route moves it three
// times. What bounds it on the H100: at the GF32 batch encode ([2^10,
// 65536], 512 MiB in and out) 0.160 ms of bytes against 0.088 ms of
// multiplies. Its stages are stages.cuh's loop, which sets its pace: one
// shared-memory round per radix-4 stage, twiddles read from device
// memory. Shared memory sets the tile: TL = 8192 / k lanes, clamped to
// [2, 32], two [k, TL] buffers ping-ponged. Ragged lane edges are masked.
//
// K12 runs on the register-stage engine (regstages.cuh), templated on
// LA = log2 k (k = 4 .. 2^13). What bounds it: at the GF16 wire shape
// ([2^13, 16384] pairs, 512 MiB in, 512 MiB stored, 64 MiB of bitmap)
// 0.341 ms of bytes. Its first version ran K11's stage loop on lo
// and on hi in one block (28 shared rounds at 2^13, one block an SM) at
// 20.9x that. The design:
//   * the half is in the grid (block = (lane tile, half), the half the
//     fastest index, so the second read of a tile is an L2 hit); the
//     block splits its half off as step 1 reads the tile (lo = v & 0xFFFF,
//     hi = v >> 16), and each element ends as one u16 store of its half of
//     the stored word, so no block parks a result for another;
//   * the tile in flight at once (cp.async, 16-byte copies where aligned),
//     with the inner twiddle tables, before one wait;
//   * each transform in registers with compile-time twiddles: below 2^12
//     the engine's one-exchange split (RegSplit); at 2^12 and 2^13 a
//     two-exchange split (Split3 below: an outer 16- or 32-point level,
//     the level twiddles read through L1, an exchange into padded rows,
//     then the engine's split on the inner M-point transforms with the
//     outer index as extra lanes), so no thread holds more than 32
//     elements;
//   * the mid multiply g^m k^-1 at the hand-off, as the inverse's output
//     is renamed into the forward's step 1 (col.cu's seam); no shared
//     round;
//   * the escape bits (v >> 16, GF16 values are <= 0x10000) OR-ed with
//     atomicOr into the bitmap the entry zeroes (bit 2t for lo, 2t + 1 for
//     hi of lane 8g + t; the halves' and the lane tiles' bits are
//     disjoint, so the words equal K10's; a value is 0x10000 about once
//     in 2^16, so the atomics are few).

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "gf.cuh"
#include "regstages.cuh"
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
  uint32_t* bitmap;      // unused since K12 left this struct; kept so
                        // that K11's parameter offsets stay
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

// ---------------------------------------------------------------------------
// K12 on the register-stage engine.
// ---------------------------------------------------------------------------

// K12's split of a k = 2^LA column: the engine's one-exchange RegSplit<LA>
// below 2^kTwoExchangeLog (A1 up to 64 elements a thread at 2^11, as K15);
// from there on k = B1 * M, M = A1 * A2, B1 = A1 = 2^ceil(LA / 3) (2^13 =
// 32 * 32 * 8, 2^12 = 16 * 16 * 16), so that no thread holds more than 32
// elements. kernels/ntt_mfa.py LANES16_TWO_EXCHANGE_K builds the tables
// for this split.
constexpr int kTwoExchangeLog = 12;
// Lanes a block holds in the two-exchange form: (k / B1) x TL = 1024
// threads at 2^12 and 2^13, 16-byte row segments (lanes_options.py
// weighed 2, PERF.md section 6).
constexpr int kTwoExchangeTL = 4;
constexpr int kMaxLog16 = 13;

// The two-exchange split: the outer B1-point level on column t of the
// [k, TL] tile (elements t + M n1), the level twiddles w_k^(t k1), an
// exchange into rows of (B1 + 1) * TL words, then `Inner`: M-point
// transforms on the engine (regstages.cuh's split interface) over
// TL' = B1 * TL lanes', lane' = k1 * TL + l. The forward runs it mirrored.
template <int LA>
struct Split3 {
  static constexpr int LB = (LA + 2) / 3;
  static constexpr int B1 = 1 << LB;
  static constexpr int M = (1 << LA) >> LB;
  static constexpr int A = 1 << LA;
  static constexpr int TL = kTwoExchangeTL;
  static constexpr int kThreads = M * TL;           // (column t, lane l)
  static constexpr int kOuterRow = (B1 + 1) * TL;   // padded outer row
  struct Inner {
    static constexpr int A = M;
    static constexpr int LA1 = LB, LA2 = LA - 2 * LB;
    static constexpr int A1 = 1 << LA1, A2 = 1 << LA2;
    static constexpr int TL = B1 * kTwoExchangeTL;
    static constexpr int kThreads = A2 * TL;        // == M * TL
    static constexpr int kRowWords = (A1 + 1) * TL;
    static constexpr int kTwStride = A1 + 1;
  };
};

// A K12 block's shape: the (inner) register split, the lanes and threads,
// the shared words (the exchange, which holds the tile first, and the
// inverse and forward inner tables).
template <int LA>
struct Wire16Shape {
  static constexpr bool kTwo = LA >= kTwoExchangeLog;
  using Inner = std::conditional_t<kTwo, typename Split3<LA>::Inner,
                                   fecc::RegSplit<LA>>;
  static constexpr int TL = kTwo ? kTwoExchangeTL : fecc::RegSplit<LA>::TL;
  static constexpr int kThreads = Inner::kThreads;
  static constexpr int kExchWords = Inner::A2 * Inner::kRowWords;
  static constexpr int kTwWords = Inner::A2 * Inner::kTwStride;
  static constexpr int kSmemWords = kExchWords + 2 * kTwWords;
  // The one-exchange form held to two blocks an SM (ptxas took 66
  // registers at 2^9 and 103 at 2^11 unasked; held, 64 and 128), the
  // two-exchange form's 1024 threads to one (lanes_options.py, PERF.md).
  static constexpr int kMinBlocks = kTwo ? 1 : 2;
};

struct Wire16Args {
  const uint32_t* x;      // [k, L] u32 pairs of LE u16 wire words
  uint16_t* stored;       // [k, L] stored words as u16: lo16 at 2w, hi16 2w+1
  uint32_t* bitmap;       // [k, L / 8] escape words, zeroed by the entry
  const uint32_t* lvl_i;  // two-exchange: [B1, M] w_k^-(k1 t)
  const uint32_t* lvl_f;  // [M, B1] w_k^(kk r)
  const uint32_t* tw_i;   // [A2, A1] inner twiddles of the (inner) split
  const uint32_t* tw_f;   // forward
  const uint32_t* mid;    // [k] g^m k^-1
  int L;
  int vec;                // x 16-byte aligned and L % 4 == 0
};

// The hand-off of col.cu's seam: y[n1] = X[t + A2 n1] * mid[idx(n1)], with
// n1 = j + (A1 / A2) k2 held in r[j A2 + bitrev(k2)], is the forward
// transform's step-1 column n2 = t. GF16 mid factors can be 0x10000.
template <class S, class Idx>
__device__ __forceinline__ void handoff(const uint32_t (&r)[S::A1],
                                        uint32_t (&y)[S::A1],
                                        const uint32_t* __restrict__ mid,
                                        Idx idx) {
  fecc::static_for<S::A1>([&](auto nc) {
    constexpr int n1 = decltype(nc)::value;
    constexpr int rho = S::A1 / S::A2;
    constexpr int src = n1 % rho * S::A2 + fecc::bitrev(n1 / rho, S::LA2);
    y[n1] = mul_full<fecc::kGF16>(r[src], __ldg(mid + idx(n1)));
  });
}

// Issue the copies of lanes [l0, l0 + TL) of x and of the inner tables,
// wait for them, synchronise.
template <int LA>
__device__ __forceinline__ void load_block(uint32_t* smem,
                                           const Wire16Args& p, int l0) {
  using W = Wire16Shape<LA>;
  uint32_t* tw_i = smem + W::kExchWords;
  using S = std::conditional_t<W::kTwo, Split3<LA>, typename W::Inner>;
  static_assert(S::TL >= 4, "16-byte copies need row segments of 4 lanes");
  fecc::load_tile_async<S>(smem, p.x, 1, p.L, 0, l0, p.vec != 0);
  fecc::load_twiddles_async<typename W::Inner>(tw_i, p.tw_i);
  fecc::load_twiddles_async<typename W::Inner>(tw_i + W::kTwWords, p.tw_f);
  fecc::cp_async_wait_all();
  __syncthreads();
}

// The pair on half `half` (0: lo = v & 0xFFFF, 1: hi = v >> 16) of the
// block's tile in `smem`, as load_block left it. Each element of the
// thread's result goes to emit(i, v, row) (i its register, a compile-time
// constant; row its row in natural order), in threads whose lane is
// `live`. The exchanges overwrite the tile.
template <int LA, class Emit>
__device__ __forceinline__ void pair_half(const Wire16Args& p,
                                          uint32_t* smem, int half,
                                          bool live, Emit emit) {
  using W = Wire16Shape<LA>;
  using In = typename W::Inner;
  constexpr int F = fecc::kGF16;
  uint32_t* tile = smem;
  uint32_t* tw_i = smem + W::kExchWords;
  uint32_t* tw_f = tw_i + W::kTwWords;
  const int l = threadIdx.x % W::TL, t = threadIdx.x / W::TL;
  uint32_t r[In::A1], y[In::A1];
  if constexpr (!W::kTwo) {
    // step 1: column n2 = t at stride A2, this half split off
    fecc::static_for<In::A1>([&](auto n1) {
      const uint32_t v = tile[(decltype(n1)::value * In::A2 + t) * W::TL + l];
      r[decltype(n1)::value] = half ? v >> 16 : v & 0xFFFFu;
    });
    fecc::reg_transform_regs<F, true, In>(r, tile, tw_i, t, l);
    handoff<In>(r, y, p.mid, [&](int n1) { return t + In::A2 * n1; });
    fecc::reg_transform_regs<F, false, In>(y, tile, tw_f, t, l);
    if (!live) return;
    // natural order: row t + A2 j + A1 k2
    fecc::static_for<In::A1 / In::A2>([&](auto jc) {
      constexpr int j = decltype(jc)::value;
      fecc::static_for<In::A2>([&](auto k2c) {
        constexpr int k2 = decltype(k2c)::value;
        constexpr int i = j * In::A2 + fecc::bitrev(k2, In::LA2);
        emit(std::integral_constant<int, i>{}, y[i],
             t + In::A2 * j + In::A1 * k2);
      });
    });
  } else {
    using S3 = Split3<LA>;
    // the inverse's outer level: column t (elements t + M n1), B1 points
    fecc::static_for<S3::B1>([&](auto n1) {
      const uint32_t v = tile[(decltype(n1)::value * S3::M + t) * W::TL + l];
      r[decltype(n1)::value] = half ? v >> 16 : v & 0xFFFFu;
    });
    fecc::dif_regs<F, true, S3::B1, 0>(r);
    __syncthreads();  // every column is in registers: the tile is free
    uint32_t* orow = tile + t * S3::kOuterRow + l;
    fecc::static_for<S3::B1>([&](auto k1c) {
      constexpr int k1 = decltype(k1c)::value;
      uint32_t v = r[fecc::bitrev(k1, S3::LB)];
      // w_k^-(t k1) can be p - 1 (0x10000): the full multiply
      if constexpr (k1 != 0)
        v = mul_full<F>(v, __ldg(p.lvl_i + k1 * S3::M + t));
      orow[k1 * W::TL] = v;
    });
    __syncthreads();
    // the inner M-point transforms: thread (t3, lane' = k1 * TL + l)
    const int t3 = threadIdx.x / In::TL, lp = threadIdx.x % In::TL;
    fecc::static_for<In::A1>([&](auto n1) {
      r[decltype(n1)::value] =
          tile[(decltype(n1)::value * In::A2 + t3) * S3::kOuterRow + lp];
    });
    fecc::reg_transform_regs<F, true, In>(r, tile, tw_i, t3, lp);
    const int k1 = lp / W::TL;
    handoff<In>(r, y, p.mid,
                [&](int n1) { return k1 + S3::B1 * (t3 + In::A2 * n1); });
    fecc::reg_transform_regs<F, false, In>(y, tile, tw_f, t3, lp);
    __syncthreads();  // the exchange's last reads are done
    // the forward's outer level: x w_k^(kk r) (r = k1), into padded rows
    fecc::static_for<In::A1 / In::A2>([&](auto jc) {
      constexpr int j = decltype(jc)::value;
      fecc::static_for<In::A2>([&](auto k2c) {
        constexpr int k2 = decltype(k2c)::value;
        const int kk = t3 + In::A2 * j + In::A1 * k2;
        tile[kk * S3::kOuterRow + lp] =
            mul_full<F>(y[j * In::A2 + fecc::bitrev(k2, In::LA2)],
                        __ldg(p.lvl_f + kk * S3::B1 + k1));
      });
    });
    __syncthreads();
    fecc::static_for<S3::B1>([&](auto rc) {
      r[decltype(rc)::value] = orow[decltype(rc)::value * W::TL];
    });
    fecc::dif_regs<F, false, S3::B1, 0>(r);
    if (!live) return;
    // natural order: row t + M kb in r[bitrev(kb)]
    fecc::static_for<S3::B1>([&](auto kc) {
      constexpr int kb = decltype(kc)::value;
      constexpr int i = fecc::bitrev(kb, S3::LB);
      emit(std::integral_constant<int, i>{}, r[i], t + S3::M * kb);
    });
  }
}

// K12: block = (lane tile, half), the half the fastest index so that the
// second block's read of the same tile comes from L2. Each element is
// stored as its half's u16 of the stored word (0x10000 as 0), and its
// escape bit (v >> 16) is OR-ed into the bitmap.
template <int LA>
__global__ void __launch_bounds__(Wire16Shape<LA>::kThreads,
                                  Wire16Shape<LA>::kMinBlocks)
    pair_lanes_wire16_kernel(Wire16Args p) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int half = blockIdx.x & 1;
  const int l0 = (blockIdx.x >> 1) * Wire16Shape<LA>::TL;
  load_block<LA>(smem, p, l0);
  const int lane = l0 + threadIdx.x % Wire16Shape<LA>::TL;
  uint16_t* st = p.stored + 2 * (size_t)lane + half;
  uint32_t* bm = p.bitmap + (lane >> 3);
  const uint32_t bit = 1u << (2 * (lane & 7) + half);
  const int words = p.L >> 3;
  pair_half<LA>(p, smem, half, lane < p.L, [&](auto, uint32_t v, int row) {
    st[2 * (size_t)row * p.L] = (uint16_t)v;
    if (v >> 16) atomicOr(bm + (size_t)row * words, bit);
  });
}

template <int LA>
cudaError_t launch_wire16(const Wire16Args& p, cudaStream_t s) {
  using W = Wire16Shape<LA>;
  const size_t smem = (size_t)W::kSmemWords * sizeof(uint32_t);
  auto kernel = pair_lanes_wire16_kernel<LA>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const unsigned blocks = 2u * (unsigned)((p.L + W::TL - 1) / W::TL);
  kernel<<<blocks, W::kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

template <int LA>
cudaError_t dispatch_wire16(int la, const Wire16Args& p, cudaStream_t s) {
  if constexpr (LA > kMaxLog16) {
    return cudaErrorInvalidValue;
  } else {
    if (la != LA) return dispatch_wire16<LA + 1>(la, p, s);
    return launch_wire16<LA>(p, s);
  }
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
// k = 4 .. 2^13, L % 8 == 0. lvl_i, lvl_f: the level twiddles of the
// two-exchange split (k >= 2^kTwoExchangeLog; kernels/ntt_mfa.py
// _lanes16_level_twiddles), else unused; tw_i, tw_f: the [A2, A1] inner
// twiddles of the (inner) register split; mid: [k] g^m k^-1.
int fecc_pair_lanes_wire16(int field, const void* x, void* stored,
                           void* bitmap, int k, int L, const void* lvl_i,
                           const void* lvl_f, const void* tw_i,
                           const void* tw_f, const void* mid, void* stream) {
  const int la = log2_exact(k);
  if (field != fecc::kGF16 || la < 2 || la > kMaxLog16 || L < 8 ||
      L % 8 != 0 || (la >= kTwoExchangeLog && (!lvl_i || !lvl_f)))
    return (int)cudaErrorInvalidValue;
  Wire16Args p{};
  p.x = (const uint32_t*)x;
  p.stored = (uint16_t*)stored;
  p.bitmap = (uint32_t*)bitmap;
  p.lvl_i = (const uint32_t*)lvl_i;
  p.lvl_f = (const uint32_t*)lvl_f;
  p.tw_i = (const uint32_t*)tw_i;
  p.tw_f = (const uint32_t*)tw_f;
  p.mid = (const uint32_t*)mid;
  p.L = L;
  p.vec = ((uintptr_t)x % 16 == 0) && (L % 4 == 0);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(
      bitmap, 0, (size_t)k * (size_t)(L / 8) * sizeof(uint32_t), s);
  if (e != cudaSuccess) return (int)e;
  return (int)dispatch_wire16<2>(la, p, s);
}

}  // extern "C"
