// The one-pass encode pair for Hopper (sm_90a): kernels K11 and K12 of the
// port, on the register-stage engine of regstages.cuh, with a plain C
// interface loaded through ctypes (fastecc_tpu_torch/kernels/_build.py
// builds it; kernels/ntt_mfa.py ntt_pair_lanes and ntt_pair_lanes_wire16
// wrap it).
//
// Replaces these Pallas TPU kernels of fastecc_tpu/kernels/ntt_mfa.py:
//   K11 fecc_pair_lanes        <- _pair_lanes_kernel (ntt_pair_lanes_pallas):
//       the RS-encode pair NTT_g-coset(iNTT(x)) over [k, L] u32 with whole
//       k-point columns resident: unscaled inverse transform, x g^m k^-1
//       (the prepared mid table), forward transform; GF32 and GF16
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
// Each block owns the [k, TL] column of TL lanes for the whole pair, so
// the pair moves each element through device memory once in and once
// out, where the three-pass route moves it three times. Both kernels are
// one schedule templated on LA = log2 k (k = 4 .. 2^13), K11 also on the
// field:
//   * the tile in flight at once (cp.async, 16-byte copies where aligned),
//     with the inner twiddle tables, before one wait;
//   * each transform in registers with compile-time twiddles: below 2^11
//     (K11) or 2^12 (K12) the engine's one-exchange split (RegSplit);
//     from there on a two-exchange split (Split3 below: an outer 16- or
//     32-point level, the level twiddles read through L1, an exchange
//     into padded rows, then the engine's split on the inner M-point
//     transforms with the outer index as extra lanes), so no thread holds
//     more than 32 elements;
//   * the mid multiply g^m k^-1 at the hand-off, as the inverse's output
//     is renamed into the forward's step 1 (col.cu's seam); no shared
//     round;
//   * each thread stores its outputs straight from registers, a warp's
//     store covering whole row segments.
//
// K11: what bounds it on the H100: at the GF32 batch encode ([2^10,
// 65536], 512 MiB in and out) 0.160 ms of bytes against 0.088 ms of
// multiplies. Its first version ran the Stockham stage loop of the
// port's first design (TL = 8192 / k lanes in two ping-ponged [k, TL]
// buffers, one shared-memory round per radix-4 stage, twiddles read from
// device memory, the mid multiply a round of its own) at 6.5x that; this
// one is K12's schedule on whole u32 values, each output one u32 store,
// with its own split, lane tile and launch bounds (below).
//
// K12: what bounds it: at the GF16 wire shape ([2^13, 16384] pairs, 512
// MiB in, 512 MiB stored, 64 MiB of bitmap) 0.341 ms of bytes. The half
// is in the grid (block = (lane tile, half), the half the fastest index,
// so the second read of a tile is an L2 hit); the block splits its half
// off as step 1 reads the tile (lo = v & 0xFFFF, hi = v >> 16), and each
// element ends as one u16 store of its half of the stored word, so no
// block parks a result for another; the escape bits (v >> 16, GF16 values
// are <= 0x10000) are OR-ed with atomicOr into the bitmap the entry zeroes
// (bit 2t for lo, 2t + 1 for hi of lane 8g + t; the halves' and the lane
// tiles' bits are disjoint, so the words equal K10's; a value is 0x10000
// about once in 2^16, so the atomics are few).

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "gf.cuh"
#include "regstages.cuh"

namespace {

using fecc::mul_full;

int log2_exact(int v) {
  int t = 0;
  while ((1 << t) < v) ++t;
  return (1 << t) == v ? t : -1;
}

// The split of a k = 2^LA column: the engine's one-exchange RegSplit<LA>
// below 2^kTwoExchangeLog (K12) or 2^kTwoExchangeLogK11 (K11); from there
// on k = B1 * M, M = A1 * A2, B1 = A1 = 2^ceil(LA / 3) (2^13 = 32 * 32 * 8,
// 2^12 = 16 * 16 * 16, 2^11 = 16 * 16 * 8), so that no thread holds more
// than 32 elements. K11's one-exchange form at 2^11 (64 elements a
// thread) ran 19% (GF32) and 23% (GF16) slower than the split; K12's ran
// 8% faster (option sweep, PERF.md section 6). kernels/ntt_mfa.py
// K11_TWO_EXCHANGE_K and K12_TWO_EXCHANGE_K build the tables for it.
constexpr int kTwoExchangeLog = 12;
constexpr int kTwoExchangeLogK11 = 11;
// Lanes a block holds in the two-exchange form: TL = 4, (k / B1) x TL =
// 1024 threads at 2^12 and 2^13 (512 at 2^11), 16-byte row segments; K12
// ran TL = 2 22-26% slower. K11 in GF32 at 2^13 holds kNarrowTL = 2: its
// 1024-thread block spilled 304 bytes at 64 registers, 512 threads ran
// 17% faster (option sweep).
constexpr int kTwoExchangeTL = 4;
constexpr int kNarrowTL = 2;
constexpr int kMaxLog = 13;

// The two-exchange split: the outer B1-point level on column t of the
// [k, TL] tile (elements t + M n1), the level twiddles w_k^(t k1), an
// exchange into rows of (B1 + 1) * TL words, then `Inner`: M-point
// transforms on the engine (regstages.cuh's split interface) over
// TL' = B1 * TL lanes', lane' = k1 * TL + l. The forward runs it mirrored.
template <int LA, int TL_>
struct Split3 {
  static constexpr int LB = (LA + 2) / 3;
  static constexpr int B1 = 1 << LB;
  static constexpr int M = (1 << LA) >> LB;
  static constexpr int A = 1 << LA;
  static constexpr int TL = TL_;
  static constexpr int kThreads = M * TL;           // (column t, lane l)
  static constexpr int kOuterRow = (B1 + 1) * TL;   // padded outer row
  struct Inner {
    static constexpr int A = M;
    static constexpr int LA1 = LB, LA2 = LA - 2 * LB;
    static constexpr int A1 = 1 << LA1, A2 = 1 << LA2;
    static constexpr int TL = B1 * TL_;
    static constexpr int kThreads = A2 * TL;        // == M * TL
    static constexpr int kRowWords = (A1 + 1) * TL;
    static constexpr int kTwStride = A1 + 1;
  };
};

// A block's shape (K11 in field F, or K12 with WIRE): the (inner) register
// split, the lanes and threads, the shared words (the exchange, which
// holds the tile first, and the inverse and forward inner tables).
template <int F, int LA, bool WIRE>
struct LanesShape {
  static constexpr bool kTwo =
      LA >= (WIRE ? kTwoExchangeLog : kTwoExchangeLogK11);
  static constexpr int kSplitTL =
      !WIRE && F == fecc::kGF32 && LA == 13 ? kNarrowTL : kTwoExchangeTL;
  using Split = Split3<LA, kSplitTL>;
  using Inner = std::conditional_t<kTwo, typename Split::Inner,
                                   fecc::RegSplit<LA>>;
  static constexpr int TL = kTwo ? kSplitTL : fecc::RegSplit<LA>::TL;
  static constexpr int kThreads = Inner::kThreads;
  static constexpr int kExchWords = Inner::A2 * Inner::kRowWords;
  static constexpr int kTwWords = Inner::A2 * Inner::kTwStride;
  static constexpr int kSmemWords = kExchWords + 2 * kTwWords;
  // K12: the one-exchange form held to two blocks an SM (ptxas took 66
  // registers at 2^9 and 103 at 2^11 unasked; held, 64 and 128), the
  // two-exchange form to one (option sweep, PERF.md).
  static constexpr int kMinBlocks = kTwo ? 1 : 2;
};

struct LanesArgs {
  const uint32_t* x;      // [k, L] input (K12: u32 pairs of LE u16 words)
  uint16_t* stored;       // K12: [k, L] stored words as u16: lo16 at 2w,
                          // hi16 at 2w + 1
  uint32_t* bitmap;       // K12: [k, L / 8] escape words, zeroed by the entry
  const uint32_t* lvl_i;  // two-exchange: [B1, M] w_k^-(k1 t)
  const uint32_t* lvl_f;  // [M, B1] w_k^(kk r)
  const uint32_t* tw_i;   // [A2, A1] inner twiddles of the (inner) split
  const uint32_t* tw_f;   // forward
  const uint32_t* mid;    // [k] g^m k^-1
  int L;
  int vec;                // x 16-byte aligned and L % 4 == 0
  uint32_t* out;          // K11: [k, L] output
};

// The hand-off of col.cu's seam: y[n1] = X[t + A2 n1] * mid[idx(n1)], with
// n1 = j + (A1 / A2) k2 held in r[j A2 + bitrev(k2)], is the forward
// transform's step-1 column n2 = t. GF16 mid factors can be 0x10000.
template <int F, class S, class Idx>
__device__ __forceinline__ void handoff(const uint32_t (&r)[S::A1],
                                        uint32_t (&y)[S::A1],
                                        const uint32_t* __restrict__ mid,
                                        Idx idx) {
  fecc::static_for<S::A1>([&](auto nc) {
    constexpr int n1 = decltype(nc)::value;
    constexpr int rho = S::A1 / S::A2;
    constexpr int src = n1 % rho * S::A2 + fecc::bitrev(n1 / rho, S::LA2);
    y[n1] = mul_full<F>(r[src], __ldg(mid + idx(n1)));
  });
}

// Issue the copies of lanes [l0, l0 + TL) of x and of the inner tables,
// wait for them, synchronise.
template <class W>
__device__ __forceinline__ void load_block(uint32_t* smem,
                                           const LanesArgs& p, int l0) {
  uint32_t* tw_i = smem + W::kExchWords;
  using S = std::conditional_t<W::kTwo, typename W::Split,
                               typename W::Inner>;
  if constexpr (S::TL < 4) {
    // 8-byte row segments: 4-byte copies
    fecc::static_for<S::A * S::TL / S::kThreads>([&](auto i) {
      const int e = threadIdx.x + decltype(i)::value * S::kThreads;
      const int a = e / S::TL, l = e % S::TL;
      const bool in = l0 + l < p.L;
      fecc::cp_async4(smem + e, in ? p.x + (size_t)a * p.L + l0 + l : p.x,
                      in ? 4 : 0);
    });
  } else {
    fecc::load_tile_async<S>(smem, p.x, 1, p.L, 0, l0, p.vec != 0);
  }
  fecc::load_twiddles_async<typename W::Inner>(tw_i, p.tw_i);
  fecc::load_twiddles_async<typename W::Inner>(tw_i + W::kTwWords, p.tw_f);
  fecc::cp_async_wait_all();
  __syncthreads();
}

// The pair in field F on the block's tile in `smem`, as load_block left
// it, each tile word taken as read(word) at step 1 (K11 the word, K12 its
// half). Each element of the thread's result goes to emit(i, v, row) (i
// its register, a compile-time constant; row its row in natural order),
// in threads whose lane is `live`. The exchanges overwrite the tile.
template <int F, int LA, bool WIRE, class Read, class Emit>
__device__ __forceinline__ void pair_columns(const LanesArgs& p,
                                             uint32_t* smem, Read read,
                                             bool live, Emit emit) {
  using W = LanesShape<F, LA, WIRE>;
  using In = typename W::Inner;
  uint32_t* tile = smem;
  uint32_t* tw_i = smem + W::kExchWords;
  uint32_t* tw_f = tw_i + W::kTwWords;
  const int l = threadIdx.x % W::TL, t = threadIdx.x / W::TL;
  uint32_t r[In::A1], y[In::A1];
  if constexpr (!W::kTwo) {
    // step 1: column n2 = t at stride A2
    fecc::static_for<In::A1>([&](auto n1) {
      r[decltype(n1)::value] =
          read(tile[(decltype(n1)::value * In::A2 + t) * W::TL + l]);
    });
    fecc::reg_transform_regs<F, true, In>(r, tile, tw_i, t, l);
    handoff<F, In>(r, y, p.mid, [&](int n1) { return t + In::A2 * n1; });
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
    using S3 = typename W::Split;
    // the inverse's outer level: column t (elements t + M n1), B1 points
    fecc::static_for<S3::B1>([&](auto n1) {
      r[decltype(n1)::value] =
          read(tile[(decltype(n1)::value * S3::M + t) * W::TL + l]);
    });
    fecc::dif_regs<F, true, S3::B1, 0>(r);
    __syncthreads();  // every column is in registers: the tile is free
    uint32_t* orow = tile + t * S3::kOuterRow + l;
    fecc::static_for<S3::B1>([&](auto k1c) {
      constexpr int k1 = decltype(k1c)::value;
      uint32_t v = r[fecc::bitrev(k1, S3::LB)];
      // w_k^-(t k1) can be p - 1 (GF16 0x10000): the full multiply
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
    handoff<F, In>(r, y, p.mid,
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

// K11: block = lane tile; each output one u32 store.
template <int F, int LA>
__device__ __forceinline__ void pair_lanes(const LanesArgs& p) {
  using W = LanesShape<F, LA, false>;
  extern __shared__ __align__(16) uint32_t smem[];
  const int l0 = blockIdx.x * W::TL;
  load_block<W>(smem, p, l0);
  const int lane = l0 + threadIdx.x % W::TL;
  uint32_t* out = p.out + lane;
  pair_columns<F, LA, false>(
      p, smem, [](uint32_t v) { return v; }, lane < p.L,
      [&](auto, uint32_t v, int row) { out[(size_t)row * p.L] = v; });
}

// K11's two-exchange form takes ptxas' own register choice: at 2^11 (512
// threads) it ran 17% (GF32) and 11% (GF16) faster than held to one block
// an SM, and within 2% either way at 2^12 and 2^13. The one-exchange form
// is held to two blocks an SM: unasked, ptxas' choice ran 13-17% slower in
// GF32 at 2^9 and 2^10 (option sweep).
template <int F, int LA>
__global__ void __launch_bounds__(LanesShape<F, LA, false>::kThreads)
    pair_lanes_kernel(LanesArgs p) {
  pair_lanes<F, LA>(p);
}

template <int F, int LA>
__global__ void __launch_bounds__(LanesShape<F, LA, false>::kThreads, 2)
    pair_lanes_kernel_lb2(LanesArgs p) {
  pair_lanes<F, LA>(p);
}

// K12: block = (lane tile, half), the half the fastest index so that the
// second block's read of the same tile comes from L2. Each element is
// stored as its half's u16 of the stored word (0x10000 as 0), and its
// escape bit (v >> 16) is OR-ed into the bitmap.
template <int LA>
__global__ void __launch_bounds__(LanesShape<fecc::kGF16, LA, true>::kThreads,
                                  LanesShape<fecc::kGF16, LA, true>::kMinBlocks)
    pair_lanes_wire16_kernel(LanesArgs p) {
  using W = LanesShape<fecc::kGF16, LA, true>;
  extern __shared__ __align__(16) uint32_t smem[];
  const int half = blockIdx.x & 1;
  const int l0 = (blockIdx.x >> 1) * W::TL;
  load_block<W>(smem, p, l0);
  const int lane = l0 + threadIdx.x % W::TL;
  uint16_t* st = p.stored + 2 * (size_t)lane + half;
  uint32_t* bm = p.bitmap + (lane >> 3);
  const uint32_t bit = 1u << (2 * (lane & 7) + half);
  const int words = p.L >> 3;
  pair_columns<fecc::kGF16, LA, true>(
      p, smem, [half](uint32_t v) { return half ? v >> 16 : v & 0xFFFFu; },
      lane < p.L, [&](auto, uint32_t v, int row) {
        st[2 * (size_t)row * p.L] = (uint16_t)v;
        if (v >> 16) atomicOr(bm + (size_t)row * words, bit);
      });
}

// K11 (WIRE false, field F) or K12 (WIRE, GF16): one block a lane tile,
// K12 two (one a half).
template <int F, int LA, bool WIRE>
cudaError_t launch(const LanesArgs& p, cudaStream_t s) {
  using W = LanesShape<F, LA, WIRE>;
  const size_t smem = (size_t)W::kSmemWords * sizeof(uint32_t);
  void (*kernel)(LanesArgs);
  if constexpr (WIRE)
    kernel = pair_lanes_wire16_kernel<LA>;
  else if constexpr (W::kTwo)
    kernel = pair_lanes_kernel<F, LA>;
  else
    kernel = pair_lanes_kernel_lb2<F, LA>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const unsigned tiles = (unsigned)((p.L + W::TL - 1) / W::TL);
  kernel<<<WIRE ? 2u * tiles : tiles, W::kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

template <int LA>
cudaError_t dispatch(int la, int field, bool wire, const LanesArgs& p,
                     cudaStream_t s) {
  if constexpr (LA > kMaxLog) {
    return cudaErrorInvalidValue;
  } else {
    if (la != LA) return dispatch<LA + 1>(la, field, wire, p, s);
    if (wire) return launch<fecc::kGF16, LA, true>(p, s);
    return field == fecc::kGF32 ? launch<fecc::kGF32, LA, false>(p, s)
                                : launch<fecc::kGF16, LA, false>(p, s);
  }
}

// The arguments both entries share; false where k or L is out of range or
// a two-exchange split (from 2^two_log on) lacks its level twiddles.
bool lanes_args(LanesArgs& p, int la, int two_log, const void* x, int L,
                const void* lvl_i, const void* lvl_f, const void* tw_i,
                const void* tw_f, const void* mid) {
  p = LanesArgs{};
  p.x = (const uint32_t*)x;
  p.lvl_i = (const uint32_t*)lvl_i;
  p.lvl_f = (const uint32_t*)lvl_f;
  p.tw_i = (const uint32_t*)tw_i;
  p.tw_f = (const uint32_t*)tw_f;
  p.mid = (const uint32_t*)mid;
  p.L = L;
  p.vec = ((uintptr_t)x % 16 == 0) && (L % 4 == 0);
  return la >= 2 && la <= kMaxLog && L >= 1 &&
         (la < two_log || (lvl_i && lvl_f));
}

}  // namespace

extern "C" {

// K11: [k, L] -> [k, L]; NTT(mid * iNTT_unscaled(x)) along axis 0, GF32 or
// GF16, k = 4 .. 2^13. lvl_i, lvl_f: the level twiddles of the
// two-exchange split (k >= 2^kTwoExchangeLogK11; kernels/ntt_mfa.py
// _lanes_level_twiddles), else unused; tw_i, tw_f: the [A2, A1] inner
// twiddles of the (inner) register split; mid: [k] g^m k^-1, prepared.
int fecc_pair_lanes(int field, const void* x, void* out, int k, int L,
                    const void* lvl_i, const void* lvl_f, const void* tw_i,
                    const void* tw_f, const void* mid, void* stream) {
  const int la = log2_exact(k);
  LanesArgs p;
  if (!lanes_args(p, la, kTwoExchangeLogK11, x, L, lvl_i, lvl_f, tw_i, tw_f,
                  mid))
    return (int)cudaErrorInvalidValue;
  p.out = (uint32_t*)out;
  return (int)dispatch<2>(la, field, false, p, (cudaStream_t)stream);
}

// K12: [k, L] u32 pairs -> stored [k, L] and bitmap [k, L / 8]; GF16 only,
// k = 4 .. 2^13, L % 8 == 0; the tables as K11's, of K12's split (two
// exchanges from 2^kTwoExchangeLog on).
int fecc_pair_lanes_wire16(int field, const void* x, void* stored,
                           void* bitmap, int k, int L, const void* lvl_i,
                           const void* lvl_f, const void* tw_i,
                           const void* tw_f, const void* mid, void* stream) {
  const int la = log2_exact(k);
  LanesArgs p;
  if (field != fecc::kGF16 || L % 8 != 0 ||
      !lanes_args(p, la, kTwoExchangeLog, x, L, lvl_i, lvl_f, tw_i, tw_f,
                  mid))
    return (int)cudaErrorInvalidValue;
  p.stored = (uint16_t*)stored;
  p.bitmap = (uint32_t*)bitmap;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(
      bitmap, 0, (size_t)k * (size_t)(L / 8) * sizeof(uint32_t), s);
  if (e != cudaSuccess) return (int)e;
  return (int)dispatch<2>(la, field, true, p, s);
}

}  // extern "C"
