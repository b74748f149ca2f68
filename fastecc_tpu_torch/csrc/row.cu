// Pass B for Hopper (sm_90a): kernels K3, K7, K7-sel and K10 of the
// port, on the register-stage engine of regstages.cuh, with a plain C
// interface loaded through ctypes (kernels/_build.py builds it;
// kernels/ntt_mfa.py row_pass, row_pass_post and wire16_pass_b2 wrap it).
//
// Replaces these Pallas TPU kernels of fastecc_tpu/kernels/ntt_mfa.py:
//   K3 fecc_row <- _row_kernel: R-point forward or inverse stages along
//                  axis 0 of [A = R, B = C, L] u32, natural-order output,
//                  no scale;
//   K7 fecc_row_post <- _row_kernel_post: K3, then out *= v[k * B + b]
//                  at every output row k (the Forney inverse derivative);
//   K7-sel fecc_row_post_sel <- _row_kernel_post_sel: K3, then at rows k
//                  whose mask[k * B + b] is not 0 out *= v[k * B + b]
//                  (the Forney inverse derivative), at the others out =
//                  orig (the erased-row merge of the decode);
//   K10 fecc_row_wire16 <- _row_kernel_wire16: K3 (GF16, forward) on the
//                  lo and the hi half of the GF16 wire pair, then the
//                  stored words lo16 | hi16 << 16 and the escape bitmap.
// The output is the same canonical residues; how it gets there is the
// port's own.
//
// What bounds it on the H100: the encode pair's last pass moves 2 GiB in
// and 2 GiB out at [512, 1024, 1024] (2^29 elements): 4 GiB at 3.35 TB/s
// is 1.2821 ms. The first version (a mode of ntt_mfa.cu's pass kernel,
// 5.96 ms) lost that to latency and to shared memory: each thread issued
// one 4-byte load at a time, every Stockham stage was a shared-memory
// round with runtime index arithmetic, and every butterfly fetched its
// twiddles from device memory.
//
// What this design does about it:
//   * the length is a template parameter (the C entry dispatches over
//     A = 2 .. 1024, both fields, both directions), so every index map,
//     loop bound and small-transform twiddle is a compile-time constant;
//   * a thread holds its elements in registers across the stages: one
//     A1-point transform (A1 = 32 at A = 512 and 1024), the inner twiddles
//     w_A^(n2 k1) from a table staged once in shared memory, one
//     transposition through shared memory, then A2-point transforms
//     (regstages.cuh); one exchange round instead of five Stockham rounds
//     at A = 512, and no twiddle loads inside the butterflies;
//   * the block's whole tile is in flight at once: each thread issues all
//     of its cp.async copies (16-byte copies of 4 lanes where aligned)
//     before the one wait, and a block holds one tile plus the table
//     (~70 KB at A = 512 and 1024), not two ping-pong buffers, so two
//     blocks of 512 threads share an SM and one block's copies overlap
//     the other's arithmetic;
//   * the lane tile is TL = 32 at A <= 512 and 16 at 1024 (128- and
//     64-byte row segments; a 16384-word tile), chosen by measurement
//     against TL = 16 and 8, which lost at [1024, 1024, 512];
//   * each thread stores its outputs straight from registers: a warp's
//     store covers 32 / TL whole rows of TL lanes (whole sectors), so no
//     second round through shared memory.
//
// Integer issue: at A = 512 an element costs 9 adds or subs (one a
// radix-2 stage), ~1.0 butterfly multiply of the 32-point half, ~1.1 of
// the 16-point half (index-0 twiddles skipped) and ~0.91 inner-twiddle
// multiply. The code is straight-line, so cuobjdump's static count is the
// dynamic one: the GF32 instantiation at A = 512 has 3768 SASS
// instructions for a thread's 32 elements, ~118 an element, 37 of them
// IMAD-class. 2^29 elements x 118 at PERF.md's measured issue rate
// (~3.3e13 integer instructions a second over both pipes) is
// ~1.9 ms, and the IMADs alone on their one pipe (1.64e13 a second)
// ~1.2 ms: below half the bytes bound (2.56 ms), but above the bound
// itself (1.28 ms), so this kernel is issue-bound, not memory-bound.
//
// K7 and K7-sel are K3's schedule with an epilogue in the store loop
// (one inlined body, `row_post`, the merge a compile-time flag). K7
// copies the block's [A] table row v[k * B + b] into shared memory with
// the tile (4 KB more at A = 1024) and stores X[k] x v[k] at every row; a
// table multiply is one shared load and one `mul_full` an element. Its
// first version (a mode of ntt_mfa.cu's pass kernel, 6.24 ms at [1024,
// 1024, 512]) ran five Stockham rounds and copied its table row after
// them. K7-sel also copies the mask row (8 KB more at A = 1024). For
// each group of A2 outputs a thread first sets every register: erased
// rows (mask not 0) x v[k], kept rows a read-only load of orig at the
// same [A, B, L] index over the transform's value, so that all the
// group's loads are in flight before its first store. The mask is a
// row's, so a warp splits only where it holds two columns t (TL = 16).
// Measured against copying the kept rows of orig into the freed exchange
// with cp.async while the A2-point DIFs run, and reading them from
// shared memory at the store: that held more registers and lost (PERF.md
// section 6).
// orig may be the pass's own input: neither is written. At the decode's
// e = n / 2 it reads half the rows of orig, 1 GiB at [1024, 1024, 512].
//
// K10 is K3's GF16 forward schedule run on both halves in one block (as
// K8 in col.cu runs K1's): lo's and hi's [A, TL] tiles and the inner
// table in flight before one wait, each half's exchange through a region
// of its own, so that lo's result stays in registers while hi's transform
// runs and nothing is parked in shared memory (one region, hi read into
// registers before lo's exchange, ran the same; option sweep). Each
// thread then stores (lo & 0xFFFF) | hi << 16 straight from its two
// result registers (a u32 shift drops hi's bit 16: 0x10000 is stored as
// 0 in either half) and ORs its escape bits into the bitmap the entry
// zeroes, as K12 does: bit 2t for lo and 2t + 1 for hi of lane 8g + t,
// where v >> 16 (GF16 values are <= 0x10000) is the escape flag. A value
// is 0x10000 about once in 2^16, so the atomics are few; building every
// word from two warp ballots a row instead (no zeroing, no atomics, but
// ~15 more instructions a register for every thread) took 16% longer at
// [64, 128, 16384] and 13% at [512, 64, 4096] (option sweep). What
// bounds it on the H100: at the GF16 wire encode ([64, 128,
// 16384] a half) it reads lo and hi (1 GiB) and writes the stored words
// and the bitmap (0.56 GiB), 0.50 ms at 3.35 TB/s. Its first version (the
// port's first design, 1.34 ms there) ran a Stockham stage loop on both
// halves (five shared rounds each at A = 64, twiddles from device memory,
// one 4-byte load at a time) and read both results back from shared
// memory for the re-pack and the bitmap.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "gf.cuh"
#include "regstages.cuh"

namespace {

using fecc::RegSplit;
using fecc::mul_full;

constexpr int kMaxLog = 10;   // longest pass the splits give (1024)

struct RowArgs {
  const uint32_t* x;
  uint32_t* out;
  const uint32_t* tw;   // [A2, A1] inner twiddles w_A^(n2 k1), prepared
  int B, L;             // columns (axis 1), lanes (axis 2)
  int lane_tiles;       // ceil(L / TL)
  int vec;              // x 16-byte aligned and L % 4 == 0
  const uint32_t* post;  // K7, K7-sel: [A * B] factors v[k * B + b]
  const uint32_t* mask;  // K7-sel: [A * B] erased-row mask
  const uint32_t* orig;  // K7-sel: [A, B, L] rows kept where mask is 0
  const uint32_t* hi;    // K10: [A, B, L] hi half (x is the lo half)
  uint32_t* bitmap;      // K10: [A * B, L / 8] escape words
};

// The schedule up to the store, K3's, K7's and K7-sel's: the block's tile and
// the inner table in flight with whatever `copies()` issues, one wait,
// then the transform of lane column (t, l): r[j A2 + bitrev(k2)] holds
// X[t + A2 j + A1 k2].
template <int F, int INV, class S, class Copies>
__device__ __forceinline__ void row_transform(const RowArgs& p,
                                              uint32_t* smem,
                                              uint32_t (&r)[S::A1], int b,
                                              int l0, Copies&& copies) {
  uint32_t* tile = smem;
  uint32_t* tw = smem + S::kExchWords;
  fecc::load_tile_async<S>(tile, p.x, p.B, p.L, b, l0, p.vec != 0);
  fecc::load_twiddles_async<S>(tw, p.tw);
  copies();
  fecc::cp_async_wait_all();
  __syncthreads();

  const int l = threadIdx.x % S::TL, t = threadIdx.x / S::TL;
  fecc::reg_transform<F, INV != 0, S>(r, tile, tw, t, l);
}

// Block = (column b, lane tile); thread = (t = n2, lane l).
template <int F, int LA, int INV>
__global__ void __launch_bounds__(RegSplit<LA>::kThreads)
    row_kernel(RowArgs p) {
  using S = RegSplit<LA>;
  extern __shared__ __align__(16) uint32_t smem[];
  const int lt = blockIdx.x % p.lane_tiles;
  const int b = blockIdx.x / p.lane_tiles;
  const int l0 = lt * S::TL;
  uint32_t r[S::A1];
  row_transform<F, INV, S>(p, smem, r, b, l0, [] {});
  const int l = threadIdx.x % S::TL, t = threadIdx.x / S::TL;
  if (l0 + l >= p.L) return;
  // natural order: out[k1 + A1 k2, b, l] of [A, B, L]
  const size_t row = (size_t)p.B * p.L;
  uint32_t* out = p.out + (size_t)b * p.L + l0 + l;
  fecc::static_for<S::A1 / S::A2>([&](auto jc) {
    constexpr int j = decltype(jc)::value;
    uint32_t* o = out + (size_t)(t + S::A2 * j) * row;
    fecc::static_for<S::A2>([&](auto k2c) {
      constexpr int k2 = decltype(k2c)::value;
      constexpr int src = j * S::A2 + fecc::bitrev(k2, S::LA2);
      o[(size_t)(k2 * S::A1) * row] = r[src];
    });
  });
}

// K7 (MERGE false): K3, then out = X[k] * post[k] at each output row k.
// K7-sel (MERGE): out = mask[k] != 0 ? X[k] * post[k] : orig. The block's
// rows of post (and mask) lie in shared memory behind K3's.
template <int F, int LA, int INV, bool MERGE>
__device__ __forceinline__ void row_post(const RowArgs& p) {
  using S = RegSplit<LA>;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* post = smem + S::kSmemWords;
  uint32_t* mask = post + S::A;
  const int lt = blockIdx.x % p.lane_tiles;
  const int b = blockIdx.x / p.lane_tiles;
  const int l0 = lt * S::TL;
  uint32_t r[S::A1];
  row_transform<F, INV, S>(p, smem, r, b, l0, [&] {
    fecc::load_row_async<S>(post, p.post + b, p.B);
    if constexpr (MERGE) fecc::load_row_async<S>(mask, p.mask + b, p.B);
  });
  const int l = threadIdx.x % S::TL, t = threadIdx.x / S::TL;
  if (l0 + l >= p.L) return;
  // natural order, as K3: out[k1 + A1 k2, b, l] of [A, B, L]
  const size_t row = (size_t)p.B * p.L;
  const size_t at = (size_t)b * p.L + l0 + l;
  fecc::static_for<S::A1 / S::A2>([&](auto jc) {
    constexpr int j = decltype(jc)::value;
    const int k1 = t + S::A2 * j;
    const uint32_t* orig = p.orig + at + (size_t)k1 * row;
    // every register of the group first (GF16 tables can hold 0x10000:
    // the full multiply), so that its orig loads are all in flight
    fecc::static_for<S::A2>([&](auto k2c) {
      constexpr int k2 = decltype(k2c)::value;
      constexpr int src = j * S::A2 + fecc::bitrev(k2, S::LA2);
      const int k = k1 + k2 * S::A1;
      if constexpr (MERGE)
        r[src] = mask[k] != 0u ? mul_full<F>(r[src], post[k])
                               : __ldg(orig + (size_t)(k2 * S::A1) * row);
      else
        r[src] = mul_full<F>(r[src], post[k]);
    });
    uint32_t* o = p.out + at + (size_t)k1 * row;
    fecc::static_for<S::A2>([&](auto k2c) {
      constexpr int k2 = decltype(k2c)::value;
      constexpr int src = j * S::A2 + fecc::bitrev(k2, S::LA2);
      o[(size_t)(k2 * S::A1) * row] = r[src];
    });
  });
}

template <int F, int LA, int INV>
__global__ void __launch_bounds__(RegSplit<LA>::kThreads)
    row_sel_kernel(RowArgs p) {
  row_post<F, LA, INV, true>(p);
}

// K7-sel and K7 at A >= 512 (kBoundLog), held to two blocks of 512
// threads an SM. Unasked, ptxas gives K7-sel 66-74 registers and one
// block at 1024; at 512 it fits 64 unasked, yet the bound (a few bytes of
// spills) ran 6% faster; at 256 its own choice (40-42 registers, three
// blocks) ran 7% faster than the bound, and a bound of one block, which
// lets it take 72-120 registers, was the slowest everywhere
// (option sweep). K7 takes 56-64 registers unasked at 512 and 1024;
// the bound (16-40 bytes of spill stores) ran 3% faster at 512 and 1%
// at 1024, and at 256 its own choice (37-40 registers) ran 2% faster
// than the bound (option sweep).
constexpr int kBoundLog = 9;

template <int F, int LA, int INV>
__global__ void __launch_bounds__(RegSplit<LA>::kThreads, 2)
    row_sel_kernel_lb2(RowArgs p) {
  row_post<F, LA, INV, true>(p);
}

template <int F, int LA, int INV>
__global__ void __launch_bounds__(RegSplit<LA>::kThreads)
    row_post_kernel(RowArgs p) {
  row_post<F, LA, INV, false>(p);
}

template <int F, int LA, int INV>
__global__ void __launch_bounds__(RegSplit<LA>::kThreads, 2)
    row_post_kernel_lb2(RowArgs p) {
  row_post<F, LA, INV, false>(p);
}

// K10: block = (column b, lane tile); lo's tile, hi's tile (each in an
// exchange region of its own) and the inner table, then K3's GF16
// forward transform on each half and the epilogue from the registers.
template <int LA>
__global__ void __launch_bounds__(RegSplit<LA>::kThreads)
    row_wire16_kernel(RowArgs p) {
  using S = RegSplit<LA>;
  constexpr int F = fecc::kGF16;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* tlo = smem;
  uint32_t* thi = smem + S::kExchWords;
  uint32_t* tw = thi + S::kExchWords;
  const int lt = blockIdx.x % p.lane_tiles;
  const int b = blockIdx.x / p.lane_tiles;
  const int l0 = lt * S::TL;
  fecc::load_tile_async<S>(tlo, p.x, p.B, p.L, b, l0, p.vec != 0);
  fecc::load_tile_async<S>(thi, p.hi, p.B, p.L, b, l0, p.vec != 0);
  fecc::load_twiddles_async<S>(tw, p.tw);
  fecc::cp_async_wait_all();
  __syncthreads();
  const int l = threadIdx.x % S::TL, t = threadIdx.x / S::TL;
  uint32_t lo[S::A1], hi[S::A1];
  fecc::reg_transform<F, false, S>(lo, tlo, tw, t, l);
  fecc::reg_transform<F, false, S>(hi, thi, tw, t, l);
  if (l0 + l >= p.L) return;
  // natural order, as K3: row k1 + A1 k2 of [A, B, L]; bitmap word
  // (l0 + l) / 8 of row k * B + b (TL is a multiple of 8, so the lane's
  // place in its group is l mod 8)
  const int words = p.L >> 3;
  const size_t row = (size_t)p.B * p.L;
  uint32_t* out = p.out + (size_t)b * p.L + l0 + l;
  uint32_t* bm = p.bitmap + (size_t)b * words + ((l0 + l) >> 3);
  fecc::static_for<S::A1 / S::A2>([&](auto jc) {
    constexpr int j = decltype(jc)::value;
    const int k1 = t + S::A2 * j;
    fecc::static_for<S::A2>([&](auto k2c) {
      constexpr int k2 = decltype(k2c)::value;
      constexpr int src = j * S::A2 + fecc::bitrev(k2, S::LA2);
      const size_t k = (size_t)k1 + k2 * S::A1;
      const uint32_t vl = lo[src], vh = hi[src];
      out[k * row] = (vl & 0xFFFFu) | (vh << 16);
      const uint32_t bits = ((vl >> 16) | (vh >> 16) << 1) << (2 * (l & 7));
      if (bits) atomicOr(bm + k * p.B * words, bits);
    });
  });
}

// The store's epilogue: none (K3), the table multiply (K7: one more [A]
// row of shared memory), the select (K7-sel: two more) or the wire pair's
// (K10: hi's exchange region more).
enum Epilogue : int { kNone = 0, kSel = 1, kPost = 2, kWire16 = 3 };

template <int F, int LA, int INV, int SEL>
cudaError_t launch(RowArgs p, cudaStream_t stream) {
  using S = RegSplit<LA>;
  constexpr int kMore = SEL == kSel ? 2 * S::A : SEL == kPost ? S::A
                        : SEL == kWire16 ? S::kExchWords : 0;
  const size_t smem = (size_t)(S::kSmemWords + kMore) * sizeof(uint32_t);
  void (*kernel)(RowArgs);
  if constexpr (SEL == kNone)
    kernel = row_kernel<F, LA, INV>;
  else if constexpr (SEL == kWire16)
    kernel = row_wire16_kernel<LA>;
  else if constexpr (SEL == kPost && LA >= kBoundLog)
    kernel = row_post_kernel_lb2<F, LA, INV>;
  else if constexpr (SEL == kPost)
    kernel = row_post_kernel<F, LA, INV>;
  else if constexpr (LA >= kBoundLog)
    kernel = row_sel_kernel_lb2<F, LA, INV>;
  else
    kernel = row_sel_kernel<F, LA, INV>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  p.lane_tiles = (p.L + S::TL - 1) / S::TL;
  const unsigned blocks = (unsigned)p.B * (unsigned)p.lane_tiles;
  kernel<<<blocks, S::kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int LA, int SEL>
cudaError_t dispatch(int la, int field, bool inv, const RowArgs& p,
                     cudaStream_t s) {
  if constexpr (LA > kMaxLog) {
    return cudaErrorInvalidValue;
  } else {
    if (la != LA) return dispatch<LA + 1, SEL>(la, field, inv, p, s);
    if constexpr (SEL == kWire16)   // GF16 forward: u16 wire words
      return field == fecc::kGF16 && !inv
                 ? launch<fecc::kGF16, LA, 0, SEL>(p, s)
                 : cudaErrorInvalidValue;
    if (field == fecc::kGF32)
      return inv ? launch<fecc::kGF32, LA, 1, SEL>(p, s)
                 : launch<fecc::kGF32, LA, 0, SEL>(p, s);
    return inv ? launch<fecc::kGF16, LA, 1, SEL>(p, s)
               : launch<fecc::kGF16, LA, 0, SEL>(p, s);
  }
}

int log2_exact(int v) {
  int t = 0;
  while ((1 << t) < v) ++t;
  return (1 << t) == v ? t : -1;
}

template <int SEL>
int run(int field, const void* x, void* out, int A, int B, int L,
        int inverse, const void* tw, RowArgs p, void* stream) {
  const int la = log2_exact(A);
  if (la < 1 || la > kMaxLog || B < 1 || L < 1)
    return (int)cudaErrorInvalidValue;
  p.x = (const uint32_t*)x;
  p.out = (uint32_t*)out;
  p.tw = (const uint32_t*)tw;
  p.B = B;
  p.L = L;
  // (K10 reads hi too; the others leave it null)
  p.vec = ((uintptr_t)x % 16 == 0) && ((uintptr_t)p.hi % 16 == 0) &&
          (L % 4 == 0);
  return (int)dispatch<1, SEL>(la, field, inverse != 0, p,
                               (cudaStream_t)stream);
}

}  // namespace

extern "C" {

// K3: [A=R, B=C, L] -> [R, C, L]; R-point forward (inverse != 0: inverse,
// unscaled) transforms along axis 0, natural-order write. tw: the [A2, A1]
// inner twiddles of kernels/ntt_mfa.py _row_inner_twiddles.
int fecc_row(int field, const void* x, void* out, int A, int B, int L,
             int inverse, const void* tw, void* stream) {
  return run<kNone>(field, x, out, A, B, L, inverse, tw, RowArgs{}, stream);
}

// K7: K3 (inverse != 0: inverse, unscaled), then out[k, b, :] =
// vec[k * B + b] * X[k, b, :]; vec is [A * B] u32.
int fecc_row_post(int field, const void* x, void* out, int A, int B, int L,
                  int inverse, const void* tw, const void* vec,
                  void* stream) {
  RowArgs p{};
  p.post = (const uint32_t*)vec;
  return run<kPost>(field, x, out, A, B, L, inverse, tw, p, stream);
}

// K7-sel: K3 (inverse != 0: inverse, unscaled), then out[k, b, :] =
// vec[k * B + b] * X[k, b, :] where mask[k * B + b] != 0, else
// orig[k, b, :]. vec and mask are [A * B] u32, orig [A, B, L] u32 (it may
// be x itself).
int fecc_row_post_sel(int field, const void* x, void* out, int A, int B,
                      int L, int inverse, const void* tw, const void* vec,
                      const void* mask, const void* orig, void* stream) {
  RowArgs p{};
  p.post = (const uint32_t*)vec;
  p.mask = (const uint32_t*)mask;
  p.orig = (const uint32_t*)orig;
  return run<kSel>(field, x, out, A, B, L, inverse, tw, p, stream);
}

// K10: lo, hi [A=R2, B=C2, L] -> stored [R2, C2, L] (natural order, as K3)
// and bitmap [R2 * C2, L / 8]; GF16, forward, L % 8 == 0. tw: the [A2, A1]
// forward inner twiddles.
int fecc_row_wire16(int field, const void* lo, const void* hi, void* stored,
                    void* bitmap, int A, int B, int L, const void* tw,
                    void* stream) {
  if (L % 8 != 0 || A < 1 || B < 1)   // whole groups
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaMemsetAsync(
      bitmap, 0, (size_t)A * B * (L / 8) * sizeof(uint32_t),
      (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  RowArgs p{};
  p.hi = (const uint32_t*)hi;
  p.bitmap = (uint32_t*)bitmap;
  return run<kWire16>(field, lo, stored, A, B, L, 0, tw, p, stream);
}

const char* fecc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
