// Register-resident NTT stages for Hopper: the engine of K3 and K7-sel
// (row.cu) and of K1, K2, K4, K5 and K6 (col.cu). Three parts:
//
//   * a tile loader that puts a block's [A, TL] column tile of an [A, B, L]
//     u32 view into shared memory with cp.async, every copy of the tile
//     issued before the first wait (16-byte copies of 4 lanes where the
//     base is 16-byte aligned and L % 4 == 0, 4-byte copies otherwise;
//     lanes past L are zero-filled, never read), and likewise a column of
//     an [A, B] table;
//   * in-place radix-2 DIF transforms of S <= 32 elements held in
//     registers, with the length, the direction and every twiddle known at
//     compile time: the twiddles are immediates (`root_pow`), index 0
//     skips its multiply, and the output lands in bit-reversed register
//     order, which the caller reads back with compile-time indices;
//   * the split A = A1 * A2 (A1 = 2^ceil(log2 A / 2), A2 = A / A1) and the
//     one transposition between its two halves through shared memory.
//
// The split (the four-step identity on one column, n = A2 n1 + n2,
// k = k1 + A1 k2):  X[k1 + A1 k2] = sum_n2 w_A2^(n2 k2) * w_A^(n2 k1) *
// sum_n1 w_A1^(n1 k1) x[A2 n1 + n2].  A thread holds one lane's column
// n2 (A1 elements at stride A2), transforms it, multiplies by the inner
// twiddles w_A^(n2 k1) (a host table, staged in shared memory beside the
// tile) and writes it into the exchange; then it reads A1 / A2 (1 or 2)
// columns k1 of A2 elements and transforms those. Any correct DFT with
// the field's root gives the same canonical residues, so the output is
// the Stockham passes' bit for bit.
#pragma once

#include <cstddef>
#include <cstdint>
#include <type_traits>
#include <utility>

#include "gf.cuh"

namespace fecc {

// ---------------------------------------------------------------------------
// Compile-time field constants (the values of fastecc_tpu_torch/fields.py
// and ntt.py's tables, computed by the compiler).
// ---------------------------------------------------------------------------

__host__ __device__ constexpr uint64_t modulus(int f) {
  return f == kGF32 ? kP32 : kP16;
}

__host__ __device__ constexpr uint64_t pow_mod(uint64_t a, uint64_t e,
                                               uint64_t p) {
  uint64_t r = 1;
  a %= p;
  while (e) {
    if (e & 1) r = r * a % p;
    a = a * a % p;
    e >>= 1;
  }
  return r;
}

// Prepared w_m^j, w = root_of_order(m) (its inverse if `inv`): the same
// value as ntt._stage_twiddles(field, m, inv)[j] for j < m / 2. GF32
// constants are Montgomery-prepared (c * 2^32 mod p), GF16 ones plain.
__host__ __device__ constexpr uint32_t root_pow(int f, bool inv, int m,
                                                int j) {
  const uint64_t p = modulus(f);
  uint64_t w = pow_mod(f == kGF32 ? 19 : 3, (p - 1) / (uint64_t)m, p);
  if (inv) w = pow_mod(w, p - 2, p);
  const uint64_t c = pow_mod(w, (uint64_t)j, p);
  return (uint32_t)(f == kGF32 ? (c << 32) % p : c);
}

__host__ __device__ constexpr int log2i(int v) {
  return v <= 1 ? 0 : 1 + log2i(v >> 1);
}

__host__ __device__ constexpr int bitrev(int v, int bits) {
  int r = 0;
  for (int i = 0; i < bits; ++i) r |= ((v >> i) & 1) << (bits - 1 - i);
  return r;
}

// fn(std::integral_constant<int, I>{}) for I = 0 .. N-1, unrolled by the
// compiler: inside fn, decltype(arg)::value is a constant expression.
template <typename Fn, int... I>
__device__ __forceinline__ void static_for_(Fn& fn,
                                            std::integer_sequence<int, I...>) {
  (fn(std::integral_constant<int, I>{}), ...);
}

template <int N, typename Fn>
__device__ __forceinline__ void static_for(Fn&& fn) {
  static_for_(fn, std::make_integer_sequence<int, N>{});
}

// ---------------------------------------------------------------------------
// The register transform.
// ---------------------------------------------------------------------------

// In-place radix-2 DIF of the S elements r[OFF .. OFF + S): natural order
// in, r[OFF + bitrev(k)] = X[k] out. Stage h (half size) multiplies the
// difference at offset j by w_2h^j; j = 0 skips it. Stage constants are
// never p - 1, so GF16 takes the butterfly multiply mul_tw.
template <int F, bool INV, int S, int OFF, int N>
__device__ __forceinline__ void dif_regs(uint32_t (&r)[N]) {
  static_for<log2i(S)>([&](auto st) {
    constexpr int h = S >> (decltype(st)::value + 1);
    static_for<S / 2>([&](auto bt) {
      constexpr int j = decltype(bt)::value % h;
      constexpr int i0 = OFF + decltype(bt)::value / h * 2 * h + j;
      const uint32_t u = r[i0], v = r[i0 + h];
      r[i0] = add<F>(u, v);
      if constexpr (j == 0) {
        r[i0 + h] = sub<F>(u, v);
      } else {
        constexpr uint32_t w = root_pow(F, INV, 2 * h, j);
        r[i0 + h] = mul_tw<F>(sub<F>(u, v), w);
      }
    });
  });
}

// ---------------------------------------------------------------------------
// The split of an A-point column and a block's shape.
// ---------------------------------------------------------------------------

template <int LA>
struct RegSplit {
  static constexpr int A = 1 << LA;
  static constexpr int LA1 = (LA + 1) / 2, LA2 = LA / 2;
  static constexpr int A1 = 1 << LA1, A2 = 1 << LA2;
  // lanes a block holds: kTileWords / A, at most 32 (TL = 16 at A = 1024:
  // 64-byte row segments; 32, 128 bytes, at A <= 512)
  static constexpr int kTileWords = 16384;
  static constexpr int TL = (kTileWords >> LA) < 32 ? (kTileWords >> LA) : 32;
  static constexpr int kThreads = A2 * TL;   // one (n2, lane) each
  // Exchange row n2 holds A1 values of TL lanes plus TL words of padding:
  // a warp's 32 / TL columns n2 then write, and its columns k1 read,
  // 32 distinct banks.
  static constexpr int kRowWords = (A1 + 1) * TL;
  static constexpr int kExchWords = A2 * kRowWords;  // >= A * TL, the tile
  static constexpr int kTwStride = A1 + 1;           // padded table row
  static constexpr int kSmemWords = kExchWords + A2 * kTwStride;
};

// ---------------------------------------------------------------------------
// Asynchronous copies into shared memory (sm_80+ cp.async). A source size
// below the copy size zero-fills the rest; 0 reads nothing.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(uint32_t* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(uint32_t* dst, const void* src,
                                          int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Issue the copies of the [A, TL] tile of column b, lanes [l0, l0 + TL),
// of x viewed [A, B, L], into tile[a * TL + l]. `vec`: x is 16-byte
// aligned and L % 4 == 0, so a row segment is whole 16-byte chunks, each
// wholly inside or wholly past the lane edge.
template <class S>
__device__ __forceinline__ void load_tile_async(uint32_t* tile,
                                                const uint32_t* x, int B,
                                                int L, int b, int l0,
                                                bool vec) {
  const size_t row = (size_t)B * L;
  const uint32_t* base = x + (size_t)b * L + l0;
  if (vec) {
    constexpr int kChunks = S::A * S::TL / 4, kPerRow = S::TL / 4;
    static_for<(kChunks + S::kThreads - 1) / S::kThreads>([&](auto i) {
      const int c = threadIdx.x + decltype(i)::value * S::kThreads;
      if (kChunks % S::kThreads == 0 || c < kChunks) {
        const int a = c / kPerRow, l = (c % kPerRow) * 4;
        const bool in = l0 + l < L;
        cp_async16(tile + a * S::TL + l, in ? base + a * row + l : x,
                   in ? 16 : 0);
      }
    });
  } else {
    constexpr int kWords = S::A * S::TL;   // a multiple of kThreads
    static_for<kWords / S::kThreads>([&](auto i) {
      const int e = threadIdx.x + decltype(i)::value * S::kThreads;
      const int a = e / S::TL, l = e % S::TL;
      const bool in = l0 + l < L;
      cp_async4(tile + e, in ? base + a * row + l : x, in ? 4 : 0);
    });
  }
}

// Issue the copies of the [A2, A1] inner-twiddle table into rows of
// kTwStride words.
template <class S>
__device__ __forceinline__ void load_twiddles_async(uint32_t* dst,
                                                    const uint32_t* tw) {
  static_for<(S::A + S::kThreads - 1) / S::kThreads>([&](auto i) {
    const int e = threadIdx.x + decltype(i)::value * S::kThreads;
    if (S::A % S::kThreads == 0 || e < S::A)
      cp_async4(dst + e / S::A1 * S::kTwStride + e % S::A1, tw + e, 4);
  });
}

// Issue the copies of one [A] column of an [A, stride] table, dst[k] =
// src[k * stride] (the decode's table rows: K6's middle, K7-sel's
// factors and mask). The words lie `stride` apart, so 4-byte copies.
template <class S>
__device__ __forceinline__ void load_row_async(uint32_t* dst,
                                               const uint32_t* src,
                                               int stride) {
  static_for<(S::A + S::kThreads - 1) / S::kThreads>([&](auto i) {
    const int k = threadIdx.x + decltype(i)::value * S::kThreads;
    if (S::A % S::kThreads == 0 || k < S::A)
      cp_async4(dst + k, src + (size_t)k * stride, 4);
  });
}

// The A-point transform from step 1's registers on: r[n1] holds element
// n1 * A2 + t of lane column (t, l). The A1-point DIF on column n2 = t,
// the inner twiddles, the exchange through `tile`, step 2 on columns
// k1 = t + A2 j (j < A1 / A2). On return r[j * A2 + bitrev(k2)] holds
// X[k1 + A1 k2]; as k = t + A2 (j + (A1 / A2) k2), those are the A1
// elements of column n2 = t of a second transform of the same length
// (the seam's hand-off, col.cu). The exchange overwrites `tile`; its
// first barrier waits until every thread has done with it.
template <int F, bool INV, class S>
__device__ __forceinline__ void reg_transform_regs(uint32_t (&r)[S::A1],
                                                   uint32_t* tile,
                                                   const uint32_t* tw, int t,
                                                   int l) {
  dif_regs<F, INV, S::A1, 0>(r);
  __syncthreads();  // every column is in registers: the tile is free
  uint32_t* row = tile + t * S::kRowWords + l;
  const uint32_t* twr = tw + t * S::kTwStride;
  static_for<S::A1>([&](auto k1c) {
    constexpr int k1 = decltype(k1c)::value;
    constexpr int src = bitrev(k1, S::LA1);
    uint32_t v = r[src];
    // w_A^(n2 k1) can be p - 1 (GF16 0x10000): the full multiply
    if constexpr (k1 != 0) v = mul_full<F>(v, twr[k1]);
    row[k1 * S::TL] = v;
  });
  __syncthreads();
  static_for<S::A1 / S::A2>([&](auto jc) {
    constexpr int j = decltype(jc)::value;
    const uint32_t* col = tile + (t + S::A2 * j) * S::TL + l;
    static_for<S::A2>([&](auto n2) {
      r[j * S::A2 + decltype(n2)::value] =
          col[decltype(n2)::value * S::kRowWords];
    });
    dif_regs<F, INV, S::A2, j * S::A2>(r);
  });
}

// The A-point transform of lane column (t, l) of the tile: step 1 reads
// column n2 = t into registers, then reg_transform_regs. Callers have
// waited for the copies and synchronised.
template <int F, bool INV, class S>
__device__ __forceinline__ void reg_transform(uint32_t (&r)[S::A1],
                                              uint32_t* tile,
                                              const uint32_t* tw, int t,
                                              int l) {
  static_for<S::A1>([&](auto n1) {
    r[decltype(n1)::value] =
        tile[(decltype(n1)::value * S::A2 + t) * S::TL + l];
  });
  reg_transform_regs<F, INV, S>(r, tile, tw, t, l);
}

// reg_transform of the tile times a factor per row: step 1 reads element
// a = n1 * A2 + t as tile[a] * pre[a] (K4's and K5's input multiply, on
// the way from shared memory into the registers). pre is a shared [A]
// row; GF16 factors and elements can be 0x10000, hence the full multiply.
template <int F, bool INV, class S>
__device__ __forceinline__ void reg_transform(uint32_t (&r)[S::A1],
                                              uint32_t* tile,
                                              const uint32_t* tw,
                                              const uint32_t* pre, int t,
                                              int l) {
  static_for<S::A1>([&](auto n1) {
    constexpr int a0 = decltype(n1)::value * S::A2;
    r[decltype(n1)::value] =
        mul_full<F>(tile[(a0 + t) * S::TL + l], pre[a0 + t]);
  });
  reg_transform_regs<F, INV, S>(r, tile, tw, t, l);
}

}  // namespace fecc
