// Pass A, pass A with an input multiply, the two seams and the GF16 wire
// pair's first two passes for Hopper (sm_90a): kernels K1, K2, K4, K5,
// K6, K8 and K9 of the port, on the register-stage engine of
// regstages.cuh (as K3, K7 and K7-sel in row.cu), with a plain C
// interface loaded through ctypes (kernels/_build.py builds it;
// kernels/ntt_mfa.py col_pass, col_pass_pre, col_pass_vec, seam_pass,
// seam_pass_vec, col_pass_wire16 and seam_pass_wire16 wrap it).
//
// Replaces these Pallas TPU kernels of fastecc_tpu/kernels/ntt_mfa.py:
//   K1 fecc_col  <- _col_kernel  (pass A: C-point stages along axis 0 of
//                   [A = C, B = R, L] u32, x the four-step twiddle
//                   T[k, b], transposed write [R, C, L])
//   K2 fecc_seam <- _seam_kernel (the encode pair's middle pass: inverse
//                   R1-point stages, x pcol[k] * prow[b] = g^m, forward
//                   stages (C2 = R1), x T2[k, b], transposed write)
//   K4 fecc_col_pre <- _col_kernel_pre (K1 after x[m] *= g^m, m = r +
//                   R * c: the rank-1 pcol[k] * prow[b] of K2's middle,
//                   applied at the input; the rate-1/4 encode's cosets)
//   K5 fecc_col_vec <- _col_kernel_prevec (K1 after x[m] *= v[m], m =
//                   c * R + r, from a prepared [N] table: the decode's
//                   locator evaluations l(w^j))
//   K6 fecc_seam_vec <- _seam_kernel_vec (the decode pair's middle pass:
//                   K2 with the middle factor v[k * B + b] read from a
//                   prepared [N] table, the x d/dx table m mod p)
//   K8 fecc_col_wire16 <- _col_kernel_wire16 (the GF16 wire pair's pass
//                   A1: K1, inverse and scaled, on lo = x & 0xFFFF and on
//                   hi = x >> 16 of [C1, R1, Wu] u32 pairs, into half 0
//                   and half 1 of a [2, R1, C1, Wu] output)
//   K9 fecc_seam_wire16 <- _seam_kernel_wire16 (the GF16 wire pair's
//                   seam: K2 on the lo half and on the hi half)
// The output is the same canonical residues; how it gets there is the
// port's own.
//
// What bounds it on the H100: each moves 2 GiB in and 2 GiB out at the
// encode's shapes ([512, 1024, 1024], [1024, 512, 1024]; 2^29 elements),
// 1.2821 ms at 3.35 TB/s (K5 and K6 at the decode's [1024, 1024, 512] the
// same plus their 4 MB table; K4 at the rate-1/4 encode's [512, 512,
// 1024] half that). The first versions (modes of ntt_mfa.cu's pass
// kernel: K1 6.05, K2 10.10, K4 3.21, K5 6.84 and K6 10.35 ms) lost that
// to latency and to shared memory, as K3's did: one synchronous 4-byte
// load at a time, every Stockham stage a shared-memory round (five at
// A = 512, ten in the seam at 1024) with run-time index arithmetic and
// twiddles fetched from device memory, and a lane tile of 8192 / A lanes
// (32- or 64-byte row segments).
//
// What this design does about it, K3's schedule plus what pass A adds:
//   * the length is a template parameter (the C entry dispatches over
//     A = 2 .. 1024, both fields, K1, K4 and K5 in both directions), so
//     every index map, loop bound and small-transform twiddle is a
//     compile-time constant;
//   * the block's [A, TL] tile is in flight at once (cp.async, 16-byte
//     copies where aligned, one wait), with the inner-twiddle tables; while
//     the copies land, the block computes its per-row factors into shared
//     memory: T[k, b] = seed[k, b mod tr] * t0[b / tr, k] and, for K2 and
//     K4, pcol[k] * prow[b]; K5's input row and K6's middle row
//     v[k * B + b] are copied in with the tile (A 4-byte copies B words
//     apart: the table is 4 MB, and the lane tiles and neighbouring
//     columns that share its sectors find them in L2);
//   * each transform is one A1-point DIF in registers, the inner
//     twiddles, one exchange through padded shared rows, then A2-point
//     DIFs (reg_transform); K4 and K5 multiply each element by its row's
//     factor as step 1 reads it from the tile, so the input multiply
//     costs one shared load and one multiply an element and no register;
//   * the seam hands its first transform's output to the second without a
//     third exchange: thread t ends the first holding X[t + A2 n1] for
//     n1 = j + (A1 / A2) k2 in r[j A2 + bitrev(k2)], which is column
//     n2 = t of the second transform's step 1, so the middle multiply and
//     the second transform run straight on the registers (a compile-time
//     renaming); two exchanges in all, not three;
//   * each thread stores straight from registers, x T[k, b] from the
//     shared row: out[b, k, l] of [B, A, L], rows k = t + A2 j + A1 k2
//     L words apart; a warp's store covers 32 / TL whole row segments of
//     TL lanes (TL = 32 at A <= 512, 16 at 1024: 128- and 64-byte
//     segments), so no second round through shared memory;
//   * two blocks of 512 threads share an SM at A = 512 and 1024 (K2 and K6
//     at 1024: a 16,896-word exchange, two inner tables and two factor
//     rows, ~84 KB a block; K4 and K5 one inner table and two rows).
// Ragged lanes as in K3: zero-filled past L, never stored past L.
//
// K8 is K1's GF16 kernel run on both halves of the pairs in one block:
// step 1 splits each tile word into lo = x & 0xFFFF and hi = x >> 16 on
// its way into two register arrays (where K4 and K5 multiply), then the
// block runs lo's transform and hi's (hi's exchange reuses the tile
// after lo's last reads of it) and stores lo into half 0 and hi into
// half 1 of the output, x T[k, b]. One tile read and one T row serve
// both halves: measured against the half in the grid (a block a half, a
// column's two blocks side by side, the second tile read from L2), it
// took 16% less time at the wire encode's [64, 128, 16384] and 9% less
// at [128, 256, 4096] (option sweep). It holds twice the elements a
// thread (34 registers at C1 = 64, 64 at 128; 120-128 from 512 on, one
// block an SM, where the wire gate, C1 <= 128, never goes). It moves 4 bytes a pair in and 8 out
// (1.5 GiB at that shape); its first version (a mode of ntt_mfa.cu's
// pass kernel, 1.63 ms there) ran three Stockham rounds.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "gf.cuh"
#include "regstages.cuh"

namespace {

using fecc::RegSplit;
using fecc::mul_full;

constexpr int kMaxLog = 10;   // longest pass the splits give (1024)

struct ColArgs {
  const uint32_t* x;
  uint32_t* out;
  const uint32_t* tw1;   // [A2, A1] inner twiddles of the (first) transform
  const uint32_t* tw2;   // the seam's second (forward) transform
  const uint32_t* seed;  // [A, tr] four-step seeds
  const uint32_t* t0;    // [B / tr, A] four-step column bases
  const uint32_t* pcol;  // K2, K4: [A] rank-1 row factor
  const uint32_t* prow;  // K2, K4: [B] rank-1 column factor
  int B, L;              // columns (axis 1), lanes (axis 2)
  int log_tr;
  int lane_tiles;        // ceil(L / TL)
  int vec;               // x 16-byte aligned and L % 4 == 0
  const uint32_t* table;  // K5, K6: [A * B] factors v[k * B + b]
};

// The kernel's modes. The numbers are template arguments that
// sass_check.py keys the instantiations by: new modes take new numbers.
enum Mode : int { kCol = 0, kSeam = 1, kSeamVec = 2, kColPre = 3,
                  kColVec = 4, kColWire16 = 5 };

__host__ __device__ constexpr bool is_seam(int mode) {
  return mode == kSeam || mode == kSeamVec;
}

// A second [A] factor row: the seams' middle, K4's and K5's input.
__host__ __device__ constexpr bool has_row(int mode) {
  return mode != kCol && mode != kColWire16;
}

// Shared words of a block: the exchange (which holds the tile first), the
// inner tables, T's row and the second factor row.
template <int LA, int MODE>
constexpr int smem_words() {
  using S = RegSplit<LA>;
  return S::kExchWords + (is_seam(MODE) ? 2 : 1) * S::A2 * S::kTwStride +
         (has_row(MODE) ? 2 : 1) * S::A;
}

// Block = (column b, lane tile); thread = (t = n2, lane l). K1: MODE =
// kCol, INV the direction. K2: kSeam, INV = 1: the first transform
// inverse, the second forward. K6: kSeamVec, K2 with the middle row from
// the table. K4: kColPre, K1 with the rank-1 row at the input; K5:
// kColVec, K1 with the table row at the input. K8: kColWire16, K1
// (GF16, INV = 1) on the lo and the hi half of the pairs.
template <int F, int LA, int INV, int MODE>
__global__ void __launch_bounds__(RegSplit<LA>::kThreads)
    col_kernel(ColArgs p) {
  using S = RegSplit<LA>;
  constexpr int kTw = S::A2 * S::kTwStride;
  constexpr bool kSeamMode = is_seam(MODE);
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* tile = smem;
  uint32_t* tw1 = smem + S::kExchWords;
  uint32_t* tw2 = tw1 + kTw;                     // seam only
  uint32_t* fac = tw1 + (kSeamMode ? 2 : 1) * kTw;  // [A] T[k, b]
  uint32_t* mid = fac + S::A;   // [A] the seam's middle or K4/K5's input
  const int lt = blockIdx.x % p.lane_tiles;
  const int b = blockIdx.x / p.lane_tiles;
  const int l0 = lt * S::TL;
  fecc::load_tile_async<S>(tile, p.x, p.B, p.L, b, l0, p.vec != 0);
  fecc::load_twiddles_async<S>(tw1, p.tw1);
  if constexpr (kSeamMode) fecc::load_twiddles_async<S>(tw2, p.tw2);
  if constexpr (MODE == kSeamVec || MODE == kColVec)
    fecc::load_row_async<S>(mid, p.table + b, p.B);
  // while the copies land: T[k, b] = seed[k, b mod tr] * t0[b / tr, k]
  // and the rank-1 row pcol[k] * prow[b] (prepared x prepared stays
  // prepared; GF16 tables can hold 0x10000)
  constexpr bool kRank1 = MODE == kSeam || MODE == kColPre;
  const int j = b & ((1 << p.log_tr) - 1);
  const uint32_t* t0 = p.t0 + (size_t)(b >> p.log_tr) * S::A;
  const uint32_t pr = kRank1 ? p.prow[b] : 0u;
  for (int k = threadIdx.x; k < S::A; k += S::kThreads) {
    fac[k] = mul_full<F>(p.seed[(k << p.log_tr) + j], t0[k]);
    if constexpr (kRank1) mid[k] = mul_full<F>(p.pcol[k], pr);
  }
  fecc::cp_async_wait_all();
  __syncthreads();

  const int l = threadIdx.x % S::TL, t = threadIdx.x / S::TL;
  uint32_t r[S::A1];
  uint32_t hi[S::A1];   // K8's hi half
  if constexpr (MODE == kColPre || MODE == kColVec) {
    fecc::reg_transform<F, INV != 0, S>(r, tile, tw1, mid, t, l);
  } else if constexpr (MODE == kColWire16) {
    // step 1 splits each pair word; hi's exchange follows lo's last reads
    fecc::static_for<S::A1>([&](auto n1) {
      const uint32_t w = tile[(decltype(n1)::value * S::A2 + t) * S::TL + l];
      r[decltype(n1)::value] = w & 0xFFFFu;
      hi[decltype(n1)::value] = w >> 16;
    });
    fecc::reg_transform_regs<F, INV != 0, S>(r, tile, tw1, t, l);
    fecc::reg_transform_regs<F, INV != 0, S>(hi, tile, tw1, t, l);
  } else {
    fecc::reg_transform<F, INV != 0, S>(r, tile, tw1, t, l);
  }
  if constexpr (kSeamMode) {
    // the hand-off: y[n1] = X[t + A2 n1] * mid[t + A2 n1], with
    // n1 = j + (A1 / A2) k2 held in r[j A2 + bitrev(k2)], is step 1's
    // column n2 = t
    uint32_t y[S::A1];
    fecc::static_for<S::A1>([&](auto nc) {
      constexpr int n1 = decltype(nc)::value;
      constexpr int rho = S::A1 / S::A2;
      constexpr int src = n1 % rho * S::A2 + fecc::bitrev(n1 / rho, S::LA2);
      y[n1] = mul_full<F>(r[src], mid[t + S::A2 * n1]);
    });
    fecc::reg_transform_regs<F, false, S>(y, tile, tw2, t, l);
    fecc::static_for<S::A1>([&](auto nc) {
      r[decltype(nc)::value] = y[decltype(nc)::value];
    });
  }
  if (l0 + l >= p.L) return;
  // transposed: out[b, k1 + A1 k2, l] of [B, A, L], x T[k, b]
  auto store = [&](const uint32_t(&v)[S::A1], uint32_t* out) {
    fecc::static_for<S::A1 / S::A2>([&](auto jc) {
      constexpr int jj = decltype(jc)::value;
      const int k1 = t + S::A2 * jj;
      uint32_t* o = out + (size_t)k1 * p.L;
      fecc::static_for<S::A2>([&](auto k2c) {
        constexpr int k2 = decltype(k2c)::value;
        constexpr int src = jj * S::A2 + fecc::bitrev(k2, S::LA2);
        o[(size_t)(k2 * S::A1) * p.L] =
            mul_full<F>(v[src], fac[k1 + k2 * S::A1]);
      });
    });
  };
  uint32_t* out = p.out + (size_t)b * S::A * p.L + l0 + l;
  store(r, out);
  // K8: hi into half 1 of [2, B, A, L]
  if constexpr (MODE == kColWire16) store(hi, out + (size_t)S::A * p.B * p.L);
}

template <int F, int LA, int INV, int MODE>
cudaError_t launch(ColArgs p, cudaStream_t stream) {
  using S = RegSplit<LA>;
  const size_t smem = (size_t)smem_words<LA, MODE>() * sizeof(uint32_t);
  auto kernel = col_kernel<F, LA, INV, MODE>;
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

// The seams run their first transform inverse; K1, K4 and K5 either way;
// K8 is GF16 and inverse only (its lanes are u16 wire words).
template <int LA, int MODE>
cudaError_t launch_mode(int field, bool inv, const ColArgs& p,
                        cudaStream_t s) {
  if constexpr (MODE == kColWire16) {
    return field == fecc::kGF16 ? launch<fecc::kGF16, LA, 1, MODE>(p, s)
                                : cudaErrorInvalidValue;
  } else if constexpr (is_seam(MODE)) {
    return field == fecc::kGF32 ? launch<fecc::kGF32, LA, 1, MODE>(p, s)
                                : launch<fecc::kGF16, LA, 1, MODE>(p, s);
  } else {
    if (field == fecc::kGF32)
      return inv ? launch<fecc::kGF32, LA, 1, MODE>(p, s)
                 : launch<fecc::kGF32, LA, 0, MODE>(p, s);
    return inv ? launch<fecc::kGF16, LA, 1, MODE>(p, s)
               : launch<fecc::kGF16, LA, 0, MODE>(p, s);
  }
}

template <int LA>
cudaError_t dispatch(int la, int field, bool inv, int mode, const ColArgs& p,
                     cudaStream_t s) {
  if constexpr (LA > kMaxLog) {
    return cudaErrorInvalidValue;
  } else {
    if (la != LA) return dispatch<LA + 1>(la, field, inv, mode, p, s);
    switch (mode) {
      case kSeam: return launch_mode<LA, kSeam>(field, inv, p, s);
      case kSeamVec: return launch_mode<LA, kSeamVec>(field, inv, p, s);
      case kColPre: return launch_mode<LA, kColPre>(field, inv, p, s);
      case kColVec: return launch_mode<LA, kColVec>(field, inv, p, s);
      case kColWire16: return launch_mode<LA, kColWire16>(field, inv, p, s);
      default: return launch_mode<LA, kCol>(field, inv, p, s);
    }
  }
}

int log2_exact(int v) {
  int t = 0;
  while ((1 << t) < v) ++t;
  return (1 << t) == v ? t : -1;
}

int run(int field, bool inv, Mode mode, ColArgs p, int A, int tr,
        void* stream) {
  const int la = log2_exact(A);
  p.log_tr = log2_exact(tr);
  if (la < 1 || la > kMaxLog || p.B < 1 || p.L < 1 || p.log_tr < 0)
    return (int)cudaErrorInvalidValue;
  p.vec = ((uintptr_t)p.x % 16 == 0) && (p.L % 4 == 0);
  return (int)dispatch<1>(la, field, inv, mode, p, (cudaStream_t)stream);
}

// The arguments K1, K4 and K5 share: pass A over [A=C, B=R, L].
ColArgs col_args(const void* x, void* out, int B, int L, const void* tw,
                 const void* seed, const void* t0) {
  ColArgs p{};
  p.x = (const uint32_t*)x;
  p.out = (uint32_t*)out;
  p.tw1 = (const uint32_t*)tw;
  p.seed = (const uint32_t*)seed;
  p.t0 = (const uint32_t*)t0;
  p.B = B;
  p.L = L;
  return p;
}

}  // namespace

extern "C" {

// K1: [A=C, B=R, L] -> [R, C, L]; C-point forward (inverse != 0: inverse)
// stages, x T[k_c, r], transpose. tw: the [A2, A1] inner twiddles of
// kernels/ntt_mfa.py _row_inner_twiddles; seed [C, tr], t0 [R / tr, C]
// (N^-1 folded into t0 for a scaled inverse).
int fecc_col(int field, const void* x, void* out, int A, int B, int L,
             int inverse, const void* tw, const void* seed, const void* t0,
             int tr, void* stream) {
  return run(field, inverse != 0, kCol, col_args(x, out, B, L, tw, seed, t0),
             A, tr, stream);
}

// K4: K1 with x[a, b] *= pcol[a] * prow[b] (g^m, m = b + B * a) first.
int fecc_col_pre(int field, const void* x, void* out, int A, int B, int L,
                 int inverse, const void* tw, const void* seed,
                 const void* t0, int tr, const void* pcol, const void* prow,
                 void* stream) {
  ColArgs p = col_args(x, out, B, L, tw, seed, t0);
  p.pcol = (const uint32_t*)pcol;
  p.prow = (const uint32_t*)prow;
  return run(field, inverse != 0, kColPre, p, A, tr, stream);
}

// K5: K1 with x[a, b] *= vec[a * B + b] (a prepared [A * B] table) first.
int fecc_col_vec(int field, const void* x, void* out, int A, int B, int L,
                 int inverse, const void* tw, const void* seed,
                 const void* t0, int tr, const void* vec, void* stream) {
  ColArgs p = col_args(x, out, B, L, tw, seed, t0);
  p.table = (const uint32_t*)vec;
  return run(field, inverse != 0, kColVec, p, A, tr, stream);
}

// K8: [A=C1, B=R1, L=Wu] u32 pairs of LE u16 words -> [2, R1, C1, L]:
// K1 (GF16, inverse; N^-1 folded into t0) on lo = x & 0xFFFF (half 0)
// and on hi = x >> 16 (half 1). tw: the [A2, A1] inverse inner twiddles.
int fecc_col_wire16(int field, const void* x, void* out, int A, int B,
                    int L, const void* tw, const void* seed, const void* t0,
                    int tr, void* stream) {
  return run(field, true, kColWire16, col_args(x, out, B, L, tw, seed, t0),
             A, tr, stream);
}

// K2: [A=R1, B=C1, L] -> [C1, R1, L]; inverse R1-point stages (inner
// table tw_inv), x pcol[k] * prow[b] (rank-1 g^m), forward stages
// (tw_fwd), x T2, transpose.
int fecc_seam(int field, const void* x, void* out, int A, int B, int L,
              const void* tw_inv, const void* tw_fwd, const void* seed,
              const void* t0, int tr, const void* pcol, const void* prow,
              void* stream) {
  ColArgs p{};
  p.x = (const uint32_t*)x;
  p.out = (uint32_t*)out;
  p.tw1 = (const uint32_t*)tw_inv;
  p.tw2 = (const uint32_t*)tw_fwd;
  p.seed = (const uint32_t*)seed;
  p.t0 = (const uint32_t*)t0;
  p.pcol = (const uint32_t*)pcol;
  p.prow = (const uint32_t*)prow;
  p.B = B;
  p.L = L;
  return run(field, true, kSeam, p, A, tr, stream);
}

// K9: [2, A=R1, B=C1, L] -> [2, C1, R1, L]; K2 (GF16) on each half of the
// wire pair, one launch a half (each half is contiguous, and 16-byte
// aligned where x is and L % 4 == 0, as the wire pair's L % 8 == 0 gives).
int fecc_seam_wire16(int field, const void* x, void* out, int A, int B,
                     int L, const void* tw_inv, const void* tw_fwd,
                     const void* seed, const void* t0, int tr,
                     const void* pcol, const void* prow, void* stream) {
  if (field != fecc::kGF16) return (int)cudaErrorInvalidValue;
  const size_t half = (size_t)A * B * L;
  for (int h = 0; h < 2; ++h) {
    const int e = fecc_seam(field, (const uint32_t*)x + h * half,
                            (uint32_t*)out + h * half, A, B, L, tw_inv,
                            tw_fwd, seed, t0, tr, pcol, prow, stream);
    if (e != 0) return e;
  }
  return 0;
}

// K6: K2 with the middle factor v[k * B + b] (k = c2, b = r2: the
// decode's x d/dx table m mod p) from the prepared [A * B] table `vec`.
int fecc_seam_vec(int field, const void* x, void* out, int A, int B, int L,
                  const void* tw_inv, const void* tw_fwd, const void* seed,
                  const void* t0, int tr, const void* vec, void* stream) {
  ColArgs p{};
  p.x = (const uint32_t*)x;
  p.out = (uint32_t*)out;
  p.tw1 = (const uint32_t*)tw_inv;
  p.tw2 = (const uint32_t*)tw_fwd;
  p.seed = (const uint32_t*)seed;
  p.t0 = (const uint32_t*)t0;
  p.table = (const uint32_t*)vec;
  p.B = B;
  p.L = L;
  return run(field, true, kSeamVec, p, A, tr, stream);
}

}  // extern "C"
