// Fused four-step NTT passes for Hopper (sm_90a): kernels K1-K7 of the
// port, with a plain C interface loaded through ctypes
// (fastecc_tpu_torch/kernels/_build.py builds it; kernels/ntt_mfa.py
// wraps it).
//
// Replaces these Pallas TPU kernels of fastecc_tpu/kernels/ntt_mfa.py:
//   K1 fecc_col      <- _col_kernel      (pass A: C-point stages,
//                       four-step twiddle, transposed write)
//   K4 fecc_col_pre  <- _col_kernel_pre  (K1 with the rank-1 x[m] *= g^m
//                       prologue)
//   K2 fecc_seam     <- _seam_kernel     (the encode pair's middle pass:
//                       inverse stages, coset multiply, forward stages,
//                       four-step twiddle, transposed write)
//   K3 fecc_row      <- _row_kernel      (pass B: R-point stages,
//                       natural-order write)
// and the decode fusions, each with a general prepared [N] table v:
//   K5 fecc_col_vec      <- _col_kernel_prevec  (K1 with x[m] *= v[m]:
//                           the locator evaluations l(w^j))
//   K6 fecc_seam_vec     <- _seam_kernel_vec    (K2 with the middle
//                           multiply by v[m]: the x d/dx table m mod p)
//   K7 fecc_row_post     <- _row_kernel_post    (K3, then out[k] *= v[k]:
//                           the Forney inverse derivative)
//   K7-sel fecc_row_post_sel <- _row_kernel_post_sel (K7, then
//                           out[k] = mask[k] ? out[k] : orig[k]: the
//                           erased-row merge)
// They compute what the Pallas kernels compute, not how: the output is
// bit-identical (canonical residues), while the C x R split, the tile and
// the twiddle tables are this port's own.
//
// Every pass views its input as [A, B, L] u32 (the transform runs along A,
// lanes L are contiguous in memory) and gives each block one column b and
// a tile of TL lanes. The block loads the [A, TL] column into shared
// memory (neighbouring threads on neighbouring lanes), runs every
// Stockham stage there (radix 4, one leading radix-2 stage when log2 A is
// odd) ping-ponging between two buffers, and writes the tile once. So a
// pass moves each element through device memory once in and once out,
// whatever the number of stages.
//
// In every pass the element (a, b) of the [A, B] view is index a * B + b
// of the natural-order [N] sequence the reference's table is laid over
// (K5: m = c * R + r; K6: m = c2 * R2 + r2 with C2 = R1, R2 = C1; K7:
// k = k_r * C + k_c), so a block loads its A table words v[a * B + b]
// once into shared memory (`vec_row`) beside the tile; the reference's
// reshape/transpose of the tables was a Mosaic layout device, not
// ported. Table traffic is N words a pass against the N * L of the data.
// Every table multiply is the full `mul_full`: a GF16 table can hold
// 0x10000 (l(w^j) or inv(x l') equal to p - 1). K7-sel reads `orig`
// only at rows whose mask is 0 (bit-identical to the select, and at
// e = n/2 a sixth less traffic than reading it everywhere), and
// multiplies only at rows whose mask is set.
//
// What bounds it on the H100: at the encode's main path (k = 2^19 rows x
// 1024 lanes, 2 GiB per pass each way) a pass's floor is its 4 GiB of
// device-memory traffic, ~1.28 ms at 3.35 TB/s. Even the seam, with two
// transforms and 12 mulmods per element, stays under that in integer
// multiplies: for p = 0xFFF00001 a mulmod needs only the two words of
// a * b (the REDC's m and m * p are shift/add chains), ~0.77 ms. This
// first version is simple and right: TL = 8192 / A lanes (8 to 32 for
// A <= 1024) keeps both buffers at 32 KB so three blocks share an SM; no
// TMA, cp.async ring or persistent blocks yet (later work). Ragged lane
// edges are masked.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "gf.cuh"

namespace {

using fecc::add;
using fecc::mul_full;
using fecc::mul_tw;
using fecc::sub;

constexpr int kThreads = 256;
constexpr int kTileWords = 8192;  // A * TL words per buffer (32 KB)
constexpr int kMaxLaneTile = 32;
constexpr int kMaxLen = 1024;     // longest pass the splits give (2^20)

enum Mode : int {
  kCol = 0, kColPre = 1, kSeam = 2, kRow = 3,
  kColVec = 4, kSeamVec = 5, kRowPost = 6, kRowPostSel = 7
};

__host__ __device__ constexpr bool is_row(int mode) {
  return mode == kRow || mode == kRowPost || mode == kRowPostSel;
}

// Shared words beyond the two tile buffers: one [A] row of factors, and
// for K7-sel a second [A] row for the mask.
constexpr int scratch_rows(int mode) { return mode == kRowPostSel ? 2 : 1; }

struct PassArgs {
  const uint32_t* x;
  uint32_t* out;
  int A, log_a;          // transform length along axis 0
  int B;                 // columns (axis 1)
  int L;                 // lanes (axis 2)
  int log_tl;            // lane tile TL = 2^log_tl
  int lane_tiles;        // ceil(L / TL)
  const uint32_t* tw1;   // packed stage tables, first transform
  const uint32_t* w31;   // packed radix-4 w^3j tables, first transform
  const uint32_t* tw2;   // second transform (seam only)
  const uint32_t* w32;
  const uint32_t* seed;  // [A, tr] four-step seeds
  const uint32_t* t0;    // [B / tr, A] four-step column bases
  int log_tr;
  const uint32_t* pcol;  // [A] rank-1 multiply, row factor
  const uint32_t* prow;  // [B] rank-1 multiply, column factor
};

// The decode operands travel in a second kernel parameter. Kept in
// PassArgs they grow it past 128 bytes, and NVVM then reads its fields
// through a pointer into the parameter space near each use instead of
// once at entry: on the H100 that made K1 9% and K3 5% slower (a
// 136-byte against a 112-byte PassArgs, same kernels, same inputs).
struct TableArgs {
  const uint32_t* vec;   // [A * B] general table (K5, K6, K7)
  const uint32_t* mask;  // [A * B] erased-row mask (K7-sel)
  const uint32_t* orig;  // [A, B, L] rows kept where mask is 0 (K7-sel)
};

// One radix-2 Stockham DIF stage of size a = A >> s (d = 2^s finished
// sub-transforms): y[i, j] viewed [a, d] -> out[i, bit, j] viewed
// [a/2, 2d].
template <int F>
__device__ __forceinline__ void stage_r2(const uint32_t* src, uint32_t* dst,
                                         int A, int s, int log_tl,
                                         const uint32_t* __restrict__ tw) {
  const int tl_mask = (1 << log_tl) - 1;
  const int half_all = A >> 1;
  const int d = 1 << s;
  for (int e = threadIdx.x; e < (half_all << log_tl); e += blockDim.x) {
    int l = e & tl_mask, idx = e >> log_tl;
    int i = idx >> s, j = idx & (d - 1);
    uint32_t u = src[e], v = src[e + (half_all << log_tl)];
    int o = ((i << (s + 1)) + j) << log_tl | l;
    dst[o] = add<F>(u, v);
    dst[o + (d << log_tl)] = mul_tw<F>(sub<F>(u, v), tw[i]);
  }
}

// One radix-4 stage (two radix-2 stages fused; slot order
// (stage2_bit, stage1_bit) as in fastecc_tpu/ntt.py::_stage_r4). The
// operands come from the packed tables at this stage's offset: w^j and
// i4 = w^(a/4) from stage a's table, w^2j from stage a/2's, w^3j from the
// side table.
template <int F>
__device__ __forceinline__ void stage_r4(const uint32_t* src, uint32_t* dst,
                                         int A, int s, int log_tl,
                                         const uint32_t* __restrict__ tw,
                                         const uint32_t* __restrict__ w3) {
  const int tl_mask = (1 << log_tl) - 1;
  const int quarter = (A >> 2) << log_tl;
  const int q = (A >> s) >> 2;
  const int d = 1 << s;
  const uint32_t i4 = tw[q];
  for (int e = threadIdx.x; e < quarter; e += blockDim.x) {
    int l = e & tl_mask, idx = e >> log_tl;
    int i = idx >> s, j = idx & (d - 1);
    uint32_t x0 = src[e], x1 = src[e + quarter];
    uint32_t x2 = src[e + 2 * quarter], x3 = src[e + 3 * quarter];
    uint32_t s0 = add<F>(x0, x2), s1 = add<F>(x1, x3);
    uint32_t d0 = sub<F>(x0, x2);
    uint32_t d1 = mul_tw<F>(sub<F>(x1, x3), i4);
    int o = ((i << (s + 2)) + j) << log_tl | l;
    int step = d << log_tl;
    dst[o] = add<F>(s0, s1);
    dst[o + step] = mul_tw<F>(add<F>(d0, d1), tw[i]);
    dst[o + 2 * step] = mul_tw<F>(sub<F>(s0, s1), tw[2 * q + i]);
    dst[o + 3 * step] = mul_tw<F>(sub<F>(d0, d1), w3[i]);
  }
}

// All stages of an A-point transform on the [A, TL] tile in `src`;
// returns the buffer that holds the result. Callers synchronise before.
template <int F>
__device__ uint32_t* run_stages(uint32_t* src, uint32_t* dst, int A,
                                int log_a, int log_tl,
                                const uint32_t* __restrict__ tw,
                                const uint32_t* __restrict__ w3) {
  int off = 0, s = 0;
  if (log_a & 1) {
    stage_r2<F>(src, dst, A, 0, log_tl, tw);
    off += A >> 1;
    s = 1;
    uint32_t* t = src; src = dst; dst = t;
    __syncthreads();
  }
  while (s < log_a) {
    stage_r4<F>(src, dst, A, s, log_tl, tw + off, w3 + off);
    off += 3 * ((A >> s) >> 2);
    s += 2;
    uint32_t* t = src; src = dst; dst = t;
    __syncthreads();
  }
  return src;
}

// scratch[a] = pcol[a] * prow[b] (a rank-1 row of g^m, m = a * B + b).
template <int F>
__device__ __forceinline__ void rank1_row(uint32_t* scratch, const PassArgs& p,
                                          int b) {
  const uint32_t pr = p.prow[b];
  for (int a = threadIdx.x; a < p.A; a += blockDim.x)
    scratch[a] = mul_full<F>(p.pcol[a], pr);
}

// scratch[a] = v[a * B + b] (column b of a general [A, B] table).
__device__ __forceinline__ void vec_row(uint32_t* scratch,
                                        const uint32_t* __restrict__ v,
                                        int A, int B, int b) {
  for (int a = threadIdx.x; a < A; a += blockDim.x)
    scratch[a] = v[(size_t)a * B + b];
}

template <int F, int MODE>
__global__ void __launch_bounds__(kThreads) pass_kernel(PassArgs p,
                                                        TableArgs t) {
  extern __shared__ uint32_t smem[];
  const int tile = p.A << p.log_tl;
  uint32_t* buf0 = smem;
  uint32_t* buf1 = smem + tile;
  uint32_t* scratch = smem + 2 * tile;  // [A] per-row factors
  const int tl_mask = (1 << p.log_tl) - 1;
  const int lt = blockIdx.x % p.lane_tiles;
  const int b = blockIdx.x / p.lane_tiles;
  const int l0 = lt << p.log_tl;

  if (MODE == kColPre) rank1_row<F>(scratch, p, b);
  if (MODE == kColVec) vec_row(scratch, t.vec, p.A, p.B, b);
  if (MODE == kColPre || MODE == kColVec) __syncthreads();
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    int l = e & tl_mask, a = e >> p.log_tl;
    uint32_t v = 0;
    if (l0 + l < p.L) v = p.x[((size_t)a * p.B + b) * p.L + l0 + l];
    if (MODE == kColPre || MODE == kColVec) v = mul_full<F>(v, scratch[a]);
    buf0[e] = v;
  }
  __syncthreads();
  uint32_t* y = run_stages<F>(buf0, buf1, p.A, p.log_a, p.log_tl, p.tw1, p.w31);

  if (MODE == kSeam || MODE == kSeamVec) {
    if (MODE == kSeam) rank1_row<F>(scratch, p, b);
    else vec_row(scratch, t.vec, p.A, p.B, b);
    __syncthreads();
    for (int e = threadIdx.x; e < tile; e += blockDim.x)
      y[e] = mul_full<F>(y[e], scratch[e >> p.log_tl]);
    __syncthreads();
    y = run_stages<F>(y, y == buf0 ? buf1 : buf0, p.A, p.log_a, p.log_tl,
                      p.tw2, p.w32);
  }

  if (is_row(MODE)) {
    uint32_t* mrow = scratch + p.A;
    if (MODE != kRow) vec_row(scratch, t.vec, p.A, p.B, b);
    if (MODE == kRowPostSel) vec_row(mrow, t.mask, p.A, p.B, b);
    if (MODE != kRow) __syncthreads();
    // natural order: out[k, b, l] of [A, B, L]
    for (int e = threadIdx.x; e < tile; e += blockDim.x) {
      int l = e & tl_mask, k = e >> p.log_tl;
      if (l0 + l >= p.L) continue;
      size_t o = ((size_t)k * p.B + b) * p.L + l0 + l;
      uint32_t v = y[e];
      if (MODE == kRowPost) v = mul_full<F>(v, scratch[k]);
      if (MODE == kRowPostSel)
        v = mrow[k] != 0u ? mul_full<F>(v, scratch[k]) : t.orig[o];
      p.out[o] = v;
    }
    return;
  }

  // four-step twiddle T[k, b] = seed[k, b % tr] * t0[b / tr, k] (product
  // of prepared values stays prepared), then the transposed write
  // out[b, k, l] of [B, A, L]
  const int j = b & ((1 << p.log_tr) - 1);
  const size_t t0_row = (size_t)(b >> p.log_tr) * p.A;
  for (int k = threadIdx.x; k < p.A; k += blockDim.x)
    scratch[k] = mul_full<F>(p.seed[(k << p.log_tr) + j], p.t0[t0_row + k]);
  __syncthreads();
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    int l = e & tl_mask, k = e >> p.log_tl;
    if (l0 + l < p.L)
      p.out[((size_t)b * p.A + k) * p.L + l0 + l] = mul_full<F>(y[e], scratch[k]);
  }
}

int log2_exact(int v) {
  int t = 0;
  while ((1 << t) < v) ++t;
  return (1 << t) == v ? t : -1;
}

template <int F, int MODE>
cudaError_t launch(PassArgs p, TableArgs t, cudaStream_t stream) {
  size_t smem = (2 * ((size_t)p.A << p.log_tl) + scratch_rows(MODE) * p.A) *
                sizeof(uint32_t);
  auto kernel = pass_kernel<F, MODE>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  unsigned blocks = (unsigned)p.B * (unsigned)p.lane_tiles;
  kernel<<<blocks, kThreads, smem, stream>>>(p, t);
  return cudaGetLastError();
}

template <int MODE>
int run(int field, PassArgs p, void* stream, TableArgs t = {}) {
  p.log_a = log2_exact(p.A);
  if (p.log_a < 1 || p.A > kMaxLen || p.B < 1 || p.L < 1 || p.log_tr < 0)
    return (int)cudaErrorInvalidValue;
  int tl = kTileWords / p.A;
  if (tl > kMaxLaneTile) tl = kMaxLaneTile;
  p.log_tl = log2_exact(tl);
  p.lane_tiles = (p.L + tl - 1) / tl;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = field == fecc::kGF32 ? launch<fecc::kGF32, MODE>(p, t, s)
                                       : launch<fecc::kGF16, MODE>(p, t, s);
  return (int)e;
}

PassArgs base_args(const void* x, void* out, int A, int B, int L) {
  PassArgs p{};
  p.x = (const uint32_t*)x;
  p.out = (uint32_t*)out;
  p.A = A;
  p.B = B;
  p.L = L;
  return p;
}

}  // namespace

extern "C" {

// K1: [A=C, B=R, L] -> [R, C, L]; C-point stages, x T[k_c, r], transpose.
int fecc_col(int field, const void* x, void* out, int A, int B, int L,
             const void* tw, const void* w3, const void* seed, const void* t0,
             int tr, void* stream) {
  PassArgs p = base_args(x, out, A, B, L);
  p.tw1 = (const uint32_t*)tw;
  p.w31 = (const uint32_t*)w3;
  p.seed = (const uint32_t*)seed;
  p.t0 = (const uint32_t*)t0;
  p.log_tr = log2_exact(tr);
  return run<kCol>(field, p, stream);
}

// K4: K1 with x[a, b] *= pcol[a] * prow[b] before the stages.
int fecc_col_pre(int field, const void* x, void* out, int A, int B, int L,
                 const void* tw, const void* w3, const void* seed,
                 const void* t0, int tr, const void* pcol, const void* prow,
                 void* stream) {
  PassArgs p = base_args(x, out, A, B, L);
  p.tw1 = (const uint32_t*)tw;
  p.w31 = (const uint32_t*)w3;
  p.seed = (const uint32_t*)seed;
  p.t0 = (const uint32_t*)t0;
  p.log_tr = log2_exact(tr);
  p.pcol = (const uint32_t*)pcol;
  p.prow = (const uint32_t*)prow;
  return run<kColPre>(field, p, stream);
}

// K2: [A=R1, B=C1, L] -> [C1, R1, L]; inverse R1-point stages, x g^m
// (rank-1), forward stages, x T2, transpose.
int fecc_seam(int field, const void* x, void* out, int A, int B, int L,
              const void* tw1, const void* w31, const void* tw2,
              const void* w32, const void* seed, const void* t0, int tr,
              const void* pcol, const void* prow, void* stream) {
  PassArgs p = base_args(x, out, A, B, L);
  p.tw1 = (const uint32_t*)tw1;
  p.w31 = (const uint32_t*)w31;
  p.tw2 = (const uint32_t*)tw2;
  p.w32 = (const uint32_t*)w32;
  p.seed = (const uint32_t*)seed;
  p.t0 = (const uint32_t*)t0;
  p.log_tr = log2_exact(tr);
  p.pcol = (const uint32_t*)pcol;
  p.prow = (const uint32_t*)prow;
  return run<kSeam>(field, p, stream);
}

// K3: [A=R, B=C, L] -> [R, C, L]; R-point stages, natural-order write.
int fecc_row(int field, const void* x, void* out, int A, int B, int L,
             const void* tw, const void* w3, void* stream) {
  PassArgs p = base_args(x, out, A, B, L);
  p.tw1 = (const uint32_t*)tw;
  p.w31 = (const uint32_t*)w3;
  return run<kRow>(field, p, stream);
}

// K5: K1 with x[a, b] *= vec[a * B + b] before the stages.
int fecc_col_vec(int field, const void* x, void* out, int A, int B, int L,
                 const void* tw, const void* w3, const void* seed,
                 const void* t0, int tr, const void* vec, void* stream) {
  PassArgs p = base_args(x, out, A, B, L);
  p.tw1 = (const uint32_t*)tw;
  p.w31 = (const uint32_t*)w3;
  p.seed = (const uint32_t*)seed;
  p.t0 = (const uint32_t*)t0;
  p.log_tr = log2_exact(tr);
  return run<kColVec>(field, p, stream, {(const uint32_t*)vec});
}

// K6: K2 with the middle multiply y[a, b] *= vec[a * B + b] (a = c2,
// b = r2) instead of the rank-1 g^m.
int fecc_seam_vec(int field, const void* x, void* out, int A, int B, int L,
                  const void* tw1, const void* w31, const void* tw2,
                  const void* w32, const void* seed, const void* t0, int tr,
                  const void* vec, void* stream) {
  PassArgs p = base_args(x, out, A, B, L);
  p.tw1 = (const uint32_t*)tw1;
  p.w31 = (const uint32_t*)w31;
  p.tw2 = (const uint32_t*)tw2;
  p.w32 = (const uint32_t*)w32;
  p.seed = (const uint32_t*)seed;
  p.t0 = (const uint32_t*)t0;
  p.log_tr = log2_exact(tr);
  return run<kSeamVec>(field, p, stream, {(const uint32_t*)vec});
}

// K7: K3, then out[k, b] *= vec[k * B + b].
int fecc_row_post(int field, const void* x, void* out, int A, int B, int L,
                  const void* tw, const void* w3, const void* vec,
                  void* stream) {
  PassArgs p = base_args(x, out, A, B, L);
  p.tw1 = (const uint32_t*)tw;
  p.w31 = (const uint32_t*)w3;
  return run<kRowPost>(field, p, stream, {(const uint32_t*)vec});
}

// K7-sel: K7 where mask[k * B + b] != 0, orig[k, b, :] elsewhere.
int fecc_row_post_sel(int field, const void* x, void* out, int A, int B,
                      int L, const void* tw, const void* w3, const void* vec,
                      const void* mask, const void* orig, void* stream) {
  PassArgs p = base_args(x, out, A, B, L);
  p.tw1 = (const uint32_t*)tw;
  p.w31 = (const uint32_t*)w3;
  return run<kRowPostSel>(field, p, stream,
                           {(const uint32_t*)vec, (const uint32_t*)mask,
                            (const uint32_t*)orig});
}

const char* fecc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
