// Fused four-step NTT passes for Hopper (sm_90a): kernels K7, K8 and K10
// of the port, with a plain C interface loaded through ctypes
// (fastecc_tpu_torch/kernels/_build.py builds it; kernels/ntt_mfa.py
// wraps it).
//
// (K1 and K4 pass A, K5 pass A with the decode's table multiply, K2 the
// encode seam, K3 pass B, K6 the decode seam, K7-sel and K9 (K2 on each
// half of the wire pair) are kernels of their own on the register-stage
// engine regstages.cuh: col.cu, row.cu.)
// Replaces these Pallas TPU kernels of fastecc_tpu/kernels/ntt_mfa.py,
// the decode fusion with a general prepared [N] table v:
//   K7 fecc_row_post     <- _row_kernel_post    (K3, then out[k] *= v[k]:
//                           the Forney inverse derivative)
// and the GF16 wire pair, whose lanes are u32 pairs of little-endian u16
// wire words:
//   K8 fecc_col_wire16  <- _col_kernel_wire16  (K1 on lo = x & 0xFFFF and
//                          on hi = x >> 16)
//   K10 fecc_row_wire16 <- _row_kernel_wire16  (K3 on lo and on hi, then
//                          stored = lo16 | hi16 << 16 and the escape
//                          bitmap)
// They compute what the Pallas kernels compute, not how: the output is
// bit-identical (canonical residues), while the C x R split, the tile and
// the twiddle tables are this port's own.
//
// Every pass views its input as [A, B, L] u32 (the transform runs along A,
// lanes L are contiguous in memory) and gives each block one column b and
// a tile of TL lanes. The block loads the [A, TL] column into shared
// memory (neighbouring threads on neighbouring lanes), runs every
// Stockham stage there (radix 4, one leading radix-2 stage when log2 A is
// odd; stages.cuh) ping-ponging between two buffers, and writes the tile
// once. So a
// pass moves each element through device memory once in and once out,
// whatever the number of stages.
//
// In K7 the element (a, b) of the [A, B] view is index a * B + b of the
// natural-order [N] sequence the reference's table is laid over (k =
// k_r * C + k_c), so a block loads its A table words v[a * B + b] once
// into shared memory (`vec_row`) beside the tile; the reference's
// reshape/transpose of the tables was a Mosaic layout device, not
// ported. Table traffic is N words a pass against the N * L of the data.
// Every table multiply is the full `mul_full`: a GF16 table can hold
// 0x10000 (inv(x l') equal to p - 1).
//
// What bounds it on the H100: at 2^29 elements (the decode's 2^20 rows x
// 512 lanes, 2 GiB per pass each way) a pass's floor is its 4 GiB of
// device-memory traffic, ~1.28 ms at 3.35 TB/s. Even a seam, with two
// transforms and 12 mulmods per element, stays under that in integer
// multiplies: for p = 0xFFF00001 a mulmod needs only the two words of
// a * b (the REDC's m and m * p are shift/add chains), ~0.77 ms. This
// first version is simple and right: TL = 8192 / A lanes (8 to 32 for
// A <= 1024) keeps both buffers at 32 KB so three blocks share an SM; no
// TMA, cp.async ring or persistent blocks yet (later work). Ragged lane
// edges are masked.
//
// The wire pair. Lo and hi are independent lane sets; the reference kept
// them as two arrays only because a lane concatenate is a paid relayout
// on the TPU. Here K8 puts the half in the grid (the fastest block
// index, so a column's two blocks run side by side and its second read
// of the same input tile comes from L2) and keeps both halves in one
// [2, ...] tensor, which K9 (col.cu) takes half by half. K10 needs both
// halves of a row in one block to re-pack them, so it runs lo's stages,
// parks the result and runs hi's in a third
// tile buffer, then writes the stored words and one escape word per group
// of 8 lanes (bit 2t for lo, 2t + 1 for hi of lane 8g + t: v >> 16 is the
// escape flag, as GF16 values are <= 0x10000). The reference's MXU
// compaction and transposed bitmap were Mosaic workarounds, not ported.
// Its extra pointers ride TableArgs, which keeps PassArgs at 112 bytes.
// At the bench's shape (k = 2^13 blocks of 64 KB: 512 MiB of pairs in) the
// three passes move 1.5, 2 and 1.56 GiB, a 1.62 ms floor at 3.35 TB/s;
// their GF16 multiplies (one 32-bit product each) need under a tenth of
// that.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "gf.cuh"
#include "stages.cuh"

namespace {

using fecc::mul_full;

constexpr int kThreads = 256;
constexpr int kTileWords = 8192;  // A * TL words per buffer (32 KB)
constexpr int kMaxLaneTile = 32;
constexpr int kMaxLen = 1024;     // longest pass the splits give (2^20)

// (0-5, 7 and 9 were the modes of K1, K4, K2, K3, K5, K6, K7-sel and K9,
// kernels of their own now in col.cu and row.cu. The numbers stay, so
// sass_check.py keys the other instantiations as before.)
enum Mode : int {
  kRowPost = 6,
  kColWire16 = 8, kRowWire16 = 10
};

__host__ __device__ constexpr bool is_row(int mode) {
  return mode == kRowPost;
}

// K8 runs each column twice, once per half (the grid's fastest index);
// its output is [2, A * B * L].
__host__ __device__ constexpr bool has_halves(int mode) {
  return mode == kColWire16;
}

constexpr bool is_wire16(int mode) { return mode >= kColWire16; }

// [A, TL] tile buffers: two to ping-pong the stages, a third for K10's
// parked lo result.
__host__ __device__ constexpr int tile_bufs(int mode) {
  return mode == kRowWire16 ? 3 : 2;
}

// Shared words beyond the tile buffers: one [A] row of factors, none for
// K10.
constexpr int scratch_rows(int mode) {
  return mode == kRowWire16 ? 0 : 1;
}

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
  const uint32_t* tw2;   // unused (K9's second transform)
  const uint32_t* w32;   // unused
  const uint32_t* seed;  // [A, tr] four-step seeds
  const uint32_t* t0;    // [B / tr, A] four-step column bases
  int log_tr;
  const uint32_t* pcol;  // unused (K9's rank-1 multiply, row factor)
  const uint32_t* prow;  // unused (column factor)
};
// The unused fields stay, as TableArgs' mask and orig do: removing them
// would move the later fields and with them K7's, K8's and K10's SASS.

// The decode operands travel in a second kernel parameter. Kept in
// PassArgs they grow it past 128 bytes, and NVVM then reads its fields
// through a pointer into the parameter space near each use instead of
// once at entry: on the H100 that made K1 9% and K3 5% slower (a
// 136-byte against a 112-byte PassArgs, same kernels, same inputs).
// K10's hi input and bitmap output travel here for the same reason.
// mask and orig were K7-sel's and are unused until K7 leaves this kernel
// too: removing them would move hi and bitmap, and with them K10's SASS.
struct TableArgs {
  const uint32_t* vec;   // [A * B] general table (K7)
  const uint32_t* mask;  // unused
  const uint32_t* orig;  // unused
  const uint32_t* hi;    // [A, B, L] hi half; x holds lo (K10)
  uint32_t* bitmap;      // [A * B, L / 8] escape words (K10)
};

// scratch[a] = v[a * B + b] (column b of a general [A, B] table).
__device__ __forceinline__ void vec_row(uint32_t* scratch,
                                        const uint32_t* __restrict__ v,
                                        int A, int B, int b) {
  for (int a = threadIdx.x; a < A; a += blockDim.x)
    scratch[a] = v[(size_t)a * B + b];
}

// K10 on column b, lanes [l0, l0 + TL): the stages on the lo tile (p.x)
// and the hi tile (t.hi), then the re-pack and the escape words.
template <int F>
__device__ __forceinline__ void row_wire16(const PassArgs& p,
                                           const TableArgs& t,
                                           uint32_t* smem, int b, int l0) {
  const int tile = p.A << p.log_tl;
  const int tl_mask = (1 << p.log_tl) - 1;
  uint32_t* buf0 = smem;
  uint32_t* buf1 = smem + tile;
  uint32_t* buf2 = smem + 2 * tile;
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    int l = e & tl_mask, a = e >> p.log_tl;
    uint32_t vl = 0, vh = 0;
    if (l0 + l < p.L) {
      size_t i = ((size_t)a * p.B + b) * p.L + l0 + l;
      vl = p.x[i];
      vh = t.hi[i];
    }
    buf0[e] = vl;
    buf2[e] = vh;
  }
  __syncthreads();
  uint32_t* lo = run_stages<F>(buf0, buf1, p.A, p.log_a, p.log_tl, p.tw1,
                               p.w31);
  uint32_t* hi = run_stages<F>(buf2, lo == buf0 ? buf1 : buf0, p.A, p.log_a,
                               p.log_tl, p.tw1, p.w31);
  // natural order, as K3: stored[k, b, l] of [A, B, L]; a u32 shift drops
  // hi's bit 16, so 0x10000 is stored as 0 in either half
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    int l = e & tl_mask, k = e >> p.log_tl;
    if (l0 + l < p.L)
      p.out[((size_t)k * p.B + b) * p.L + l0 + l] =
          (lo[e] & 0xFFFFu) | (hi[e] << 16);
  }
  // bitmap[k * B + b, g] for the TL / 8 groups of this tile (L % 8 == 0
  // and TL >= 8, so a group is wholly inside or wholly past the edge)
  const int log_g = p.log_tl - 3;
  const int words = p.L >> 3;
  for (int e = threadIdx.x; e < (p.A << log_g); e += blockDim.x) {
    int g = e & ((1 << log_g) - 1), k = e >> log_g;
    int w = (l0 >> 3) + g;
    if (w >= words) continue;
    int e0 = (k << p.log_tl) + (g << 3);
    uint32_t bits = 0;
#pragma unroll
    for (int q = 0; q < 8; ++q)
      bits |= (lo[e0 + q] >> 16) << (2 * q) | (hi[e0 + q] >> 16) << (2 * q + 1);
    t.bitmap[((size_t)k * p.B + b) * words + w] = bits;
  }
}

template <int F, int MODE>
__global__ void __launch_bounds__(kThreads) pass_kernel(PassArgs p,
                                                        TableArgs t) {
  extern __shared__ uint32_t smem[];
  const int tile = p.A << p.log_tl;
  uint32_t* buf0 = smem;
  uint32_t* buf1 = smem + tile;
  uint32_t* scratch = smem + tile_bufs(MODE) * tile;  // [A] per-row factors
  const int tl_mask = (1 << p.log_tl) - 1;
  const int half = has_halves(MODE) ? blockIdx.x & 1 : 0;
  const unsigned blk = has_halves(MODE) ? blockIdx.x >> 1 : blockIdx.x;
  const int lt = blk % p.lane_tiles;
  const int b = blk / p.lane_tiles;
  const int l0 = lt << p.log_tl;
  // K8 writes half `half` of a [2, ...] output
  const size_t half_off = (size_t)half * p.A * p.B * p.L;
  uint32_t* out = p.out + half_off;

  if (MODE == kRowWire16) {
    row_wire16<F>(p, t, smem, b, l0);
    return;
  }
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    int l = e & tl_mask, a = e >> p.log_tl;
    uint32_t v = 0;
    if (l0 + l < p.L) v = p.x[((size_t)a * p.B + b) * p.L + l0 + l];
    if (MODE == kColWire16) v = half ? v >> 16 : v & 0xFFFFu;
    buf0[e] = v;
  }
  __syncthreads();
  uint32_t* y = run_stages<F>(buf0, buf1, p.A, p.log_a, p.log_tl, p.tw1, p.w31);

  if (is_row(MODE)) {
    vec_row(scratch, t.vec, p.A, p.B, b);
    __syncthreads();
    // natural order: out[k, b, l] of [A, B, L]
    for (int e = threadIdx.x; e < tile; e += blockDim.x) {
      int l = e & tl_mask, k = e >> p.log_tl;
      if (l0 + l >= p.L) continue;
      size_t o = ((size_t)k * p.B + b) * p.L + l0 + l;
      p.out[o] = mul_full<F>(y[e], scratch[k]);
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
      out[((size_t)b * p.A + k) * p.L + l0 + l] = mul_full<F>(y[e], scratch[k]);
  }
}

int log2_exact(int v) {
  int t = 0;
  while ((1 << t) < v) ++t;
  return (1 << t) == v ? t : -1;
}

template <int F, int MODE>
cudaError_t launch(PassArgs p, TableArgs t, cudaStream_t stream) {
  size_t smem = (tile_bufs(MODE) * ((size_t)p.A << p.log_tl) +
                 scratch_rows(MODE) * p.A) *
                sizeof(uint32_t);
  auto kernel = pass_kernel<F, MODE>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  unsigned blocks = (unsigned)p.B * (unsigned)p.lane_tiles *
                    (has_halves(MODE) ? 2u : 1u);
  kernel<<<blocks, kThreads, smem, stream>>>(p, t);
  return cudaGetLastError();
}

// The wire modes are GF16 only (their lanes are u16 wire words).
template <int MODE>
int run(int field, PassArgs p, void* stream, TableArgs t = {}) {
  p.log_a = log2_exact(p.A);
  if (p.log_a < 1 || p.A > kMaxLen || p.B < 1 || p.L < 1 || p.log_tr < 0)
    return (int)cudaErrorInvalidValue;
  int tl = kTileWords / p.A;
  if (tl > kMaxLaneTile) tl = kMaxLaneTile;
  if (MODE == kRowWire16 && (p.L % 8 != 0 || tl < 8))
    return (int)cudaErrorInvalidValue;     // whole bitmap groups per tile
  p.log_tl = log2_exact(tl);
  p.lane_tiles = (p.L + tl - 1) / tl;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if constexpr (is_wire16(MODE))
    e = field == fecc::kGF16 ? launch<fecc::kGF16, MODE>(p, t, s)
                             : cudaErrorInvalidValue;
  else
    e = field == fecc::kGF32 ? launch<fecc::kGF32, MODE>(p, t, s)
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

// K7: K3, then out[k, b] *= vec[k * B + b].
int fecc_row_post(int field, const void* x, void* out, int A, int B, int L,
                  const void* tw, const void* w3, const void* vec,
                  void* stream) {
  PassArgs p = base_args(x, out, A, B, L);
  p.tw1 = (const uint32_t*)tw;
  p.w31 = (const uint32_t*)w3;
  return run<kRowPost>(field, p, stream, {(const uint32_t*)vec});
}

// K8: [A=C1, B=R1, L=Wu] u32 pairs of LE u16 words -> [2, R1, C1, L]:
// K1 on lo = x & 0xFFFF (half 0) and on hi = x >> 16 (half 1).
int fecc_col_wire16(int field, const void* x, void* out, int A, int B, int L,
                    const void* tw, const void* w3, const void* seed,
                    const void* t0, int tr, void* stream) {
  PassArgs p = base_args(x, out, A, B, L);
  p.tw1 = (const uint32_t*)tw;
  p.w31 = (const uint32_t*)w3;
  p.seed = (const uint32_t*)seed;
  p.t0 = (const uint32_t*)t0;
  p.log_tr = log2_exact(tr);
  return run<kColWire16>(field, p, stream);
}

// K10: lo, hi [A=R2, B=C2, L] -> stored [R2, C2, L] (natural order, as
// K3) and bitmap [R2 * C2, L / 8]; L % 8 == 0.
int fecc_row_wire16(int field, const void* lo, const void* hi, void* stored,
                    void* bitmap, int A, int B, int L, const void* tw,
                    const void* w3, void* stream) {
  PassArgs p = base_args(lo, stored, A, B, L);
  p.tw1 = (const uint32_t*)tw;
  p.w31 = (const uint32_t*)w3;
  TableArgs t{};
  t.hi = (const uint32_t*)hi;
  t.bitmap = (uint32_t*)bitmap;
  return run<kRowWire16>(field, p, stream, t);
}

const char* fecc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
