// The GF16 wire pair's last pass for Hopper (sm_90a): kernel K10 of the
// port, with a plain C interface loaded through ctypes
// (fastecc_tpu_torch/kernels/_build.py builds it; kernels/ntt_mfa.py
// wire16_pass_b2 wraps it). It and K11 (lanes.cu) are what is left of
// the port's first design, the Stockham stage loop of stages.cuh; K1-K9
// run on the register-stage engine regstages.cuh (col.cu, row.cu).
//
// Replaces this Pallas TPU kernel of fastecc_tpu/kernels/ntt_mfa.py, whose
// lanes are u32 pairs of little-endian u16 wire words:
//   K10 fecc_row_wire16 <- _row_kernel_wire16  (K3 on lo and on hi, then
//                          stored = lo16 | hi16 << 16 and the escape
//                          bitmap)
// It computes what the Pallas kernel computes, not how: the output is
// bit-identical (canonical residues), while the tile and the twiddle
// tables are this port's own.
//
// The pass views lo and hi as [A, B, L] u32 (the transform runs along A,
// lanes L are contiguous in memory) and gives each block one column b and
// a tile of TL lanes. The block loads both [A, TL] columns into shared
// memory (neighbouring threads on neighbouring lanes), runs every
// Stockham stage there (radix 4, one leading radix-2 stage when log2 A is
// odd; stages.cuh) on lo, ping-ponging between two buffers, parks lo's
// result and runs hi's stages in the third, then writes the stored words
// and one escape word per group of 8 lanes (bit 2t for lo, 2t + 1 for hi
// of lane 8g + t: v >> 16 is the escape flag, as GF16 values are
// <= 0x10000). The reference's MXU compaction and transposed bitmap were
// Mosaic workarounds, not ported. TL = 8192 / A lanes (8 to 32 for
// A <= 1024) keeps each buffer at 32 KB.
//
// What bounds it on the H100: at the bench's shape (k = 2^13 blocks of
// 64 KB, [64, 128, 16384] a half) it reads lo and hi (1 GiB) and writes
// the stored words and the bitmap (0.56 GiB), a 0.50 ms floor at
// 3.35 TB/s; its GF16 multiplies (one 32-bit product each) need under a
// tenth of that. It ran at ~2.7x that floor (PERF.md): each stage is a
// shared-memory round with run-time index arithmetic and twiddles read
// from device memory, and the tiles are loaded one 4-byte word at a time.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "gf.cuh"
#include "stages.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileWords = 8192;  // A * TL words per buffer (32 KB)
constexpr int kMaxLaneTile = 32;
constexpr int kMaxLen = 1024;     // longest pass the splits give (2^20)
constexpr int kTileBufs = 3;      // two to ping-pong the stages, lo parked

// (0-9 were the modes of K1-K9, kernels of their own now in col.cu and
// row.cu. The number stays, so sass_check.py keys K10 as before.)
enum Mode : int { kRowWire16 = 10 };

struct PassArgs {
  const uint32_t* x;     // [A, B, L] lo half
  uint32_t* out;         // [A, B, L] stored words
  int A, log_a;          // transform length along axis 0
  int B;                 // columns (axis 1)
  int L;                 // lanes (axis 2)
  int log_tl;            // lane tile TL = 2^log_tl
  int lane_tiles;        // ceil(L / TL)
  const uint32_t* tw1;   // packed stage tables
  const uint32_t* w31;   // packed radix-4 w^3j tables
};

// K10's other operands travel in a second kernel parameter, as they did
// beside the modes that have left.
struct TableArgs {
  const uint32_t* hi;    // [A, B, L] hi half
  uint32_t* bitmap;      // [A * B, L / 8] escape words
};

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
  const int lt = blockIdx.x % p.lane_tiles;
  const int b = blockIdx.x / p.lane_tiles;
  row_wire16<F>(p, t, smem, b, lt << p.log_tl);
}

int log2_exact(int v) {
  int t = 0;
  while ((1 << t) < v) ++t;
  return (1 << t) == v ? t : -1;
}

// GF16 only: the lanes are u16 wire words.
cudaError_t launch(PassArgs p, TableArgs t, cudaStream_t stream) {
  const size_t smem = kTileBufs * ((size_t)p.A << p.log_tl) *
                      sizeof(uint32_t);
  auto kernel = pass_kernel<fecc::kGF16, kRowWire16>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const unsigned blocks = (unsigned)p.B * (unsigned)p.lane_tiles;
  kernel<<<blocks, kThreads, smem, stream>>>(p, t);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K10: lo, hi [A=R2, B=C2, L] -> stored [R2, C2, L] (natural order, as
// K3) and bitmap [R2 * C2, L / 8]; L % 8 == 0.
int fecc_row_wire16(int field, const void* lo, const void* hi, void* stored,
                    void* bitmap, int A, int B, int L, const void* tw,
                    const void* w3, void* stream) {
  const int log_a = log2_exact(A);
  if (field != fecc::kGF16 || log_a < 1 || A > kMaxLen || B < 1 || L < 1)
    return (int)cudaErrorInvalidValue;
  int tl = kTileWords / A;
  if (tl > kMaxLaneTile) tl = kMaxLaneTile;
  if (L % 8 != 0 || tl < 8)
    return (int)cudaErrorInvalidValue;     // whole bitmap groups per tile
  PassArgs p{};
  p.x = (const uint32_t*)lo;
  p.out = (uint32_t*)stored;
  p.A = A;
  p.log_a = log_a;
  p.B = B;
  p.L = L;
  p.log_tl = log2_exact(tl);
  p.lane_tiles = (L + tl - 1) / tl;
  p.tw1 = (const uint32_t*)tw;
  p.w31 = (const uint32_t*)w3;
  TableArgs t{};
  t.hi = (const uint32_t*)hi;
  t.bitmap = (uint32_t*)bitmap;
  return (int)launch(p, t, (cudaStream_t)stream);
}

const char* fecc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
