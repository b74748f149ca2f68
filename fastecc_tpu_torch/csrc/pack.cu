// The GF32 escape pack for Hopper (sm_90a), with a plain C interface loaded
// through ctypes (kernels/_build.py builds it, kernels/pack.py pack_gf32
// launches it on a CUDA tensor):
//
//   out[r, i]     = x[r, i] - p if x[r, i] >= p, else x[r, i]    (i < W)
//   out[r, W + m] = bit j set iff x[r, 16m + j] >= p              (m < W16)
//
// over x [rows, W] u32, the little-endian words of raw data blocks, and out
// [rows, W + W16] u32, W16 = ceil(W / 16), p = 0xFFF00001; the last bitmap
// word's bits past W are zero. Byte for byte the plain version
// (kernels/pack.py pack_gf32_plain) and the JAX package's pack_data.
//
// It replaces no TPU kernel: fastecc_tpu/packing.py:157 pack_data is jnp
// outside any Pallas kernel. The port's plain version, int64 torch ops,
// still runs on CPU tensors.
//
// What bounds it on the H100: bytes. The raw-byte encode packs [2^19, 1024]
// words a call: 2 GiB read and 2^19 x 1088 words (2.28 GB) written,
// 4,429,185,024 B, 1.3221 ms at 3.35 TB/s, against a compare and a
// subtract a word.
//
// What this design does about it (K13's copy, microbench.cu, with the
// escape in the middle):
//   * one pass: each word is read once, its stored lane and its escape bit
//     made in registers, the stored lanes and the bitmap written once; no
//     int64 carrier and no temporary reach HBM;
//   * each thread moves one 16-byte vector of 4 words (uint4) where W and
//     the output row W + W16 divide by 4 and both pointers are 16-byte
//     aligned, one word otherwise, so every load is issued before its
//     thread's stores and the grid sets the bytes in flight;
//   * a bitmap word gathers the escape bits of the 4 threads (vectors) or
//     16 threads (words) that hold its 16 words, neighbouring lanes of one
//     warp: two __shfl_xor_sync or one __ballot_sync, no shared memory and
//     no second pass; the group's first thread stores it;
//   * rows on gridDim.x (2^19 in the cell, above gridDim.y's 65,535), a
//     row's vectors on gridDim.y and threadIdx.x; blockDim.x is a power of
//     two of at least one group, and a block of 256 threads covers
//     256 / blockDim.x whole rows when a row is short;
//   * element offsets are 64-bit (the cell's input is 2^29 words);
//   * the loads and stores carry the streaming hint (ld/st .cs), as K13's
//     and table.cu's: gigabytes that nothing reads again before they leave
//     L2.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "gf.cuh"

namespace {

using fecc::kP32;

constexpr int kThreads = 256;
constexpr unsigned kMaxGridY = 65535u;
constexpr unsigned kWarp = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t stored(uint32_t w) {
  return w >= kP32 ? w - kP32 : w;
}

// Thread (threadIdx.x, threadIdx.y) of block (bx, by) packs vector
// v = by * blockDim.x + threadIdx.x of row bx * blockDim.y + threadIdx.y.
// Every thread of the block reaches the warp's exchange (none returns
// early); out-of-range threads add no bit and store nothing.

// 4 words a thread: vecs = W / 4 vectors a row, out_vecs = (W + W16) / 4.
__global__ void __launch_bounds__(kThreads) pack_vec_kernel(
    const uint4* __restrict__ x, uint4* __restrict__ out, int rows, int vecs,
    int out_vecs) {
  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  const int v = blockIdx.y * blockDim.x + threadIdx.x;
  const bool live = row < rows && v < vecs;
  uint32_t bits = 0;
  if (live) {
    const uint4 a = __ldcs(x + (size_t)row * vecs + v);
    bits = (uint32_t)(a.x >= kP32) | (uint32_t)(a.y >= kP32) << 1 |
           (uint32_t)(a.z >= kP32) << 2 | (uint32_t)(a.w >= kP32) << 3;
    __stcs(out + (size_t)row * out_vecs + v,
           make_uint4(stored(a.x), stored(a.y), stored(a.z), stored(a.w)));
  }
  // vectors 4m .. 4m + 3 hold bitmap word m's 16 words
  bits <<= 4 * (threadIdx.x & 3);
  bits |= __shfl_xor_sync(kWarp, bits, 1);
  bits |= __shfl_xor_sync(kWarp, bits, 2);
  if (live && (threadIdx.x & 3) == 0)
    __stcs(reinterpret_cast<uint32_t*>(out) + (size_t)row * out_vecs * 4 +
               vecs * 4 + v / 4,
           bits);
}

// 1 word a thread: W words a row, out_words = W + W16.
__global__ void __launch_bounds__(kThreads) pack_word_kernel(
    const uint32_t* __restrict__ x, uint32_t* __restrict__ out, int rows,
    int words, int out_words) {
  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  const int v = blockIdx.y * blockDim.x + threadIdx.x;
  const bool live = row < rows && v < words;
  bool esc = false;
  if (live) {
    const uint32_t w = __ldcs(x + (size_t)row * words + v);
    esc = w >= kP32;
    __stcs(out + (size_t)row * out_words + v, esc ? w - kP32 : w);
  }
  // words 16m .. 16m + 15 sit in one half of the warp's vote
  const uint32_t vote = __ballot_sync(kWarp, esc);
  const unsigned lane = (threadIdx.y * blockDim.x + threadIdx.x) & 31u;
  if (live && (threadIdx.x & 15) == 0)
    __stcs(out + (size_t)row * out_words + words + v / 16,
           (vote >> (lane & 16u)) & 0xFFFFu);
}

cudaError_t launch(const uint32_t* x, uint32_t* out, int rows, int words,
                   cudaStream_t s) {
  const int out_words = words + (words + 15) / 16;
  const bool vec = words % 4 == 0 && out_words % 4 == 0 &&
                   (uintptr_t)x % 16 == 0 && (uintptr_t)out % 16 == 0;
  const int vecs = vec ? words / 4 : words;
  unsigned tx = vec ? 4 : 16;            // one bitmap word's threads
  while (tx < (unsigned)vecs && tx < (unsigned)kThreads) tx <<= 1;
  const dim3 block(tx, kThreads / tx);
  const dim3 grid((rows + block.y - 1) / block.y, (vecs + tx - 1) / tx);
  if (grid.y > kMaxGridY) return cudaErrorInvalidValue;
  if (vec)
    pack_vec_kernel<<<grid, block, 0, s>>>(
        reinterpret_cast<const uint4*>(x), reinterpret_cast<uint4*>(out),
        rows, vecs, out_words / 4);
  else
    pack_word_kernel<<<grid, block, 0, s>>>(x, out, rows, words, out_words);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out = the escape pack of x [rows, words] u32 into [rows, words +
// ceil(words / 16)] u32 (out of place; out may not overlap x).
int fecc_pack_gf32(const void* x, void* out, int rows, int words,
                   void* stream) {
  if (rows < 0 || words < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0 || words == 0) return 0;
  return (int)launch((const uint32_t*)x, (uint32_t*)out, rows, words,
                     (cudaStream_t)stream);
}

}  // extern "C"
