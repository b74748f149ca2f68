// Stockham NTT stages on an [A, TL] tile in shared memory: the stage loop
// of the port's first design, left in K10 (ntt_mfa.cu) and K11
// (lanes.cu). Element (a, l) of the tile is word a * TL + l: lanes
// are contiguous, so neighbouring threads touch neighbouring words. Each
// stage reads one buffer and writes the other; `run_stages` ping-pongs
// between them and returns the buffer that holds the result.
#pragma once

#include <cstdint>

#include "gf.cuh"

namespace {

using fecc::add;
using fecc::mul_tw;
using fecc::sub;

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

}  // namespace
