// GF(p) arithmetic for the Hopper kernels of fastecc_tpu_torch.
//
// Counterpart of fastecc_tpu/gf.py (add/sub, Montgomery REDC, the GF16
// Fermat reduction). The TPU had no 64-bit integer product and built it
// from 16-bit limbs; here the card's native 32x32 -> 64 product
// (__umulhi plus a low multiply) gives the same canonical residues with
// four multiplies per GF32 mulmod.
//
// Conventions (as in the reference):
//   * values are canonical residues < p (GF16: <= 0x10000), in u32;
//   * GF32 constants arrive Montgomery-prepared (c * 2^32 mod p), so
//     mul_full(x, prep(c)) = REDC(x * prep(c)) = x * c mod p, and
//     mul_full(prep(a), prep(b)) = prep(a * b);
//   * GF16 constants are plain values; mul_tw is valid only for butterfly
//     stage tables, which never hold 0x10000 (= -1). Four-step, coset and
//     scale-folded tables can hold it and take mul_full.
#pragma once

#include <cstdint>

namespace fecc {

enum Field : int { kGF32 = 0, kGF16 = 1 };

constexpr uint32_t kP32 = 0xFFF00001u;
constexpr uint32_t kBias32 = 0x000FFFFFu;   // 2^32 - p
constexpr uint32_t kNPrime32 = 0xFFEFFFFFu; // -p^-1 mod 2^32
constexpr uint32_t kP16 = 0x10001u;

template <int F> __device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b);
template <int F> __device__ __forceinline__ uint32_t sub(uint32_t a, uint32_t b);
template <int F> __device__ __forceinline__ uint32_t mul_full(uint32_t a, uint32_t b);
template <int F> __device__ __forceinline__ uint32_t mul_tw(uint32_t a, uint32_t b);

// GF32: p > 2^31, so a + b can wrap u32. Bias one operand by 2^32 - p:
// s = a + (b + bias) wraps exactly when a + b >= p, and then s is already
// a + b - p.
template <> __device__ __forceinline__ uint32_t add<kGF32>(uint32_t a, uint32_t b) {
  uint32_t t = b + kBias32;
  uint32_t s = a + t;
  return s < t ? s : s - kBias32;
}

template <> __device__ __forceinline__ uint32_t sub<kGF32>(uint32_t a, uint32_t b) {
  uint32_t d = a - b;
  return a >= b ? d : d + kP32;
}

// Montgomery REDC of the 64-bit product a * b (a, b < p).
// t = hi * 2^32 + lo; m = lo * n' mod 2^32 makes t + m * p divisible by
// 2^32; the carry out of the low word is 1 iff lo != 0. The quotient is
// below 2p, so one conditional subtraction makes it canonical.
template <> __device__ __forceinline__ uint32_t mul_full<kGF32>(uint32_t a, uint32_t b) {
  uint32_t lo = a * b;
  uint32_t hi = __umulhi(a, b);
  uint32_t m = lo * kNPrime32;
  uint32_t mp_hi = __umulhi(m, kP32);
  uint64_t u = (uint64_t)hi + mp_hi + (lo != 0u);
  return (uint32_t)(u >= kP32 ? u - kP32 : u);
}

template <> __device__ __forceinline__ uint32_t mul_tw<kGF32>(uint32_t a, uint32_t b) {
  return mul_full<kGF32>(a, b);
}

template <> __device__ __forceinline__ uint32_t add<kGF16>(uint32_t a, uint32_t b) {
  uint32_t s = a + b;
  return s >= kP16 ? s - kP16 : s;
}

template <> __device__ __forceinline__ uint32_t sub<kGF16>(uint32_t a, uint32_t b) {
  uint32_t d = a - b;
  return a >= b ? d : d + kP16;
}

// (a * b) mod 0x10001, operands in [0, 0x10000]. The u32 product wraps
// only for 0x10000 * 0x10000 = 2^32 (= 1 mod p); 2^16 = -1 reduces the
// rest: x = hi * 2^16 + lo = lo - hi.
template <> __device__ __forceinline__ uint32_t mul_full<kGF16>(uint32_t a, uint32_t b) {
  uint32_t t = a * b;
  uint32_t ov = (a == 0x10000u) & (b == 0x10000u);
  uint32_t lo = t & 0xFFFFu, hi = t >> 16;
  uint32_t r = (lo >= hi ? lo - hi : lo - hi + kP16) + ov;
  return r >= kP16 ? r - kP16 : r;
}

// b < 2^16 (a stage-table entry): no wrap, and lo - hi lies in
// (-2^16, 2^16), so both branches are already canonical.
template <> __device__ __forceinline__ uint32_t mul_tw<kGF16>(uint32_t a, uint32_t b) {
  uint32_t t = a * b;
  uint32_t lo = t & 0xFFFFu, hi = t >> 16;
  return lo >= hi ? lo - hi : lo - hi + kP16;
}

}  // namespace fecc
