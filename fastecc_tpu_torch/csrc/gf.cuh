// GF(p) arithmetic for the Hopper kernels of fastecc_tpu_torch.
//
// Counterpart of fastecc_tpu/gf.py (add/sub, Montgomery REDC, the GF16
// Fermat reduction). The TPU had no 64-bit integer product and built it
// from 16-bit limbs; here the card's native 32x32 -> 64 product gives the
// same canonical residues. Every GF32 pass multiplies with mul_solinas,
// the REDC specialised for p = 2^32 - 2^20 + 1 (one wide multiply, the
// rest shifts and adds); mul_generic, the textbook REDC with four
// multiplies, is kept for the microbenchmark's "generic" step.
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

// The generic Montgomery REDC of the 64-bit product a * b (a, b < p), the
// microbenchmark's "generic" step (fastecc_tpu/gf.py mont_mul(generic=True)).
// t = hi * 2^32 + lo; m = lo * n' mod 2^32 makes t + m * p divisible by
// 2^32; the carry out of the low word is 1 iff lo != 0. The quotient is
// below 2p, so one conditional subtraction makes it canonical.
__device__ __forceinline__ uint32_t mul_generic(uint32_t a, uint32_t b) {
  uint32_t lo = a * b;
  uint32_t hi = __umulhi(a, b);
  uint32_t m = lo * kNPrime32;
  uint32_t mp_hi = __umulhi(m, kP32);
  uint64_t u = (uint64_t)hi + mp_hi + (lo != 0u);
  return (uint32_t)(u >= kP32 ? u - kP32 : u);
}

// The Solinas REDC for p = 0xFFF00001 = 2^32 - 2^20 + 1, the counterpart of
// fastecc_tpu/gf.py mont_mul's default branch (the microbenchmark's
// "solinas" step, and mul_full<kGF32>: every GF32 pass's multiply), written
// for Hopper: IMAD-class instructions issue on one integer pipe, IADD3,
// LOP3, SHF, LEA, ISETP and SEL on the other, each at half the issue
// rate. It is REDC with the negated Montgomery factor: m = lo * p^-1 mod
// 2^32 makes a * b - m * p divisible by 2^32 with no borrow out of the low
// word, so the quotient is d = hi - q, q = (m * p) >> 32, in (-p, p), and
// + p where negative. p^-1 = 1 + 2^20 mod 2^32, so with l = lo << 20 the
// factor is m = lo + l, whose carry out is c = [m < l], and since
// m * 2^20 = (m >> 12) * 2^32 + l, q = m - (m >> 12) - c. The carry rides
// into t = (m >> 12) + ~m + c = ~q, so d = hi + t + 1, and hi - q wrapped
// exactly when d > hi. ptxas makes it IMAD.WIDE (a * b), LEA (m and c),
// LEA.HI.X (t), then d, the compare and the predicated + p: ~8
// instructions a step, 2.6 of them IMAD-class (`sass_check.py --ops`),
// against mul_generic's 10.2. The product a * b is plain C, so a constant
// operand (the butterflies' compile-time twiddles) folds into the
// multiply: with it inside the asm block ptxas gave the seams K2 and K6
// 66 and 80 registers at A = 1024, one 512-thread block an SM, and they
// ran 16-21% slower. Forms weighed on the H100 (sweeps of K14's steps and the
// passes, PERF.md section 6): this select won against d + k * (2^32 - p)
// as a multiply-add, funnel shifts and plain C.
// Two ptxas 12.8 behaviours shaped it: subc after add.cc subtracts
// 1 - carry (not the carry), and a sub.cc of mul.hi's result is folded
// into IMAD.HI with a wrong carry when the subtrahend is 0; so the flag is
// read only by addc, right after add.cc. The same canonical residue as
// mul_generic, bit for bit, wherever a * b < p * 2^32 (one operand below p
// is enough): both are a * b * 2^-32 mod p (tests/test_torch_solinas_step.py
// runs this asm text against fastecc_tpu/gf.py).
__device__ __forceinline__ uint32_t mul_solinas(uint32_t a, uint32_t b) {
  const uint32_t lo = a * b, hi = __umulhi(a, b);
  uint32_t r;
  asm("{\n\t"
      ".reg .u32 l, m, nm, s, t, d, k;\n\t"
      ".reg .pred w;\n\t"
      "mul.lo.u32 l, %1, 1048576;\n\t"
      "add.cc.u32 m, %1, l;\n\t"
      "mul.hi.u32 s, m, 1048576;\n\t"
      "not.b32 nm, m;\n\t"
      "addc.u32 t, s, nm;\n\t"
      "add.u32 d, %2, t;\n\t"
      "add.u32 d, d, 1;\n\t"
      "setp.gt.u32 w, d, %2;\n\t"
      "selp.u32 k, -1048575, 0, w;\n\t"
      "add.u32 %0, d, k;\n\t"
      "}"
      : "=r"(r) : "r"(lo), "r"(hi));
  return r;
}

template <> __device__ __forceinline__ uint32_t mul_full<kGF32>(uint32_t a, uint32_t b) {
  return mul_solinas(a, b);
}

template <> __device__ __forceinline__ uint32_t mul_tw<kGF32>(uint32_t a, uint32_t b) {
  return mul_full<kGF32>(a, b);
}

// The reference microbenchmark's "*-masksel" forms
// (fastecc_tpu/kernels/microbench.py _addmod_masksel, _mont_mul_masksel):
// the final select written as mask arithmetic, s - (bias & -[no wrap]);
// the Solinas one on mul_solinas' REDC, d + (p & k), k = -[d > hi].
__device__ __forceinline__ uint32_t add_masksel(uint32_t a, uint32_t b) {
  uint32_t t = b + kBias32;
  uint32_t s = a + t;
  uint32_t nw = s >= t ? 1u : 0u;
  return s - (kBias32 & (0u - nw));
}

__device__ __forceinline__ uint32_t mul_solinas_masksel(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("{\n\t"
      ".reg .u32 lo, hi, l, m, nm, s, t, d, k;\n\t"
      "mul.lo.u32 lo, %1, %2;\n\t"
      "mul.hi.u32 hi, %1, %2;\n\t"
      "mul.lo.u32 l, lo, 1048576;\n\t"
      "add.cc.u32 m, lo, l;\n\t"
      "mul.hi.u32 s, m, 1048576;\n\t"
      "not.b32 nm, m;\n\t"
      "addc.u32 t, s, nm;\n\t"
      "add.u32 d, hi, t;\n\t"
      "add.u32 d, d, 1;\n\t"
      "set.gt.u32.u32 k, d, hi;\n\t"
      "and.b32 k, k, -1048575;\n\t"
      "add.u32 %0, d, k;\n\t"
      "}"
      : "=r"(r) : "r"(a), "r"(b));
  return r;
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
