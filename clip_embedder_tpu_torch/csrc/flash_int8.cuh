// The arithmetic that makes kernel 2's int8 codes and scales, shared by its
// two int8 routes (flash_int8.cu: f32 and head dims TMA cannot move;
// flash_int8_tma.cu: bf16 with D a multiple of 8), so that both divide and
// round as the plain version does (ops/flash.py `_code`, `_scale`).
#pragma once

#include "common.cuh"

namespace clipk {
inline namespace CLIPK_SOURCE {
namespace flash8 {

// x / s rounded half to even (rintf), clipped to [lo, 127]: the division is
// IEEE's, as the plain version's is.
__device__ __forceinline__ int8_t code(float x, float s, float lo) {
  return (int8_t)fminf(fmaxf(rintf(__fdiv_rn(x, s)), lo), 127.0f);
}

// amax / 127, or 1 where amax is 0; `bits`: amax as f32 bits
__device__ __forceinline__ float scale_of(float amax) {
  return amax == 0.0f ? 1.0f : __fdiv_rn(amax, 127.0f);
}

__device__ __forceinline__ float scale_of(unsigned int bits) {
  return scale_of(__uint_as_float(bits));
}

// quant_pv's scale of a row of p from its largest weight: under exp_bf16
// p, its scale and p / scale are bf16 (JAX's weak-typed scalars keep p's
// dtype), so the quotient is rounded to bf16 too.
__device__ __forceinline__ float p_scale(float pmax, bool exp_bf16) {
  return pmax == 0.0f ? 1.0f : exp_bf16 ? round_bf16(__fdiv_rn(pmax, 127.0f))
                                        : __fdiv_rn(pmax, 127.0f);
}

// p's code in [0, 127] under the row scale `s`: p / s rounded half to even
// and clipped (in integers: the value code() would give, in fewer steps).
__device__ __forceinline__ int p_code(float p, float s, bool exp_bf16) {
  const float r = exp_bf16 ? round_bf16(__fdiv_rn(p, s)) : __fdiv_rn(p, s);
  return min(max(__float2int_rn(r), 0), 127);
}

// p / s without a division: from r = __frcp_rn(s) (once a row), q = p * r
// is within an ulp of p / s, and one Newton step from its residual p - q * s
// (exact in an fma) rounds to IEEE's quotient (Markstein) wherever that
// residual is normal. It can differ in the last place only for a p far
// below its row's largest, whose code is 0 either way: tools/pcode_check.py
// holds the codes of both against each other on the card.
__device__ __forceinline__ float p_quotient(float p, float s, float r) {
  const float q = __fmul_rn(p, r);
  return __fmaf_rn(__fmaf_rn(-q, s, p), r, q);
}

// The code of quotient `r` >= 0 (rounded to bf16 first under exp_bf16) in
// the low byte of the result: clipped to 127 and rounded half to even by
// adding 1.5 * 2^23 (the f32 sum's rounding is the code's), so a thread
// packs 4 codes with two byte permutes, and no conversion instruction
// (a quarter of the card's FP32 rate) runs an element.
__device__ __forceinline__ uint32_t p_code_bits(float r, bool exp_bf16) {
  const float c = fminf(exp_bf16 ? round_bf16(r) : r, 127.0f);
  return __float_as_uint(__fadd_rn(c, 12582912.0f));
}

// int32 x (|x| < 2^22) as f32, exactly, by integer and f32 adds (no I2F).
__device__ __forceinline__ float small_int_to_f32(int x) {
  return __fsub_rn(__int_as_float(x + 0x4B400000), 12582912.0f);
}

}  // namespace flash8
}  // namespace CLIPK_SOURCE
}  // namespace clipk
