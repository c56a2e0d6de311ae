// df32.cuh: double-float32 error-free transforms (EFT) for the precise
// levels of the kernels (SpmmConfig.precise = 1, 2).
//
// Twins of sextans_tpu/ops/df32.py (two_sum, two_prod, acc_step,
// compensated_epilogue) and of sextans_tpu_torch/ops/df32.py, which the
// plain versions use. nvcc contracts a * b + c into one FMA by default, and
// a contracted two_sum or epilogue loses the very bits it is meant to
// recover. So every add, subtract and multiply here is an __f*_rn
// intrinsic, which nvcc never contracts, and the build flags stay as they
// are (-fmad=false would change the plain-mode rounding of every kernel).
//
// two_prod takes the FMA form: p = fl(a * b), e = fma(a, b, -p) = a * b - p
// exactly. The JAX package uses Dekker's split (no FMA on the TPU's vector
// unit); both give the same (p, e) wherever the split is exact.
//
// Convention (the JAX package's): comp is the amount by which acc OVERSTATES
// the true sum, so the value of a pair is acc - comp.

#pragma once

#include <cuda_runtime.h>

namespace sx_df32 {

// s = fl(a + b), s + e == a + b exactly (Knuth, 6 operations).
__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = __fadd_rn(a, b);
  const float v = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, v)), __fsub_rn(b, v));
}

// p = fl(a * b), p + e == a * b exactly (no underflow).
__device__ __forceinline__ void two_prod(float a, float b, float& p, float& e) {
  p = __fmul_rn(a, b);
  e = __fmaf_rn(a, b, -p);
}

// Neumaier step: (acc, comp) += x, acc - comp kept exact up to the rounding
// of comp itself.
__device__ __forceinline__ void acc_step(float& acc, float& comp, float x) {
  float t, e;
  two_sum(acc, x, t, e);
  acc = t;
  comp = __fsub_rn(comp, e);
}

// The same with an exact residual xerr of x to ADD (a two_prod error).
__device__ __forceinline__ void acc_step(float& acc, float& comp, float x, float xerr) {
  float t, e;
  two_sum(acc, x, t, e);
  acc = t;
  comp = __fsub_rn(__fsub_rn(comp, e), xerr);
}

// alpha * (total - comp), one final rounding (the no-C epilogue).
__device__ __forceinline__ float compensated_epilogue(float alpha, float total, float comp) {
  float p, pe;
  two_prod(alpha, total, p, pe);
  return __fadd_rn(p, __fsub_rn(pe, __fmul_rn(alpha, comp)));
}

// alpha * (total - comp) + beta * cin, every product and sum compensated
// and the error terms folded into one final rounding.
__device__ __forceinline__ float compensated_epilogue(float alpha, float total, float comp,
                                                      float beta, float cin) {
  float p, pe, q, qe, s, se;
  two_prod(alpha, total, p, pe);
  const float err = __fsub_rn(pe, __fmul_rn(alpha, comp));
  two_prod(beta, cin, q, qe);
  two_sum(p, q, s, se);
  return __fadd_rn(s, __fadd_rn(__fadd_rn(err, qe), se));
}

// One compensated term of a gather kernel's sum (K5, K6, K7): the exact
// product v * x, then the Neumaier step with its error, lane by lane.
__device__ __forceinline__ void mul_acc_step(float v, float x, float& acc, float& comp) {
  float p, pe;
  two_prod(v, x, p, pe);
  acc_step(acc, comp, p, pe);
}
__device__ __forceinline__ void mul_acc_step(float v, float4 x, float4& acc, float4& comp) {
  mul_acc_step(v, x.x, acc.x, comp.x);
  mul_acc_step(v, x.y, acc.y, comp.y);
  mul_acc_step(v, x.z, acc.z, comp.z);
  mul_acc_step(v, x.w, acc.w, comp.w);
}

// The compensated epilogue with C (with_c) or without it, lane by lane.
__device__ __forceinline__ float epilogue(float total, float comp, float cin, float alpha,
                                          float beta, bool with_c) {
  return with_c ? compensated_epilogue(alpha, total, comp, beta, cin)
                : compensated_epilogue(alpha, total, comp);
}
__device__ __forceinline__ float4 epilogue(float4 total, float4 comp, float4 cin, float alpha,
                                           float beta, bool with_c) {
  return make_float4(epilogue(total.x, comp.x, cin.x, alpha, beta, with_c),
                     epilogue(total.y, comp.y, cin.y, alpha, beta, with_c),
                     epilogue(total.z, comp.z, cin.z, alpha, beta, with_c),
                     epilogue(total.w, comp.w, cin.w, alpha, beta, with_c));
}

}  // namespace sx_df32
