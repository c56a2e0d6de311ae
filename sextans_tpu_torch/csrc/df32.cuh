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

// ---- Level 2 with a rounding check (K4) ----
//
// A compensated pair carries its sum to about u^2 * sum |terms|, not to
// u^2 * |sum| (u = 2^-24): where the terms cancel, or the sum lies near a
// rounding boundary, its one final rounding can land on the wrong f32. The
// bounded steps below also gather `bound`, from which 2^-22 * bound is at
// least the pair's whole error, so that the epilogue can tell where its f32
// may not be the nearest one; those few elements are summed again from f64
// (nearest_f32).

// (acc, comp) += p + pe, with the step's two errors summed first:
// comp' = comp - fl(e + pe). The step's two roundings are at most
// u * |fl(e + pe)| + u * |comp'| <= u * (|comp| + (2 + u) * |comp'|), so
// adding |comp'| into `bound` at every step bounds the error of a run of
// steps from comp = 0 by 3.0001 * u * the bound's gain. A step that adds
// nothing (a pad) may add to the bound too: it only grows.
__device__ __forceinline__ void acc_step_bounded(float& acc, float& comp, float& bound, float p,
                                                 float pe) {
  float t, e;
  two_sum(acc, p, t, e);
  acc = t;
  comp = __fsub_rn(comp, __fadd_rn(e, pe));
  bound = __fadd_rn(bound, fabsf(comp));
}

// A run's flush: acc_step(acc, comp, reg), then comp += regc; bound (which
// the run's steps have grown) gathers the magnitudes of its two roundings.
__device__ __forceinline__ void flush_bounded(float& acc, float& comp, float& bound, float reg,
                                              float regc) {
  float t, e;
  two_sum(acc, reg, t, e);
  acc = t;
  const float c1 = __fsub_rn(comp, e);
  comp = __fadd_rn(c1, regc);
  bound = __fadd_rn(__fadd_rn(bound, fabsf(c1)), fabsf(comp));
}

// The compensated epilogue (the same result r, to the bit), and whether r
// may not be the f32 nearest to alpha * (total - comp) + beta * cin, where
// the pair total - comp is the exact sum to within 2^-22 * bound. r + d is
// the epilogue's own sum before its rounding, exactly (two_sum); each of its
// roundings is at most u * |its result|, gathered in `slack`. r is the
// nearest f32 when |d| + the error bound stays under half the gap to r's
// neighbour (the smaller one, at a power of two). A non-finite r reads as
// sure: the sum of finite terms is not the question there.
__device__ __forceinline__ float checked_epilogue(float total, float comp, float bound, float cin,
                                                  float alpha, float beta, bool with_c,
                                                  bool& sure) {
  float p, pe;
  two_prod(alpha, total, p, pe);
  const float ac = __fmul_rn(alpha, comp);
  const float err = __fsub_rn(pe, ac);
  float s = p, tail = err;
  float slack = __fadd_rn(fabsf(ac), fabsf(err));
  if (with_c) {
    float q, qe, se;
    two_prod(beta, cin, q, qe);
    two_sum(p, q, s, se);
    const float t1 = __fadd_rn(err, qe);
    tail = __fadd_rn(t1, se);
    slack = __fadd_rn(__fadd_rn(slack, fabsf(t1)), fabsf(tail));
  }
  float r, d;
  two_sum(s, tail, r, d);
  const float margin = __fadd_rn(
      fabsf(d), __fmul_rn(0x1p-22f, __fadd_rn(__fmul_rn(fabsf(alpha), bound), slack)));
  const unsigned bits = __float_as_uint(r);
  const int ef = (bits >> 23) & 0xff;
  const int shift = (bits & 0x7fffffu) ? 24 : 25;
  const float half_gap = ef > shift ? __uint_as_float((unsigned)(ef - shift) << 23) : 0.f;
  sure = !(margin >= half_gap && margin > 0.f);
  return r;
}

// s = fl(a + b), s + e == a + b exactly, in f64.
__device__ __forceinline__ void two_sum(double a, double b, double& s, double& e) {
  s = __dadd_rn(a, b);
  const double v = __dsub_rn(s, a);
  e = __dadd_rn(__dsub_rn(a, __dsub_rn(s, v)), __dsub_rn(b, v));
}

// The f32 nearest to hi + lo: their f64 sum rounded to odd (toward zero,
// then the last bit set where that was inexact), then to f32. With 53 >=
// 24 + 2 bits that is one rounding of hi + lo.
__device__ __forceinline__ float nearest_f32(double hi, double lo) {
  double z, zl;
  two_sum(hi, lo, z, zl);
  if (zl != 0.0) {
    long long bits = __double_as_longlong(z);
    if (!(bits & 1)) bits += ((zl > 0.0) == (z > 0.0)) ? 1 : -1;
    z = __longlong_as_double(bits);
  }
  return __double2float_rn(z);
}

// alpha * (acc - comp) + beta * cin (with_c) or alpha * (acc - comp) for an
// f64 pair, rounded once to f32: alpha * acc exactly (an FMA's residual),
// beta * cin exactly (48 bits), the rest of order 2^-53 of the pair.
__device__ __forceinline__ float nearest_epilogue(double acc, double comp, float alpha,
                                                  float beta, float cin, bool with_c) {
  const double a = alpha;
  const double p = __dmul_rn(a, acc);
  double lo = __dsub_rn(__fma_rn(a, acc, -p), __dmul_rn(a, comp));
  double hi = p;
  if (with_c) {
    double se;
    two_sum(p, __dmul_rn((double)beta, (double)cin), hi, se);
    lo = __dadd_rn(lo, se);
  }
  return nearest_f32(hi, lo);
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
