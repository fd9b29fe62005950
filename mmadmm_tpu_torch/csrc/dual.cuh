// Forward-mode dual numbers for the port's kernels (K1-K3 through
// huang2d.cuh, K4 through huang3d.cuh): a value and one tangent, with JAX's
// jvp rules, the same rules as ops/newton.py::Dual, which the plain PyTorch
// versions run. Everything here is templated on the real type R (float or
// double): a kernel instantiated in double computes in double throughout,
// with the constants of Num<double>, and never rounds through float.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

// The floors and the stall tolerance in each real type, as the JAX kernels
// take them in their dtype (prox_pallas2d.py: _DET_FLOOR, _DIAG_FLOOR,
// _LEVENBERG, 10 * finfo(dtype).eps)
template <typename R>
struct Num;

template <>
struct Num<float> {
  static constexpr float kDetFloor = 1e-30f;
  static constexpr float kDiagFloor = 1e-12f;
  static constexpr float kLevenberg = 1e-9f;
  static constexpr float kEpsStall = 10.0f * 1.1920928955078125e-07f;
};

template <>
struct Num<double> {
  static constexpr double kDetFloor = 1e-30;
  static constexpr double kDiagFloor = 1e-12;
  static constexpr double kLevenberg = 1e-9;
  static constexpr double kEpsStall = 10.0 * 2.220446049250313080847263336181640625e-16;
};

template <typename R>
struct Dual {
  R v, d;
};

// the real type of a value or a dual number; as a parameter's type it is
// not deduced, so a real operand of a dual operation takes the dual's type
template <typename T>
struct RealOf {
  using type = T;
};
template <typename R>
struct RealOf<Dual<R>> {
  using type = R;
};
template <typename T>
using real_t = typename RealOf<T>::type;

template <typename R>
__device__ __forceinline__ Dual<R> operator+(Dual<R> a, Dual<R> b) { return {a.v + b.v, a.d + b.d}; }
template <typename R>
__device__ __forceinline__ Dual<R> operator+(Dual<R> a, real_t<R> b) { return {a.v + b, a.d}; }
template <typename R>
__device__ __forceinline__ Dual<R> operator+(real_t<R> a, Dual<R> b) { return {b.v + a, b.d}; }
template <typename R>
__device__ __forceinline__ Dual<R> operator-(Dual<R> a, Dual<R> b) { return {a.v - b.v, a.d - b.d}; }
template <typename R>
__device__ __forceinline__ Dual<R> operator-(Dual<R> a, real_t<R> b) { return {a.v - b, a.d}; }
template <typename R>
__device__ __forceinline__ Dual<R> operator-(real_t<R> a, Dual<R> b) { return {a - b.v, -b.d}; }
template <typename R>
__device__ __forceinline__ Dual<R> operator-(Dual<R> a) { return {-a.v, -a.d}; }
template <typename R>
__device__ __forceinline__ Dual<R> operator*(Dual<R> a, Dual<R> b) {
  return {a.v * b.v, a.d * b.v + a.v * b.d};
}
template <typename R>
__device__ __forceinline__ Dual<R> operator*(Dual<R> a, real_t<R> b) { return {a.v * b, a.d * b}; }
template <typename R>
__device__ __forceinline__ Dual<R> operator*(real_t<R> a, Dual<R> b) { return {a * b.v, a * b.d}; }
template <typename R>
__device__ __forceinline__ Dual<R> operator/(Dual<R> a, Dual<R> b) {
  R r = R(1) / (b.v * b.v);
  return {a.v / b.v, a.d / b.v + (-b.d * a.v) * r};
}
template <typename R>
__device__ __forceinline__ Dual<R> operator/(Dual<R> a, real_t<R> b) { return {a.v / b, a.d / b}; }
template <typename R>
__device__ __forceinline__ Dual<R> operator/(real_t<R> a, Dual<R> b) {
  R r = R(1) / (b.v * b.v);
  return {a / b.v, (-b.d * a) * r};
}

// max(x, c) that keeps a NaN x (jnp.maximum / torch.clamp_min)
template <typename R>
__device__ __forceinline__ R max_floor(R x, real_t<R> c) { return (x > c || x != x) ? x : c; }
template <typename R>
__device__ __forceinline__ Dual<R> max_floor(Dual<R> x, real_t<R> c) {
  R f = x.v > c ? R(1) : (x.v == c ? R(0.5) : R(0));
  return {max_floor(x.v, c), x.d * f};
}
// IEEE square root and absolute value in the operand's own type, one
// overload per type, so that a float is never promoted to double or a double
// rounded to float
__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }
template <typename R>
__device__ __forceinline__ Dual<R> sqrt_(Dual<R> x) {
  R s = sqrt_(x.v);
  return {s, x.d * (R(0.5) / s)};
}
__device__ __forceinline__ float abs_(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_(double x) { return fabs(x); }
template <typename R>
__device__ __forceinline__ Dual<R> abs_(Dual<R> x) { return {abs_(x.v), x.v >= R(0) ? x.d : -x.d}; }

}  // namespace
