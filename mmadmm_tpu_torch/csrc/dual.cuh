// Forward-mode dual numbers for the port's kernels (K1-K3 through
// huang2d.cuh, K4 through huang3d.cuh): a value and one tangent, with JAX's
// jvp rules, the same rules as ops/newton.py::Dual, which the plain PyTorch
// versions run.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kDetFloor = 1e-30f;
constexpr float kLevenberg = 1e-9f;

struct Dual {
  float v, d;
};

__device__ __forceinline__ Dual operator+(Dual a, Dual b) { return {a.v + b.v, a.d + b.d}; }
__device__ __forceinline__ Dual operator+(Dual a, float b) { return {a.v + b, a.d}; }
__device__ __forceinline__ Dual operator+(float a, Dual b) { return {b.v + a, b.d}; }
__device__ __forceinline__ Dual operator-(Dual a, Dual b) { return {a.v - b.v, a.d - b.d}; }
__device__ __forceinline__ Dual operator-(Dual a, float b) { return {a.v - b, a.d}; }
__device__ __forceinline__ Dual operator-(float a, Dual b) { return {a - b.v, -b.d}; }
__device__ __forceinline__ Dual operator-(Dual a) { return {-a.v, -a.d}; }
__device__ __forceinline__ Dual operator*(Dual a, Dual b) {
  return {a.v * b.v, a.d * b.v + a.v * b.d};
}
__device__ __forceinline__ Dual operator*(Dual a, float b) { return {a.v * b, a.d * b}; }
__device__ __forceinline__ Dual operator*(float a, Dual b) { return {a * b.v, a * b.d}; }
__device__ __forceinline__ Dual operator/(Dual a, Dual b) {
  float r = 1.0f / (b.v * b.v);
  return {a.v / b.v, a.d / b.v + (-b.d * a.v) * r};
}
__device__ __forceinline__ Dual operator/(Dual a, float b) { return {a.v / b, a.d / b}; }
__device__ __forceinline__ Dual operator/(float a, Dual b) {
  float r = 1.0f / (b.v * b.v);
  return {a / b.v, (-b.d * a) * r};
}

// max(x, c) that keeps a NaN x (jnp.maximum / torch.clamp_min)
__device__ __forceinline__ float max_floor(float x, float c) { return (x > c || x != x) ? x : c; }
__device__ __forceinline__ Dual max_floor(Dual x, float c) {
  float f = x.v > c ? 1.0f : (x.v == c ? 0.5f : 0.0f);
  return {max_floor(x.v, c), x.d * f};
}
__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ Dual sqrt_(Dual x) {
  float s = sqrtf(x.v);
  return {s, x.d * (0.5f / s)};
}
__device__ __forceinline__ float abs_(float x) { return fabsf(x); }
__device__ __forceinline__ Dual abs_(Dual x) { return {fabsf(x.v), x.v >= 0.0f ? x.d : -x.d}; }

}  // namespace
