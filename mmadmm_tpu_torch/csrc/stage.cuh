// Staging a block's inputs into shared memory with cp.async, for the
// kernels that keep each element's inputs on chip (K1 in prox2d.cu; K4, K4'
// and K4'' in prox3d.cu): a channel-major [C, n] input's columns first ..
// first + kE, 16-byte copies where a channel row's run is aligned and
// whole, 4- or 8-byte copies elsewhere, so that any n works. Compiled for
// the host (no __CUDA_ARCH__), each copy is a plain one.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

// cp.async of one value (4 or 8 bytes) or of 16 bytes from device to shared
// memory (a plain copy where this is compiled for the host)
template <typename R>
__device__ __forceinline__ void copy1(R* dst, const R* src) {
#ifdef __CUDA_ARCH__
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (sizeof(R) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
#else
  *dst = *src;
#endif
}

template <typename R>
__device__ __forceinline__ void copy16(R* dst, const R* src) {
#ifdef __CUDA_ARCH__
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
#else
  std::memcpy(dst, src, 16);
#endif
}

__device__ __forceinline__ void copies_done() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
#endif
}

// rows [rows, n] of the block's elements first .. first + kE (those below n)
// into dst [rows][kE]: 16-byte copies when every row's run is 16-byte
// aligned and whole, else one-value copies
template <int kE, int kT, typename R>
__device__ __forceinline__ void stage_rows(R* dst, const R* src, int rows, long long n,
                                           long long first) {
  constexpr int kV = 16 / sizeof(R);  // values in a 16-byte copy
  static_assert(kE % kV == 0, "a row of kE values is whole 16-byte copies");
  const bool whole = first + kE <= n && n % kV == 0 && (uintptr_t)src % 16 == 0;
  if (whole) {
    for (int q = threadIdx.x; q < rows * (kE / kV); q += kT) {
      const int c = q / (kE / kV), i = (q % (kE / kV)) * kV;
      copy16(dst + c * kE + i, src + c * n + first + i);
    }
  } else {
    for (int q = threadIdx.x; q < rows * kE; q += kT) {
      const int c = q / kE, i = q % kE;
      if (first + i < n) copy1(dst + c * kE + i, src + c * n + first + i);
    }
  }
}

// the same rows transposed into dst [kE][rows]: one-value copies
template <int kE, int kT, typename R>
__device__ __forceinline__ void stage_cols(R* dst, const R* src, int rows, long long n,
                                           long long first) {
  for (int q = threadIdx.x; q < rows * kE; q += kT) {
    const int c = q / kE, i = q % kE;
    if (first + i < n) copy1(dst + i * rows + c, src + c * n + first + i);
  }
}

}  // namespace
