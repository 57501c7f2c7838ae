// The min-plus step shared by both kernels of the batched SOAR solve.
//
// One definition of the j-shift reduction, as the JAX package shares
// `_minplus_loop` (src/repro/kernels/minplus/levelfold.py) between its two
// Pallas kernels: the level fold's chains and the standalone min-plus
// convolution must round identically, or the color traceback, which replays
// the gather's chains through the standalone kernel, would read different
// bits than the gather wrote.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace soar {

// Rounded arithmetic that nvcc never contracts into an FMA. The plain torch
// path rounds the product and the sum separately (`acc + load * rho`), and
// on non-dyadic rates a fused multiply-add would differ in the last bit.
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

template <typename T>
__device__ __forceinline__ T min_of(T a, T b) { return b < a ? b : a; }

// The finite +inf stand-in BIG = 1e18, rounded to T as the host rounds it.
template <typename T>
__device__ __forceinline__ T big() { return static_cast<T>(1e18); }

template <typename T>
__device__ __forceinline__ T inf() { return static_cast<T>(INFINITY); }

// Output i (0 <= i < K) of the min-plus convolution of two width-K rows:
//   out[i] = min(a[i] + b[0],  min_{j=1..K-1} (j <= i ? a[i-j] : BIG) + b[j])
// The candidate set is the plain version's (`minplus_fused`), shifted-in
// BIG entries included: BIG + BIG rounds to 2e18, not BIG, so dropping the
// j > i candidates would change saturated outputs. Each candidate is one
// rounded add and min is exact, so the order over j is free.
template <typename T>
__device__ __forceinline__ T minplus_at(const T* a, const T* b, int i, int K) {
  T acc = add_rn(a[i], b[0]);
  for (int j = 1; j <= i; ++j) acc = min_of(acc, add_rn(a[i - j], b[j]));
  const T pad = big<T>();
  for (int j = i + 1; j < K; ++j) acc = min_of(acc, add_rn(pad, b[j]));
  return acc;
}

}  // namespace soar
