// The min-plus step shared by both kernels of the batched SOAR solve.
//
// One definition of the j-shift reduction, as the JAX package shares
// `_minplus_loop` (src/repro/kernels/minplus/levelfold.py) between its two
// Pallas kernels: the level fold's chains and the color's replayed chains
// must round identically, or the color traceback would read different bits
// than the gather wrote.
//
// Besides the per-output step, the lane-group helpers both kernels run: a
// chain belongs to a group of g lanes (g a power of two, at most 32, the
// group aligned inside its warp), lane q of the group owning outputs
// q, q + g, ... . Groups of one warp may run different control flow; every
// sync, shuffle and ballot below names the group's own lanes only.
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
// rounded add and min is exact, so the order over j is free. One loop of
// K - 1 steps for every lane (the shifted-in entry selected, not branched
// to), so the lanes of a warp, each at its own i, do not diverge.
template <typename T>
__device__ __forceinline__ T minplus_at(const T* a, const T* b, int i, int K) {
  const T pad = big<T>();
  T acc = add_rn(a[i], b[0]);
#pragma unroll 4
  for (int j = 1; j < K; ++j) {
    const T x = a[j <= i ? i - j : 0];
    acc = min_of(acc, add_rn(j <= i ? x : pad, b[j]));
  }
  return acc;
}

// The warp mask of the calling lane's group of g lanes.
__device__ __forceinline__ unsigned group_mask(int g) {
  const int lane = threadIdx.x & 31;
  return g == 32 ? 0xffffffffu : ((1u << g) - 1u) << (lane & ~(g - 1));
}

// Inclusive prefix minimum over the group's lanes (exact in any order).
template <typename T>
__device__ __forceinline__ T group_prefix_min(T v, int q, int g,
                                              unsigned mask) {
  for (int s = 1; s < g; s <<= 1) {
    const T u = __shfl_up_sync(mask, v, s, g);
    if (q >= s) v = min_of(v, u);
  }
  return v;
}

// The group's least (value, index) pair, lowest index on ties: the first
// minimizer, as torch.argmin picks it. Every lane ends with the result.
template <typename T>
__device__ __forceinline__ void group_argmin(T& v, int& j, int g,
                                             unsigned mask) {
  for (int s = g >> 1; s > 0; s >>= 1) {
    const T ov = __shfl_xor_sync(mask, v, s, g);
    const int oj = __shfl_xor_sync(mask, j, s, g);
    if (ov < v || (ov == v && oj < j)) {
      v = ov;
      j = oj;
    }
  }
}

// One chain step by a group: dst[i] = minplus_at(acc, child, i, K). In
// place (dst == acc) it runs the top chunk of g outputs first, since
// output i reads acc[0..i] only.
template <typename T>
__device__ __forceinline__ void group_minplus_step(const T* acc,
                                                   const T* child, T* dst,
                                                   int K, int q, int g,
                                                   unsigned mask) {
  for (int base = ((K - 1) / g) * g; base >= 0; base -= g) {
    const int i = base + q;
    const T v = i < K ? minplus_at(acc, child, i, K) : T(0);
    __syncwarp(mask);  // every lane has read acc[0..base+g-1]
    if (i < K) dst[i] = v;
    __syncwarp(mask);
  }
}

// r >= 1 chain steps against the all-zeros identity child, in closed form
// (the plain version is `identity_steps` in kernels/minplus/levelfold.py).
// minplus_at(a, 0, i, K) is min(pm[i], BIG) for i < K-1 and pm[K-1] at the
// last entry, pm the prefix minimum of a + 0: a[x] + 0 is exact and the
// shifted-in BIG + 0 candidate exists only below the last entry. A second
// step caps the last entry too and a third changes nothing, so a run of r
// sentinel children costs one O(K) scan instead of r K*K steps, bit for
// bit. src and dst may alias: each lane reads and writes its own entries.
template <typename T>
__device__ __forceinline__ void group_identity_steps(const T* src, T* dst,
                                                     int K, int r, int q,
                                                     int g, unsigned mask) {
  const bool cap_last = r >= 2 && K >= 2;
  T carry = inf<T>();
  for (int base = 0; base < K; base += g) {
    const int i = base + q;
    T v = i < K ? add_rn(src[i], T(0)) : inf<T>();
    v = min_of(group_prefix_min(v, q, g, mask), carry);
    carry = __shfl_sync(mask, v, g - 1, g);
    if (i < K) dst[i] = (i < K - 1 || cap_last) ? min_of(v, big<T>()) : v;
  }
  __syncwarp(mask);
}

// Asynchronous 4- or 8-byte copy from device to shared memory (cp.async),
// committed and awaited in groups; a plain copy in a host build.
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(sizeof(T)));
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void cp_async_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

// Wait until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
#endif
}

}  // namespace soar

// Threads a launch keeps in flight before its chains' groups narrow:
// about four waves of an H100 (132 SMs x 2,048 threads).
constexpr long long kThreadsInFlight = 1LL << 20;

// Lanes of the group that carries one chain at width K, for a launch of
// `chains` chains: the next power of two at or above min(K, 32), so that
// each lane owns one output (beyond 32, ceil(K / 32)), halved while the
// launch would run more than kThreadsInFlight threads. A level of many
// short chains (the deep levels of a binary forest: one step of K = 5 for
// each of 852,000 chains) is bound by each thread's fixed work, and a
// lane that owns several outputs does it once for all; a level of few
// long chains (a hub's hundred children) is bound by each step's latency,
// and wide groups shorten it.
inline int soar_lane_group(int K, long long chains) {
  int g = 1;
  while (g < K && g < 32) g <<= 1;
  while (g > 1 && chains * g > kThreadsInFlight) g >>= 1;
  return g;
}
