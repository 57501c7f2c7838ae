// Masked segment sum for Hopper (sm_90a): the Reduce at an aggregating switch,
//   out[g, d] = sum_c mask[g, c] * x[g, c, d],   x (G, C, D), mask (G, C).
//
// Replaces the Pallas kernel src/repro/kernels/segment_reduce/
// segment_reduce.py :: segment_reduce_pallas (body _segsum_kernel). In the
// port it runs every CompressOp, FoldOp and destination fold of the SOAR
// reduce executor (repro_torch/collectives/tree_allreduce.py).
//
// Summation order: the sum over c is a strict left fold in ascending c,
// acc = ((0 + m_0 x_0) + m_1 x_1) + ..., each product and each sum rounded
// on its own (__fmul_rn, __fadd_rn; the build also passes -fmad=false).
// No tree reduction and no split over c: that order is what lets the
// executor reproduce the JAX package's _left_fold bit for bit. A row whose
// mask is 0 is not read; for finite inputs this differs from adding 0 * x
// only in the sign of a zero sum (the sum starts at +0). bfloat16 inputs
// accumulate in float32 and are rounded once at the store, or, with
// kRoundEach (entry soar_segment_reduce_bf16_round_each), rounded to
// bfloat16 after every add: that is what the JAX executor's fold does with
// a bfloat16 buffer (its fori_loop carries a bfloat16 accumulator; tested
// bitwise in tests/test_torch_executor.py). Rounding the float32 sum of
// two bfloat16 values to bfloat16 is the correctly rounded bfloat16 sum
// (24 >= 2 * 8 + 2 bits), so this is bfloat16 addition.
//
// Bound on the H100: bytes. Each output element costs one read of every
// unmasked row and one write, at 2 operations per read value, far below the
// fp32 ridge; the least time is (unmasked rows + G) * D * itemsize over
// 3.35 TB/s. Design: grid (ceil(D / 1024), G), 256 threads, each thread
// owning 4 consecutive d with one 16-byte (float) or 8-byte (bfloat16) load
// per row where D % 4 == 0 and the pointers are aligned, scalar loads
// otherwise. The mask row is staged in shared memory once per block (in
// chunks of 256), so the skip of a masked-out row is uniform across the
// block. Group g reads the C consecutive rows starting at row rows[g] of a
// (R, D) buffer when `rows` is given (row g*C otherwise), and writes row
// out_rows[g] of `out` (row g otherwise): the executor folds a device's
// slots in place, out_rows == rows, where each thread reads its own d of
// every row before it writes them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;                    // consecutive d per thread
constexpr int kTileD = kThreads * kPer;    // d per block

__device__ __forceinline__ float bf16_bits_to_float(unsigned int bits16) {
  return __uint_as_float(bits16 << 16);
}

// Four consecutive values starting at p, as float; `left` values remain in
// the row (scalar path only).
template <typename T, bool kVec>
struct Io;

template <bool kVec>
struct Io<float, kVec> {
  static __device__ __forceinline__ void load(const float* p, long long left,
                                              float v[kPer]) {
    if (kVec) {
      const float4 q = *reinterpret_cast<const float4*>(p);
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else {
#pragma unroll
      for (int j = 0; j < kPer; ++j) v[j] = j < left ? p[j] : 0.f;
    }
  }
  static __device__ __forceinline__ void store(float* p, long long left,
                                               const float v[kPer]) {
    if (kVec) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        if (j < left) p[j] = v[j];
    }
  }
};

template <bool kVec>
struct Io<__nv_bfloat16, kVec> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              long long left, float v[kPer]) {
    if (kVec) {
      const uint2 q = *reinterpret_cast<const uint2*>(p);
      v[0] = bf16_bits_to_float(q.x & 0xffffu);
      v[1] = bf16_bits_to_float(q.x >> 16);
      v[2] = bf16_bits_to_float(q.y & 0xffffu);
      v[3] = bf16_bits_to_float(q.y >> 16);
    } else {
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        v[j] = j < left ? __bfloat162float(p[j]) : 0.f;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               long long left,
                                               const float v[kPer]) {
    if (kVec) {
      unsigned int h[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        h[j] = __bfloat16_as_ushort(__float2bfloat16_rn(v[j]));
      *reinterpret_cast<uint2*>(p) = make_uint2(h[0] | (h[1] << 16),
                                                h[2] | (h[3] << 16));
    } else {
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        if (j < left) p[j] = __float2bfloat16_rn(v[j]);
    }
  }
};

// x and out may be the same buffer (the executor's in-place fold), so
// neither pointer is __restrict__.
template <typename T, bool kVec, bool kRoundEach>
__global__ void __launch_bounds__(kThreads)
segment_reduce_kernel(const T* x, const float* __restrict__ mask,
                      const long long* __restrict__ rows, T* out,
                      const long long* __restrict__ out_rows, int C,
                      long long D) {
  __shared__ float m_sh[kThreads];
  const long long g = blockIdx.y;
  const long long d0 =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kPer;
  const long long in_row = rows ? rows[g] : g * C;
  const long long out_row = out_rows ? out_rows[g] : g;
  const float* m_row = mask + g * C;
  const bool live = d0 < D;
  float acc[kPer] = {0.f, 0.f, 0.f, 0.f};
  for (int c0 = 0; c0 < C; c0 += kThreads) {
    const int n = min(kThreads, C - c0);
    __syncthreads();  // the previous chunk's reads of m_sh are done
    if (threadIdx.x < n) m_sh[threadIdx.x] = m_row[c0 + threadIdx.x];
    __syncthreads();
    if (!live) continue;
    for (int i = 0; i < n; ++i) {
      const float m = m_sh[i];
      if (m == 0.f) continue;  // a masked-out row is not read
      float v[kPer];
      Io<T, kVec>::load(x + (in_row + c0 + i) * D + d0, D - d0, v);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        acc[j] = __fadd_rn(acc[j], __fmul_rn(m, v[j]));
        if (kRoundEach) acc[j] = __bfloat162float(__float2bfloat16_rn(acc[j]));
      }
    }
  }
  if (live) Io<T, kVec>::store(out + out_row * D + d0, D - d0, acc);
}

template <typename T, bool kRoundEach>
int launch(const void* x, const void* mask, const void* rows, void* out,
           const void* out_rows, int G, int C, long long D, int vec,
           void* stream) {
  if (G <= 0 || D <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(static_cast<unsigned>((D + kTileD - 1) / kTileD),
                  static_cast<unsigned>(G));
  const auto s = static_cast<cudaStream_t>(stream);
  const T* xp = static_cast<const T*>(x);
  const float* mp = static_cast<const float*>(mask);
  const long long* rp = static_cast<const long long*>(rows);
  const long long* op = static_cast<const long long*>(out_rows);
  T* outp = static_cast<T*>(out);
  if (vec)
    segment_reduce_kernel<T, true, kRoundEach>
        <<<grid, kThreads, 0, s>>>(xp, mp, rp, outp, op, C, D);
  else
    segment_reduce_kernel<T, false, kRoundEach>
        <<<grid, kThreads, 0, s>>>(xp, mp, rp, outp, op, C, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int soar_segment_reduce_f32(const void* x, const void* mask, const void* rows,
                            void* out, const void* out_rows, int G, int C,
                            long long D, int vec, void* stream) {
  return launch<float, false>(x, mask, rows, out, out_rows, G, C, D, vec,
                              stream);
}

int soar_segment_reduce_bf16(const void* x, const void* mask, const void* rows,
                             void* out, const void* out_rows, int G, int C,
                             long long D, int vec, void* stream) {
  return launch<__nv_bfloat16, false>(x, mask, rows, out, out_rows, G, C, D,
                                      vec, stream);
}

int soar_segment_reduce_bf16_round_each(const void* x, const void* mask,
                                        const void* rows, void* out,
                                        const void* out_rows, int G, int C,
                                        long long D, int vec, void* stream) {
  return launch<__nv_bfloat16, true>(x, mask, rows, out, out_rows, G, C, D,
                                     vec, stream);
}

}  // extern "C"
