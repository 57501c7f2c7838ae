// Gather-table segment reduce for Hopper (sm_90a): the Reduce at an
// aggregating switch,
//   out[o[g], d] = fold_c mask[g, c] * row(table[g, c])[d],
// where row(i) is row i of a (R0, D) source x for i < R0 and row i - R0 of a
// (P, D) scratch of partials otherwise. An entry of -1, or a mask of 0, is
// not read. The JAX API's stacked (G, C, D) form is the table g*C + c over
// x viewed as (G*C, D) (table == nullptr), written to rows 0..G-1 of a fresh
// output (out_rows == nullptr).
//
// Replaces the Pallas kernel src/repro/kernels/segment_reduce/
// segment_reduce.py :: segment_reduce_pallas (body _segsum_kernel). In the
// port it runs every Reduce of the SOAR reduce executor
// (repro_torch/collectives/tree_allreduce.py), which compiles its program
// into these tables: a call is its Reduce launches and nothing else, with
// no slot buffer.
//
// Summation order: the sum over c is a strict left fold in ascending c,
// acc = ((0 + m_0 x_0) + m_1 x_1) + ..., each product and each sum rounded
// on its own (__fmul_rn, __fadd_rn; the build also passes -fmad=false).
// No tree reduction and no split over c: that order is what lets the
// executor reproduce the JAX package's _left_fold bit for bit. A row that
// is not read differs from adding 0 * x only in the sign of a zero sum (the
// sum starts at +0). bfloat16 inputs accumulate in float32 and are rounded
// once at the store, or, with kRoundEach (entry
// soar_segment_reduce_bf16_round_each), rounded to bfloat16 after every
// add: that is what the JAX executor's fold does with a bfloat16 buffer
// (its fori_loop carries a bfloat16 accumulator; tested bitwise in
// tests/test_torch_executor.py). Rounding the float32 sum of two bfloat16
// values to bfloat16 is the correctly rounded bfloat16 sum
// (24 >= 2 * 8 + 2 bits), so this is bfloat16 addition.
//
// Bound on the H100: bytes. Each output element costs one read of every
// row the table names and one write, at 2 operations per read value, far
// below the fp32 ridge; the least time is (rows read + G) * D * itemsize
// over 3.35 TB/s. Design:
//  * 16-byte loads for both dtypes: a thread owns 4 float32 or 8 bfloat16
//    consecutive d, where D is a multiple of that and every base pointer is
//    16-byte aligned; scalar loads of the same d otherwise.
//  * Several rows in flight: warp 0 stages a chunk of the group's table and
//    mask in shared memory, compacted by ballot to the rows that are read
//    (in ascending c), as row pointers. Every thread then issues the loads
//    of kDepth rows into registers before their adds, which still run in
//    ascending c. Which rows are read is the same for every thread of the
//    block, so the skip is uniform. kDepth is 2: `chip_smoke.py --reduce`
//    builds 1, 2, 4 and 8 and times them on the executor's launches, where
//    1 and 2 are the fastest and 4 and 8 up to 2% slower (a full grid of
//    16-byte loads already keeps enough bytes in flight).
//  * Grid (ceil(D / tile), G) with tile / (values a thread) threads a block;
//    the launcher narrows the tile (down to 256 d) where the grid would
//    fill fewer than two waves of the 132 SMs (segment_reduce.tile_of).
// Row offsets are 64-bit (row * D can pass 2^31). Rows read and rows
// written must differ within one launch (the executor's partials are each
// written once, before they are read), so the scratch may be both a source
// and the output; neither pointer is __restrict__.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef SOAR_REDUCE_DEPTH
#define SOAR_REDUCE_DEPTH 2
#endif

namespace {

constexpr int kMaxThreads = 256;
constexpr int kChunk = 256;                 // table entries staged at once
constexpr int kDepth = SOAR_REDUCE_DEPTH;   // rows whose loads are in flight

__device__ __forceinline__ float bf16_bits_to_float(unsigned int bits16) {
  return __uint_as_float(bits16 << 16);
}

__device__ __forceinline__ unsigned int float_to_bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// One thread's kPer values of one row: a 16-byte vector (kVec) or kPer
// scalar loads, `left` values remaining in the row.
template <typename T, bool kVec>
struct Frag;

template <bool kVec>
struct Frag<float, kVec> {
  static constexpr int kPer = 4;
  float v[kPer];
  __device__ __forceinline__ void load(const float* p, long long left) {
    if (kVec) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p));
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else {
#pragma unroll
      for (int j = 0; j < kPer; ++j) v[j] = j < left ? p[j] : 0.f;
    }
  }
  __device__ __forceinline__ float get(int j) const { return v[j]; }
  static __device__ __forceinline__ void store(float* p, long long left,
                                               const float a[kPer]) {
    if (kVec) {
      *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
    } else {
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        if (j < left) p[j] = a[j];
    }
  }
};

template <bool kVec>
struct Frag<__nv_bfloat16, kVec> {
  static constexpr int kPer = 8;
  unsigned int w[kPer / 2];                 // two bfloat16 bit patterns each
  __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                       long long left) {
    if (kVec) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
    } else {
      const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
      for (int j = 0; j < kPer / 2; ++j) {
        const unsigned int lo = 2 * j < left ? h[2 * j] : 0u;
        const unsigned int hi = 2 * j + 1 < left ? h[2 * j + 1] : 0u;
        w[j] = lo | (hi << 16);
      }
    }
  }
  __device__ __forceinline__ float get(int j) const {
    return bf16_bits_to_float((w[j / 2] >> (16 * (j % 2))) & 0xffffu);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               long long left,
                                               const float a[kPer]) {
    if (kVec) {
      unsigned int h[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) h[j] = float_to_bf16_bits(a[j]);
      *reinterpret_cast<uint4*>(p) =
          make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16),
                     h[4] | (h[5] << 16), h[6] | (h[7] << 16));
    } else {
      unsigned short* o = reinterpret_cast<unsigned short*>(p);
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        if (j < left) o[j] = static_cast<unsigned short>(
            float_to_bf16_bits(a[j]));
    }
  }
};

template <typename T, bool kVec, bool kRoundEach>
__global__ void __launch_bounds__(kMaxThreads)
gather_reduce_kernel(const T* x, long long r0, const T* scratch,
                     const long long* __restrict__ table,
                     const float* __restrict__ mask, T* out,
                     const long long* __restrict__ out_rows, int C,
                     long long D) {
  using F = Frag<T, kVec>;
  constexpr int kPer = F::kPer;
  __shared__ const T* row_sh[kChunk];
  __shared__ float m_sh[kChunk];
  __shared__ int n_sh;
  const long long g = blockIdx.y;
  const long long d0 =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * kPer;
  const bool live = d0 < D;
  const long long left = D - d0;
  float acc[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) acc[j] = 0.f;
  for (int c0 = 0; c0 < C; c0 += kChunk) {
    const int n = min(kChunk, C - c0);
    __syncthreads();  // the previous chunk's reads of row_sh/m_sh are done
    if (threadIdx.x < 32) {
      // warp 0 keeps the entries that are read, in ascending c
      int kept = 0;
      for (int i0 = 0; i0 < n; i0 += 32) {
        const int i = i0 + static_cast<int>(threadIdx.x);
        long long e = -1;
        float m = 0.f;
        if (i < n) {
          const long long at = g * C + c0 + i;
          e = table ? table[at] : at;
          m = mask ? mask[at] : 1.f;
        }
        const bool take = e >= 0 && m != 0.f;
        const unsigned int ball = __ballot_sync(0xffffffffu, take);
        if (take) {
          const int k = kept + __popc(ball & ((1u << threadIdx.x) - 1u));
          row_sh[k] = e < r0 ? x + e * D : scratch + (e - r0) * D;
          m_sh[k] = m;
        }
        kept += __popc(ball);
      }
      if (threadIdx.x == 0) n_sh = kept;
    }
    __syncthreads();
    const int nk = n_sh;
    if (!live) continue;
    for (int i = 0; i < nk; i += kDepth) {
      F f[kDepth];
#pragma unroll
      for (int u = 0; u < kDepth; ++u)
        if (i + u < nk) f[u].load(row_sh[i + u] + d0, left);
#pragma unroll
      for (int u = 0; u < kDepth; ++u) {
        if (i + u < nk) {
          const float m = m_sh[i + u];
#pragma unroll
          for (int j = 0; j < kPer; ++j) {
            acc[j] = __fadd_rn(acc[j], __fmul_rn(m, f[u].get(j)));
            if (kRoundEach)
              acc[j] = __bfloat162float(__float2bfloat16_rn(acc[j]));
          }
        }
      }
    }
  }
  if (live) {
    const long long o = out_rows ? out_rows[g] : g;
    F::store(out + o * D + d0, left, acc);
  }
}

template <typename T, bool kRoundEach>
int launch(const void* x, long long r0, const void* scratch,
           const void* table, const void* mask, void* out,
           const void* out_rows, int G, int C, long long D, int tile,
           int vec, void* stream) {
  constexpr int kPer = Frag<T, true>::kPer;
  if (G <= 0 || D <= 0) return static_cast<int>(cudaSuccess);
  const int threads = tile / kPer;
  if (C < 0 || tile % kPer != 0 || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || G > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((D + tile - 1) / tile),
                  static_cast<unsigned>(G));
  const auto s = static_cast<cudaStream_t>(stream);
  const T* xp = static_cast<const T*>(x);
  const T* sp = static_cast<const T*>(scratch);
  const long long* tp = static_cast<const long long*>(table);
  const float* mp = static_cast<const float*>(mask);
  const long long* op = static_cast<const long long*>(out_rows);
  T* outp = static_cast<T*>(out);
  if (vec)
    gather_reduce_kernel<T, true, kRoundEach><<<grid, threads, 0, s>>>(
        xp, r0, sp, tp, mp, outp, op, C, D);
  else
    gather_reduce_kernel<T, false, kRoundEach><<<grid, threads, 0, s>>>(
        xp, r0, sp, tp, mp, outp, op, C, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int soar_segment_reduce_f32(const void* x, long long r0, const void* scratch,
                            const void* table, const void* mask, void* out,
                            const void* out_rows, int G, int C, long long D,
                            int tile, int vec, void* stream) {
  return launch<float, false>(x, r0, scratch, table, mask, out, out_rows, G,
                              C, D, tile, vec, stream);
}

int soar_segment_reduce_bf16(const void* x, long long r0, const void* scratch,
                             const void* table, const void* mask, void* out,
                             const void* out_rows, int G, int C, long long D,
                             int tile, int vec, void* stream) {
  return launch<__nv_bfloat16, false>(x, r0, scratch, table, mask, out,
                                      out_rows, G, C, D, tile, vec, stream);
}

int soar_segment_reduce_bf16_round_each(const void* x, long long r0,
                                        const void* scratch,
                                        const void* table, const void* mask,
                                        void* out, const void* out_rows,
                                        int G, int C, long long D, int tile,
                                        int vec, void* stream) {
  return launch<__nv_bfloat16, true>(x, r0, scratch, table, mask, out,
                                     out_rows, G, C, D, tile, vec, stream);
}

}  // extern "C"
