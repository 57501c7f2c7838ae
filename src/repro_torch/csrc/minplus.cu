// Batched min-plus (tropical) convolution for Hopper (sm_90a):
//   out[r, i] = min_{j} (j <= i ? a[r, i-j] : BIG) + b[r, j],  (rows, K) each.
//
// Replaces the Pallas kernel src/repro/kernels/minplus/minplus.py ::
// minplus_pallas (body _minplus_kernel). In the port it carries the color
// traceback's partial chains (chain_fold with collect=True), one launch per
// child index.
//
// Bound on the H100: a row does 2*K*K operations (add, min) on 3*K values
// moved, so at the color's widths (K <= 65 at k = 64) the kernel sits at or
// below the fp32 ridge (~20 operations per byte) and is bound by bytes and
// by latency for the narrow deep levels (K = 5..17, many rows).
// Design: one warp per row; the row's two operands are staged once in
// shared memory, and each lane owns the outputs i = lane, lane + 32, ...,
// reading the shifted operand from shared memory. No atomics, no
// reductions across lanes: every output is one thread's exact min.
#include <cuda_runtime.h>

#include "minplus.cuh"

namespace {

constexpr int kWarps = 8;  // rows per block

template <typename T>
__global__ void minplus_kernel(const T* __restrict__ a, const T* __restrict__ b,
                               T* __restrict__ out, long long rows, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (row >= rows) return;  // whole warp leaves; no block barrier below
  T* sa = smem + static_cast<size_t>(warp) * 2 * K;
  T* sb = sa + K;
  const T* ar = a + row * K;
  const T* br = b + row * K;
  for (int i = lane; i < K; i += 32) {
    sa[i] = ar[i];
    sb[i] = br[i];
  }
  __syncwarp();
  T* o = out + row * K;
  for (int i = lane; i < K; i += 32) o[i] = soar::minplus_at(sa, sb, i, K);
}

template <typename T>
int launch_minplus(const void* a, const void* b, void* out, long long rows,
                   int K, void* stream) {
  if (rows <= 0 || K <= 0) return static_cast<int>(cudaSuccess);
  const size_t smem = static_cast<size_t>(kWarps) * 2 * K * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        minplus_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long blocks = (rows + kWarps - 1) / kWarps;
  minplus_kernel<T><<<static_cast<unsigned>(blocks), kWarps * 32, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(out),
      rows, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int soar_minplus_f32(const void* a, const void* b, void* out, long long rows,
                     int K, void* stream) {
  return launch_minplus<float>(a, b, out, rows, K, stream);
}

int soar_minplus_f64(const void* a, const void* b, void* out, long long rows,
                     int K, void* stream) {
  return launch_minplus<double>(a, b, out, rows, K, stream);
}

const char* soar_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
