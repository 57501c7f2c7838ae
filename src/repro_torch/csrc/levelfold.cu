// Fused level fold of the batched SOAR-Gather for Hopper (sm_90a): one
// launch per tree level, across all B instances.
//
// Replaces the Pallas kernel src/repro/kernels/minplus/levelfold.py ::
// level_fold_pallas (body _levelfold_kernel -> _fold_math -> _minplus_loop).
// For each internal node w of the level it chains the min-plus convolutions
// of its children's tables (child 0 first, left to right; index C-1 of the
// child block is the all-zeros identity that missing children point at),
// for the nl red rows and for the blue row, then writes
//   out[r, i] = cummin_i min(acc_r[r, i] + load*rho[r],
//                            avail && i > 0 ? acc_b[i-1] + send*rho[r] : BIG)
// with no fused multiply-add (minplus.cuh).
//
// Bound on the H100: a chain step costs 2*K*K operations per row against
// 2*K values read, so at the wide levels (K = 65 at k = 64) the fold does
// ~10 operations per byte moved, under the fp32 ridge of ~20: the bound is
// bytes, and at the narrow deep levels (K = 5..17, most of the nodes) it is
// bytes and latency. The TPU kernel padded K to 128 lanes; here K stays the
// level's own capped width and the launch grows with the node count.
// Design: one block per (instance, tile of nt nodes); one warp per (node,
// row) chain, rows = nl red + 1 blue. Each chain's accumulator lives in
// shared memory and is updated in place, top chunk of 32 outputs first (an
// output i reads only acc[0..i]), so a partial never goes back to device
// memory. After a block barrier one warp per (node, red row) applies the
// red/blue epilogue and the at-most-k cummin as a warp prefix-min (exact in
// any order), and writes the level's block once.
#include <cuda_runtime.h>

#include "minplus.cuh"

namespace {

constexpr int kMaxWarps = 32;
constexpr int kChainsPerBlock = 16;  // target (node, row) chains per block

template <typename T>
__global__ void levelfold_kernel(const T* __restrict__ xs,
                                 const T* __restrict__ xb,
                                 const long long* __restrict__ kid,
                                 const T* __restrict__ load,
                                 const T* __restrict__ send,
                                 const unsigned char* __restrict__ avail,
                                 const T* __restrict__ rho, T* __restrict__ out,
                                 int C, int W, int max_c, int nl, int K,
                                 int nt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int rows = nl + 1;  // nl red rows, then the blue row
  const int chains = nt * rows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const long long b = blockIdx.y;
  const int w0 = blockIdx.x * nt;
  T* accs = smem;  // [chains][K]
  T* child = smem + static_cast<size_t>(chains) * K +
             static_cast<size_t>(warp) * K;  // this warp's operand row

  // Phase 1: the min-plus chain over the node's children, one warp each.
  for (int p = warp; p < chains; p += nwarps) {
    const int n = p / rows;
    const int r = p - n * rows;
    const int w = w0 + n;
    if (w >= W) continue;
    T* acc = accs + static_cast<size_t>(p) * K;
    const long long* kw = kid + (b * W + w) * max_c;
    const T* src = r < nl ? xs + ((b * C + kw[0]) * nl + r) * K
                          : xb + (b * C + kw[0]) * K;
    for (int i = lane; i < K; i += 32) acc[i] = src[i];
    for (int m = 1; m < max_c; ++m) {
      src = r < nl ? xs + ((b * C + kw[m]) * nl + r) * K
                   : xb + (b * C + kw[m]) * K;
      for (int i = lane; i < K; i += 32) child[i] = src[i];
      __syncwarp();
      for (int base = ((K - 1) >> 5) << 5; base >= 0; base -= 32) {
        const int i = base + lane;
        const T v = i < K ? soar::minplus_at(acc, child, i, K) : T(0);
        __syncwarp();  // every lane has read acc[0..base+31]
        if (i < K) acc[i] = v;
        __syncwarp();
      }
    }
  }
  __syncthreads();

  // Phase 2: red/blue epilogue and cummin, one warp per (node, red row).
  const unsigned full = 0xffffffffu;
  for (int p = warp; p < nt * nl; p += nwarps) {
    const int n = p / nl;
    const int r = p - n * nl;
    const int w = w0 + n;
    if (w >= W) continue;  // warp-uniform
    const T* ar = accs + static_cast<size_t>(n * rows + r) * K;
    const T* ab = accs + static_cast<size_t>(n * rows + nl) * K;
    const long long node = b * W + w;
    const T rr = rho[node * nl + r];
    const T lr = soar::mul_rn(load[node], rr);
    const T sr = soar::mul_rn(send[node], rr);
    const bool av = avail[node] != 0;
    T* o = out + (node * nl + r) * K;
    T carry = soar::inf<T>();
    for (int base = 0; base < K; base += 32) {
      const int i = base + lane;
      T v = soar::inf<T>();
      if (i < K) {
        const T red = soar::add_rn(ar[i], lr);
        const T blue = (av && i > 0) ? soar::add_rn(ab[i - 1], sr)
                                     : soar::big<T>();
        v = soar::min_of(red, blue);
      }
      for (int s = 1; s < 32; s <<= 1) {
        const T u = __shfl_up_sync(full, v, s);
        if (lane >= s) v = soar::min_of(v, u);
      }
      v = soar::min_of(v, carry);
      carry = __shfl_sync(full, v, 31);
      if (i < K) o[i] = v;
    }
  }
}

template <typename T>
int launch_levelfold(const void* xs, const void* xb, const void* kid,
                     const void* load, const void* send, const void* avail,
                     const void* rho, void* out, int B, int C, int W,
                     int max_c, int nl, int K, void* stream) {
  if (B <= 0 || W <= 0 || K <= 0) return static_cast<int>(cudaSuccess);
  if (B > 65535 || max_c < 1 || C < 1 || nl < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = nl + 1;
  int nt = kChainsPerBlock / rows;
  if (nt < 1) nt = 1;
  if (nt > W) nt = W;
  const int warps = nt * rows < kMaxWarps ? nt * rows : kMaxWarps;
  const size_t smem =
      (static_cast<size_t>(nt) * rows + warps) * K * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        levelfold_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((W + nt - 1) / nt, B);
  levelfold_kernel<T><<<grid, warps * 32, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(xs), static_cast<const T*>(xb),
      static_cast<const long long*>(kid), static_cast<const T*>(load),
      static_cast<const T*>(send), static_cast<const unsigned char*>(avail),
      static_cast<const T*>(rho), static_cast<T*>(out), C, W, max_c, nl, K,
      nt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int soar_levelfold_f32(const void* xs, const void* xb, const void* kid,
                       const void* load, const void* send, const void* avail,
                       const void* rho, void* out, int B, int C, int W,
                       int max_c, int nl, int K, void* stream) {
  return launch_levelfold<float>(xs, xb, kid, load, send, avail, rho, out, B,
                                 C, W, max_c, nl, K, stream);
}

int soar_levelfold_f64(const void* xs, const void* xb, const void* kid,
                       const void* load, const void* send, const void* avail,
                       const void* rho, void* out, int B, int C, int W,
                       int max_c, int nl, int K, void* stream) {
  return launch_levelfold<double>(xs, xb, kid, load, send, avail, rho, out, B,
                                  C, W, max_c, nl, K, stream);
}

}  // extern "C"
