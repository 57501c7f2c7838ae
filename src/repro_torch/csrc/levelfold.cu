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
// Bound on the H100: a real chain step costs 2*K*K operations per row
// against 2*K values read, about 10 operations a byte at K = 65, under the
// float32 ridge of ~20, so the bytes bound the work; the real bound is
// latency. The deep levels of a binary forest hold tens of thousands of
// nodes at K = 5..17 with one real step each, and a star-shaped forest
// pads max_children to 128 where most nodes have one to five children.
// Design:
// - a chain gets a group of g = pow2ceil(min(K, 32)) lanes, so a warp
//   carries 32/g chains and K = 5 idles 3 lanes of 8, not 27 of 32; where
//   the level would run more than about four waves of threads, g halves
//   and each lane owns several outputs (soar_lane_group in minplus.cuh):
//   the deep levels of a binary forest run one thread a chain;
// - a block carries as many nodes as fill 512 threads (halved while its
//   shared memory would pass 96 KiB), a node's nl red chains and its blue
//   chain together;
// - sentinel children never cost a K*K step: a warp compacts each node's
//   real children once, and a run of r sentinels is one closed-form scan
//   (group_identity_steps), bitwise equal to the r steps it replaces;
// - the next three real children's rows are copied into a ring of shared
//   memory (cp.async) while the current step runs, so a node with a
//   hundred children does not wait a device-memory round trip per child;
// - the accumulators stay in shared memory, updated in place; after one
//   block barrier the same lane groups run the red/blue epilogue and the
//   at-most-k cummin as a segmented prefix minimum (exact in any order)
//   and write the level's block once.
#include <cuda_runtime.h>

#include "minplus.cuh"

namespace {

constexpr int kThreads = 512;              // most threads a block runs
constexpr int kRing = 4;                   // children's rows in flight
constexpr size_t kSmemBudget = 96 * 1024;  // a block's shared memory

// Wait until at most n (0..kRing-1) of this thread's copy groups pend.
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  if (n >= 3) soar::cp_async_wait<3>();
  else if (n == 2) soar::cp_async_wait<2>();
  else if (n == 1) soar::cp_async_wait<1>();
  else soar::cp_async_wait<0>();
}

template <typename T>
__device__ __forceinline__ const T* chain_row(const T* xs, const T* xb,
                                              long long b, int C, int nl,
                                              int K, int r, int c) {
  return r < nl ? xs + ((b * C + c) * nl + r) * K : xb + (b * C + c) * K;
}

template <typename T>
__device__ __forceinline__ void group_copy_async(T* dst, const T* src, int K,
                                                 int q, int g) {
  for (int i = q; i < K; i += g) soar::cp_async(dst + i, src + i);
}

template <typename T>
__global__ void levelfold_kernel(const T* __restrict__ xs,
                                 const T* __restrict__ xb,
                                 const long long* __restrict__ kid,
                                 const T* __restrict__ load,
                                 const T* __restrict__ send,
                                 const unsigned char* __restrict__ avail,
                                 const T* __restrict__ rho, T* __restrict__ out,
                                 int C, int W, int max_c, int nl, int K,
                                 int nt, int g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rows = nl + 1;  // nl red rows, then the blue row
  const int chains = nt * rows;
  const int slots = blockDim.x / g;
  const int slot = threadIdx.x / g;
  const int q = threadIdx.x % g;
  const unsigned mask = soar::group_mask(g);
  const long long b = blockIdx.y;
  const int w0 = blockIdx.x * nt;
  T* accs = reinterpret_cast<T*>(smem_raw);              // [chains][K]
  T* bufs = accs + static_cast<size_t>(chains) * K;      // [slots][kRing][K]
  int* nreal =
      reinterpret_cast<int*>(bufs + static_cast<size_t>(slots) * kRing * K);
  int* first = nreal + nt;                             // [nt] child 0
  int* pos = first + nt;        // [nt][max_c] positions m >= 1 of real kids
  int* cid = pos + static_cast<size_t>(nt) * max_c;    // ... and their index

  // Phase 0: one warp per node compacts its real children (m >= 1).
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long sentinel = C - 1;
  for (int n = warp; n < nt; n += static_cast<int>(blockDim.x >> 5)) {
    const int w = w0 + n;
    if (w >= W) continue;  // warp-uniform; phases 1-2 skip it too
    const long long* kw = kid + (b * W + w) * max_c;
    int cnt = 0;
    for (int base = 1; base < max_c; base += 32) {
      const int m = base + lane;
      const long long c = m < max_c ? kw[m] : sentinel;
      const unsigned bits = __ballot_sync(0xffffffffu, c != sentinel);
      if (c != sentinel) {
        const int at = cnt + __popc(bits & ((1u << lane) - 1u));
        pos[n * max_c + at] = m;
        cid[n * max_c + at] = static_cast<int>(c);
      }
      cnt += __popc(bits);
    }
    if (lane == 0) {
      nreal[n] = cnt;
      first[n] = static_cast<int>(kw[0]);
    }
  }
  __syncthreads();

  // Phase 1: each group folds its chains over the node's children.
  T* ring = bufs + static_cast<size_t>(slot) * kRing * K;
  for (int p = slot; p < chains; p += slots) {
    const int n = p / rows;
    const int r = p - n * rows;
    if (w0 + n >= W) continue;  // group-uniform
    T* acc = accs + static_cast<size_t>(p) * K;
    const int cnt = nreal[n];
    const int* pn = pos + n * max_c;
    const int* cn = cid + n * max_c;
    // one copy group per row: child 0 with real child 0, then real
    // children 1..kRing-2; real child t lands in ring slot t % kRing
    group_copy_async(acc, chain_row(xs, xb, b, C, nl, K, r, first[n]), K, q,
                     g);
    int issued = 0;  // real children's rows issued
    do {
      if (issued < cnt)
        group_copy_async(ring + issued * K,
                         chain_row(xs, xb, b, C, nl, K, r, cn[issued]), K, q,
                         g);
      soar::cp_async_commit();
      ++issued;
    } while (issued < kRing - 1 && issued < cnt);
    int prev = 0;  // position of the last child folded
    for (int t = 0; t < cnt; ++t) {
      if (issued < cnt) {  // into the slot that step t-1 read and left
        group_copy_async(ring + (issued % kRing) * K,
                         chain_row(xs, xb, b, C, nl, K, r, cn[issued]), K, q,
                         g);
        soar::cp_async_commit();
        ++issued;
      }
      cp_async_wait_upto(issued - 1 - t);  // row t (and child 0) landed
      __syncwarp(mask);
      const int m = pn[t];
      if (m - prev > 1)
        soar::group_identity_steps(acc, acc, K, m - prev - 1, q, g, mask);
      soar::group_minplus_step(acc, ring + (t % kRing) * K, acc, K, q, g,
                               mask);
      prev = m;
    }
    if (cnt == 0) {
      soar::cp_async_wait<0>();
      __syncwarp(mask);
    }
    if (max_c - 1 > prev)  // the trailing run of sentinel children
      soar::group_identity_steps(acc, acc, K, max_c - 1 - prev, q, g, mask);
  }
  __syncthreads();

  // Phase 2: red/blue epilogue and cummin, one group per (node, red row).
  for (int p = slot; p < nt * nl; p += slots) {
    const int n = p / nl;
    const int r = p - n * nl;
    const int w = w0 + n;
    if (w >= W) continue;  // group-uniform
    const T* ar = accs + static_cast<size_t>(n * rows + r) * K;
    const T* ab = accs + static_cast<size_t>(n * rows + nl) * K;
    const long long node = b * W + w;
    const T rr = rho[node * nl + r];
    const T lr = soar::mul_rn(load[node], rr);
    const T sr = soar::mul_rn(send[node], rr);
    const bool av = avail[node] != 0;
    T* o = out + (node * nl + r) * K;
    T carry = soar::inf<T>();
    for (int base = 0; base < K; base += g) {
      const int i = base + q;
      T v = soar::inf<T>();
      if (i < K) {
        const T red = soar::add_rn(ar[i], lr);
        const T blue = (av && i > 0) ? soar::add_rn(ab[i - 1], sr)
                                     : soar::big<T>();
        v = soar::min_of(red, blue);
      }
      v = soar::min_of(soar::group_prefix_min(v, q, g, mask), carry);
      carry = __shfl_sync(mask, v, g - 1, g);
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
  const int g = soar_lane_group(K, static_cast<long long>(B) * W * rows);
  const int per_node = rows * g;  // lanes of one node's chains
  // as many nodes as fill the block, the block halved while its shared
  // memory (accumulators, rings, child lists) would pass the budget
  int nt = 1;
  int threads = kThreads;
  size_t smem = 0;
  for (int cap = kThreads;; cap /= 2) {
    nt = per_node >= cap ? 1 : (cap / per_node < W ? cap / per_node : W);
    threads = per_node >= cap ? cap : (nt * per_node + 31) / 32 * 32;
    smem = (static_cast<size_t>(nt) * rows * K +
            static_cast<size_t>(threads / g) * kRing * K) * sizeof(T) +
           static_cast<size_t>(nt) * (2 + 2 * static_cast<size_t>(max_c)) *
               sizeof(int);
    if (smem <= kSmemBudget || cap <= 32) break;
  }
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        levelfold_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((W + nt - 1) / nt, B);
  levelfold_kernel<T><<<grid, threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(xs), static_cast<const T*>(xb),
      static_cast<const long long*>(kid), static_cast<const T*>(load),
      static_cast<const T*>(send), static_cast<const unsigned char*>(avail),
      static_cast<const T*>(rho), static_cast<T*>(out), C, W, max_c, nl, K,
      nt, g);
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
