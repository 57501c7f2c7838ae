// Min-plus kernels for Hopper (sm_90a), the counterparts of the Pallas
// kernel src/repro/kernels/minplus/minplus.py :: minplus_pallas (body
// _minplus_kernel), the batched tropical convolution
//   out[r, i] = min_{j} (j <= i ? a[r, i-j] : BIG) + b[r, j],  (rows, K) each.
//
// 1. color_level_kernel: the on-device SOAR-Color's chains and budget split
//    for one tree level, one launch per level with internal nodes. For each
//    internal node it folds the red chain (children's tables at row el+1)
//    and the blue chain (row 1) over its children, keeping every partial;
//    takes red_val = chain_r[i] + load*rho and blue_val = chain_b[i-1] +
//    send*rho (blue iff strictly smaller); and replays the mSplit, last
//    child first, each step the first j <= bud minimizing
//    chain[m-1][bud-j] + child_m[j]. It writes only isblue and the split.
//    The plain version is kernels/minplus/color.py :: color_level_torch.
// 2. minplus_kernel: the single convolution (`ops.minplus`).
//
// Bound on the H100: a real chain step costs 2*K*K operations on 2*K values
// read, about 10 operations a byte at K = 65, so the bytes bound the work
// (the children's rows at two rows, once); the real bound is latency.
// Before, the color made one convolution launch per child index over a
// materialised stack of mostly identity rows (1,397 launches a solve on a
// forest whose max_children buckets to 128) and replayed the split with
// about nine torch launches per child index.
// Design of the color-level kernel:
// - a node's two chains each get a group of g = pow2ceil(min(Kc, 32))
//   lanes, halved where the level would run more than about four waves of
//   threads (soar_lane_group in minplus.cuh); a block holds up to 256
//   threads of nodes;
// - each group stages its children's rows up to the last real child
//   (zeros for sentinels; none is read from the identity) into a slab of
//   shared memory, or of scratch device memory when one node's slab would
//   pass the budget the wrapper gives, and folds them there, each partial
//   chain in its own row;
// - sentinel children cost one O(K) closed-form scan each, and only the
//   two after the last real child are folded at all: a chain past them
//   no longer changes, so the split steps that read it take j = 0 without
//   a scan (the partial min(prefix-min, BIG) is non-increasing, the
//   child's row zero, so j = 0 is the first minimizer);
// - every other split step is one group argmin (lowest j on ties).
#include <climits>
#include <cuda_runtime.h>

#include "minplus.cuh"

namespace {

constexpr int kWarps = 8;        // rows per block (minplus_kernel)
constexpr int kColorThreads = 256;  // most threads of a color-level block

// One level of the color: see the header. Node (b, w) takes groups 2n
// (red) and 2n + 1 (blue) of its block; slab holds the chain's partials
// part[m] and its children's rows xc[m], m = 0..max_c-1, each Kc wide.
template <typename T>
__global__ void color_level_kernel(
    const T* __restrict__ ch, const long long* __restrict__ kid,
    const long long* __restrict__ bud_in, const long long* __restrict__ el,
    const T* __restrict__ rl, const T* __restrict__ load,
    const T* __restrict__ send, const unsigned char* __restrict__ avail,
    unsigned char* __restrict__ isblue, long long* __restrict__ split,
    T* __restrict__ scratch, int W1, int nl1, int ldk, int Wi, int max_c,
    int Kc, int nt, int g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int slot = threadIdx.x / g;
  const int q = threadIdx.x % g;
  const int n = slot >> 1;
  const int chain = slot & 1;  // 0: red, row el+1; 1: blue, row 1
  const unsigned mask = soar::group_mask(g);
  const long long b = blockIdx.y;
  const int w = blockIdx.x * nt + n;
  const bool live = n < nt && w < Wi;  // group-uniform
  const long long node = b * Wi + (live ? w : 0);
  const size_t slab = 2 * static_cast<size_t>(max_c) * Kc;
  T* const own = scratch != nullptr
                     ? scratch + static_cast<size_t>(node * 2) * slab
                     : reinterpret_cast<T*>(smem_raw) +
                           static_cast<size_t>(n * 2) * slab;
  const long long* kw = kid + node * max_c;

  // Last real child (at least 0) and the last partial kept: past two
  // sentinel steps after it the chain does not change.
  int last = 0;
  if (live) {
    const int gbase = (threadIdx.x & 31) & ~(g - 1);
    for (int base = 0; base < max_c; base += g) {
      const int m = base + q;
      unsigned bits = __ballot_sync(mask, m < max_c && kw[m] != W1) & mask;
      if (bits) last = base + (31 - __clz(static_cast<int>(bits))) - gbase;
    }
  }
  const int lp = last + 2 < max_c - 1 ? last + 2 : max_c - 1;

  if (live) {
    T* part = own + chain * slab;
    T* xc = part + static_cast<size_t>(max_c) * Kc;
    // stage rows 0..lp at this chain's row, as the plain version gathers
    // them from the child block with the zero identity appended at W1
    const long long row = chain == 0 ? el[node] + 1 : 1;
    const long long inside = static_cast<long long>(W1) * nl1;
    const T* chb = ch + b * inside * ldk;
    for (int idx = q; idx < (lp + 1) * Kc; idx += g) {
      const int m = idx / Kc;
      const int j = idx - m * Kc;
      const long long flat = kw[m] * nl1 + row;
      xc[idx] = flat < inside ? chb[flat * ldk + j] : T(0);
    }
    __syncwarp(mask);
    for (int j = q; j < Kc; j += g) part[j] = xc[j];
    __syncwarp(mask);
    for (int m = 1; m <= lp; ++m) {
      T* dst = part + static_cast<size_t>(m) * Kc;
      const T* src = dst - Kc;
      if (kw[m] != W1)
        soar::group_minplus_step(src, xc + static_cast<size_t>(m) * Kc, dst,
                                 Kc, q, g, mask);
      else
        soar::group_identity_steps(src, dst, Kc, 1, q, g, mask);
    }
  }
  __syncthreads();  // both chains of every node are complete
  if (!live) return;

  const T* fin_r = own + static_cast<size_t>(lp) * Kc;
  const T* fin_b = own + slab + static_cast<size_t>(lp) * Kc;
  const long long i = bud_in[node];
  const int ic = static_cast<int>(i < Kc - 1 ? i : Kc - 1);
  const long long ibl = i - 1 < 0 ? 0 : (i - 1 < Kc - 1 ? i - 1 : Kc - 1);
  const T r = rl[node];
  const T red_val = soar::add_rn(fin_r[ic], soar::mul_rn(load[node], r));
  const T blue_val = (avail[node] != 0 && i >= 1)
                         ? soar::add_rn(fin_b[ibl], soar::mul_rn(send[node], r))
                         : soar::inf<T>();
  const bool blue = blue_val < red_val;  // strict, as in the serial solver
  if (chain != (blue ? 1 : 0)) return;   // the chosen chain's group splits

  const T* part = own + chain * slab;
  const T* xc = part + static_cast<size_t>(max_c) * Kc;
  long long* sp = split + node * max_c;
  for (int m = lp + 1 + q; m < max_c; m += g) sp[m] = 0;
  long long bud = i - (blue ? 1 : 0);
  for (int m = lp; m >= 1; --m) {
    const T* prev = part + static_cast<size_t>(m - 1) * Kc;
    const T* x = xc + static_cast<size_t>(m) * Kc;
    T bv = soar::inf<T>();
    int bj = INT_MAX;
    for (int j = q; j < Kc; j += g) {
      T v = soar::inf<T>();
      if (j <= bud) {
        const long long at = bud - j < Kc - 1 ? bud - j : Kc - 1;
        v = soar::add_rn(prev[at], x[j]);
      }
      if (bj == INT_MAX || v < bv) {
        bv = v;
        bj = j;
      }
    }
    soar::group_argmin(bv, bj, g, mask);
    if (q == 0) sp[m] = bj;
    bud -= bj;
  }
  if (q == 0) {
    sp[0] = bud;
    isblue[node] = blue ? 1 : 0;
  }
}

template <typename T>
int launch_color_level(const void* ch, const void* kid, const void* bud,
                       const void* el, const void* rl, const void* load,
                       const void* send, const void* avail, void* isblue,
                       void* split, void* scratch, int B, int W1, int nl1,
                       int ldk, int Wi, int max_c, int Kc, int smem_budget,
                       void* stream) {
  if (B <= 0 || Wi <= 0) return static_cast<int>(cudaSuccess);
  if (B > 65535 || W1 < 1 || nl1 < 2 || max_c < 1 || Kc < 1 || Kc > ldk)
    return static_cast<int>(cudaErrorInvalidValue);
  const int g = soar_lane_group(Kc, 2LL * B * Wi);
  // a node's slabs in shared memory (unless in scratch) fill the budget
  const size_t node_bytes = 2 * 2 * static_cast<size_t>(max_c) * Kc * sizeof(T);
  int nt = kColorThreads / (2 * g);
  if (scratch == nullptr) {
    if (node_bytes > static_cast<size_t>(smem_budget))
      return static_cast<int>(cudaErrorInvalidValue);
    const size_t fit = static_cast<size_t>(smem_budget) / node_bytes;
    if (fit < static_cast<size_t>(nt)) nt = static_cast<int>(fit);
  }
  if (nt > Wi) nt = Wi;
  const size_t smem = scratch == nullptr ? nt * node_bytes : 0;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        color_level_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int threads = (nt * 2 * g + 31) / 32 * 32;
  const dim3 grid((Wi + nt - 1) / nt, B);
  color_level_kernel<T><<<grid, threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(ch), static_cast<const long long*>(kid),
      static_cast<const long long*>(bud), static_cast<const long long*>(el),
      static_cast<const T*>(rl), static_cast<const T*>(load),
      static_cast<const T*>(send), static_cast<const unsigned char*>(avail),
      static_cast<unsigned char*>(isblue), static_cast<long long*>(split),
      static_cast<T*>(scratch), W1, nl1, ldk, Wi, max_c, Kc, nt, g);
  return static_cast<int>(cudaGetLastError());
}

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

int soar_color_level_f32(const void* ch, const void* kid, const void* bud,
                          const void* el, const void* rl, const void* load,
                          const void* send, const void* avail, void* isblue,
                          void* split, void* scratch, int B, int W1, int nl1,
                          int ldk, int Wi, int max_c, int Kc, int smem_budget,
                          void* stream) {
  return launch_color_level<float>(ch, kid, bud, el, rl, load, send, avail,
                                   isblue, split, scratch, B, W1, nl1, ldk,
                                   Wi, max_c, Kc, smem_budget, stream);
}

int soar_color_level_f64(const void* ch, const void* kid, const void* bud,
                          const void* el, const void* rl, const void* load,
                          const void* send, const void* avail, void* isblue,
                          void* split, void* scratch, int B, int W1, int nl1,
                          int ldk, int Wi, int max_c, int Kc, int smem_budget,
                          void* stream) {
  return launch_color_level<double>(ch, kid, bud, el, rl, load, send, avail,
                                    isblue, split, scratch, B, W1, nl1, ldk,
                                    Wi, max_c, Kc, smem_budget, stream);
}

const char* soar_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
