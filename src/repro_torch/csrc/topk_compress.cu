// Per-row top-k by magnitude for Hopper (sm_90a): gradient compression.
//
//   x (R, D) float32 or bfloat16 -> the k largest |x| of each row as
//   (values (R, k) in x's dtype, indices (R, k) int32), by descending |x|,
//   the lower index first among equal magnitudes; and the threshold, the
//   k-th largest |x| of each row.
//
// Replaces the Pallas kernel src/repro/kernels/topk_compress/
// topk_compress.py :: topk_compress_pallas (body _topk_kernel). It computes
// what that module's oracle topk_compress_ref computes (lax.top_k on |x| in
// float32), not the Pallas loop: that loop runs k argmax rounds, O(k D),
// and repeats an index on a row with fewer than k nonzeros. In the port the
// select stage alone runs on every gradient leaf of every worker in
// optim/compression.py::_topk_leaf (R = 1, D = the leaf's size), which
// needs only the threshold.
//
// Key: the bit pattern of |x| as float32, read as uint32, orders like the
// magnitude for non-negative floats, +inf included. Every NaN maps to one
// key above +inf (0x7fc00000), so NaNs come first and tie among themselves,
// as in lax.top_k and in a stable descending torch.sort. bfloat16 is
// widened first (its bits << 16).
//
// Stages, each a few launches on the caller's stream:
//  1. select: a radix select over four 8-bit digits, most significant
//     first. Each pass builds a per-block shared-memory histogram of the
//     keys that match the prefix found so far, merges it into the row's
//     global histogram with atomics, and a one-block pick kernel finds the
//     digit where the count from the top reaches k. After four passes the
//     prefix is T, the k-th largest key, with n_gt = #(key > T).
//  2. compact: in ascending index order, every entry with key > T and the
//     first k - n_gt entries with key == T (the set lax.top_k keeps). A
//     tile count, an exclusive scan over the row's tiles, and a scatter
//     that block-scans (gt, eq) flags: an entry's slot is
//     gt_before + min(eq_before, k - n_gt).
//  3. order: a stable LSD radix sort of the k (key, index) pairs on ~key,
//     four 8-bit passes (histogram per tile, scan in digit-major order,
//     stable scatter ranked with __match_any_sync). Stability keeps the
//     lower index first among equal keys.
//  4. gather: values = x[index], indices as int32.
// No library kernels (no CUB, no torch.sort).
//
// Bound on the H100: bytes. The least traffic is one read of the row plus
// k values and k int32 indices written: at the trainer's largest leaf
// (781,189,120 bfloat16 values, k = 7,811,891) 1.59 GB, 0.47 ms at
// 3.35 TB/s (3.19 GB and 0.95 ms for float32). This design reads the row
// six times (four select passes, the tile count, the scatter) and is
// simple first; fewer passes (11-bit digits, skipping the passes a
// bfloat16 key cannot change) are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;                     // striped items per thread
constexpr int kTile = kThreads * kItems;      // elements per tile
constexpr int kScanThreads = 1024;
constexpr unsigned kNanKey = 0x7fc00000u;
constexpr unsigned kInfKey = 0x7f800000u;

// state per row (uint32 x 4): prefix, k_rem, n_gt, n_eq
enum { kPrefix = 0, kRem = 1, kGt = 2, kEq = 3 };

__device__ __forceinline__ unsigned key_of_bits(unsigned bits) {
  const unsigned b = bits & 0x7fffffffu;
  return b > kInfKey ? kNanKey : b;
}

template <typename T>
__device__ __forceinline__ unsigned load_key(const T* x, long long i);

template <>
__device__ __forceinline__ unsigned load_key<float>(const float* x,
                                                    long long i) {
  return key_of_bits(__float_as_uint(x[i]));
}

template <>
__device__ __forceinline__ unsigned load_key<unsigned short>(
    const unsigned short* x, long long i) {
  return key_of_bits(static_cast<unsigned>(x[i]) << 16);
}

// Histogram add from a whole warp (every lane calls it): the lanes that
// hit the same bin add once, through their lowest lane, so a bin that most
// keys fall into costs one shared atomic per warp, not 32.
__device__ __forceinline__ void warp_hist_add(unsigned* h, bool hit,
                                              unsigned d) {
  const unsigned m = __ballot_sync(0xffffffffu, hit);
  if (hit) {
    const unsigned peers = __match_any_sync(m, d);
    const unsigned lt = (1u << (threadIdx.x & 31)) - 1u;
    if ((peers & lt) == 0u) atomicAdd(&h[d], __popc(peers));
  }
}

// Exclusive scan of one value per thread over a block of NT threads;
// `sh` holds NT / 32 + 1 words. Returns the prefix; *total gets the sum.
template <int NT>
__device__ __forceinline__ unsigned block_exclusive_scan(unsigned v,
                                                         unsigned* sh,
                                                         unsigned* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned n = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += n;
  }
  if (lane == 31) sh[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    constexpr int kWarps = NT / 32;
    unsigned w = lane < kWarps ? sh[lane] : 0u;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned n = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += n;
    }
    if (lane < kWarps) sh[lane] = w;          // inclusive warp totals
    if (lane == kWarps - 1) sh[kWarps] = w;
  }
  __syncthreads();
  const unsigned out = inc - v + (warp ? sh[warp - 1] : 0u);
  *total = sh[NT / 32];
  __syncthreads();                            // sh is reused by the caller
  return out;
}

// ---- select ----------------------------------------------------------------

__global__ void select_init(unsigned* state, unsigned* hist, int k) {
  const int r = blockIdx.x;
  hist[r * 256 + threadIdx.x] = 0u;
  if (threadIdx.x == 0) {
    state[r * 4 + kPrefix] = 0u;
    state[r * 4 + kRem] = static_cast<unsigned>(k);
    state[r * 4 + kGt] = 0u;
    state[r * 4 + kEq] = 0u;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
select_hist(const T* __restrict__ x, long long D,
            const unsigned* __restrict__ state, unsigned* hist, int shift) {
  __shared__ unsigned h[256];
  const int r = blockIdx.y;
  h[threadIdx.x] = 0u;
  __syncthreads();
  const unsigned prefix = state[r * 4 + kPrefix];
  const unsigned hi = shift == 24 ? 0u : (0xffffffffu << (shift + 8));
  const T* row = x + static_cast<long long>(r) * D;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  // the trip count is uniform across the block, so whole warps call
  // warp_hist_add
  for (long long b0 = static_cast<long long>(blockIdx.x) * kThreads; b0 < D;
       b0 += stride) {
    const long long i = b0 + threadIdx.x;
    const unsigned key = i < D ? load_key<T>(row, i) : 0u;
    warp_hist_add(h, i < D && (key & hi) == prefix, (key >> shift) & 255u);
  }
  __syncthreads();
  const unsigned c = h[threadIdx.x];
  if (c) atomicAdd(&hist[r * 256 + threadIdx.x], c);
}

// One block of 256 threads per row: pick the digit where the count from
// the top reaches k_rem, extend the prefix, clear the histogram.
__global__ void select_pick(unsigned* state, unsigned* hist, int shift) {
  __shared__ unsigned h[256];
  const int r = blockIdx.x;
  h[threadIdx.x] = hist[r * 256 + threadIdx.x];
  hist[r * 256 + threadIdx.x] = 0u;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned* st = state + r * 4;
    const unsigned rem = st[kRem];
    unsigned above = 0u;
    for (int b = 255; b >= 0; --b) {
      if (above + h[b] >= rem) {
        st[kPrefix] |= static_cast<unsigned>(b) << shift;
        st[kRem] = rem - above;
        st[kGt] += above;
        st[kEq] = h[b];
        break;
      }
      above += h[b];
    }
  }
}

// ---- compact ---------------------------------------------------------------

// counts[r][tile] of key > T and of key == T
template <typename T>
__global__ void __launch_bounds__(kThreads)
compact_count(const T* __restrict__ x, long long D,
              const unsigned* __restrict__ state, unsigned* gt_count,
              unsigned* eq_count, long long n_tiles) {
  __shared__ unsigned sh[kThreads / 32 + 1];
  const int r = blockIdx.y;
  const unsigned t = state[r * 4 + kPrefix];
  const T* row = x + static_cast<long long>(r) * D;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  unsigned gt = 0u, eq = 0u;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = base + j * kThreads + threadIdx.x;
    if (i < D) {
      const unsigned key = load_key<T>(row, i);
      gt += key > t;
      eq += key == t;
    }
  }
  unsigned tg, te;
  block_exclusive_scan<kThreads>(gt, sh, &tg);
  block_exclusive_scan<kThreads>(eq, sh, &te);
  if (threadIdx.x == 0) {
    gt_count[r * n_tiles + blockIdx.x] = tg;
    eq_count[r * n_tiles + blockIdx.x] = te;
  }
}

// In-place exclusive scan of each row of a (R, n) uint32 array: one block
// per row, each thread scanning a contiguous chunk.
__global__ void __launch_bounds__(kScanThreads)
row_exclusive_scan(unsigned* a, long long n) {
  __shared__ unsigned sh[kScanThreads / 32 + 1];
  unsigned* row = a + static_cast<long long>(blockIdx.x) * n;
  const long long chunk = (n + kScanThreads - 1) / kScanThreads;
  const long long lo = threadIdx.x * chunk;
  const long long hi = lo + chunk < n ? lo + chunk : n;
  unsigned s = 0u;
  for (long long i = lo; i < hi; ++i) s += row[i];
  unsigned total;
  unsigned run = block_exclusive_scan<kScanThreads>(s, sh, &total);
  for (long long i = lo; i < hi; ++i) {
    const unsigned v = row[i];
    row[i] = run;
    run += v;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
compact_scatter(const T* __restrict__ x, long long D,
                const unsigned* __restrict__ state,
                const unsigned* __restrict__ gt_before,
                const unsigned* __restrict__ eq_before, long long n_tiles,
                int k, unsigned* __restrict__ out_key,
                int* __restrict__ out_idx) {
  __shared__ unsigned sh[kThreads / 32 + 1];
  const int r = blockIdx.y;
  const unsigned t = state[r * 4 + kPrefix];
  const unsigned need = state[r * 4 + kRem];      // entries == T to take
  const T* row = x + static_cast<long long>(r) * D;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  unsigned run_gt = gt_before[r * n_tiles + blockIdx.x];
  unsigned run_eq = eq_before[r * n_tiles + blockIdx.x];
  unsigned* ok = out_key + static_cast<long long>(r) * k;
  int* oi = out_idx + static_cast<long long>(r) * k;
  for (int j = 0; j < kItems; ++j) {
    const long long i = base + j * kThreads + threadIdx.x;
    unsigned key = 0u;
    bool gt = false, eq = false;
    if (i < D) {
      key = load_key<T>(row, i);
      gt = key > t;
      eq = key == t;
    }
    // gt and eq counts of one round fit 16 bits each
    unsigned total;
    const unsigned ex = block_exclusive_scan<kThreads>(
        (gt ? 1u : 0u) | (eq ? 1u << 16 : 0u), sh, &total);
    const unsigned gb = run_gt + (ex & 0xffffu);
    const unsigned eb = run_eq + (ex >> 16);
    if (gt || (eq && eb < need)) {
      const unsigned pos = gb + (eb < need ? eb : need);
      ok[pos] = key;
      oi[pos] = static_cast<int>(i);
    }
    run_gt += total & 0xffffu;
    run_eq += total >> 16;
  }
}

// ---- order: stable LSD radix sort on ~key ------------------------------------

// counts[r][digit][tile]
__global__ void __launch_bounds__(kThreads)
sort_hist(const unsigned* __restrict__ keys, int k, int shift,
          unsigned* counts, long long n_tiles) {
  __shared__ unsigned h[256];
  const int r = blockIdx.y;
  h[threadIdx.x] = 0u;
  __syncthreads();
  const unsigned* row = keys + static_cast<long long>(r) * k;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = base + j * kThreads + threadIdx.x;
    const unsigned d = i < k ? (~row[i] >> shift) & 255u : 0u;
    warp_hist_add(h, i < k, d);
  }
  __syncthreads();
  counts[(static_cast<long long>(r) * 256 + threadIdx.x) * n_tiles +
         blockIdx.x] = h[threadIdx.x];
}

__global__ void __launch_bounds__(kThreads)
sort_scatter(const unsigned* __restrict__ keys, const int* __restrict__ idx,
             int k, int shift, const unsigned* __restrict__ offsets,
             long long n_tiles, unsigned* __restrict__ keys_out,
             int* __restrict__ idx_out) {
  constexpr int kWarps = kThreads / 32;
  __shared__ unsigned off[256];
  __shared__ unsigned warp_hist[kWarps][256];
  const int r = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  off[threadIdx.x] =
      offsets[(static_cast<long long>(r) * 256 + threadIdx.x) * n_tiles +
              blockIdx.x];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) warp_hist[w][threadIdx.x] = 0u;
  __syncthreads();
  const long long row0 = static_cast<long long>(r) * k;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const unsigned lt = (1u << lane) - 1u;
  for (int j = 0; j < kItems; ++j) {
    const long long i = base + j * kThreads + threadIdx.x;
    const bool valid = i < k;
    unsigned key = 0u, d = 0u, peers = 0u;
    int id = 0;
    if (valid) {
      key = keys[row0 + i];
      id = idx[row0 + i];
      d = (~key >> shift) & 255u;
    }
    const unsigned live = __ballot_sync(0xffffffffu, valid);
    if (valid) {
      peers = __match_any_sync(live, d);
      if ((peers & lt) == 0u) warp_hist[warp][d] = __popc(peers);
    }
    __syncthreads();
    if (valid) {
      unsigned pos = off[d] + __popc(peers & lt);
      for (int w = 0; w < warp; ++w) pos += warp_hist[w][d];
      keys_out[row0 + pos] = key;
      idx_out[row0 + pos] = id;
    }
    __syncthreads();
    unsigned add = 0u;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      add += warp_hist[w][threadIdx.x];
      warp_hist[w][threadIdx.x] = 0u;
    }
    off[threadIdx.x] += add;
    __syncthreads();
  }
}

template <typename T>
__global__ void gather_values(const T* __restrict__ x, long long D, int k,
                              const int* __restrict__ idx,
                              T* __restrict__ values) {
  const int r = blockIdx.y;
  const long long j =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j < k) {
    const long long o = static_cast<long long>(r) * k + j;
    values[o] = x[static_cast<long long>(r) * D + idx[o]];
  }
}

// ---- launchers ---------------------------------------------------------------

unsigned select_blocks(long long D) {
  // enough blocks to fill the card several times over; each loops over
  // its share of the row
  const long long per = static_cast<long long>(kThreads) * 16;
  long long b = (D + per - 1) / per;
  if (b > 1056) b = 1056;                     // 8 per SM on 132 SMs
  return static_cast<unsigned>(b < 1 ? 1 : b);
}

template <typename T>
int run_select(const void* x, int R, long long D, int k, void* state,
               void* hist, cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  auto* st = static_cast<unsigned*>(state);
  auto* h = static_cast<unsigned*>(hist);
  select_init<<<R, 256, 0, s>>>(st, h, k);
  const dim3 grid(select_blocks(D), static_cast<unsigned>(R));
  for (int shift = 24; shift >= 0; shift -= 8) {
    select_hist<T><<<grid, kThreads, 0, s>>>(xp, D, st, h, shift);
    select_pick<<<R, 256, 0, s>>>(st, h, shift);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run_topk(const void* x, int R, long long D, int k, void* state,
             void* hist, void* tile_a, void* tile_b, void* key_a,
             void* key_b, void* idx_a, void* idx_b, void* sort_counts,
             void* values, cudaStream_t s) {
  int err = run_select<T>(x, R, D, k, state, hist, s);
  if (err) return err;
  const T* xp = static_cast<const T*>(x);
  const auto* st = static_cast<const unsigned*>(state);
  auto* gt = static_cast<unsigned*>(tile_a);
  auto* eq = static_cast<unsigned*>(tile_b);
  const long long n_tiles = (D + kTile - 1) / kTile;
  const dim3 grid(static_cast<unsigned>(n_tiles), static_cast<unsigned>(R));
  compact_count<T><<<grid, kThreads, 0, s>>>(xp, D, st, gt, eq, n_tiles);
  row_exclusive_scan<<<R, kScanThreads, 0, s>>>(gt, n_tiles);
  row_exclusive_scan<<<R, kScanThreads, 0, s>>>(eq, n_tiles);
  auto* ka = static_cast<unsigned*>(key_a);
  auto* kb = static_cast<unsigned*>(key_b);
  auto* ia = static_cast<int*>(idx_a);
  auto* ib = static_cast<int*>(idx_b);
  compact_scatter<T><<<grid, kThreads, 0, s>>>(xp, D, st, gt, eq, n_tiles, k,
                                               ka, ia);
  const long long k_tiles = (k + kTile - 1) / kTile;
  const dim3 kgrid(static_cast<unsigned>(k_tiles), static_cast<unsigned>(R));
  auto* counts = static_cast<unsigned*>(sort_counts);
  for (int shift = 0; shift < 32; shift += 8) {   // four passes: ends in a
    sort_hist<<<kgrid, kThreads, 0, s>>>(ka, k, shift, counts, k_tiles);
    row_exclusive_scan<<<R, kScanThreads, 0, s>>>(counts, 256 * k_tiles);
    sort_scatter<<<kgrid, kThreads, 0, s>>>(ka, ia, k, shift, counts,
                                            k_tiles, kb, ib);
    unsigned* tk = ka; ka = kb; kb = tk;
    int* ti = ia; ia = ib; ib = ti;
  }
  const dim3 vgrid(static_cast<unsigned>((k + 255) / 256),
                   static_cast<unsigned>(R));
  gather_values<T><<<vgrid, 256, 0, s>>>(xp, D, k, ia, static_cast<T*>(values));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The select stage alone: state (R, 4) uint32 gets prefix = the k-th
// largest key (the threshold's bits), k - n_gt, n_gt, and #(key == T).
// hist is (R, 256) uint32 scratch.
int soar_topk_select(const void* x, int bf16, int R, long long D, int k,
                     void* state, void* hist, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? run_select<unsigned short>(x, R, D, k, state, hist, s)
              : run_select<float>(x, R, D, k, state, hist, s);
}

// The whole top-k. Scratch (uint32/int32): tile_a, tile_b (R, n_tiles);
// key_a, key_b, idx_a, idx_b (R, k); sort_counts (R, 256 * k_tiles), with
// n_tiles = ceil(D / 2048) and k_tiles = ceil(k / 2048). The sorted
// indices end in idx_a; values (R, k) in x's dtype.
int soar_topk_compress(const void* x, int bf16, int R, long long D, int k,
                       void* state, void* hist, void* tile_a, void* tile_b,
                       void* key_a, void* key_b, void* idx_a, void* idx_b,
                       void* sort_counts, void* values, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? run_topk<unsigned short>(x, R, D, k, state, hist, tile_a,
                                         tile_b, key_a, key_b, idx_a, idx_b,
                                         sort_counts, values, s)
              : run_topk<float>(x, R, D, k, state, hist, tile_a, tile_b,
                                key_a, key_b, idx_a, idx_b, sort_counts,
                                values, s);
}

}  // extern "C"
