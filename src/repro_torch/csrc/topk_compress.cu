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
// widened first (its bits << 16). Bit 31 of a key is always 0.
//
// Bound on the H100: bytes. The least traffic is one read of the row plus
// k values and k int32 indices written: at the trainer's largest leaf
// (781,189,120 float32 values, k = 7,811,891) 3.19 GB, 0.95 ms at
// 3.35 TB/s; the select stage alone, one read, 0.93 ms. Its design against
// that bound:
//  1. select, a radix select over 11-bit digits of the key, most
//     significant first: bits 30-20, 19-9, 8-0 (a bfloat16 key's bits 15-0
//     are 0, so it is done after two). A pass reads the row with 16-byte
//     loads (a row that does not start on 16 bytes takes its first and last
//     vector element by element) into a 2,048-bin shared histogram of the
//     keys that match the prefix found so far, added once per warp where
//     the warp's keys share a bin (a gradient full of zeros) and per lane
//     otherwise; merges it into the row's global histogram, and the last
//     block to finish (an atomic ticket after __threadfence) picks the
//     digit where the count from the top reaches k, extends the prefix and
//     clears the histogram. After pass 1 the count of the chosen bin is
//     known: when it fits the candidate buffer (D / 16 keys a row) pass 2
//     also writes the keys of that bin there,
//     gathered per warp in shared memory and placed with one atomic a
//     batch, and pass 3 reads only those, not the row; a bin that does not
//     fit (heavy ties) is read from the row again. Counts alone decide
//     each digit, so the order in which candidates land does not matter.
//     A float32 call is one memset and three launches, bfloat16 one memset
//     and two; a row of at most 16,384 values runs every pass in one
//     launch, one block a row, its keys in registers.
//  2. compact, one pass over the row: in ascending index order, every
//     entry with key > T and the first k - n_gt entries with key == T (the
//     set lax.top_k keeps), at slot gt_before + min(eq_before, k - n_gt).
//     Each tile of 8,192 keys takes its predecessors' (gt, eq) counts by a
//     decoupled look-back (Merrill and Garland, "Single-pass Parallel
//     Prefix Scan with Decoupled Look-back", NVIDIA 2016): it publishes its
//     own counts, then its inclusive prefix. A tile's kept pairs fill
//     consecutive slots, so they are gathered in shared memory and written
//     out together.
//  3. order: a stable LSD radix sort of the k (key, index) pairs on ~key,
//     three passes of 11 bits. One launch histograms all three digits; a
//     pass whose digit puts all k keys in one bin is the identity and is
//     skipped (for bfloat16 the lowest). Each other pass: a per-tile
//     histogram, an exclusive scan of the (digit, tile) counts in
//     digit-major order by a look-back scan whose threads read neighbouring
//     counts, and a stable scatter ranked with __match_any_sync.
//  4. gather: values = x[index], and the indices, from the sort's last
//     buffer.
// No library kernels (no CUB, no torch.sort). What it still gives up: the
// select reads a row whose chosen first digit overflows the candidate
// buffer three times; the compaction reads it once more at well under the
// memory's rate (one tile a block, its look-back and writes after its
// loads, with nothing in flight); the sort's scatter writes land a few to
// a 32-byte sector, and the gather reads x at random.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kU = 4;                         // 16-byte vectors per thread
constexpr int kBins = 2048;
constexpr int kSmallThreads = 1024;
constexpr int kSmallItems = 16;
constexpr long long kSmallMax = kSmallThreads * kSmallItems;
constexpr int kSortItems = 16;
constexpr int kSortTile = kThreads * kSortItems;
constexpr int kScanTile = kThreads * kU * 4;  // uint32 values per scan tile
constexpr unsigned kMaxBlocks = 1056;         // 8 per SM on 132 SMs
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNanKey = 0x7fc00000u;
constexpr unsigned kInfKey = 0x7f800000u;
constexpr unsigned long long kFlagAgg = 1ull << 62;
constexpr unsigned long long kFlagPre = 2ull << 62;
constexpr unsigned long long kValMask = (1ull << 62) - 1;

// per row: the select's result (prefix = the k-th largest key at the end,
// rem = k - n_gt entries equal to it to take, n_gt, n_eq = #(key == T)),
// the last-block ticket and the candidate buffer's fill and use
struct RowState {
  unsigned prefix, rem, n_gt, n_eq, ticket, n_cand, cand_ok, pad;
};

__device__ __forceinline__ unsigned key_of_bits(unsigned bits) {
  const unsigned b = bits & 0x7fffffffu;
  return b > kInfKey ? kNanKey : b;
}

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int n = 4;
  static __device__ __forceinline__ unsigned key(const float* p) {
    return key_of_bits(__float_as_uint(*p));
  }
  static __device__ __forceinline__ void keys(uint4 q, unsigned* k) {
    k[0] = key_of_bits(q.x);
    k[1] = key_of_bits(q.y);
    k[2] = key_of_bits(q.z);
    k[3] = key_of_bits(q.w);
  }
};
template <>
struct Vec<unsigned short> {                  // bfloat16 bits
  static constexpr int n = 8;
  static __device__ __forceinline__ unsigned key(const unsigned short* p) {
    return key_of_bits(static_cast<unsigned>(*p) << 16);
  }
  static __device__ __forceinline__ void keys(uint4 q, unsigned* k) {
    const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      k[2 * i] = key_of_bits(w[i] << 16);
      k[2 * i + 1] = key_of_bits(w[i] & 0xffff0000u);
    }
  }
};
template <>
struct Vec<unsigned> {                        // keys already made
  static constexpr int n = 4;
  static __device__ __forceinline__ unsigned key(const unsigned* p) {
    return *p;
  }
  static __device__ __forceinline__ void keys(uint4 q, unsigned* k) {
    k[0] = q.x;
    k[1] = q.y;
    k[2] = q.z;
    k[3] = q.w;
  }
};

// A row seen as 16-byte vectors: base = row - h0 is 16-byte aligned, and
// vector v holds the elements v * n - h0 .. v * n - h0 + n - 1 that lie in
// [0, D). Vectors wholly inside the row load in one instruction, the first
// and the last element by element; valid gets a bit per element.
template <typename T>
struct RowVecs {
  const T* row;
  long long h0, D, nv;
  __device__ RowVecs(const T* r, long long d) : row(r), D(d) {
    h0 = static_cast<long long>(reinterpret_cast<unsigned long long>(r) &
                                15ull) / static_cast<long long>(sizeof(T));
    nv = (h0 + D + Vec<T>::n - 1) / Vec<T>::n;
  }
  __device__ __forceinline__ void load(long long v, unsigned* key,
                                       unsigned& valid) const {
    constexpr int n = Vec<T>::n;
    const long long i0 = v * n - h0;
    if (v >= nv) {
      valid = 0u;
#pragma unroll
      for (int e = 0; e < n; ++e) key[e] = 0u;
    } else if (i0 >= 0 && i0 + n <= D) {
      Vec<T>::keys(*reinterpret_cast<const uint4*>(row + i0), key);
      valid = (1u << n) - 1u;
    } else {
      valid = 0u;
#pragma unroll
      for (int e = 0; e < n; ++e) {
        const long long i = i0 + e;
        const bool in = i >= 0 && i < D;
        key[e] = in ? Vec<T>::key(row + i) : 0u;
        valid |= in ? 1u << e : 0u;
      }
    }
  }
};

// Histogram add from a whole warp (every lane calls it): one add for the
// warp where every hitting lane has the same bin, else one per lane.
__device__ __forceinline__ void hist_add(unsigned* h, bool hit, unsigned d) {
  const unsigned m = __ballot_sync(kFull, hit);
  if (m == 0u) return;
  const int leader = __ffs(m) - 1;
  const unsigned d0 = __shfl_sync(kFull, d, leader);
  if (__all_sync(kFull, !hit || d == d0)) {
    if ((threadIdx.x & 31) == static_cast<unsigned>(leader))
      atomicAdd(&h[d0], static_cast<unsigned>(__popc(m)));
  } else if (hit) {
    atomicAdd(&h[d], 1u);
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
    const unsigned n = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += n;
  }
  if (lane == 31) sh[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    constexpr int kW = NT / 32;
    unsigned w = lane < kW ? sh[lane] : 0u;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned n = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += n;
    }
    if (lane < kW) sh[lane] = w;              // inclusive warp totals
    if (lane == kW - 1) sh[kW] = w;
  }
  __syncthreads();
  const unsigned out = inc - v + (warp ? sh[warp - 1] : 0u);
  *total = sh[NT / 32];
  __syncthreads();                            // sh is reused by the caller
  return out;
}

// Exclusive scan over a tile of kThreads x U values in (j, thread) order:
// value j of every thread, then value j + 1. `sh` holds U * kWarps + 1
// words.
template <int U>
__device__ __forceinline__ void tile_scan(const unsigned (&v)[U],
                                          unsigned (&ex)[U],
                                          unsigned* total, unsigned* sh) {
  constexpr int kE = U * kWarps, kP = kE / 32;   // warp totals, per lane
  static_assert(kP * 32 == kE, "warp 0 scans the warp totals");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned inc[U];
#pragma unroll
  for (int j = 0; j < U; ++j) {
    inc[j] = v[j];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned n = __shfl_up_sync(kFull, inc[j], o);
      if (lane >= o) inc[j] += n;
    }
    if (lane == 31) sh[j * kWarps + warp] = inc[j];
  }
  __syncthreads();
  if (warp == 0) {
    unsigned loc[kP], sum = 0u;
#pragma unroll
    for (int q = 0; q < kP; ++q) sum += loc[q] = sh[lane * kP + q];
    unsigned w = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned n = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += n;
    }
    unsigned run = w - sum;
#pragma unroll
    for (int q = 0; q < kP; ++q) {
      sh[lane * kP + q] = run;
      run += loc[q];
    }
    if (lane == 31) sh[kE] = w;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < U; ++j) ex[j] = inc[j] - v[j] + sh[j * kWarps + warp];
  *total = sh[kE];
  __syncthreads();
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

// Decoupled look-back, by warp 0 of the block of tile `tile`: publishes
// the tile's aggregate, sums its predecessors' published values back to
// the nearest inclusive prefix (32 tiles a step), publishes its own
// inclusive prefix and returns the exclusive one (every lane). The tile is
// the block's blockIdx.x, as in CUB's single-pass scan: the card starts
// blocks in the order of their index, so every predecessor is running or
// done and the wait ends.
__device__ unsigned long long lookback(unsigned long long* status,
                                       long long tile,
                                       unsigned long long agg) {
  const int lane = threadIdx.x & 31;
  if (lane == 0) store_status(&status[tile], (tile ? kFlagAgg : kFlagPre) | agg);
  if (tile == 0) return 0ull;
  unsigned long long excl = 0ull;
  for (long long base = tile - 1;; base -= 32) {
    const long long t = base - lane;
    unsigned long long s = kFlagPre;          // before tile 0: prefix 0
    if (t >= 0) {
      do {
        s = load_status(&status[t]);
      } while ((s >> 62) == 0ull);
    }
    const unsigned pre = __ballot_sync(kFull, (s >> 62) == 2ull);
    const int stop = pre ? __ffs(pre) - 1 : 31;
    unsigned long long val = lane <= stop ? (s & kValMask) : 0ull;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) val += __shfl_xor_sync(kFull, val, o);
    excl += val;
    if (pre) break;
  }
  if (lane == 0) store_status(&status[tile], kFlagPre | (excl + agg));
  return excl;
}

// ---- select ----------------------------------------------------------------

struct Pick {
  unsigned digit, above, count;
};

// Over the histogram h of nbins bins (the keys matching the prefix), the
// digit where the count from the top bin first reaches rem (1 <= rem <=
// the sum): *out gets it, the count above it and its own. Block of NT
// threads, each a run of bins from the top; `sh` holds NT / 32 + 1 words.
template <int NT>
__device__ void pick_digit(const unsigned* h, int nbins, unsigned rem,
                           unsigned* sh, Pick* out) {
  const int per = (nbins + NT - 1) / NT;
  const int top = nbins - 1 - static_cast<int>(threadIdx.x) * per;
  unsigned sum = 0u;
  for (int i = 0; i < per; ++i)
    if (top - i >= 0) sum += h[top - i];
  unsigned total;
  unsigned above = block_exclusive_scan<NT>(sum, sh, &total);
  for (int i = 0; i < per; ++i) {
    const int b = top - i;
    if (b < 0) break;
    const unsigned c = h[b];
    if (above < rem && above + c >= rem) *out = Pick{static_cast<unsigned>(b),
                                                     above, c};
    above += c;
  }
  __syncthreads();
}

// pass p: the digit's shift and bins, and the mask of the bits fixed before
__host__ __device__ constexpr int pass_shift(int p) {
  return p == 0 ? 20 : p == 1 ? 9 : 0;
}
__host__ __device__ constexpr int pass_bins(int p) { return p == 2 ? 512 : 2048; }
__host__ __device__ constexpr unsigned pass_fixed(int p) {
  return p == 0 ? 0u : p == 1 ? 0xfff00000u : 0xfffffe00u;
}

// One block per row of at most kSmallMax values: every pass in one launch,
// the keys in registers.
template <typename T>
__global__ void __launch_bounds__(kSmallThreads)
select_small(const T* __restrict__ x, long long D, int k, int passes,
             RowState* state, float* thr) {
  __shared__ unsigned h[kBins];
  __shared__ unsigned sh[kSmallThreads / 32 + 1];
  __shared__ Pick pk;
  const int r = blockIdx.x;
  const T* row = x + static_cast<long long>(r) * D;
  unsigned key[kSmallItems];
  unsigned valid = 0u;
#pragma unroll
  for (int j = 0; j < kSmallItems; ++j) {
    const long long i = static_cast<long long>(j) * kSmallThreads + threadIdx.x;
    key[j] = i < D ? Vec<T>::key(row + i) : 0u;
    valid |= i < D ? 1u << j : 0u;
  }
  unsigned prefix = 0u, rem = static_cast<unsigned>(k), n_gt = 0u, n_eq = 0u;
  for (int p = 0; p < passes; ++p) {
    const int shift = pass_shift(p);
    const unsigned fixed = pass_fixed(p), dmask = pass_bins(p) - 1;
    for (int i = threadIdx.x; i < kBins; i += kSmallThreads) h[i] = 0u;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kSmallItems; ++j)
      hist_add(h, ((valid >> j) & 1u) && (key[j] & fixed) == prefix,
               (key[j] >> shift) & dmask);
    __syncthreads();
    pick_digit<kSmallThreads>(h, pass_bins(p), rem, sh, &pk);
    prefix |= pk.digit << shift;
    rem -= pk.above;
    n_gt += pk.above;
    n_eq = pk.count;
    __syncthreads();                          // pk and h are written again
  }
  if (threadIdx.x == 0) {
    state[r] = RowState{prefix, rem, n_gt, n_eq, 0u, 0u, 0u, 0u};
    if (thr) thr[r] = __uint_as_float(prefix);
  }
}

// Candidates of pass 1, gathered per warp in shared memory (kCandBuf
// keys) and copied out with one atomic for the warp's offset a batch.
constexpr unsigned kCandBuf = 256;

__device__ __forceinline__ void cand_flush(unsigned* buf, unsigned& fill,
                                           RowState* st, unsigned* cand) {
  const unsigned lane = threadIdx.x & 31;
  __syncwarp();
  unsigned base = 0u;
  if (lane == 0 && fill) base = atomicAdd(&st->n_cand, fill);
  base = __shfl_sync(kFull, base, 0);
  for (unsigned i = lane; i < fill; i += 32) cand[base + i] = buf[i];
  __syncwarp();
  fill = 0u;
}

__device__ __forceinline__ void cand_put(unsigned* buf, unsigned& fill,
                                         bool hit, unsigned key, RowState* st,
                                         unsigned* cand) {
  const unsigned m = __ballot_sync(kFull, hit);
  if (m == 0u) return;
  const unsigned lane = threadIdx.x & 31;
  if (hit) buf[fill + __popc(m & ((1u << lane) - 1u))] = key;
  fill += __popc(m);
  if (fill > kCandBuf - 32) cand_flush(buf, fill, st, cand);
}

// Pass PASS of the select over the rows (grid (blocks, R)); the last block
// of a row picks the digit. cap: the candidate buffer's keys a row (0:
// none, as for bfloat16, whose pass 1 is its last). LAST: the row's last
// pass, which also writes its threshold to thr (when not null); the
// other passes compile without that store.
template <typename T, int PASS, bool LAST>
__global__ void __launch_bounds__(kThreads)
select_pass(const T* __restrict__ x, long long D, int k, long long cap,
            RowState* state, unsigned* ghist, unsigned* cands, float* thr) {
  __shared__ unsigned h[kBins];
  __shared__ unsigned sh[kWarps + 1];
  __shared__ unsigned wbuf[kWarps][kCandBuf];
  __shared__ bool last_block;
  __shared__ Pick pk;
  constexpr int shift = pass_shift(PASS), nbins = pass_bins(PASS);
  constexpr unsigned fixed = pass_fixed(PASS), dmask = nbins - 1;
  const int r = blockIdx.y;
  RowState* st = state + r;
  unsigned* gh = ghist + static_cast<long long>(r) * kBins;
  unsigned* cand = cands + static_cast<long long>(r) * cap;
  for (int i = threadIdx.x; i < nbins; i += kThreads) h[i] = 0u;
  const unsigned prefix = PASS == 0 ? 0u : st->prefix;
  const bool cand_ok = PASS > 0 && st->cand_ok != 0u;
  __syncthreads();
  const long long step = static_cast<long long>(gridDim.x) * kThreads * kU;
  const long long v_first = static_cast<long long>(blockIdx.x) * kThreads * kU;
  if (PASS == 2 && cand_ok) {                 // the candidates, not the row
    const RowVecs<unsigned> rv(cand, st->n_cand);
    for (long long v0 = v_first; v0 < rv.nv; v0 += step) {
      unsigned key[kU][4], valid[kU];
#pragma unroll
      for (int j = 0; j < kU; ++j)
        rv.load(v0 + j * kThreads + threadIdx.x, key[j], valid[j]);
#pragma unroll
      for (int j = 0; j < kU; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          hist_add(h, ((valid[j] >> e) & 1u) && (key[j][e] & fixed) == prefix,
                   (key[j][e] >> shift) & dmask);
    }
  } else {
    constexpr int n = Vec<T>::n;
    // pass 0's bin goes to the candidates when it fits the buffer
    const bool put = PASS == 1 && cand_ok;
    unsigned* wb = wbuf[threadIdx.x >> 5];
    unsigned fill = 0u;                       // the same in every lane
    const RowVecs<T> rv(x + static_cast<long long>(r) * D, D);
    for (long long v0 = v_first; v0 < rv.nv; v0 += step) {
      unsigned key[kU][n], valid[kU];
#pragma unroll
      for (int j = 0; j < kU; ++j)
        rv.load(v0 + j * kThreads + threadIdx.x, key[j], valid[j]);
#pragma unroll
      for (int j = 0; j < kU; ++j) {
#pragma unroll
        for (int e = 0; e < n; ++e) {
          const bool hit = ((valid[j] >> e) & 1u) &&
                           (key[j][e] & fixed) == prefix;
          hist_add(h, hit, (key[j][e] >> shift) & dmask);
          if (put) cand_put(wb, fill, hit, key[j][e], st, cand);
        }
      }
    }
    if (put) cand_flush(wb, fill, st, cand);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nbins; i += kThreads)
    if (h[i]) atomicAdd(&gh[i], h[i]);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last_block = atomicAdd(&st->ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last_block) return;
  // the last block of the row: every other block's adds are in gh
  __threadfence();
  for (int i = threadIdx.x; i < nbins; i += kThreads) {
    h[i] = __ldcg(&gh[i]);
    gh[i] = 0u;
  }
  __syncthreads();
  const unsigned rem = PASS == 0 ? static_cast<unsigned>(k) : st->rem;
  const unsigned n_gt = PASS == 0 ? 0u : st->n_gt;
  pick_digit<kThreads>(h, nbins, rem, sh, &pk);
  if (threadIdx.x == 0) {
    st->prefix = prefix | (pk.digit << shift);
    if (LAST && thr) thr[r] = __uint_as_float(st->prefix);
    st->rem = rem - pk.above;
    st->n_gt = n_gt + pk.above;
    st->n_eq = pk.count;
    st->ticket = 0u;
    if (PASS == 0) st->cand_ok = static_cast<long long>(pk.count) <= cap;
  }
}

// ---- compact ---------------------------------------------------------------

// One tile of kCompactKeys keys per block (kThreads x U vectors), tile =
// blockIdx.x; status holds each tile's (gt, eq) counts packed as gt << 31
// | eq under the look-back flags. The tile's kept pairs fill consecutive
// slots: up to kCompactOut of them are gathered in shared memory and
// written out together, more (a tile of ties) each where it goes.
constexpr int kCompactKeys = kThreads * 32;
constexpr int kCompactOut = 1024;

template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
compact(const T* __restrict__ x, long long D, int k,
        const RowState* __restrict__ state, unsigned long long* status,
        long long n_tiles, unsigned* __restrict__ out_key,
        int* __restrict__ out_idx) {
  constexpr int n = Vec<T>::n, U = 32 / n;
  __shared__ unsigned sh[U * kWarps + 1];
  __shared__ unsigned long long pre_sh;
  __shared__ unsigned out_k[kCompactOut];
  __shared__ int out_i[kCompactOut];
  const int r = blockIdx.y;
  const long long tile = blockIdx.x;
  const unsigned t = state[r].prefix;
  const unsigned need = state[r].rem;           // entries == T to take
  const RowVecs<T> rv(x + static_cast<long long>(r) * D, D);
  unsigned key[U][n], valid[U], cnt[U], ex[U];
#pragma unroll
  for (int j = 0; j < U; ++j)
    rv.load((tile * U + j) * kThreads + threadIdx.x, key[j], valid[j]);
#pragma unroll
  for (int j = 0; j < U; ++j) {
    unsigned gt = 0u, eq = 0u;
#pragma unroll
    for (int e = 0; e < n; ++e) {
      const bool in = (valid[j] >> e) & 1u;
      gt += in && key[j][e] > t;
      eq += in && key[j][e] == t;
    }
    cnt[j] = gt | eq << 16;                      // a tile's counts < 2^16
  }
  unsigned total;
  tile_scan<U>(cnt, ex, &total, sh);
  if (threadIdx.x < 32) {
    const unsigned long long agg =
        static_cast<unsigned long long>(total & 0xffffu) << 31 | (total >> 16);
    const unsigned long long p =
        lookback(status + static_cast<long long>(r) * n_tiles, tile, agg);
    if (threadIdx.x == 0) pre_sh = p;
  }
  __syncthreads();
  const unsigned gt0 = static_cast<unsigned>(pre_sh >> 31);
  const unsigned eq0 = static_cast<unsigned>(pre_sh & 0x7fffffffu);
  // the tile's pairs go to slots [first, first + n_out)
  const unsigned first = gt0 + min(eq0, need);
  const unsigned n_out = (total & 0xffffu) + min(eq0 + (total >> 16), need) -
                         min(eq0, need);
  const bool gather = n_out <= kCompactOut;     // the same in every thread
  unsigned* ok = out_key + static_cast<long long>(r) * k;
  int* oi = out_idx + static_cast<long long>(r) * k;
#pragma unroll
  for (int j = 0; j < U; ++j) {
    unsigned gb = gt0 + (ex[j] & 0xffffu), eb = eq0 + (ex[j] >> 16);
    const long long i0 = ((tile * U + j) * kThreads + threadIdx.x) * n - rv.h0;
#pragma unroll
    for (int e = 0; e < n; ++e) {
      if (!((valid[j] >> e) & 1u)) continue;
      const bool gt = key[j][e] > t, eq = key[j][e] == t;
      if (gt || (eq && eb < need)) {
        const unsigned pos = gb + (eb < need ? eb : need);
        if (gather) {
          out_k[pos - first] = key[j][e];
          out_i[pos - first] = static_cast<int>(i0 + e);
        } else {
          ok[pos] = key[j][e];
          oi[pos] = static_cast<int>(i0 + e);
        }
      }
      gb += gt;
      eb += eq;
    }
  }
  if (gather) {
    __syncthreads();
    for (unsigned i = threadIdx.x; i < n_out; i += kThreads) {
      ok[first + i] = out_k[i];
      oi[first + i] = out_i[i];
    }
  }
}

// ---- order: stable LSD radix sort on ~key, three 11-bit digits -------------

__device__ __forceinline__ unsigned sort_digit(unsigned key, int pass) {
  return (~key >> (11 * pass)) & (kBins - 1);
}

// passes skipped before `pass` leave the pairs where they were: the source
// buffer is a if an even number of passes ran before, else b
__device__ __forceinline__ int ran_before(const unsigned* skip, int pass) {
  int n = 0;
  for (int q = 0; q < pass; ++q) n += skip[q] == 0u;
  return n;
}

// The three digit histograms of every row in one read; the row's last
// block marks the passes whose histogram has a bin of all k keys.
__global__ void __launch_bounds__(kThreads)
sort_prehist(const unsigned* __restrict__ keys, int k, unsigned* ghist3,
             unsigned* ticket, unsigned* skip) {
  __shared__ unsigned h[3][kBins];
  __shared__ bool last_block;
  const int r = blockIdx.y;
  for (int i = threadIdx.x; i < 3 * kBins; i += kThreads) (&h[0][0])[i] = 0u;
  __syncthreads();
  const unsigned* row = keys + static_cast<long long>(r) * k;
  for (long long b0 = static_cast<long long>(blockIdx.x) * kThreads; b0 < k;
       b0 += static_cast<long long>(gridDim.x) * kThreads) {
    const long long i = b0 + threadIdx.x;
    const unsigned key = i < k ? row[i] : 0u;
#pragma unroll
    for (int p = 0; p < 3; ++p) hist_add(h[p], i < k, sort_digit(key, p));
  }
  __syncthreads();
  unsigned* gh = ghist3 + static_cast<long long>(r) * 3 * kBins;
  for (int i = threadIdx.x; i < 3 * kBins; i += kThreads)
    if ((&h[0][0])[i]) atomicAdd(&gh[i], (&h[0][0])[i]);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last_block = atomicAdd(&ticket[r], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  for (int i = threadIdx.x; i < 3 * kBins; i += kThreads)
    if (__ldcg(&gh[i]) == static_cast<unsigned>(k))
      skip[r * 4 + i / kBins] = 1u;             // one bin: the identity
}

// counts[r][digit][tile] of one pass
__global__ void __launch_bounds__(kThreads)
sort_hist(const unsigned* __restrict__ ka, const unsigned* __restrict__ kb,
          int k, int pass, const unsigned* __restrict__ skip,
          unsigned* counts, long long k_tiles) {
  __shared__ unsigned h[kBins];
  const int r = blockIdx.y;
  if (skip[r * 4 + pass]) return;
  const unsigned* keys =
      (ran_before(skip + r * 4, pass) & 1 ? kb : ka) +
      static_cast<long long>(r) * k;
  for (int i = threadIdx.x; i < kBins; i += kThreads) h[i] = 0u;
  __syncthreads();
  const long long base = static_cast<long long>(blockIdx.x) * kSortTile;
#pragma unroll 4
  for (int j = 0; j < kSortItems; ++j) {
    const long long i = base + j * kThreads + threadIdx.x;
    hist_add(h, i < k, i < k ? sort_digit(keys[i], pass) : 0u);
  }
  __syncthreads();
  unsigned* c = counts + static_cast<long long>(r) * kBins * k_tiles;
  for (int d = threadIdx.x; d < kBins; d += kThreads)
    c[d * k_tiles + blockIdx.x] = h[d];
}

// In-place exclusive scan of each row of counts (n values, a multiple of
// 4), one tile of kScanTile values a block read as 16-byte vectors, the
// tiles chained by a look-back (tile = blockIdx.x).
__global__ void __launch_bounds__(kThreads)
scan_counts(unsigned* counts, long long n, int pass,
            const unsigned* __restrict__ skip, unsigned long long* status,
            long long n_tiles) {
  __shared__ unsigned sh[kU * kWarps + 1];
  __shared__ unsigned long long pre_sh;
  const int r = blockIdx.y;
  if (skip[r * 4 + pass]) return;
  const long long tile = blockIdx.x;
  uint4* row = reinterpret_cast<uint4*>(counts + static_cast<long long>(r) * n);
  uint4 q[kU];
  unsigned v[kU], ex[kU];
#pragma unroll
  for (int j = 0; j < kU; ++j) {
    const long long i = (tile * kU + j) * kThreads + threadIdx.x;
    q[j] = i * 4 < n ? row[i] : uint4{0u, 0u, 0u, 0u};
    v[j] = q[j].x + q[j].y + q[j].z + q[j].w;
  }
  unsigned total;
  tile_scan<kU>(v, ex, &total, sh);
  if (threadIdx.x < 32) {
    const unsigned long long p =
        lookback(status + static_cast<long long>(r) * n_tiles, tile, total);
    if (threadIdx.x == 0) pre_sh = p;
  }
  __syncthreads();
  const unsigned pre = static_cast<unsigned>(pre_sh);
#pragma unroll
  for (int j = 0; j < kU; ++j) {
    const long long i = (tile * kU + j) * kThreads + threadIdx.x;
    if (i * 4 >= n) continue;
    const unsigned a = pre + ex[j];
    row[i] = uint4{a, a + q[j].x, a + q[j].x + q[j].y,
                   a + q[j].x + q[j].y + q[j].z};
  }
}

// Stable scatter of one tile: rows of kThreads pairs in order; within a
// row, lanes of a digit ranked by __match_any_sync and warps by their
// counts (bytes of wcnt[digit]).
__global__ void __launch_bounds__(kThreads)
sort_scatter(unsigned* ka, unsigned* kb, int* ia, int* ib, int k, int pass,
             const unsigned* __restrict__ skip,
             const unsigned* __restrict__ offsets, long long k_tiles) {
  __shared__ unsigned off[kBins];
  __shared__ unsigned long long wcnt[kBins];  // byte w: warp w's count
  const int r = blockIdx.y;
  if (skip[r * 4 + pass]) return;
  const bool odd = ran_before(skip + r * 4, pass) & 1;
  const long long row0 = static_cast<long long>(r) * k;
  const unsigned* src_k = (odd ? kb : ka) + row0;
  const int* src_i = (odd ? ib : ia) + row0;
  unsigned* dst_k = (odd ? ka : kb) + row0;
  int* dst_i = (odd ? ia : ib) + row0;
  const unsigned* o = offsets + static_cast<long long>(r) * kBins * k_tiles;
  for (int d = threadIdx.x; d < kBins; d += kThreads) {
    off[d] = o[d * k_tiles + blockIdx.x];
    wcnt[d] = 0ull;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const unsigned long long below =
      warp ? (1ull << (8 * warp)) - 1ull : 0ull;  // bytes of lower warps
  const long long base = static_cast<long long>(blockIdx.x) * kSortTile;
  for (int j = 0; j < kSortItems; ++j) {
    const long long i = base + j * kThreads + threadIdx.x;
    const bool valid = i < k;
    const unsigned key = valid ? src_k[i] : 0u;
    const int id = valid ? src_i[i] : 0;
    const unsigned d = valid ? sort_digit(key, pass) : kFull;
    const unsigned peers = __match_any_sync(kFull, d);
    const bool leader = valid && (peers & lt) == 0u;
    if (leader)
      reinterpret_cast<unsigned char*>(&wcnt[d])[warp] =
          static_cast<unsigned char>(__popc(peers));
    __syncthreads();
    if (valid) {
      const unsigned long long w = wcnt[d] & below;
      const unsigned pos =
          off[d] + __popc(peers & lt) +
          __dp4a(static_cast<unsigned>(w), 0x01010101u,
                 __dp4a(static_cast<unsigned>(w >> 32), 0x01010101u, 0u));
      dst_k[pos] = key;
      dst_i[pos] = id;
    }
    __syncthreads();
    if (leader) {
      atomicAdd(&off[d], static_cast<unsigned>(__popc(peers)));
      reinterpret_cast<unsigned char*>(&wcnt[d])[warp] = 0u;
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void gather_values(const T* __restrict__ x, long long D, int k,
                              const unsigned* __restrict__ skip,
                              const int* __restrict__ ia,
                              const int* __restrict__ ib,
                              T* __restrict__ values, int* __restrict__ idx) {
  const int r = blockIdx.y;
  const long long j =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j < k) {
    const long long o = static_cast<long long>(r) * k + j;
    const int id = (ran_before(skip + r * 4, 3) & 1 ? ib : ia)[o];
    values[o] = x[static_cast<long long>(r) * D + id];
    idx[o] = id;
  }
}

// ---- launchers ---------------------------------------------------------------

// The scratch of one call, carved from two buffers: z, which must start
// at zero (one memset clears it), and the rest, s (byte offsets).
struct Layout {
  long long state, ghist, zero_end;           // z: select
  long long cstatus, ghist3, sticket, skip, sstatus;  // z: whole
  long long cand, ka, kb, ia, ib, counts, end;  // s
  long long n_ctiles, k_tiles, n_counts, n_stiles, cap;
};

long long align16(long long b) { return (b + 15) / 16 * 16; }

bool small_row(long long D) { return D <= kSmallMax; }

Layout layout(int bf16, int R, long long D, int k, bool whole) {
  Layout L{};
  const int n = bf16 ? 8 : 4;
  // the candidate buffer: D / 16 keys a row, a multiple of 4 (16-byte rows)
  L.cap = bf16 || small_row(D) ? 0 : D / 16 / 4 * 4;
  long long at = 0;
  auto take = [&at](long long bytes) {
    const long long p = at;
    at = align16(at + bytes);
    return p;
  };
  L.state = take(32ll * R);
  L.ghist = take(4ll * kBins * R);
  if (whole) {
    // tiles of the padded row (at most 15 bytes of head)
    L.n_ctiles = ((16 / (bf16 ? 2 : 4) + D + n - 1) / n * n + kCompactKeys -
                  1) / kCompactKeys;
    L.k_tiles = (k + kSortTile - 1) / kSortTile;
    L.n_counts = kBins * L.k_tiles;
    L.n_stiles = (L.n_counts + kScanTile - 1) / kScanTile;
    L.cstatus = take(8ll * R * L.n_ctiles);
    L.ghist3 = take(12ll * kBins * R);
    L.sticket = take(4ll * R);
    L.skip = take(16ll * R);
    L.sstatus = take(24ll * R * L.n_stiles);
  }
  L.zero_end = at;
  at = 0;
  L.cand = take(4ll * R * L.cap);
  if (whole) {
    L.ka = take(4ll * R * k);
    L.kb = take(4ll * R * k);
    L.ia = take(4ll * R * k);
    L.ib = take(4ll * R * k);
    L.counts = take(4ll * R * L.n_counts);
  }
  L.end = at;
  return L;
}

unsigned pass_blocks(long long nv) {
  const long long per = static_cast<long long>(kThreads) * kU;
  long long b = (nv + per - 1) / per;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return static_cast<unsigned>(b < 1 ? 1 : b);
}

template <typename T>
int run_select(const T* x, int R, long long D, int k, const Layout& L,
               char* z, char* s, float* thr, cudaStream_t st, bool zeroed) {
  auto* state = reinterpret_cast<RowState*>(z + L.state);
  const int passes = sizeof(T) == 2 ? 2 : 3;
  if (small_row(D)) {
    select_small<T><<<R, kSmallThreads, 0, st>>>(x, D, k, passes, state,
                                                  thr);
    return static_cast<int>(cudaGetLastError());
  }
  if (!zeroed) {
    const cudaError_t e = cudaMemsetAsync(z, 0, L.zero_end, st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  auto* gh = reinterpret_cast<unsigned*>(z + L.ghist);
  auto* cand = reinterpret_cast<unsigned*>(s + L.cand);
  const long long nv = (16 / static_cast<long long>(sizeof(T)) + D +
                        Vec<T>::n - 1) / Vec<T>::n;
  const dim3 grid(pass_blocks(nv), static_cast<unsigned>(R));
  select_pass<T, 0, false><<<grid, kThreads, 0, st>>>(x, D, k, L.cap, state,
                                                      gh, cand, nullptr);
  if constexpr (sizeof(T) == 2) {
    select_pass<T, 1, true><<<grid, kThreads, 0, st>>>(x, D, k, L.cap, state,
                                                       gh, cand, thr);
  } else {
    select_pass<T, 1, false><<<grid, kThreads, 0, st>>>(x, D, k, L.cap, state,
                                                        gh, cand, nullptr);
    select_pass<T, 2, true><<<grid, kThreads, 0, st>>>(x, D, k, L.cap, state,
                                                       gh, cand, thr);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run_topk(const T* x, int R, long long D, int k, const Layout& L, char* z,
             char* s, T* values, int* indices, cudaStream_t st) {
  cudaError_t e = cudaMemsetAsync(z, 0, L.zero_end, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  int err = run_select<T>(x, R, D, k, L, z, s, nullptr, st, true);
  if (err) return err;
  const auto* state = reinterpret_cast<const RowState*>(z + L.state);
  auto* ka = reinterpret_cast<unsigned*>(s + L.ka);
  auto* kb = reinterpret_cast<unsigned*>(s + L.kb);
  auto* ia = reinterpret_cast<int*>(s + L.ia);
  auto* ib = reinterpret_cast<int*>(s + L.ib);
  auto* skip = reinterpret_cast<unsigned*>(z + L.skip);
  auto* counts = reinterpret_cast<unsigned*>(s + L.counts);
  const unsigned rows = static_cast<unsigned>(R);
  compact<T><<<dim3(static_cast<unsigned>(L.n_ctiles), rows), kThreads, 0,
               st>>>(x, D, k, state,
                     reinterpret_cast<unsigned long long*>(z + L.cstatus),
                     L.n_ctiles, ka, ia);
  long long pb = (k + kThreads - 1) / kThreads;
  if (pb > kMaxBlocks) pb = kMaxBlocks;
  sort_prehist<<<dim3(static_cast<unsigned>(pb), rows), kThreads, 0, st>>>(
      ka, k, reinterpret_cast<unsigned*>(z + L.ghist3),
      reinterpret_cast<unsigned*>(z + L.sticket), skip);
  const dim3 kgrid(static_cast<unsigned>(L.k_tiles), rows);
  for (int p = 0; p < 3; ++p) {
    sort_hist<<<kgrid, kThreads, 0, st>>>(ka, kb, k, p, skip, counts,
                                          L.k_tiles);
    scan_counts<<<dim3(static_cast<unsigned>(L.n_stiles), rows), kThreads, 0,
                  st>>>(
        counts, L.n_counts, p, skip,
        reinterpret_cast<unsigned long long*>(z + L.sstatus) +
            static_cast<long long>(p) * R * L.n_stiles,
        L.n_stiles);
    sort_scatter<<<kgrid, kThreads, 0, st>>>(ka, kb, ia, ib, k, p, skip,
                                             counts, L.k_tiles);
  }
  const dim3 vgrid(static_cast<unsigned>((k + 255) / 256), rows);
  gather_values<T><<<vgrid, 256, 0, st>>>(x, D, k, skip, ia, ib, values,
                                          indices);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bytes of scratch a call needs (whole: the whole top-k, else the select
// stage alone): bytes[0] for the buffer that starts at zero, bytes[1] for
// the rest. Returns 0.
int soar_topk_scratch(int bf16, int R, long long D, int k, int whole,
                      long long* bytes) {
  const Layout L = layout(bf16, R, D, k, whole != 0);
  bytes[0] = L.zero_end;
  bytes[1] = L.end;
  return 0;
}

// The select stage alone: the k-th largest |x| of each row into
// thresholds (R,) float32.
int soar_topk_select(const void* x, int bf16, int R, long long D, int k,
                     void* zeroed, void* scratch, void* thresholds,
                     void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const Layout L = layout(bf16, R, D, k, false);
  char* z = static_cast<char*>(zeroed);
  char* s = static_cast<char*>(scratch);
  auto* thr = static_cast<float*>(thresholds);
  return bf16 ? run_select(static_cast<const unsigned short*>(x), R, D, k, L,
                           z, s, thr, st, false)
              : run_select(static_cast<const float*>(x), R, D, k, L, z, s,
                           thr, st, false);
}

// The whole top-k: values (R, k) in x's dtype and indices (R, k) int32.
int soar_topk_compress(const void* x, int bf16, int R, long long D, int k,
                       void* zeroed, void* scratch, void* values,
                       void* indices, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const Layout L = layout(bf16, R, D, k, true);
  char* z = static_cast<char*>(zeroed);
  char* s = static_cast<char*>(scratch);
  auto* idx = static_cast<int*>(indices);
  return bf16 ? run_topk(static_cast<const unsigned short*>(x), R, D, k, L,
                         z, s, static_cast<unsigned short*>(values), idx, st)
              : run_topk(static_cast<const float*>(x), R, D, k, L, z, s,
                         static_cast<float*>(values), idx, st);
}

}  // extern "C"
