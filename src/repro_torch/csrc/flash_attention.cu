// Flash (online-softmax) attention for Hopper (sm_90a): the serving path's
// attention, prefill and decode.
//
//   q (B, T, H, D), k (B, S, Hkv, D) and v (B, S, Hkv, Dv), Dv <= D (MLA:
//   keys 96 wide, values 64), float32 or bfloat16, each a strided view
//   whose last dimension is contiguous -> o (B, T, H, Dv) in q's dtype.
//   Query head h reads KV head h / (H / Hkv), so grouped K/V are never
//   repeated; the (BH, T, D) layout is H = Hkv = 1. For every (b, h,
//   query row): logits (q . k) * scale in float32, masked to key < S and,
//   when causal, key <= row (positions aligned at 0, as the JAX oracle
//   aligns them) and, with a sliding window w > 0 (causal, T == S only),
//   key > row - w, the band of models/attention.py::causal_mask(T, S, w);
//   the running max m and normaliser l in float32 from NEG_INF = -1e30;
//   o = acc / max(l, 1e-30) in q's dtype.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention/
// flash_attention.py :: flash_attention_pallas (body _flash_kernel; the
// pallas_call at :69). It computes what that body computes, not its
// (128 x 128 block, VMEM-resident K/V panel) schedule; ragged query and key
// tiles are masked here, so the wrapper pads nothing and never falls back.
//
// Three launch shapes for attention; the wrapper picks one by T, dtype and
// (D, Dv) only and counts each call once:
//  * tensor-core tile kernel (T > 1, bfloat16, (D, Dv) (64, 64), (128,
//    128), (96, 64), (112, 112) or (192, 128), a template on the pair; the
//    serving cells' prefill):
//    one block of 288 threads (256 at (192, 128), below) per (b, h,
//    128-row query tile), head-major
//    and each head's longest causal tiles first, so the blocks in flight
//    read the same K/V through L2 (tile-major, 132 heads at once
//    streamed their K/V from device memory: at MLA's 40/40 heads nearly
//    at the memory's rate). A producer warp (one thread of it issuing)
//    loads the Q tile once and 128-key K and V tiles into a ring of as
//    many stages as shared memory holds, at most 4 (4 at Dv 64, 3 at (128,
//    128), 2 at deepseek-v2's (192, 128): S over 12 k-steps of three
//    64-column panels) by TMA (tensor maps over each strided
//    view, zeros out of bounds), each stage guarded by a full and an empty
//    mbarrier. Q and K load as 64-column panels in the 128-byte swizzle
//    and, at D 96, a last 32-column panel in the 64-byte swizzle (its own
//    tensor map and wgmma descriptors), so
//    no byte is loaded that the products do not read: a (96, 64) stage is
//    40 KB. At (112, 112) the maps keep the true width 112 and the second
//    64-column box of Q, K and V carries 48 columns and 16 zeros of TMA's
//    fill (no device memory read for them): the (128, 128) layout, S over
//    7 k-steps (the 8th would read zeros only) and O by m64n112k16, which
//    reads the second V panel's first 48 columns (faster than m64n128k16
//    over the padding in 8 of 10 pairs of turns, 4 fewer registers, no
//    spill; PERF.md). Two consumer warpgroups of 64 rows each compute S =
//    Q K^T with wgmma.m64n128k16 (bf16 operands from shared memory, float32
//    accumulator), the online softmax on the accumulator fragment in
//    registers (a row's max and sum over the four lanes that hold it, two
//    shuffles; base-2 exponentials of logits pre-scaled by log2(e)), round
//    P to bfloat16 in registers, where the accumulator layout is exactly
//    wgmma's register-A layout, and compute O += P V with
//    wgmma.m64n{Dv}k16 (V the transposed B operand). l sums the float32 P;
//    only P's product rounds it, as the plain version rounds its weights to
//    v's dtype. Key tiles past the diagonal are never loaded, the window's
//    band starts at its first tile, and only diagonal, ragged and band-edge
//    tiles are masked element by element. A masked score becomes -inf:
//    its weight 2^(s c - m) is 0 whatever the row's running max, so a row
//    whose band starts past the window's first key tile keeps m = -1e30
//    and l = 0 there. Each weight takes one FMA and one ex2.approx.ftz,
//    and O is rescaled only when a row's max moved. Each warpgroup works
//    in series (S, its softmax, P V, each waited for); the two overlap
//    only as the SM's warp schedulers interleave them. The warpgroup index
//    is taken from lane 0 by a shuffle, so the compiler knows it uniform
//    across the warp (without it every row ran 2.5-4.5% slower, PERF.md).
//    At the MLA prefill cell the products are 27.8 ms at the bf16 rate and
//    the exponentials alone about 20-23 ms.
//  * CUDA-core tile kernel (T > 1, float32, or bfloat16 with (D, Dv) not
//    a tensor-core pair): one block of 256 threads per (b, h, 64-row query
//    tile). The Q
//    tile and one 64-key K tile, then the V tile in the same buffer, sit in
//    shared memory as float32 rows padded to an odd stride (conflict-free
//    column reads). Thread (ty, tx) of the 16 x 16 grid holds rows ty + 16 i
//    and key columns tx + 16 j of the 64 x 64 score tile, and rows ty + 16 i,
//    head dims tx + 16 jj of the accumulator; row max and row sum are
//    butterflies over the 16 lanes of a row group. Products in float32 with
//    explicit fmaf (the build has -fmad=false), P kept in float32,
//    exponentials by expf; causal and window skips as above.
//  * split decode (T = 1, float32 and bfloat16): grid (B Hkv ceil(G / 8),
//    n_split). A block of 128 threads takes up to 8 query heads of one KV
//    head over one contiguous key range of the split, so each K/V byte is
//    read once per KV head, not G times. 64-key K/V tiles (32 or 16 for
//    rows past 256 bytes) are staged in shared memory by cp.async, 16 bytes
//    a thread, double-buffered; scores (a thread per key, q rows read as
//    float4), the online softmax (expf) and P V (a thread per pair of head
//    dims of all the block's heads and one phase of the keys, the phases
//    summed in order at the end) are float32 on the CUDA cores. Each split
//    writes its m, l and unnormalised accumulator to scratch; a second
//    launch merges the splits in split order (no atomics: deterministic)
//    and writes o. A decode passes the cache prefix k_all[:, :n] as a view,
//    with no copy.
// And two for MLA's absorbed decode, which has no TPU twin (the JAX package
// computes it in jnp, src/repro/models/attention.py :: mla_decode): q_lat
// (B, 1, H, r) and q_rope (B, 1, H, rd) over the latent cache ckv (B, n, r)
// and kr (B, n, rd), r <= 512 and rd <= 64 -> ctx_lat (B, 1, H, r):
// scores (q_lat . ckv + q_rope . kr) * scale in float32, the online
// softmax, P ckv. Every head reads the same cache, so a block takes many
// heads of one sequence over one split of the keys and stages each 64-key
// tile of ckv | kr once for both products.
//  * latent decode on the tensor cores (bfloat16 with r 64, 128, 192, 256
//    or 512 and rd 32 or 64, minicpm3's 256 + 32 and deepseek-v2's 512 +
//    64; the served path): a block takes up to 64 heads of one sequence
//    over one split. The heads are the M rows of wgmma products: S = Q
//    [ckv | kr]^T (m64n64k16, Q written once into the swizzled layout, the
//    tile K-major) and O += P ckv (m64n64k16 a 64-column ckv panel, P
//    rounded to bfloat16 in registers as the A operand, the panel
//    MN-major); the softmax in base 2 on the S fragment (ex2.approx, as the
//    tile kernel). Up to r 256 one consumer warpgroup holds O and a loader
//    warp keeps a ring of 4 tiles in flight (160 threads); at r 512 O's
//    64 x 512 float32 would need 256 registers a thread, so two consumer
//    warpgroups each hold 256 of its columns, warpgroup 0 computes S and
//    the softmax and hands P and the rows' rescale to warpgroup 1 through
//    shared memory, the ring holds 2 tiles (Q, 2 tiles and P 230,400
//    bytes), and warpgroup 1's first thread refills it (256 threads: a
//    loader warp would leave 168 registers a thread, and warpgroup 0
//    spilled). Each tile comes by TMA (r / 64 ckv boxes in the 128-byte
//    swizzle and one kr box, zeros past n) on mbarriers. One wave of
//    blocks (B ceil(H / 64) splits about 132), so a split is about n B /
//    132 keys (deepseek-v2's decode: 2 head groups x 66 splits, 38.1 MB a
//    layer, 11.4 us at 3.35 TB/s);
//    the splits' float32 partials merge in split order in base 2 by a
//    merge kernel of its own (deterministic). At minicpm3's cell (B 4, 40
//    heads, 256 + 32, n 32,832) a layer moves 75.6 MB (22.6 us at 3.35
//    TB/s): bound by bytes, its 5.7 GFLOP 5.8 us at the bf16 rate (9.2 with
//    the heads padded to 64). Staging by one bulk copy a row and part, or
//    by one warp's 16-byte cp.async copies, and products by mma.sync with
//    one warp a 16-head group were slower (PERF.md).
//  * latent decode on the CUDA cores (float32, and bfloat16 at other
//    widths: the float32 gates and reduced configs):
//    a block takes up to 40 heads (8 warps of 5) over one split, 32 (8
//    warps of 4) where r is past 256; each 64-key tile (32 in float32) is
//    staged once by cp.async, double-buffered, and serves both the scores
//    (a lane two keys, a warp its heads, q rows read as float4 broadcasts)
//    and P ckv (a thread two latent columns of 20 heads, or four of 16
//    past r 256, keys in order). Grid (B ceil(H / heads), n_split); the
//    split decode's merge launch folds the splits in split order.
//
// Bound on the H100: prefill is bound by operations (minicpm3's MLA
// prefill, (4, 32768, 40/40, 96|64) causal, 27.5 TFLOP a layer, 27.8 ms at
// the bf16 rate). At the qwen3-32b
// serving cell (B 4, T = S = 2048, 64 heads over 8 KV heads, D 128) the two
// causal products are 275 GFLOP per layer: 0.28 ms at the bf16 tensor-core
// rate (989 TFLOP/s), which only wgmma reaches; the CUDA-core kernel is
// capped at the float32 rate (67 TFLOP/s). Decode is bound by bytes: the KV
// prefix, 34.6 MB per layer at 2112 positions, 10 us at 3.35 TB/s, which the
// split decode reads once with about two waves of blocks in flight. What the
// designs still give up: ordering the two warpgroups against each other
// (FA3's ping-pong: named barriers, the next S issued before this tile's
// softmax; at (96, 64) it won 7-8 of 10 pairs of turns by about 1%, at
// (64, 64) it lost 4% on hymba's windowed layers and at (128, 128) 30%,
// with spills: nine warps or twelve leave ptxas 168 registers a thread,
// and a producer warpgroup with setmaxnreg moved no row, PERF.md), a third
// consumer warpgroup, a persistent grid, a TMA store of the output, and a
// polynomial exp2 on the FMA pipe beside the special function unit; in
// the latent decode, overlapping one tile's
// softmax with the next tile's S, the merge folded into the last block of
// each sequence, and the split decode's own move to the tensor cores.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kTile = 64;                 // query rows and keys of a tile
constexpr int kThreads = 256;             // the tile kernel's 16 x 16 grid
constexpr int kPs = kTile + 1;            // row stride of the P tile
constexpr unsigned kFull = 0xffffffffu;

struct Strides {                          // element strides of (B, T, H, D)
  long long b, t, h;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);             // round to nearest even
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// The CUDA-core tile kernel

// Copy rows [r0, r0 + kTile) of a (rows, D) panel (row stride `ld_g`) into
// a float32 tile of row stride `ld`, zeros past `rows` and past D up to W.
template <typename T, int W>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long ld_g, int r0, int rows,
                                          int D, int ld) {
  for (int i = threadIdx.x; i < kTile * W; i += kThreads) {
    const int r = i / W, d = i - r * W, g = r0 + r;
    dst[r * ld + d] =
        (g < rows && d < D) ? to_f(src[g * ld_g + d]) : 0.f;
  }
}

// DJ = head-dim columns per thread: D <= 16 * DJ.
template <typename T, int DJ>
__global__ void __launch_bounds__(kThreads)
flash_tile_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, int B, int Tq,
                  int S, int H, int G, int D, int Dv, Strides sq, Strides sk,
                  Strides sv, Strides so, int causal, int window,
                  float scale) {
  constexpr int W = 16 * DJ;
  constexpr int ld = W + 1;               // odd: conflict-free column reads
  extern __shared__ float smem[];
  float* qs = smem;                       // kTile x ld
  float* kv = qs + kTile * ld;            // kTile x ld: K, then V
  float* ps = kv + kTile * ld;            // kTile x kPs

  const int n_bh = B * H;
  const int n_qt = (Tq + kTile - 1) / kTile;
  const int bh = blockIdx.x % n_bh;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x / n_bh);
  const int b = bh / H, h = bh - (bh / H) * H, hk = h / G;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = qt * kTile;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;

  load_tile<T, W>(qs, qb + q0 * sq.t, sq.t, 0, Tq - q0, D, ld);

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = 0.f;
  }
  const int q_last = min(Tq, q0 + kTile) - 1;
  const int s_end = causal ? min(S, q_last + 1) : S;
  const int n_kt = (s_end + kTile - 1) / kTile;
  const int kt0 = window > 0 ? max(0, q0 - window + 1) / kTile : 0;

  for (int kt = kt0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();                      // the previous V tile is read
    load_tile<T, W>(kv, kb, sk.t, k0, S, D, ld);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = kv[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (kpos >= S || (causal && kpos > qpos) ||
            (window > 0 && kpos <= qpos - window))
          x = kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty + 16 * i) * kPs + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(kFull, sum, off);
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) acc[i][jj] *= alpha;
      m[i] = m_new;
    }

    __syncthreads();                      // K is read and P is written
    load_tile<T, W>(kv, vb, sv.t, k0, S, Dv, ld);   // zeros past Dv
    __syncthreads();
    const int n_c = min(kTile, S - k0);   // keys past S: p = 0 and v = 0
    for (int c = 0; c < n_c; ++c) {
      float a[4], w[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ps[(ty + 16 * i) * kPs + c];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) w[jj] = kv[c * ld + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj)
          acc[i][jj] = fmaf(a[i], w[jj], acc[i][jj]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= Tq) continue;
    T* orow = o + b * so.b + t * so.t + h * so.h;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      const int d = tx + 16 * jj;
      if (d < Dv) orow[d] = from_f<T>(acc[i][jj] / den);
    }
  }
}


template <typename T, int DJ>
cudaError_t launch_tile(const T* q, const T* k, const T* v, T* o, int B,
                        int Tq, int S, int H, int G, int D, int Dv, Strides sq,
                        Strides sk, Strides sv, Strides so, int causal,
                        int window, float scale, cudaStream_t stream) {
  const int ld = 16 * DJ + 1;
  const int smem = (2 * kTile * ld + kTile * kPs) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_tile_kernel<T, DJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const long long blocks =
      static_cast<long long>(B) * H * ((Tq + kTile - 1) / kTile);
  flash_tile_kernel<T, DJ><<<static_cast<unsigned>(blocks), kThreads, smem,
                             stream>>>(q, k, v, o, B, Tq, S, H, G, D, Dv, sq,
                                       sk, sv, so, causal, window, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The tensor-core tile kernel (bfloat16; (D, Dv) (64, 64), (128, 128), (96,
// 64), (112, 112), (192, 128))

namespace tc {

constexpr int kRows = 128;                // query rows of a block
constexpr int kKeys = 128;                // keys of a K/V tile
constexpr int kMaxStages = 4;             // K/V tiles in flight, at most
constexpr int kConsumers = 256;           // two warpgroups of 64 rows
constexpr int kThreadsTc = kConsumers + 32;   // and one producer warp
constexpr int kRowBytes = 128;            // 64 bf16: one swizzled row

// Shared memory: the Q tile, then a ring of (K tile, V tile) stages. Q and
// K are panels of 64 columns (128-byte rows in the 128-byte swizzle) and,
// where DK % 64 is 32, one panel of 32 columns (64-byte rows in the 64-byte
// swizzle), so no column is loaded that the products do not read; V is
// panels of 64 columns. A width that ends part way into a 64-column panel
// (112) is padded to the panel's end (kPadK, kPadV) by the tensor map's
// zero fill. Every panel starts on a 1024-byte boundary. The ring takes as
// many stages as the block's shared memory holds beside Q, at most 4:
// (64, 64): 16 KB of Q and four 32 KB stages; (128, 128) and (112, 112):
// 32 KB of Q and three 64 KB stages (225 KB with the alignment); (96, 64):
// 24 KB of Q and four 40 KB stages (184 KB); deepseek-v2's (192, 128): 48
// KB of Q and two 80 KB stages (209 KB).
constexpr int kSmemBlock = 232448;        // shared memory a block may use
constexpr int kSmemStatic = 128;          // the kernel's mbarriers, rounded
template <int DK, int DV>
struct Layout {
  static constexpr bool kHalfK = DK % 64 == 32;   // a 32-column panel last
  static constexpr int kPadK = kHalfK ? DK : (DK + 63) / 64 * 64;
  static constexpr int kPadV = (DV + 63) / 64 * 64;
  static constexpr int kPanelsK = kPadK / 64;     // 64-column panels of Q, K
  static constexpr int kPanelsV = kPadV / 64;
  static constexpr int kQ = kRows * kPadK * 2;
  static constexpr int kK = kKeys * kPadK * 2;
  static constexpr int kV = kKeys * kPadV * 2;
  static constexpr int kStage = kK + kV;
  static constexpr int kFit = (kSmemBlock - kSmemStatic - 1024 - kQ) / kStage;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kBytes = kQ + kStages * kStage;
  // At (192, 128) no producer warp: nine warps leave ptxas 168 registers
  // a thread, where the consumers' O, S and P and the softmax spill (as at
  // (128, 128)); with eight it may use 255. The first thread issues Q and
  // the ring's first tiles, and whichever warpgroup is second to finish
  // with a stage refills it (a counter a stage), so neither waits for the
  // other. The other pairs keep their producer warp, their instructions
  // as measured.
  static constexpr bool kNoLoader = DK == 192;
  static constexpr int kThreads = kNoLoader ? kConsumers : kThreadsTc;
  static_assert(DK % 16 == 0 && (DV == 64 || DV == 112 || DV == 128) &&
                    DV <= DK && kStages >= 2,
                "the tile kernel's widths");
};

struct Args {
  __nv_bfloat16* o;
  int B, Tq, S, H, G, causal, window;
  float scale_log2;                       // scale * log2(e)
  Strides sq, sk, sv, so;
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Returns once the barrier's phase of this parity has completed. A phase
// that never completes (a fault of the protocol) traps after 2^26 tries, a
// launch failure the wrapper raises, rather than hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  int tries = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (!done && ++tries == (1 << 26)) __trap();
  } while (!done);
}

// One TMA box (64 or 32 d, 1 head, rows, 1 batch) at coordinates (c0..c3)
// of a (D, heads, rows, B) tensor map into shared memory; completes on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// wgmma matrix descriptor: start address, leading and stride byte offsets
// (in 16-byte units) and the swizzle (1: 128-byte, 2: 64-byte).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t mode) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (mode << 62);
}

__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return smem_desc(addr, lbo, sbo, 1);
}

__device__ __forceinline__ uint64_t sw64_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return smem_desc(addr, lbo, sbo, 2);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving registers that an asynchronous product
// writes or reads across its issue and its wait.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// Gives r values that the compiler need not keep: placed before a product
// whose first step overwrites r (scale_d = 0), it ends r's old values'
// lives at their last read instead of keeping them across the loop.
template <int N>
__device__ __forceinline__ void fresh(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "=f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// 2^x by the special function unit, subnormal results flushed to zero
// (relative error below 2^-22; 2^-inf = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);   // .x = lo
  return *reinterpret_cast<const uint32_t*>(&t);
}

// d (+)= A B: A (64 x 16) and B (16 x 128, K-major) from shared memory by
// descriptor; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A B: A (64 x 16) from registers (a: four bf16 pairs in the
// accumulator's layout), B (16 x 64) MN-major (transposed) in shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B: A (64 x 16) from registers (a: four bf16 pairs in the
// accumulator's layout), B (16 x 128) MN-major (transposed) in shared memory.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                            const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B: A (64 x 16) from registers (a: four bf16 pairs in the
// accumulator's layout), B (16 x 112) MN-major (transposed) in shared
// memory: the second 64-dim panel read in its first 48 columns.
__device__ __forceinline__ void wgmma_rs_n112(float (&d)[56],
                                             const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// S = Q K^T for warpgroup wg's 64 query rows (issued, not waited for):
// K-major A and B, 16 head dims a k-step, DK / 16 steps (a zero-padded
// panel's padding is never read). A step inside a panel row advances the
// start address by 32 bytes; the 32-column panel takes the 64-byte
// swizzle's descriptors (8-row groups of 512 bytes).
template <int DK, int NPK>
__device__ __forceinline__ void issue_qk(float (&sc)[kKeys / 2],
                                         uint32_t q_addr, uint32_t k_addr,
                                         int wg) {
  constexpr int kWide = 4 * NPK;          // k-steps in 64-column panels
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk) {
    uint64_t da, db;
    if (kk < kWide) {
      da = sw128_desc(q_addr + (kk >> 2) * kRows * kRowBytes +
                          wg * 64 * kRowBytes + (kk & 3) * 32,
                      16, 1024);
      db = sw128_desc(k_addr + (kk >> 2) * kKeys * kRowBytes + (kk & 3) * 32,
                      16, 1024);
    } else {
      const int j = kk - kWide;
      da = sw64_desc(q_addr + NPK * kRows * kRowBytes + wg * 64 * 64 +
                         j * 32,
                     16, 512);
      db = sw64_desc(k_addr + NPK * kKeys * kRowBytes + j * 32, 16, 512);
    }
    wgmma_ss_n128(sc, da, db, kk > 0);
  }
}

// O += P V (issued, not waited for): P from registers in wgmma's register-A
// layout, V MN-major (head dims contiguous), 16 keys a step of 2048 bytes;
// its 64-dim panels kKeys x 128 bytes apart. At DV 112 the product reads
// the second panel's first 48 columns (its zero fill never enters O).
template <int DV>
__device__ __forceinline__ void issue_pv(float (&o)[DV / 2],
                                         const uint32_t (&pa)[kKeys / 4],
                                         uint32_t v_addr) {
#pragma unroll
  for (int j = 0; j < kKeys / 16; ++j) {
    const uint64_t dv = sw128_desc(v_addr + j * 16 * kRowBytes,
                                   kKeys * kRowBytes, 1024);
    if constexpr (DV == 64)
      wgmma_rs_n64(o, pa + 4 * j, dv);
    else if constexpr (DV == 112)
      wgmma_rs_n112(o, pa + 4 * j, dv);
    else
      wgmma_rs_n128(o, pa + 4 * j, dv);
  }
}

// Where a warpgroup's rows sit in the S fragment: sc[4 i + e] holds row
// row0 + 8 (e / 2), key k0 + 8 i + col + e % 2.
struct Rows {
  int qmin, qmax, row0, col;
};

// The online softmax of one key tile on the S fragment, in place: the
// element mask only where the tile crosses the diagonal, the key end or the
// band's lower edge (a masked score becomes -inf, whose weight is 0
// whatever the row's max); then, base 2, the max m of the scaled logits
// (from -1e30), alpha = 2^(m - m_new), p = 2^(s c - m_new) by one FMA and
// ex2 written over s, and l = l alpha + sum(p).
__device__ __forceinline__ void softmax_tile(float (&sc)[kKeys / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2],
                                             const Args& a, const Rows& rw,
                                             int k0) {
  const bool edge = (a.causal && k0 + kKeys - 1 > rw.qmin) ||
                    k0 + kKeys > a.S ||
                    (a.window > 0 && k0 <= rw.qmax - a.window);
  if (edge) {
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) {
      const int key = k0 + 8 * (i >> 2) + rw.col + (i & 1);
      const int row = rw.row0 + 8 * ((i >> 1) & 1);
      if (key >= a.S || (a.causal && key > row) ||
          (a.window > 0 && key <= row - a.window))
        sc[i] = -INFINITY;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < kKeys / 8; ++i)
      mx = fmaxf(mx, fmaxf(sc[4 * i + 2 * r], sc[4 * i + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
    const float m_new = fmaxf(m[r], mx * a.scale_log2);
    alpha[r] = ex2(m[r] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kKeys / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = ex2(fmaf(sc[4 * i + 2 * r + e], a.scale_log2, -m_new));
        sc[4 * i + 2 * r + e] = p;
        sum += p;
      }
    sum += __shfl_xor_sync(kFull, sum, 1);
    sum += __shfl_xor_sync(kFull, sum, 2);
    l[r] = l[r] * alpha[r] + sum;
    m[r] = m_new;
  }
}

// O rescaled only where a row's max moved (alpha != 1).
template <int DV>
__device__ __forceinline__ void rescale(float (&o)[DV / 2],
                                        const float (&alpha)[2]) {
  if (__any_sync(kFull, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
    for (int i = 0; i < DV / 8; ++i) {
      o[4 * i] *= alpha[0];
      o[4 * i + 1] *= alpha[0];
      o[4 * i + 2] *= alpha[1];
      o[4 * i + 3] *= alpha[1];
    }
  }
}

// P in bfloat16 as wgmma's register A: k-step j (keys 16 j ..) takes the
// accumulator's column blocks 2 j and 2 j + 1, rows row0 and row0 + 8.
__device__ __forceinline__ void pack_p(uint32_t (&pa)[kKeys / 4],
                                       const float (&sc)[kKeys / 2]) {
#pragma unroll
  for (int j = 0; j < kKeys / 16; ++j) {
    pa[4 * j + 0] = pack_bf16(sc[8 * j + 0], sc[8 * j + 1]);
    pa[4 * j + 1] = pack_bf16(sc[8 * j + 2], sc[8 * j + 3]);
    pa[4 * j + 2] = pack_bf16(sc[8 * j + 4], sc[8 * j + 5]);
    pa[4 * j + 3] = pack_bf16(sc[8 * j + 6], sc[8 * j + 7]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

template <int DK, int DV>
__global__ void __launch_bounds__(Layout<DK, DV>::kThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tq2,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tk2,
                const __grid_constant__ CUtensorMap tv, const Args a) {
  using L = Layout<DK, DV>;
  constexpr int NPK = L::kPanelsK, NPV = L::kPanelsV;
  constexpr int kStages = L::kStages;
  extern __shared__ char smem_raw[];
  __shared__ __align__(8) uint64_t full[kMaxStages], empty[kMaxStages], qbar;
  __shared__ int freed[kMaxStages];       // warpgroups done with a stage
  const uint32_t raw = smem_u32(smem_raw);
  char* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  char* qs = smem;

  // head-major: a head's query tiles run one after another, longest
  // first, so the blocks in flight share their K/V through L2 (with the
  // tiles major, 132 heads' K/V streamed from memory at once)
  const int n_qt = (a.Tq + kRows - 1) / kRows;
  const int bh = static_cast<int>(blockIdx.x / n_qt);
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x % n_qt);
  const int b = bh / a.H, h = bh - b * a.H, hk = h / a.G;
  const int q0 = qt * kRows;
  const int q_last = min(a.Tq, q0 + kRows) - 1;
  const int s_end = a.causal ? min(a.S, q_last + 1) : a.S;
  const int kt0 = a.window > 0 ? max(0, q0 - a.window + 1) / kKeys : 0;
  const int n_tiles = (s_end + kKeys - 1) / kKeys - kt0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the warpgroup, taken from lane 0 so that the compiler sees it uniform
  // across the warp
  const int wgi = __shfl_sync(kFull, static_cast<int>(threadIdx.x) / 128, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);            // one arrival per warpgroup
      freed[s] = 0;
    }
    mbar_init(&qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // (no producer warp) tile it's K and V into its stage
  const auto load_kv = [&](int it) {
    const int s = it % kStages;
    char* ks = smem + L::kQ + s * L::kStage;
    const int k0 = (kt0 + it) * kKeys;
    mbar_expect_tx(&full[s], L::kStage);
    for (int p = 0; p < NPK; ++p)
      tma_load(ks + p * kKeys * kRowBytes, &tk, &full[s], p * 64, hk, k0, b);
    for (int p = 0; p < NPV; ++p)
      tma_load(ks + L::kK + p * kKeys * kRowBytes, &tv, &full[s], p * 64, hk,
               k0, b);
  };
  if constexpr (L::kNoLoader) {
    static_assert(!L::kHalfK, "a 32-column panel needs the producer warp");
    if (threadIdx.x == 0) {               // Q, then the ring's first tiles
      mbar_expect_tx(&qbar, L::kQ);
      for (int p = 0; p < NPK; ++p)
        tma_load(qs + p * kRows * kRowBytes, &tq, &qbar, p * 64, h, q0, b);
      for (int it = 0; it < n_tiles && it < kStages; ++it) load_kv(it);
    }
    __syncwarp();
  } else if (wgi == kConsumers / 128) {
    // the producer warp: one thread loads Q once, then K and V tile by tile
    // into the ring
    if (lane == 0) {
      // a box partly out of bounds (ragged rows, the columns past 112)
      // still delivers its whole bytes, the zero fill included
      mbar_expect_tx(&qbar, L::kQ);
      for (int p = 0; p < NPK; ++p)
        tma_load(qs + p * kRows * kRowBytes, &tq, &qbar, p * 64, h, q0, b);
      if (L::kHalfK)
        tma_load(qs + NPK * kRows * kRowBytes, &tq2, &qbar, NPK * 64, h, q0,
                 b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        char* ks = smem + L::kQ + s * L::kStage;
        const int k0 = (kt0 + it) * kKeys;
        mbar_expect_tx(&full[s], L::kStage);
        for (int p = 0; p < NPK; ++p)
          tma_load(ks + p * kKeys * kRowBytes, &tk, &full[s], p * 64, hk,
                   k0, b);
        if (L::kHalfK)
          tma_load(ks + NPK * kKeys * kRowBytes, &tk2, &full[s], NPK * 64,
                   hk, k0, b);
        for (int p = 0; p < NPV; ++p)
          tma_load(ks + L::kK + p * kKeys * kRowBytes, &tv, &full[s],
                   p * 64, hk, k0, b);
      }
    }
    return;
  }

  // a consumer warpgroup: query rows [qmin, qmin + 64)
  const int wg = wgi, w = warp & 3;
  Rows rw;
  rw.qmin = q0 + wg * 64;
  rw.qmax = rw.qmin + 63;
  rw.row0 = rw.qmin + w * 16 + (lane >> 2);   // and row0 + 8
  rw.col = 2 * (lane & 3);
  const uint32_t q_addr = smem_u32(qs);
  const uint32_t ring = smem_u32(smem + L::kQ);
  // sc is zeroed once: every S product's first k-step overwrites it
  float o[DV / 2], sc[kKeys / 2];
  uint32_t pa[kKeys / 4];
  zero(o);
  zero(sc);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
  mbar_wait(&qbar, 0);

  // S, its softmax, then P V, each waited for
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    const uint32_t k_addr = ring + s * L::kStage;
    mbar_wait(&full[s], (it / kStages) & 1);
    pin(sc);
    wgmma_fence();
    issue_qk<DK, NPK>(sc, q_addr, k_addr, wg);
    wgmma_commit();
    wgmma_wait0();
    pin(sc);
    softmax_tile(sc, m, l, alpha, a, rw, (kt0 + it) * kKeys);
    rescale<DV>(o, alpha);
    pack_p(pa, sc);
    pin(o);
    pin(pa);
    wgmma_fence();
    issue_pv<DV>(o, pa, k_addr + L::kK);
    wgmma_commit();
    wgmma_wait0();
    pin(o);
    pin(pa);
    if constexpr (L::kNoLoader) {
      // the second warpgroup done with stage s refills it: both have read
      // it (their products waited for); the fences order the reads and the
      // counter before the refill
      if ((threadIdx.x & 127) == 0) {
        __threadfence_block();
        if (atomicAdd(&freed[s], 1) == 1) {
          freed[s] = 0;
          __threadfence_block();
          if (it + kStages < n_tiles) load_kv(it + kStages);
        }
      }
      __syncwarp();
    } else if ((threadIdx.x & 127) == 0) {
      mbar_arrive(&empty[s]);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rw.row0 + 8 * r;
    if (row >= a.Tq) continue;
    const float den = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = a.o + b * a.so.b + row * a.so.t + h * a.so.h;
#pragma unroll
    for (int i = 0; i < DV / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i + rw.col) =
          __floats2bfloat162_rn(o[4 * i + 2 * r] / den,
                                o[4 * i + 2 * r + 1] / den);
  }
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the CUDA driver, found through the runtime (the
// library links no -lcuda); null where the CUDA driver has none.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (D, heads, rows, B) tensor map of a strided bf16 view (element
// strides st), box (cols, 1, box_rows, 1): 64 columns in the 128-byte
// swizzle or 32 in the 64-byte one, zeros out of bounds (rows past the
// end, and columns past D: a map declared wider than D would read the next
// head's first columns). The caller has checked 16-byte alignment of base
// and strides.
bool make_map(CUtensorMap* map, const void* base, int D, int heads, int rows,
              int B, Strides st, int cols, int box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.h) * 2,
                                 static_cast<cuuint64_t>(st.t) * 2,
                                 static_cast<cuuint64_t>(st.b) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), 1,
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(base), dims, strides, box, step,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                        : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DK, int DV>
constexpr int smem_bytes() {
  return Layout<DK, DV>::kBytes + 1024;   // + alignment to 1024
}

// maps: q, q's 32-column panel, k, k's 32-column panel, v.
template <int DK, int DV>
cudaError_t launch_d(const CUtensorMap* m, const Args& a,
                     cudaStream_t stream) {
  const int smem = smem_bytes<DK, DV>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<DK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const long long blocks =
      static_cast<long long>(a.B) * a.H * ((a.Tq + kRows - 1) / kRows);
  flash_tc_kernel<DK, DV><<<static_cast<unsigned>(blocks),
                            Layout<DK, DV>::kThreads, smem, stream>>>(
      m[0], m[1], m[2], m[3], m[4], a);
  return cudaGetLastError();
}

// The (DK, DV) pairs built: (64, 64), (128, 128), (96, 64), (112, 112)
// and (192, 128).
bool tc_dims(int D, int Dv) {
  return (D == 64 && Dv == 64) || (D == 128 && Dv == 128) ||
         (D == 96 && Dv == 64) || (D == 112 && Dv == 112) ||
         (D == 192 && Dv == 128);
}

cudaError_t launch(const void* q, const void* k, const void* v,
                   const Args& a, int D, int Dv, int Hkv,
                   cudaStream_t stream) {
  CUtensorMap m[5];
  const bool half = D % 64 == 32;
  if (!tc_dims(D, Dv) ||
      !make_map(&m[0], q, D, a.H, a.Tq, a.B, a.sq, 64, kRows) ||
      !make_map(&m[2], k, D, Hkv, a.S, a.B, a.sk, 64, kKeys) ||
      !make_map(&m[4], v, Dv, Hkv, a.S, a.B, a.sv, 64, kKeys) ||
      (half && (!make_map(&m[1], q, D, a.H, a.Tq, a.B, a.sq, 32, kRows) ||
                !make_map(&m[3], k, D, Hkv, a.S, a.B, a.sk, 32, kKeys))))
    return cudaErrorInvalidValue;
  if (!half) {                            // the kernel reads no half panel
    m[1] = m[0];
    m[3] = m[2];
  }
  if (D == 64) return launch_d<64, 64>(m, a, stream);
  if (D == 96) return launch_d<96, 64>(m, a, stream);
  if (D == 112) return launch_d<112, 112>(m, a, stream);
  if (D == 192) return launch_d<192, 128>(m, a, stream);
  return launch_d<128, 128>(m, a, stream);
}

// out: registers a thread, local (spill) bytes a thread, blocks an SM at
// the launch's shared memory, and that shared memory (dynamic + static).
template <typename K>
cudaError_t kernel_info(K kern, int threads, int smem, int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, threads,
                                                      smem);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = blocks;
  out[3] = smem + static_cast<int>(attr.sharedSizeBytes);
  return err;
}

cudaError_t info(int D, int Dv, int* out) {
  if (D == 64 && Dv == 64)
    return kernel_info(flash_tc_kernel<64, 64>, Layout<64, 64>::kThreads,
                       smem_bytes<64, 64>(), out);
  if (D == 96 && Dv == 64)
    return kernel_info(flash_tc_kernel<96, 64>, Layout<96, 64>::kThreads,
                       smem_bytes<96, 64>(), out);
  if (D == 128 && Dv == 128)
    return kernel_info(flash_tc_kernel<128, 128>,
                       Layout<128, 128>::kThreads,
                       smem_bytes<128, 128>(), out);
  if (D == 112 && Dv == 112)
    return kernel_info(flash_tc_kernel<112, 112>,
                       Layout<112, 112>::kThreads,
                       smem_bytes<112, 112>(), out);
  if (D == 192 && Dv == 128)
    return kernel_info(flash_tc_kernel<192, 128>,
                       Layout<192, 128>::kThreads,
                       smem_bytes<192, 128>(), out);
  return cudaErrorInvalidValue;
}

}  // namespace tc

// ---------------------------------------------------------------------------
// The split decode (T = 1)

namespace dec {

constexpr int kThreadsDec = 128;
constexpr int kHeads = 8;                 // query heads of a block

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Keys [k0, min(k0 + KT, k_end)) of one KV head (row stride ld) into
// shared rows of RB bytes: 16-byte cp.async copies (kVec: rows and base
// 16-byte aligned, D * sizeof(T) a multiple of 16), else element copies.
template <typename T, int KT, int RB, bool kVec>
__device__ __forceinline__ void stage_rows(char* dst, const T* src,
                                           long long ld, int k0, int k_end,
                                           int D) {
  if (kVec) {
    const int chunks = D * static_cast<int>(sizeof(T)) / 16;
    for (int i = threadIdx.x; i < KT * chunks; i += kThreadsDec) {
      const int r = i / chunks, c = i - r * chunks;
      if (k0 + r < k_end)
        cp_async16(dst + r * RB + c * 16,
                   src + static_cast<long long>(k0 + r) * ld +
                       c * (16 / static_cast<int>(sizeof(T))));
    }
  } else {
    for (int i = threadIdx.x; i < KT * D; i += kThreadsDec) {
      const int r = i / D, d = i - r * D;
      if (k0 + r < k_end)
        reinterpret_cast<T*>(dst + r * RB)[d] =
            src[static_cast<long long>(k0 + r) * ld + d];
    }
  }
}

// 16 bytes of a shared row as floats
__device__ __forceinline__ void load16(const float* p, float (&x)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  x[0] = u.x;
  x[1] = u.y;
  x[2] = u.z;
  x[3] = u.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {           // a bfloat16 is the high half of
    x[2 * e] = __uint_as_float(w[e] << 16);   // a float32; element 2e is
    x[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);   // the low half
  }
}

template <typename T, int DP>
struct DecodeShape {
  static constexpr int kRowBytes = DP * static_cast<int>(sizeof(T));
  // keys of a staged tile: 64, or fewer for long rows
  static constexpr int KT = kRowBytes <= 256 ? 64 : kRowBytes <= 512 ? 32
                                                                     : 16;
  static constexpr int RB = kRowBytes + 16;   // padded: conflict-free rows
  static constexpr int kFloats = kHeads * DP + kHeads * KT + 3 * kHeads;
  static constexpr int kBytes = 4 * kFloats + 4 * KT * RB;
};

// two consecutive elements of a shared row as floats
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  const unsigned w = *reinterpret_cast<const unsigned*>(p);
  return make_float2(__uint_as_float(w << 16),
                     __uint_as_float(w & 0xffff0000u));
}

// DP = D rounded up to a power of two (at least 32).
template <typename T, int DP, bool kVec>
__global__ void __launch_bounds__(kThreadsDec)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, float* __restrict__ part_ml,
                    float* __restrict__ part_acc, int H, int G, int D,
                    int Dv, int n, int chunk, int n_split, Strides sq,
                    Strides sk, Strides sv, float scale) {
  using Sh = DecodeShape<T, DP>;
  constexpr int KT = Sh::KT, RB = Sh::RB;
  constexpr int kSets = kThreadsDec / KT;         // head sets of the scores
  constexpr int kG = kHeads / kSets;              // heads of a set
  constexpr int NV = 16 / static_cast<int>(sizeof(T));
  constexpr int kPairs = DP / 2;                  // head-dim pairs of P V
  constexpr int kPhases = kThreadsDec / kPairs;   // key phases of P V
  extern __shared__ __align__(16) char smem[];
  float* qs = reinterpret_cast<float*>(smem);    // kHeads x DP
  float* ps = qs + kHeads * DP;                  // KT x kHeads: p[j][g]
  float* ms = ps + kHeads * KT;                  // running max
  float* as = ms + kHeads;                       // this tile's alpha
  float* ls = as + kHeads;                       // running sum
  char* kv = reinterpret_cast<char*>(ls + kHeads);   // 2 x (K, V) x KT x RB

  const int n_hg = (G + kHeads - 1) / kHeads;
  const int hg = blockIdx.x % n_hg, bk = blockIdx.x / n_hg;
  const int Hkv = H / G;
  const int b = bk / Hkv, hk = bk - b * Hkv;
  const int g0 = hg * kHeads, gn = min(kHeads, G - g0);
  const int split = blockIdx.y;
  const int k_lo = split * chunk, k_hi = min(n, k_lo + chunk);
  const int n_t = k_hi > k_lo ? (k_hi - k_lo + KT - 1) / KT : 0;
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;

  for (int i = threadIdx.x; i < kHeads * DP; i += kThreadsDec) {
    const int g = i / DP, d = i - g * DP;
    qs[i] = (g < gn && d < D)
                ? to_f(q[b * sq.b + (hk * G + g0 + g) * sq.h + d])
                : 0.f;
  }
  if (threadIdx.x < kHeads) {
    ms[threadIdx.x] = kNegInf;
    ls[threadIdx.x] = 0.f;
  }
  // P V: thread -> head dims 2 dp, 2 dp + 1 of every head, keys of its
  // phase (j = phase, phase + kPhases, ...)
  const int dp = threadIdx.x % kPairs, phase = threadIdx.x / kPairs;
  float acc[kHeads][2];
#pragma unroll
  for (int g = 0; g < kHeads; ++g) acc[g][0] = acc[g][1] = 0.f;
  if (n_t > 0) {
    stage_rows<T, KT, RB, kVec>(kv, kb, sk.t, k_lo, k_hi, D);
    stage_rows<T, KT, RB, kVec>(kv + KT * RB, vb, sv.t, k_lo, k_hi, Dv);
    cp_commit();
  }
  __syncthreads();

  for (int it = 0; it < n_t; ++it) {
    if (it + 1 < n_t) {                   // the next tile into the other
      char* nxt = kv + ((it + 1) & 1) * 2 * KT * RB;   // buffer
      const int k1 = k_lo + (it + 1) * KT;
      stage_rows<T, KT, RB, kVec>(nxt, kb, sk.t, k1, k_hi, D);
      stage_rows<T, KT, RB, kVec>(nxt + KT * RB, vb, sv.t, k1, k_hi, Dv);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const char* ks = kv + (it & 1) * 2 * KT * RB;
    const char* vs = ks + KT * RB;
    const int k0 = k_lo + it * KT;
    const int nk = min(KT, k_hi - k0);

    {  // scores: thread -> key j of the tile, heads [set kG, set kG + kG)
      const int j = threadIdx.x % KT, set = threadIdx.x / KT;
      const T* kr = reinterpret_cast<const T*>(ks + j * RB);
      const float* qset = qs + set * kG * DP;
      float dot[kG];
#pragma unroll
      for (int gi = 0; gi < kG; ++gi) dot[gi] = 0.f;
      if (kVec) {
        for (int d = 0; d < D; d += NV) {
          float x[NV];
          load16(kr + d, x);
#pragma unroll
          for (int gi = 0; gi < kG; ++gi)
#pragma unroll
            for (int e = 0; e < NV; e += 4) {
              const float4 qv =
                  *reinterpret_cast<const float4*>(qset + gi * DP + d + e);
              dot[gi] = fmaf(qv.x, x[e], dot[gi]);
              dot[gi] = fmaf(qv.y, x[e + 1], dot[gi]);
              dot[gi] = fmaf(qv.z, x[e + 2], dot[gi]);
              dot[gi] = fmaf(qv.w, x[e + 3], dot[gi]);
            }
        }
      } else {
        for (int d = 0; d < D; ++d) {
          const float x = to_f(kr[d]);
#pragma unroll
          for (int gi = 0; gi < kG; ++gi)
            dot[gi] = fmaf(qset[gi * DP + d], x, dot[gi]);
        }
      }
#pragma unroll
      for (int gi = 0; gi < kG; ++gi)     // keys past the range: -1e30
        ps[j * kHeads + set * kG + gi] = j < nk ? dot[gi] * scale : kNegInf;
    }
    __syncthreads();

    {  // the online softmax: warp w takes heads w, w + 4
      const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
      for (int g = warp; g < gn; g += kThreadsDec / 32) {
        const float x0 = lane < KT ? ps[lane * kHeads + g] : kNegInf;
        const float x1 =
            lane + 32 < KT ? ps[(lane + 32) * kHeads + g] : kNegInf;
        float mx = fmaxf(x0, x1);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
        const float m_old = ms[g], m_new = fmaxf(m_old, mx);
        const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
        if (lane < KT) ps[lane * kHeads + g] = p0;
        if (lane + 32 < KT) ps[(lane + 32) * kHeads + g] = p1;
        float sum = p0 + p1;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sum += __shfl_xor_sync(kFull, sum, off);
        if (lane == 0) {
          const float alpha = expf(m_old - m_new);
          ms[g] = m_new;
          as[g] = alpha;
          ls[g] = ls[g] * alpha + sum;
        }
      }
    }
    __syncthreads();

    {  // P V over this thread's keys; heads past gn hold p = 0 rows
#pragma unroll
      for (int g = 0; g < kHeads; ++g) {
        const float al = g < gn ? as[g] : 0.f;
        acc[g][0] *= al;
        acc[g][1] *= al;
      }
      const T* vcol = reinterpret_cast<const T*>(vs) + 2 * dp;
      for (int j = phase; j < nk; j += kPhases) {
        const float2 x = load2(reinterpret_cast<const T*>(
                                   reinterpret_cast<const char*>(vcol) +
                                   j * RB));
        const float4 pa = *reinterpret_cast<const float4*>(ps + j * kHeads);
        const float4 pb =
            *reinterpret_cast<const float4*>(ps + j * kHeads + 4);
        const float pj[kHeads] = {pa.x, pa.y, pa.z, pa.w,
                                  pb.x, pb.y, pb.z, pb.w};
#pragma unroll
        for (int g = 0; g < kHeads; ++g) {
          acc[g][0] = fmaf(pj[g], x.x, acc[g][0]);
          acc[g][1] = fmaf(pj[g], x.y, acc[g][1]);
        }
      }
    }
    __syncthreads();                      // the buffer and P are free
  }

  // the key phases' sums in fixed phase order (the staging buffer is free)
  float* red = reinterpret_cast<float*>(kv);     // kPhases x kHeads x DP
#pragma unroll
  for (int g = 0; g < kHeads; ++g) {
    red[(phase * kHeads + g) * DP + 2 * dp] = acc[g][0];
    red[(phase * kHeads + g) * DP + 2 * dp + 1] = acc[g][1];
  }
  __syncthreads();
  // this split's partial state; an empty split leaves m = -1e30, l = 0
  const long long bh0 = static_cast<long long>(b) * H + hk * G + g0;
  if (threadIdx.x < gn) {
    float* ml = part_ml + ((bh0 + threadIdx.x) * n_split + split) * 2;
    ml[0] = ms[threadIdx.x];
    ml[1] = ls[threadIdx.x];
  }
  for (int i = threadIdx.x; i < gn * Dv; i += kThreadsDec) {
    const int g = i / Dv, d = i - g * Dv;
    float x = 0.f;
    for (int ph = 0; ph < kPhases; ++ph) x += red[(ph * kHeads + g) * DP + d];
    part_acc[((bh0 + g) * n_split + split) * Dv + d] = x;
  }
}

// o[b, 0, h] = sum_s acc_s exp(m_s - M) / max(sum_s l_s exp(m_s - M),
// 1e-30), M = max_s m_s, the splits taken in order. With `lse` (B H
// float32, or null) also lse[b, h] = M + log(sum_s l_s exp(m_s - M)), the
// log of the softmax's denominator over all the keys: what a caller needs
// to merge this output with another one over other keys.
template <typename T>
__global__ void __launch_bounds__(kThreadsDec)
flash_merge_kernel(const float* __restrict__ part_ml,
                   const float* __restrict__ part_acc, T* __restrict__ o,
                   int H, int D, int n_split, Strides so,
                   float* __restrict__ lse) {
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const float* ml = part_ml + static_cast<long long>(bh) * n_split * 2;
  const float* acc = part_acc + static_cast<long long>(bh) * n_split * D;
  float mm = kNegInf;
  for (int s = 0; s < n_split; ++s) mm = fmaxf(mm, ml[2 * s]);
  float ll = 0.f;
  for (int s = 0; s < n_split; ++s)
    ll = fmaf(ml[2 * s + 1], expf(ml[2 * s] - mm), ll);
  if (lse != nullptr && threadIdx.x == 0) lse[bh] = mm + logf(ll);
  const float den = fmaxf(ll, 1e-30f);
  T* orow = o + b * so.b + h * so.h;
  for (int d = threadIdx.x; d < D; d += kThreadsDec) {
    float x = 0.f;
    for (int s = 0; s < n_split; ++s)
      x = fmaf(acc[s * D + d], expf(ml[2 * s] - mm), x);
    orow[d] = from_f<T>(x / den);
  }
}

template <typename T, int DP>
cudaError_t launch_dp(const T* q, const T* k, const T* v, T* o, int B, int n,
                      int H, int G, int D, int Dv, Strides sq, Strides sk,
                      Strides sv, Strides so, float scale, int n_split,
                      int chunk, float* part_ml, float* part_acc,
                      float* lse, cudaStream_t stream) {
  // 16-byte copies when every K and V row starts on a 16-byte boundary
  const long long vec = 16 / sizeof(T);
  const bool aligned =
      reinterpret_cast<unsigned long long>(k) % 16 == 0 &&
      reinterpret_cast<unsigned long long>(v) % 16 == 0 && D % vec == 0 &&
      Dv % vec == 0 &&
      sk.b % vec == 0 && sk.t % vec == 0 && sk.h % vec == 0 &&
      sv.b % vec == 0 && sv.t % vec == 0 && sv.h % vec == 0;
  const int smem = DecodeShape<T, DP>::kBytes;
  auto kern = aligned ? flash_decode_kernel<T, DP, true>
                      : flash_decode_kernel<T, DP, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(B) * (H / G) *
                      ((G + kHeads - 1) / kHeads),
                  static_cast<unsigned>(n_split));
  kern<<<grid, kThreadsDec, smem, stream>>>(q, k, v, part_ml, part_acc, H, G,
                                            D, Dv, n, chunk, n_split, sq, sk,
                                            sv, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_merge_kernel<T><<<static_cast<unsigned>(B) * H, kThreadsDec, 0,
                          stream>>>(part_ml, part_acc, o, H, Dv, n_split, so,
                                    lse);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q_, const void* k_, const void* v_, void* o_,
                   int B, int n, int H, int Hkv, int D, int Dv, Strides sq,
                   Strides sk, Strides sv, Strides so, float scale,
                   int n_split, int chunk, float* part_ml, float* part_acc,
                   float* lse, cudaStream_t stream) {
  const T* q = static_cast<const T*>(q_);
  const T* k = static_cast<const T*>(k_);
  const T* v = static_cast<const T*>(v_);
  T* o = static_cast<T*>(o_);
  const int G = H / Hkv;
  if (D <= 32)
    return launch_dp<T, 32>(q, k, v, o, B, n, H, G, D, Dv, sq, sk, sv, so,
                            scale, n_split, chunk, part_ml, part_acc, lse,
                            stream);
  if (D <= 64)
    return launch_dp<T, 64>(q, k, v, o, B, n, H, G, D, Dv, sq, sk, sv, so,
                            scale, n_split, chunk, part_ml, part_acc, lse,
                            stream);
  if (D <= 128)
    return launch_dp<T, 128>(q, k, v, o, B, n, H, G, D, Dv, sq, sk, sv, so,
                             scale, n_split, chunk, part_ml, part_acc, lse,
                             stream);
  return launch_dp<T, 256>(q, k, v, o, B, n, H, G, D, Dv, sq, sk, sv, so,
                           scale, n_split, chunk, part_ml, part_acc, lse,
                           stream);
}

}  // namespace dec

// ---------------------------------------------------------------------------
// The latent (MLA) decode: all heads of a sequence over its one latent cache

namespace mla {

constexpr int kThreadsMla = 256;
constexpr int kMaxRd = 64;                // rope width, at most

// A block's shape at latent widths up to R (256 or 512). R 256: 40 heads
// (8 warps x 5), a thread 2 latent columns of 20 heads. R 512: 32 heads (8
// warps x 4), so the heads' q rows (576 wide) and two tiles fit in shared
// memory (float32: 73,728 + 2 x 74,240 bytes; bfloat16 231,808 of 232,448
// in all), a thread 4 latent columns (two pairs 256 apart) of 16 heads.
template <typename T, int R>
struct Shape {
  static constexpr int kHeads = R <= 256 ? 40 : 32;   // heads of a block
  static constexpr int kWarpHeads = kHeads / 8;       // heads a warp scores
  static constexpr int kMaxW = R + kMaxRd;            // a staged row, at most
  static constexpr int kPairs = R / 256;   // column pairs a thread holds
  static constexpr int KT = sizeof(T) == 2 ? 64 : 32;   // keys of a tile
  static constexpr int KJ = KT / 32;                     // keys a lane scores
  static constexpr int NV = 16 / static_cast<int>(sizeof(T));   // a chunk
  // a staged row: ckv | kr, padded to an odd number of 16-byte chunks
  static constexpr int RB = kMaxW * static_cast<int>(sizeof(T)) + 16;
  // q (kHeads x kMaxW), p (KT x kHeads), m, alpha, l: floats; 2 tiles
  static constexpr int kFloats = kHeads * kMaxW + KT * kHeads + 3 * kHeads;
  static constexpr int kBytes = 4 * kFloats + 2 * KT * RB;
  static_assert(kBytes <= 232448, "the latent decode's shared memory");
};

// Keys [k0, min(k0 + KT, k_end)) of the latent cache into shared rows:
// ckv's r columns, then kr's rd columns. 16-byte cp.async copies (kVec:
// bases and strides 16-byte aligned), else element copies.
template <typename T, int R, bool kVec>
__device__ __forceinline__ void stage_latent(char* dst, const T* ckv,
                                             long long c_st, const T* kr,
                                             long long kr_st, int k0,
                                             int k_end, int r, int rd) {
  using Sh = Shape<T, R>;
  constexpr int KT = Sh::KT, RB = Sh::RB, NV = Sh::NV;
  const int w = r + rd;
  if (kVec) {
    const int chunks = w / NV;
    for (int i = threadIdx.x; i < KT * chunks; i += kThreadsMla) {
      const int j = i / chunks, c = (i - j * chunks) * NV;
      if (k0 + j >= k_end) continue;
      const T* src = c < r ? ckv + (k0 + j) * c_st + c
                           : kr + (k0 + j) * kr_st + (c - r);
      dec::cp_async16(dst + j * RB + c * static_cast<int>(sizeof(T)), src);
    }
  } else {
    for (int i = threadIdx.x; i < KT * w; i += kThreadsMla) {
      const int j = i / w, c = i - j * w;
      if (k0 + j >= k_end) continue;
      reinterpret_cast<T*>(dst + j * RB)[c] =
          c < r ? ckv[(k0 + j) * c_st + c] : kr[(k0 + j) * kr_st + (c - r)];
    }
  }
}

// a pair of consecutive elements of a staged row as floats
__device__ __forceinline__ float2 pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 pair(const __nv_bfloat16* p) {
  const unsigned u = *reinterpret_cast<const unsigned*>(p);
  return make_float2(__uint_as_float(u << 16),
                     __uint_as_float(u & 0xffff0000u));
}

// Block (b, head group, split): the heads [g0, g0 + gn) of sequence b over
// keys [split chunk, (split + 1) chunk). Warp w scores heads kWarpHeads w ..
// on lanes' keys (lane + 32 kj), the softmax takes a head a warp at a
// time, and thread t accumulates heads kHeads / 2 (t / 128) .. on latent
// columns 2 (t % 128) + 256 c, + 1 (c < kPairs) over every key in order.
template <typename T, int R, bool kVec>
__global__ void __launch_bounds__(kThreadsMla)
flash_mla_kernel(const T* __restrict__ q_lat, const T* __restrict__ q_rope,
                 const T* __restrict__ ckv, const T* __restrict__ kr,
                 float* __restrict__ part_ml, float* __restrict__ part_acc,
                 int H, int n, int r, int rd, int chunk, int n_split,
                 long long ql_sb, long long ql_sh, long long qr_sb,
                 long long qr_sh, long long c_sb, long long c_st,
                 long long kr_sb, long long kr_st, float scale) {
  using Sh = Shape<T, R>;
  constexpr int KT = Sh::KT, KJ = Sh::KJ, RB = Sh::RB, NV = Sh::NV;
  constexpr int kHeads = Sh::kHeads, kWarpHeads = Sh::kWarpHeads;
  constexpr int kMaxW = Sh::kMaxW, kPairs = Sh::kPairs;
  constexpr int kHalf = kHeads / 2;       // heads a thread accumulates
  extern __shared__ __align__(16) char smem[];
  float* qs = reinterpret_cast<float*>(smem);    // kHeads x kMaxW
  float* ps = qs + kHeads * kMaxW;               // KT x kHeads: p[j][g]
  float* ms = ps + KT * kHeads;                  // running max
  float* as = ms + kHeads;                       // this tile's alpha
  float* ls = as + kHeads;                       // running sum
  char* tiles = reinterpret_cast<char*>(ls + kHeads);   // 2 x KT x RB

  const int n_hg = (H + kHeads - 1) / kHeads;
  const int hg = blockIdx.x % n_hg, b = blockIdx.x / n_hg;
  const int g0 = hg * kHeads, gn = min(kHeads, H - g0);
  const int split = blockIdx.y;
  const int k_lo = split * chunk, k_hi = min(n, k_lo + chunk);
  const int n_t = k_hi > k_lo ? (k_hi - k_lo + KT - 1) / KT : 0;
  const int w = r + rd;
  const T* cb = ckv + b * c_sb;
  const T* kb = kr + b * kr_sb;

  for (int i = threadIdx.x; i < kHeads * kMaxW; i += kThreadsMla) {
    const int g = i / kMaxW, c = i - g * kMaxW;
    float x = 0.f;
    if (g < gn && c < r)
      x = to_f(q_lat[b * ql_sb + (g0 + g) * ql_sh + c]);
    else if (g < gn && c < w)
      x = to_f(q_rope[b * qr_sb + (g0 + g) * qr_sh + (c - r)]);
    qs[i] = x;
  }
  if (threadIdx.x < kHeads) {
    ms[threadIdx.x] = kNegInf;
    ls[threadIdx.x] = 0.f;
  }
  const int cp = threadIdx.x % (kThreadsMla / 2);   // latent columns 2 cp
  const int half = threadIdx.x / (kThreadsMla / 2); // heads half kHalf ..
  bool has_col[kPairs];
#pragma unroll
  for (int c = 0; c < kPairs; ++c) has_col[c] = 2 * cp + 256 * c < r;
  float acc[kHalf][2 * kPairs];
#pragma unroll
  for (int g = 0; g < kHalf; ++g)
#pragma unroll
    for (int e = 0; e < 2 * kPairs; ++e) acc[g][e] = 0.f;
  if (n_t > 0) {
    stage_latent<T, R, kVec>(tiles, cb, c_st, kb, kr_st, k_lo, k_hi, r, rd);
    dec::cp_commit();
  }
  __syncthreads();

  for (int it = 0; it < n_t; ++it) {
    if (it + 1 < n_t) {                   // the next tile into the other
      stage_latent<T, R, kVec>(tiles + ((it + 1) & 1) * KT * RB, cb, c_st,
                               kb, kr_st, k_lo + (it + 1) * KT, k_hi, r, rd);
      dec::cp_commit();
      dec::cp_wait<1>();
    } else {
      dec::cp_wait<0>();
    }
    __syncthreads();
    const char* ts = tiles + (it & 1) * KT * RB;
    const int k0 = k_lo + it * KT;
    const int nk = min(KT, k_hi - k0);

    {  // scores: warp -> heads [kWarpHeads warp, +kWarpHeads), lane -> keys
       // lane + 32 kj
      const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
      const float* qw = qs + warp * kWarpHeads * kMaxW;
      float dot[kWarpHeads][KJ];
#pragma unroll
      for (int g = 0; g < kWarpHeads; ++g)
#pragma unroll
        for (int kj = 0; kj < KJ; ++kj) dot[g][kj] = 0.f;
      for (int c = 0; c < w; c += NV) {
        float x[KJ][NV];
#pragma unroll
        for (int kj = 0; kj < KJ; ++kj)
          dec::load16(reinterpret_cast<const T*>(ts + (lane + 32 * kj) * RB) +
                          c,
                      x[kj]);
#pragma unroll
        for (int g = 0; g < kWarpHeads; ++g)
#pragma unroll
          for (int e = 0; e < NV; e += 4) {
            const float4 qv =
                *reinterpret_cast<const float4*>(qw + g * kMaxW + c + e);
#pragma unroll
            for (int kj = 0; kj < KJ; ++kj) {
              dot[g][kj] = fmaf(qv.x, x[kj][e], dot[g][kj]);
              dot[g][kj] = fmaf(qv.y, x[kj][e + 1], dot[g][kj]);
              dot[g][kj] = fmaf(qv.z, x[kj][e + 2], dot[g][kj]);
              dot[g][kj] = fmaf(qv.w, x[kj][e + 3], dot[g][kj]);
            }
          }
      }
#pragma unroll
      for (int kj = 0; kj < KJ; ++kj) {   // keys past the range: -1e30
        const int j = lane + 32 * kj;
#pragma unroll
        for (int g = 0; g < kWarpHeads; ++g)
          ps[j * kHeads + warp * kWarpHeads + g] =
              j < nk ? dot[g][kj] * scale : kNegInf;
      }
    }
    __syncthreads();

    {  // the online softmax: warp w takes heads w, w + 8, ...
      const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
      for (int g = warp; g < gn; g += kThreadsMla / 32) {
        float x[KJ], mx = kNegInf;
#pragma unroll
        for (int kj = 0; kj < KJ; ++kj) {
          x[kj] = ps[(lane + 32 * kj) * kHeads + g];
          mx = fmaxf(mx, x[kj]);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
        const float m_old = ms[g], m_new = fmaxf(m_old, mx);
        float sum = 0.f;
#pragma unroll
        for (int kj = 0; kj < KJ; ++kj) {
          const float p = expf(x[kj] - m_new);
          ps[(lane + 32 * kj) * kHeads + g] = p;
          sum += p;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sum += __shfl_xor_sync(kFull, sum, off);
        if (lane == 0) {
          const float alpha = expf(m_old - m_new);
          ms[g] = m_new;
          as[g] = alpha;
          ls[g] = ls[g] * alpha + sum;
        }
      }
    }
    __syncthreads();

#pragma unroll
    for (int c = 0; c < kPairs; ++c) {   // P ckv over the tile's keys, in
      if (!has_col[c]) continue;          // key order
#pragma unroll
      for (int g = 0; g < kHalf; ++g) {
        const int gg = half * kHalf + g;
        const float al = gg < gn ? as[gg] : 0.f;
        acc[g][2 * c] *= al;
        acc[g][2 * c + 1] *= al;
      }
      const T* col = reinterpret_cast<const T*>(ts) + 2 * cp + 256 * c;
      for (int j = 0; j < nk; ++j) {
        const float2 x = pair(reinterpret_cast<const T*>(
            reinterpret_cast<const char*>(col) + j * RB));
        const float* pj = ps + j * kHeads + half * kHalf;
#pragma unroll
        for (int g4 = 0; g4 < kHalf; g4 += 4) {
          const float4 p4 = *reinterpret_cast<const float4*>(pj + g4);
          const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[g4 + e][2 * c] = fmaf(pv[e], x.x, acc[g4 + e][2 * c]);
            acc[g4 + e][2 * c + 1] = fmaf(pv[e], x.y, acc[g4 + e][2 * c + 1]);
          }
        }
      }
    }
    __syncthreads();                      // the tile and P are free
  }

  // this split's partial state; an empty split leaves m = -1e30, l = 0
  const long long bh0 = static_cast<long long>(b) * H + g0;
  if (threadIdx.x < gn) {
    float* ml = part_ml + ((bh0 + threadIdx.x) * n_split + split) * 2;
    ml[0] = ms[threadIdx.x];
    ml[1] = ls[threadIdx.x];
  }
#pragma unroll
  for (int c = 0; c < kPairs; ++c) {
    if (!has_col[c]) continue;
#pragma unroll
    for (int g = 0; g < kHalf; ++g) {
      const int gg = half * kHalf + g;
      if (gg >= gn) continue;
      float* dst = part_acc + ((bh0 + gg) * n_split + split) * r + 2 * cp +
                   256 * c;
      dst[0] = acc[g][2 * c];
      dst[1] = acc[g][2 * c + 1];
    }
  }
}

template <typename T, int R>
cudaError_t launch_r(const T* q_lat, const T* q_rope, const T* ckv,
                     const T* kr, int B, int n, int H, int r, int rd,
                     long long ql_sb, long long ql_sh, long long qr_sb,
                     long long qr_sh, long long c_sb, long long c_st,
                     long long kr_sb, long long kr_st, float scale,
                     int n_split, int chunk, float* part_ml, float* part_acc,
                     cudaStream_t stream) {
  // 16-byte copies when every ckv and kr row starts on a 16-byte boundary
  const long long vec = 16 / sizeof(T);
  const bool aligned =
      reinterpret_cast<unsigned long long>(ckv) % 16 == 0 &&
      reinterpret_cast<unsigned long long>(kr) % 16 == 0 && r % vec == 0 &&
      rd % vec == 0 && c_sb % vec == 0 && c_st % vec == 0 &&
      kr_sb % vec == 0 && kr_st % vec == 0;
  using Sh = Shape<T, R>;
  const int smem = Sh::kBytes;
  auto kern = aligned ? flash_mla_kernel<T, R, true>
                      : flash_mla_kernel<T, R, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(B) *
                      ((H + Sh::kHeads - 1) / Sh::kHeads),
                  static_cast<unsigned>(n_split));
  kern<<<grid, kThreadsMla, smem, stream>>>(
      q_lat, q_rope, ckv, kr, part_ml, part_acc, H, n, r, rd, chunk, n_split,
      ql_sb, ql_sh, qr_sb, qr_sh, c_sb, c_st, kr_sb, kr_st, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q_lat_, const void* q_rope_, const void* ckv_,
                   const void* kr_, void* o_, int B, int n, int H, int r,
                   int rd, long long ql_sb, long long ql_sh, long long qr_sb,
                   long long qr_sh, long long c_sb, long long c_st,
                   long long kr_sb, long long kr_st, float scale,
                   int n_split, int chunk, float* part_ml, float* part_acc,
                   cudaStream_t stream) {
  const T* q_lat = static_cast<const T*>(q_lat_);
  const T* q_rope = static_cast<const T*>(q_rope_);
  const T* ckv = static_cast<const T*>(ckv_);
  const T* kr = static_cast<const T*>(kr_);
  T* o = static_cast<T*>(o_);
  const cudaError_t err =
      r <= 256 ? launch_r<T, 256>(q_lat, q_rope, ckv, kr, B, n, H, r, rd,
                                  ql_sb, ql_sh, qr_sb, qr_sh, c_sb, c_st,
                                  kr_sb, kr_st, scale, n_split, chunk,
                                  part_ml, part_acc, stream)
               : launch_r<T, 512>(q_lat, q_rope, ckv, kr, B, n, H, r, rd,
                                  ql_sb, ql_sh, qr_sb, qr_sh, c_sb, c_st,
                                  kr_sb, kr_st, scale, n_split, chunk,
                                  part_ml, part_acc, stream);
  if (err != cudaSuccess) return err;
  // the merge of the split decode, over r columns of each (b, h)
  const Strides so{static_cast<long long>(H) * r, 0, r};
  dec::flash_merge_kernel<T><<<static_cast<unsigned>(B) * H,
                               dec::kThreadsDec, 0, stream>>>(
      part_ml, part_acc, o, H, r, n_split, so, nullptr);
  return cudaGetLastError();
}

}  // namespace mla

// ---------------------------------------------------------------------------
// The latent (MLA) decode on the tensor cores (bfloat16): the heads as the
// M rows of wgmma products

namespace mtc {

constexpr int kKeys = 64;                 // keys of a staged tile
constexpr int kHeads = 64;                // heads of a block: wgmma's M rows
constexpr int kPanel = kKeys * 128;       // a 64-column panel of a tile
constexpr int kMergeThreads = 256;
constexpr int kMaxSplits = 1024;          // the merge's shared weights
constexpr int kBarP = 1, kBarFree = 2;    // named barriers of the hand-over

struct Args {
  const __nv_bfloat16 *q_lat, *q_rope;
  float *part_ml, *part_acc;
  int H, n, r, rd, chunk, n_split;
  long long ql_sb, ql_sh, qr_sb, qr_sh;
  float scale_log2;                       // scale * log2(e)
};

// The widths this kernel takes: r 64, 128, 192, 256 or 512 (ckv as
// 64-column panels in the 128-byte swizzle), rd 32 (a panel in the 64-byte
// swizzle) or 64.
bool widths(int r, int rd) {
  return ((r >= 64 && r <= 256 && r % 64 == 0) || r == 512) &&
         (rd == 32 || rd == 64);
}

// A tile (and the Q block) in shared memory: RP panels of 64 ckv columns,
// 64 rows of 128 bytes each, then one panel of kr's RD columns (rows of 2 RD
// bytes), every panel in the swizzle of its row width.
template <int RP, int RD>
struct Tile {
  static constexpr int kBytes = RP * kPanel + kKeys * 2 * RD;
  static constexpr int kSbo = 8 * 2 * RD;   // 8 rows of the kr panel
  static constexpr int kPad = 1024;         // 1024-byte alignment
};

// How a block splits its work at RP ckv panels. Up to 4 panels one consumer
// warpgroup holds O (64 heads x r float32) in its registers beside a ring
// of 4 tiles that a loader warp fills. At 8 (r 512) O would take 256
// registers a thread: two consumer warpgroups each hold 4 panels (128
// registers a thread); warpgroup 0 computes S and its softmax and hands P
// (bfloat16, as the register-A fragments of its threads: 8 KB) and each
// row's rescale to warpgroup 1 through shared memory; Q, a ring of 2 tiles
// and P take 230,400 bytes with the alignment (DeepSeek's FlashMLA splits
// O so). There the first thread of warpgroup 1, idle while 0 computes S,
// issues the loads: a loader warp would make nine warps, which leave
// ptxas 168 registers a thread, and warpgroup 0 holds O's 128, S's 32 and
// P's 16 (256 threads leave 255).
template <int RP>
struct Split {
  static constexpr int kWG = RP > 4 ? 2 : 1;      // consumer warpgroups
  static constexpr int kPanelsWG = RP / kWG;      // O's panels a warpgroup
  static constexpr int kStages = RP > 4 ? 2 : 4;  // tiles in flight
  static constexpr int kThreads = kWG > 1 ? 256 : 128 + 32;
  static constexpr int kP = kWG > 1 ? 16 * 128 * 4 : 0;   // P handed over
};

// Byte offset of 16-byte chunk c of row g in a swizzled panel of `rowb`
// (128 or 64) bytes a row: the chunk index XOR the row's bits 7.. of its
// address, as the TMA writes and wgmma reads it.
__device__ __forceinline__ int swz(int g, int c, int rowb) {
  return rowb == 128 ? g * 128 + ((c ^ (g & 7)) << 4)
                     : g * 64 + ((c ^ ((g >> 1) & 3)) << 4);
}

// One TMA box (cols, 64 rows, 1 batch) at (c0, c1, c2) of a (cols, n, B)
// tensor map into shared memory; completes on bar.
__device__ __forceinline__ void tma_load3(void* dst, const CUtensorMap* map,
                                          uint64_t* bar, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
         "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

// d (+)= A B: A (64 x 16) and B (16 x 64, K-major) from shared memory by
// descriptor; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The descriptor of k-step kk (16 columns) of a Q block or a tile at addr:
// the first 4 RP steps in the ckv panels, then RD / 16 in the kr panel.
template <int RP, int RD>
__device__ __forceinline__ uint64_t kstep_desc(uint32_t addr, int kk) {
  using T = Tile<RP, RD>;
  if (kk < 4 * RP)
    return tc::sw128_desc(addr + (kk >> 2) * kPanel + (kk & 3) * 32, 16,
                          1024);
  const uint32_t kr = addr + RP * kPanel + (kk - 4 * RP) * 32;
  return RD == 64 ? tc::sw128_desc(kr, 16, T::kSbo)
                  : tc::sw64_desc(kr, 16, T::kSbo);
}

// Named barriers among the consumer warpgroups (id 0 is __syncthreads'):
// an arrival that does not wait, and a wait for `count` threads' arrivals.
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// Block (b, head group, split): heads [g0, g0 + gn) of sequence b over keys
// [split chunk, min(n, (split + 1) chunk)). A loader warp (at two
// warpgroups, warpgroup 1's first thread after its product) brings each
// 64-key tile of ckv | kr by TMA (RP + 1 boxes, zeros past n) into a ring
// of kStages on a full and an empty mbarrier. Consumer warpgroup 0 takes
// the block's heads (up to 64, zero rows past gn) as the M rows of wgmma:
// S = Q [ckv | kr]^T (m64n64k16, Q and the tile K-major from shared
// memory), the online softmax in base 2 on the S fragment (a row's max and
// sum over its quad; keys past the split -inf), P rounded to bfloat16 in
// registers; each consumer warpgroup then computes O += P ckv over its
// kPanelsWG panels (m64n64k16 a ckv panel, A from registers, the panel
// MN-major), its part of O (64 x r) in registers. With two warpgroups, 1
// takes P and the rescale from 0 through shared memory (named barriers:
// kBarP "P written", kBarFree "P read"); splitting O's columns changes no
// rounding. It writes its float32 m (in the base-2 units of the scaled
// logits), l and unnormalised O.
template <int RP, int RD>
__global__ void __launch_bounds__(Split<RP>::kThreads, 1)
flash_mla_tc_kernel(const __grid_constant__ CUtensorMap tckv,
                    const __grid_constant__ CUtensorMap tkr, const Args a) {
  using T = Tile<RP, RD>;
  using W = Split<RP>;
  constexpr int kStages = W::kStages, kPW = W::kPanelsWG;
  extern __shared__ char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  __shared__ float alpha_s[W::kWG > 1 ? 2 * 128 : 1];
  const uint32_t raw = smem_u32(smem_raw);
  char* ring = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  char* qs = ring + kStages * T::kBytes;
  uint32_t* p_s = reinterpret_cast<uint32_t*>(qs + T::kBytes);
  const int n_hg = (a.H + kHeads - 1) / kHeads;
  const int hg = blockIdx.x % n_hg, b = blockIdx.x / n_hg;
  const int g0 = hg * kHeads, gn = min(kHeads, a.H - g0);
  const int split = blockIdx.y;
  const int k_lo = split * a.chunk, k_hi = min(a.n, k_lo + a.chunk);
  const int n_t = k_hi > k_lo ? (k_hi - k_lo + kKeys - 1) / kKeys : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // Q: the block's heads as bfloat16 rows q_lat | q_rope in the tile's
  // swizzled panels, zeros past gn heads
  constexpr int kChunks = 8 * RP + RD / 8;  // 16-byte chunks of a row
  for (int i = threadIdx.x; i < kHeads * kChunks; i += W::kThreads) {
    const int g = i / kChunks, c = i - g * kChunks;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (g < gn)
      x = *reinterpret_cast<const uint4*>(
          c < 8 * RP ? a.q_lat + b * a.ql_sb + (g0 + g) * a.ql_sh + 8 * c
                     : a.q_rope + b * a.qr_sb + (g0 + g) * a.qr_sh +
                           8 * (c - 8 * RP));
    char* dst = c < 8 * RP ? qs + (c >> 3) * kPanel + swz(g, c & 7, 128)
                           : qs + RP * kPanel + swz(g, c - 8 * RP, 2 * RD);
    *reinterpret_cast<uint4*>(dst) = x;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      tc::mbar_init(&full[s], 1);
      tc::mbar_init(&empty[s], W::kWG);   // one arrival a warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Q's stores reach wgmma's reads (the async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // tile it into its stage once the stage is free: RP ckv boxes, one kr box
  const auto load = [&](int it) {
    const int s = it % kStages;
    tc::mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
    char* dst = ring + s * T::kBytes;
    const int k0 = k_lo + it * kKeys;
    tc::mbar_expect_tx(&full[s], T::kBytes);
    for (int p = 0; p < RP; ++p)
      tma_load3(dst + p * kPanel, &tckv, &full[s], 64 * p, k0, b);
    tma_load3(dst + RP * kPanel, &tkr, &full[s], 0, k0, b);
  };
  if constexpr (W::kWG == 1) {
    if (warp == 4) {                      // the loader warp, tile by tile
      if (lane == 0)
        for (int it = 0; it < n_t; ++it) load(it);
      return;
    }
  } else if (threadIdx.x == 128) {        // the ring's first tiles
    for (int it = 0; it < n_t && it < kStages; ++it) load(it);
  }

  // a consumer warpgroup wg: sc[4 i + e] holds head row0 + 8 (e / 2), key
  // 8 i + col + e % 2 of the tile; o[p][4 i + e] head row0 + 8 (e / 2),
  // latent column 64 (kPW wg + p) + 8 i + col + e % 2
  const int wg = W::kWG > 1 ? __shfl_sync(kFull, warp >> 2, 0) : 0;
  const int tw = threadIdx.x & 127;       // the thread in its warpgroup
  const int row0 = (warp & 3) * 16 + (lane >> 2), col = 2 * (lane & 3);
  const uint32_t q_addr = smem_u32(qs), ring_a = smem_u32(ring);
  const float c = a.scale_log2;
  float o[kPW][32], sc[32];
  uint32_t pa[16];
#pragma unroll
  for (int p = 0; p < kPW; ++p) tc::zero(o[p]);
  tc::zero(sc);                           // each S's first step overwrites
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int it = 0; it < n_t; ++it) {
    const int s = it % kStages;
    const uint32_t tile = ring_a + s * T::kBytes;
    tc::mbar_wait(&full[s], (it / kStages) & 1);
    float alpha[2];
    if (wg == 0) {
      if constexpr (W::kWG > 1)           // S's registers not kept across
        tc::fresh(sc);                    // P ckv
      else
        tc::pin(sc);
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * RP + RD / 16; ++kk)
        wgmma_ss_n64(sc, kstep_desc<RP, RD>(q_addr, kk),
                     kstep_desc<RP, RD>(tile, kk), kk > 0);
      tc::wgmma_commit();
      tc::wgmma_wait0();
      tc::pin(sc);
      const int nk = min(kKeys, k_hi - (k_lo + it * kKeys));
      if (nk < kKeys) {                   // keys past the split: -inf
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if (8 * (i >> 2) + col + (i & 1) >= nk) sc[i] = -INFINITY;
      }
      // base 2: alpha = 2^(m - m_new), p = 2^(s c - m_new) by one FMA and
      // ex2
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float mx = -INFINITY;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          mx = fmaxf(mx, fmaxf(sc[4 * i + 2 * rr], sc[4 * i + 2 * rr + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
        const float m_new = fmaxf(m[rr], mx * c);
        alpha[rr] = tc::ex2(m[rr] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = tc::ex2(fmaf(sc[4 * i + 2 * rr + e], c, -m_new));
            sc[4 * i + 2 * rr + e] = p;
            sum += p;
          }
        sum += __shfl_xor_sync(kFull, sum, 1);
        sum += __shfl_xor_sync(kFull, sum, 2);
        l[rr] = l[rr] * alpha[rr] + sum;
        m[rr] = m_new;
      }
      // P in bfloat16 as wgmma's register A: k-step j (keys 16 j ..) takes
      // the accumulator's column blocks 2 j and 2 j + 1
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pa[4 * j + 0] = tc::pack_bf16(sc[8 * j + 0], sc[8 * j + 1]);
        pa[4 * j + 1] = tc::pack_bf16(sc[8 * j + 2], sc[8 * j + 3]);
        pa[4 * j + 2] = tc::pack_bf16(sc[8 * j + 4], sc[8 * j + 5]);
        pa[4 * j + 3] = tc::pack_bf16(sc[8 * j + 6], sc[8 * j + 7]);
      }
      if (W::kWG > 1) {                   // hand P and alpha to warpgroup 1
        if (it > 0) named_sync(kBarFree, 256);   // it has read the last
#pragma unroll
        for (int j = 0; j < 16; ++j) p_s[j * 128 + tw] = pa[j];
        alpha_s[2 * tw] = alpha[0];
        alpha_s[2 * tw + 1] = alpha[1];
        __threadfence_block();
        named_arrive(kBarP, 256);
      }
    } else {                              // take them from warpgroup 0
      named_sync(kBarP, 256);
#pragma unroll
      for (int j = 0; j < 16; ++j) pa[j] = p_s[j * 128 + tw];
      alpha[0] = alpha_s[2 * tw];
      alpha[1] = alpha_s[2 * tw + 1];
      if (it + 1 < n_t) named_arrive(kBarFree, 256);
    }
    if (__any_sync(kFull, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int p = 0; p < kPW; ++p)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          o[p][4 * i] *= alpha[0];
          o[p][4 * i + 1] *= alpha[0];
          o[p][4 * i + 2] *= alpha[1];
          o[p][4 * i + 3] *= alpha[1];
        }
    }
#pragma unroll
    for (int p = 0; p < kPW; ++p) tc::pin(o[p]);
    tc::pin(pa);
    tc::wgmma_fence();
    // O += P ckv over this warpgroup's panels: each 64-column panel
    // MN-major (latent columns contiguous), 16 keys a k-step of 2048 bytes
#pragma unroll
    for (int p = 0; p < kPW; ++p)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        tc::wgmma_rs_n64(o[p], pa + 4 * j,
                         tc::sw128_desc(tile + (kPW * wg + p) * kPanel +
                                            j * 16 * 128,
                                        kPanel, 1024));
    tc::wgmma_commit();
    tc::wgmma_wait0();
#pragma unroll
    for (int p = 0; p < kPW; ++p) tc::pin(o[p]);
    tc::pin(pa);
    if (tw == 0) tc::mbar_arrive(&empty[s]);
    if constexpr (W::kWG > 1) {
      if (wg == 1) {                      // the next tile into this stage
        if (tw == 0 && it + kStages < n_t) load(it + kStages);
        __syncwarp();
      }
    }
  }

  // this split's partial state; an empty split leaves m = -1e30, l = 0
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int hh = row0 + 8 * rr;
    if (hh >= gn) continue;
    const long long row =
        (static_cast<long long>(b) * a.H + g0 + hh) * a.n_split + split;
    if (wg == 0 && (lane & 3) == 0) {
      a.part_ml[2 * row] = m[rr];
      a.part_ml[2 * row + 1] = l[rr];
    }
    float* dst = a.part_acc + row * a.r + 64 * kPW * wg;
#pragma unroll
    for (int p = 0; p < kPW; ++p)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<float2*>(dst + 64 * p + 8 * i + col) =
            make_float2(o[p][4 * i + 2 * rr], o[p][4 * i + 2 * rr + 1]);
  }
}

// o[b, 0, h] = sum_s acc_s 2^(m_s - M) / max(sum_s l_s 2^(m_s - M), 1e-30),
// M = max_s m_s, the splits folded in order (two calls give the same bits);
// m in the base-2 units of the scaled logits.
__global__ void __launch_bounds__(kMergeThreads)
flash_mla_merge_kernel(const float* __restrict__ part_ml,
                       const float* __restrict__ part_acc,
                       __nv_bfloat16* __restrict__ o, int r, int n_split) {
  __shared__ float ms[kMaxSplits], ls[kMaxSplits];
  const long long bh = blockIdx.x;
  const float* ml = part_ml + bh * n_split * 2;
  const float* acc = part_acc + bh * n_split * r;
  for (int s = threadIdx.x; s < n_split; s += blockDim.x) {
    ms[s] = ml[2 * s];
    ls[s] = ml[2 * s + 1];
  }
  __syncthreads();
  float mm = kNegInf;
  for (int s = 0; s < n_split; ++s) mm = fmaxf(mm, ms[s]);
  __syncthreads();
  for (int s = threadIdx.x; s < n_split; s += blockDim.x)
    ms[s] = tc::ex2(ms[s] - mm);           // the split's weight
  __syncthreads();
  float ll = 0.f;
  for (int s = 0; s < n_split; ++s) ll = fmaf(ls[s], ms[s], ll);
  const float den = fmaxf(ll, 1e-30f);
  for (int d = threadIdx.x; d < r; d += blockDim.x) {
    float x = 0.f;
#pragma unroll 8
    for (int s = 0; s < n_split; ++s)
      x = fmaf(acc[static_cast<long long>(s) * r + d], ms[s], x);
    o[bh * r + d] = __float2bfloat16(x / den);
  }
}

// A (cols, n, B) tensor map of a strided bf16 (B, n, cols) view (element
// strides st_n, st_b), box (box_cols, 64, 1) in the swizzle of its row
// width (128 or 64 bytes), zeros out of bounds.
bool make_map3(CUtensorMap* map, const void* base, int cols, int box_cols,
               int n, int B, long long st_n, long long st_b) {
  const tc::EncodeTiled enc = tc::encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(st_n) * 2,
                                 static_cast<cuuint64_t>(st_b) * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols), kKeys, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<void*>(base), dims, strides, box, step,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                            : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int RP, int RD>
constexpr int smem_bytes() {
  return (Split<RP>::kStages + 1) * Tile<RP, RD>::kBytes + Split<RP>::kP +
         Tile<RP, RD>::kPad;
}

// Runs f.template run<RP, RD>() for the widths (r, rd); widths() first.
template <typename F>
cudaError_t with_widths(int r, int rd, const F& f) {
  if (rd == 64) {
    switch (r / 64) {
      case 1: return f.template run<1, 64>();
      case 2: return f.template run<2, 64>();
      case 3: return f.template run<3, 64>();
      case 4: return f.template run<4, 64>();
      default: return f.template run<8, 64>();
    }
  }
  switch (r / 64) {
    case 1: return f.template run<1, 32>();
    case 2: return f.template run<2, 32>();
    case 3: return f.template run<3, 32>();
    case 4: return f.template run<4, 32>();
    default: return f.template run<8, 32>();
  }
}

struct Launch {
  const CUtensorMap &mc, &mk;
  const Args& a;
  int B;
  __nv_bfloat16* o;
  cudaStream_t stream;
  template <int RP, int RD>
  cudaError_t run() const {
    const int smem = smem_bytes<RP, RD>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_mla_tc_kernel<RP, RD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(static_cast<unsigned>(B) * ((a.H + kHeads - 1) / kHeads),
                    static_cast<unsigned>(a.n_split));
    flash_mla_tc_kernel<RP, RD><<<grid, Split<RP>::kThreads, smem,
                                  stream>>>(mc, mk, a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    flash_mla_merge_kernel<<<static_cast<unsigned>(B) * a.H,
                             a.r < kMergeThreads ? a.r : kMergeThreads, 0,
                             stream>>>(
        a.part_ml, a.part_acc, o, a.r, a.n_split);
    return cudaGetLastError();
  }
};

struct Info {
  int* out;
  template <int RP, int RD>
  cudaError_t run() const {
    return tc::kernel_info(flash_mla_tc_kernel<RP, RD>, Split<RP>::kThreads,
                           smem_bytes<RP, RD>(), out);
  }
};

cudaError_t launch(const Args& a, const void* ckv, const void* kr,
                   long long c_sb, long long c_st, long long kr_sb,
                   long long kr_st, int B, __nv_bfloat16* o,
                   cudaStream_t stream) {
  CUtensorMap mc, mk;
  if (!widths(a.r, a.rd) ||
      !make_map3(&mc, ckv, a.r, 64, a.n, B, c_st, c_sb) ||
      !make_map3(&mk, kr, a.rd, a.rd, a.n, B, kr_st, kr_sb))
    return cudaErrorInvalidValue;
  return with_widths(a.r, a.rd, Launch{mc, mk, a, B, o, stream});
}

cudaError_t info(int r, int rd, int* out) {
  if (!widths(r, rd)) return cudaErrorInvalidValue;
  return with_widths(r, rd, Info{out});
}

}  // namespace mtc

template <typename T>
int launch_simt(const void* q_, const void* k_, const void* v_, void* o_,
                int B, int Tq, int S, int H, int Hkv, int D, int Dv,
                Strides sq, Strides sk, Strides sv, Strides so, int causal,
                int window, float scale, void* stream_) {
  const T* q = static_cast<const T*>(q_);
  const T* k = static_cast<const T*>(k_);
  const T* v = static_cast<const T*>(v_);
  T* o = static_cast<T*>(o_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int G = H / Hkv;
  cudaError_t err;
  if (D <= 16)
    err = launch_tile<T, 1>(q, k, v, o, B, Tq, S, H, G, D, Dv, sq, sk, sv,
                            so, causal, window, scale, stream);
  else if (D <= 32)
    err = launch_tile<T, 2>(q, k, v, o, B, Tq, S, H, G, D, Dv, sq, sk, sv,
                            so, causal, window, scale, stream);
  else if (D <= 64)
    err = launch_tile<T, 4>(q, k, v, o, B, Tq, S, H, G, D, Dv, sq, sk, sv,
                            so, causal, window, scale, stream);
  else if (D <= 128)
    err = launch_tile<T, 8>(q, k, v, o, B, Tq, S, H, G, D, Dv, sq, sk, sv,
                            so, causal, window, scale, stream);
  else
    err = launch_tile<T, 16>(q, k, v, o, B, Tq, S, H, G, D, Dv, sq, sk, sv,
                             so, causal, window, scale, stream);
  return static_cast<int>(err);
}

bool bad_shape(int B, int Tq, int S, int H, int Hkv, int D, int Dv,
               int causal, int window) {
  return B < 1 || Tq < 1 || S < 1 || H < 1 || Hkv < 1 || H % Hkv || D < 1 ||
         D > 256 || Dv < 1 || Dv > D || window < 0 ||
         (window > 0 && (!causal || Tq != S));
}

}  // namespace

extern "C" {

// Strides are in elements, for the (B, T, H, D) view q, the (B, T, H, Dv)
// view o, the (B, S, Hkv, D) view k and the (B, S, Hkv, Dv) view v, Dv <= D;
// the last dimension is contiguous in all four.

// The CUDA-core tile kernel, any T (the wrapper sends it T > 1).
int soar_flash_tile(const void* q, const void* k, const void* v, void* o,
                    int bf16, int B, int Tq, int S, int H, int Hkv, int D,
                    int Dv, long long q_sb, long long q_st, long long q_sh,
                    long long k_sb, long long k_st, long long k_sh,
                    long long v_sb, long long v_st, long long v_sh,
                    long long o_sb, long long o_st, long long o_sh,
                    int causal, int window, float scale, void* stream) {
  if (bad_shape(B, Tq, S, H, Hkv, D, Dv, causal, window))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides sq{q_sb, q_st, q_sh}, sk{k_sb, k_st, k_sh},
      sv{v_sb, v_st, v_sh}, so{o_sb, o_st, o_sh};
  if (bf16)
    return launch_simt<__nv_bfloat16>(q, k, v, o, B, Tq, S, H, Hkv, D, Dv,
                                      sq, sk, sv, so, causal, window, scale,
                                      stream);
  return launch_simt<float>(q, k, v, o, B, Tq, S, H, Hkv, D, Dv, sq, sk, sv,
                            so, causal, window, scale, stream);
}

// The tensor-core tile kernel: bfloat16, (D, Dv) (64, 64), (128, 128), (96,
// 64), (112, 112) or (192, 128), q, k and v based and strided on 16-byte
// multiples.
int soar_flash_tile_tc(const void* q, const void* k, const void* v, void* o,
                       int B, int Tq, int S, int H, int Hkv, int D, int Dv,
                       long long q_sb, long long q_st, long long q_sh,
                       long long k_sb, long long k_st, long long k_sh,
                       long long v_sb, long long v_st, long long v_sh,
                       long long o_sb, long long o_st, long long o_sh,
                       int causal, int window, float scale, void* stream) {
  if (bad_shape(B, Tq, S, H, Hkv, D, Dv, causal, window) ||
      !tc::tc_dims(D, Dv))
    return static_cast<int>(cudaErrorInvalidValue);
  const tc::Args a{static_cast<__nv_bfloat16*>(o), B, Tq, S, H, H / Hkv,
                   causal, window, scale * 1.4426950408889634f,
                   {q_sb, q_st, q_sh}, {k_sb, k_st, k_sh},
                   {v_sb, v_st, v_sh}, {o_sb, o_st, o_sh}};
  return static_cast<int>(tc::launch(q, k, v, a, D, Dv, Hkv,
                                     static_cast<cudaStream_t>(stream)));
}

// The split decode: one query row (T = 1) over keys [0, n); n_split splits
// of `chunk` keys (a multiple of 64); part_ml (B H n_split 2) and part_acc
// (B H n_split Dv) float32 scratch; lse (B H) float32, or null for no
// log-sum-exp output.
int soar_flash_decode(const void* q, const void* k, const void* v, void* o,
                      int bf16, int B, int n, int H, int Hkv, int D, int Dv,
                      long long q_sb, long long q_sh, long long k_sb,
                      long long k_st, long long k_sh, long long v_sb,
                      long long v_st, long long v_sh, long long o_sb,
                      long long o_sh, float scale, int n_split, int chunk,
                      void* part_ml, void* part_acc, void* lse,
                      void* stream) {
  if (bad_shape(B, 1, n, H, Hkv, D, Dv, 0, 0) || n_split < 1 ||
      n_split > 65535 || chunk < 1 || chunk % 64 ||
      static_cast<long long>(n_split) * chunk < n)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides sq{q_sb, 0, q_sh}, sk{k_sb, k_st, k_sh},
      sv{v_sb, v_st, v_sh}, so{o_sb, 0, o_sh};
  float* ml = static_cast<float*>(part_ml);
  float* acc = static_cast<float*>(part_acc);
  float* ls = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return static_cast<int>(dec::launch<__nv_bfloat16>(
        q, k, v, o, B, n, H, Hkv, D, Dv, sq, sk, sv, so, scale, n_split,
        chunk, ml, acc, ls, st));
  return static_cast<int>(dec::launch<float>(q, k, v, o, B, n, H, Hkv, D, Dv,
                                             sq, sk, sv, so, scale, n_split,
                                             chunk, ml, acc, ls, st));
}

// The latent (MLA) decode on the CUDA cores: q_lat (B, 1, H, r) and q_rope
// (B, 1, H, rd) over ckv (B, n, r) and kr (B, n, rd) -> o (B, 1, H, r),
// contiguous; r <= 512 and rd <= 64, multiples of 8; n_split splits of
// `chunk` keys (a multiple of 64); part_ml (B H n_split 2) and part_acc (B H
// n_split r) float32 scratch.
int soar_flash_mla_decode(const void* q_lat, const void* q_rope,
                          const void* ckv, const void* kr, void* o, int bf16,
                          int B, int n, int H, int r, int rd,
                          long long ql_sb, long long ql_sh, long long qr_sb,
                          long long qr_sh, long long c_sb, long long c_st,
                          long long kr_sb, long long kr_st, float scale,
                          int n_split, int chunk, void* part_ml,
                          void* part_acc, void* stream) {
  if (B < 1 || n < 1 || H < 1 || r < 8 || r > 512 || r % 8 ||
      rd < 8 || rd > mla::kMaxRd || rd % 8 || n_split < 1 ||
      n_split > 65535 || chunk < 1 || chunk % 64 ||
      static_cast<long long>(n_split) * chunk < n)
    return static_cast<int>(cudaErrorInvalidValue);
  float* ml = static_cast<float*>(part_ml);
  float* acc = static_cast<float*>(part_acc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return static_cast<int>(mla::launch<__nv_bfloat16>(
        q_lat, q_rope, ckv, kr, o, B, n, H, r, rd, ql_sb, ql_sh, qr_sb,
        qr_sh, c_sb, c_st, kr_sb, kr_st, scale, n_split, chunk, ml, acc, st));
  return static_cast<int>(mla::launch<float>(
      q_lat, q_rope, ckv, kr, o, B, n, H, r, rd, ql_sb, ql_sh, qr_sb, qr_sh,
      c_sb, c_st, kr_sb, kr_st, scale, n_split, chunk, ml, acc, st));
}

// The latent decode on the tensor cores, bfloat16: the arguments of
// soar_flash_mla_decode but the dtype, r 64, 128, 192, 256 or 512 and rd
// 32 or 64, every input based and strided on 16-byte multiples, n_split <=
// 1024; m in part_ml is in base-2 units.
int soar_flash_mla_decode_tc(const void* q_lat, const void* q_rope,
                             const void* ckv, const void* kr, void* o, int B,
                             int n, int H, int r, int rd, long long ql_sb,
                             long long ql_sh, long long qr_sb,
                             long long qr_sh, long long c_sb, long long c_st,
                             long long kr_sb, long long kr_st, float scale,
                             int n_split, int chunk, void* part_ml,
                             void* part_acc, void* stream) {
  const auto off16 = [](const void* p) {
    return reinterpret_cast<unsigned long long>(p) % 16 != 0;
  };
  if (B < 1 || n < 1 || H < 1 || !mtc::widths(r, rd) || n_split < 1 ||
      n_split > mtc::kMaxSplits || chunk < 1 || chunk % 64 ||
      static_cast<long long>(n_split) * chunk < n || off16(q_lat) ||
      off16(q_rope) || off16(ckv) || off16(kr) || ql_sb % 8 || ql_sh % 8 ||
      qr_sb % 8 || qr_sh % 8 || c_sb % 8 || c_st % 8 || kr_sb % 8 ||
      kr_st % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  mtc::Args a{};
  a.q_lat = static_cast<const __nv_bfloat16*>(q_lat);
  a.q_rope = static_cast<const __nv_bfloat16*>(q_rope);
  a.part_ml = static_cast<float*>(part_ml);
  a.part_acc = static_cast<float*>(part_acc);
  a.H = H;
  a.n = n;
  a.r = r;
  a.rd = rd;
  a.chunk = chunk;
  a.n_split = n_split;
  a.ql_sb = ql_sb;
  a.ql_sh = ql_sh;
  a.qr_sb = qr_sb;
  a.qr_sh = qr_sh;
  a.scale_log2 = scale * 1.4426950408889634f;
  return static_cast<int>(mtc::launch(a, ckv, kr, c_sb, c_st, kr_sb, kr_st,
                                      B, static_cast<__nv_bfloat16*>(o),
                                      static_cast<cudaStream_t>(stream)));
}

// What the compiler and the occupancy calculator give a kernel: out[0..3]
// = registers a thread, local (spill) bytes a thread, blocks an SM, shared
// memory a block. kernel 0: the tensor-core tile at (D, Dv) = (x, y); 1:
// the latent decode on the tensor cores at (r, rd) = (x, y).
int soar_flash_kernel_info(int kernel, int x, int y, void* out) {
  int* o = static_cast<int*>(out);
  if (kernel == 0) return static_cast<int>(tc::info(x, y, o));
  if (kernel == 1) return static_cast<int>(mtc::info(x, y, o));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
