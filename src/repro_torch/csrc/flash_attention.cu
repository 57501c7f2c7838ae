// Flash (online-softmax) attention for Hopper (sm_90a): the serving path's
// attention, prefill and decode.
//
//   q (B, T, H, D), k and v (B, S, Hkv, D), float32 or bfloat16, each a
//   strided view whose last dimension is contiguous -> o (B, T, H, D) in
//   q's dtype. Query head h reads KV head h / (H / Hkv), so grouped K/V are
//   never repeated; the (BH, T, D) layout is H = Hkv = 1. For every (b, h,
//   query row): logits (q . k) * scale in float32, masked to key < S and,
//   when causal, key <= row (positions aligned at 0, as the JAX oracle
//   aligns them) and, with a sliding window w > 0 (causal, T == S only),
//   key > row - w, the band of models/attention.py::causal_mask(T, S, w);
//   the running max m and normaliser l in float32 from
//   NEG_INF = -1e30; acc += p v with p kept in float32; o = acc / max(l,
//   1e-30) in q's dtype.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention/
// flash_attention.py :: flash_attention_pallas (body _flash_kernel; the
// pallas_call at :69). It computes what that body computes, not its
// (128 x 128 block, VMEM-resident K/V panel) schedule; ragged query and key
// tiles are masked here, so the wrapper pads nothing and never falls back.
//
// Two launch shapes, both counted as one launch by the wrapper:
//  * tile kernel (T > 1, prefill): one block of 256 threads per (b, h,
//    64-row query tile), the longest causal tiles first. The Q tile and
//    one 64-key K tile, then the V tile in the same buffer, sit in shared
//    memory as float32 rows padded to an odd stride (conflict-free column
//    reads). Thread (ty, tx) of the 16 x 16 grid holds rows ty + 16 i and
//    key columns tx + 16 j of the 64 x 64 score tile, and rows ty + 16 i,
//    head dims tx + 16 jj of the accumulator; row max and row sum are
//    butterflies over the 16 lanes of a row group, so every lane holds the
//    same m and l. With causal, the key loop ends at the tile holding the
//    query tile's last row: later keys have p = exp(-1e30 - m) = 0 exactly.
//    With a window w, it starts at the tile holding q0 - w + 1, the first
//    key of the tile's first row, so a query tile reads about w / 64 + 1
//    key tiles. In that first key tile a row whose band starts later sees
//    only masked keys: its m stays -1e30 and each masked key gets p =
//    exp(0) = 1, until a later tile's first unmasked key gives alpha =
//    exp(-1e30 - m) = 0 and wipes l and acc. That is exact only because
//    every row's own key (key = row) lies in the same or a later tile and
//    is never masked.
//  * decode kernel (T = 1): one block of four warps per (b, h). Warp w
//    takes key tiles w, w + 4, ... of 32 keys; lane j scores key j of the
//    tile (16-byte loads when the rows are aligned), the warp updates its
//    m, l and its accumulator (lane owns head dims lane + 32 e), and the
//    four partial states are merged in shared memory at the end. A decode
//    passes the cache prefix k_all[:, :n] as a view, with no copy.
// Products are float32 on the CUDA cores with explicit fmaf (the build has
// -fmad=false), exponentials by expf.
//
// Bound on the H100: prefill is bound by operations. At the qwen3-32b
// serving cell (B 4, T = S = 2048, 64 heads over 8 KV heads, D 128) the two
// causal products are 275 GFLOP per layer: 0.28 ms at the bf16 tensor-core
// rate (989 TFLOP/s), 4.1 ms at the float32 CUDA-core rate (67 TFLOP/s)
// that this design is limited to. Decode is bound by bytes: the KV prefix,
// 34.6 MB per layer at 2112 positions, 10 us at 3.35 TB/s. What the simple
// design gives up: tensor cores (wgmma or mma.sync on bf16 operands), TMA
// copies in a ring of tiles, skipping work inside the diagonal tile, and
// splitting long decode rows over more blocks (split-K); later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kTile = 64;                 // query rows and keys of a tile
constexpr int kThreads = 256;             // the tile kernel's 16 x 16 grid
constexpr int kPs = kTile + 1;            // row stride of the P tile
constexpr int kDecodeWarps = 4;
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
                  int S, int H, int G, int D, Strides sq, Strides sk,
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
    load_tile<T, W>(kv, vb, sv.t, k0, S, D, ld);
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
      if (d < D) orow[d] = from_f<T>(acc[i][jj] / den);
    }
  }
}

// q . k over D, q in shared memory as float32, k a row in device memory.
template <typename T, bool kVec>
struct RowDot;

template <typename T>
struct RowDot<T, false> {
  static __device__ __forceinline__ float run(const float* qs, const T* kr,
                                              int D) {
    float dot = 0.f;
    for (int d = 0; d < D; ++d) dot = fmaf(qs[d], to_f(kr[d]), dot);
    return dot;
  }
};

template <>
struct RowDot<float, true> {              // 16-byte aligned rows, D % 4 == 0
  static __device__ __forceinline__ float run(const float* qs,
                                              const float* kr, int D) {
    float dot = 0.f;
    for (int d = 0; d < D; d += 4) {
      const float4 x = *reinterpret_cast<const float4*>(kr + d);
      dot = fmaf(qs[d], x.x, dot);
      dot = fmaf(qs[d + 1], x.y, dot);
      dot = fmaf(qs[d + 2], x.z, dot);
      dot = fmaf(qs[d + 3], x.w, dot);
    }
    return dot;
  }
};

template <>
struct RowDot<__nv_bfloat16, true> {      // 16-byte aligned rows, D % 8 == 0
  static __device__ __forceinline__ float run(const float* qs,
                                              const __nv_bfloat16* kr,
                                              int D) {
    float dot = 0.f;
    for (int d = 0; d < D; d += 8) {
      const uint4 u = *reinterpret_cast<const uint4*>(kr + d);
      const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {       // a bfloat16 is the high half of
        dot = fmaf(qs[d + 2 * e], __uint_as_float(w[e] << 16), dot);
        dot = fmaf(qs[d + 2 * e + 1], __uint_as_float(w[e] & 0xffff0000u),
                   dot);                  // a float32; element 2e is low
      }
    }
    return dot;
  }
};

// DE = head dims per lane: D <= 32 * DE.
template <typename T, int DE, bool kVec>
__global__ void __launch_bounds__(kDecodeWarps * 32)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o, int H, int S,
                    int G, int D, Strides sq, Strides sk, Strides sv,
                    Strides so, float scale) {
  __shared__ float qs[32 * DE];
  __shared__ float part_m[kDecodeWarps], part_l[kDecodeWarps];
  __shared__ float part_acc[kDecodeWarps][32 * DE];
  const int bh = blockIdx.x, b = bh / H, h = bh - (bh / H) * H, hk = h / G;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* qrow = q + b * sq.b + h * sq.h;
  for (int d = threadIdx.x; d < 32 * DE; d += blockDim.x)
    qs[d] = d < D ? to_f(qrow[d]) : 0.f;
  __syncthreads();
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;

  float m = kNegInf, l = 0.f, acc[DE];
#pragma unroll
  for (int e = 0; e < DE; ++e) acc[e] = 0.f;
  for (int k0 = warp * 32; k0 < S; k0 += kDecodeWarps * 32) {
    const int key = k0 + lane;
    float x = kNegInf;
    if (key < S) x = RowDot<T, kVec>::run(qs, kb + key * sk.t, D) * scale;
    float mx = x;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    const float p = expf(x - m_new);      // 0 for a key past S
    float sum = p;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(kFull, sum, off);
    l = l * alpha + sum;
#pragma unroll
    for (int e = 0; e < DE; ++e) acc[e] *= alpha;
    const int n = min(32, S - k0);
    for (int j = 0; j < n; ++j) {
      const float pj = __shfl_sync(kFull, p, j);
      const T* vr = vb + (k0 + j) * sv.t;
#pragma unroll
      for (int e = 0; e < DE; ++e) {
        const int d = lane + 32 * e;
        if (d < D) acc[e] = fmaf(pj, to_f(vr[d]), acc[e]);
      }
    }
    m = m_new;
  }

  // merge the warps' states: a warp that saw no key has m = -1e30, l = 0
  if (lane == 0) {
    part_m[warp] = m;
    part_l[warp] = l;
  }
#pragma unroll
  for (int e = 0; e < DE; ++e) part_acc[warp][lane + 32 * e] = acc[e];
  __syncthreads();
  float mm = kNegInf;
#pragma unroll
  for (int w = 0; w < kDecodeWarps; ++w) mm = fmaxf(mm, part_m[w]);
  float ll = 0.f, f[kDecodeWarps];
#pragma unroll
  for (int w = 0; w < kDecodeWarps; ++w) {
    f[w] = expf(part_m[w] - mm);
    ll = fmaf(part_l[w], f[w], ll);
  }
  const float den = fmaxf(ll, 1e-30f);
  T* orow = o + b * so.b + h * so.h;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) a = fmaf(part_acc[w][d], f[w], a);
    orow[d] = from_f<T>(a / den);
  }
}

template <typename T, int DJ>
cudaError_t launch_tile(const T* q, const T* k, const T* v, T* o, int B,
                        int Tq, int S, int H, int G, int D, Strides sq,
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
                             stream>>>(q, k, v, o, B, Tq, S, H, G, D, sq, sk,
                                       sv, so, causal, window, scale);
  return cudaGetLastError();
}

template <typename T, int DE>
cudaError_t launch_decode(const T* q, const T* k, const T* v, T* o, int B,
                          int S, int H, int G, int D, Strides sq, Strides sk,
                          Strides sv, Strides so, float scale,
                          cudaStream_t stream) {
  // 16-byte loads of K rows when every row starts on a 16-byte boundary
  const long long vec = 16 / sizeof(T);
  const bool aligned = reinterpret_cast<unsigned long long>(k) % 16 == 0 &&
                       D % vec == 0 && sk.b % vec == 0 && sk.t % vec == 0 &&
                       sk.h % vec == 0;
  const unsigned blocks = static_cast<unsigned>(B) * H;
  if (aligned)
    flash_decode_kernel<T, DE, true><<<blocks, kDecodeWarps * 32, 0, stream>>>(
        q, k, v, o, H, S, G, D, sq, sk, sv, so, scale);
  else
    flash_decode_kernel<T, DE, false><<<blocks, kDecodeWarps * 32, 0,
                                        stream>>>(q, k, v, o, H, S, G, D, sq,
                                                  sk, sv, so, scale);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* q_, const void* k_, const void* v_, void* o_, int B,
           int Tq, int S, int H, int Hkv, int D, Strides sq, Strides sk,
           Strides sv, Strides so, int causal, int window, float scale,
           void* stream_) {
  const T* q = static_cast<const T*>(q_);
  const T* k = static_cast<const T*>(k_);
  const T* v = static_cast<const T*>(v_);
  T* o = static_cast<T*>(o_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int G = H / Hkv;
  if (B < 1 || Tq < 1 || S < 1 || H < 1 || Hkv < 1 || H % Hkv || D < 1 ||
      D > 256 || window < 0 || (window > 0 && (!causal || Tq != S)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (Tq == 1) {                          // a window holds key 0 here
    const int s_eff = causal ? 1 : S;     // the one query sits at position 0
    if (D <= 32)
      err = launch_decode<T, 1>(q, k, v, o, B, s_eff, H, G, D, sq, sk, sv, so,
                                scale, stream);
    else if (D <= 64)
      err = launch_decode<T, 2>(q, k, v, o, B, s_eff, H, G, D, sq, sk, sv, so,
                                scale, stream);
    else if (D <= 128)
      err = launch_decode<T, 4>(q, k, v, o, B, s_eff, H, G, D, sq, sk, sv, so,
                                scale, stream);
    else
      err = launch_decode<T, 8>(q, k, v, o, B, s_eff, H, G, D, sq, sk, sv, so,
                                scale, stream);
  } else if (D <= 16) {
    err = launch_tile<T, 1>(q, k, v, o, B, Tq, S, H, G, D, sq, sk, sv, so,
                            causal, window, scale, stream);
  } else if (D <= 32) {
    err = launch_tile<T, 2>(q, k, v, o, B, Tq, S, H, G, D, sq, sk, sv, so,
                            causal, window, scale, stream);
  } else if (D <= 64) {
    err = launch_tile<T, 4>(q, k, v, o, B, Tq, S, H, G, D, sq, sk, sv, so,
                            causal, window, scale, stream);
  } else if (D <= 128) {
    err = launch_tile<T, 8>(q, k, v, o, B, Tq, S, H, G, D, sq, sk, sv, so,
                            causal, window, scale, stream);
  } else {
    err = launch_tile<T, 16>(q, k, v, o, B, Tq, S, H, G, D, sq, sk, sv, so,
                             causal, window, scale, stream);
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// Strides are in elements, for the (B, T, H, D) views q, o and the
// (B, S, Hkv, D) views k, v; D is contiguous in all four.
int soar_flash_attention(const void* q, const void* k, const void* v, void* o,
                         int bf16, int B, int Tq, int S, int H, int Hkv,
                         int D, long long q_sb, long long q_st,
                         long long q_sh, long long k_sb, long long k_st,
                         long long k_sh, long long v_sb, long long v_st,
                         long long v_sh, long long o_sb, long long o_st,
                         long long o_sh, int causal, int window,
                         float scale, void* stream) {
  const Strides sq{q_sb, q_st, q_sh}, sk{k_sb, k_st, k_sh},
      sv{v_sb, v_st, v_sh}, so{o_sb, o_st, o_sh};
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, o, B, Tq, S, H, Hkv, D, sq, sk, sv,
                                 so, causal, window, scale, stream);
  return launch<float>(q, k, v, o, B, Tq, S, H, Hkv, D, sq, sk, sv, so,
                       causal, window, scale, stream);
}

}  // extern "C"
