// Selective-SSM scan for Hopper (sm_90a): the recurrence of the Mamba heads
// of the hybrid family, in prefill (T = the prompt) and decode (T = 1).
//
//   s_t = s_{t-1} * exp(delta_t * A) + (delta_t * u_t) x B_t
//   y_t = <s_t, C_t>_N
//
//   u (B, T, D), delta (B, T, 1), bv and cv (B, T, N): strided views whose
//   last dimension is contiguous; a (D, N), s0 (B, D, N): contiguous; all
//   float32 -> y (B, T, D) contiguous and the final state s_out (B, D, N),
//   which may be s0 itself (each thread reads its state before it writes
//   it). The state is float32 throughout, as the JAX model keeps it.
//
// Replaces the Pallas kernel src/repro/kernels/ssm_scan/ssm_scan.py ::
// ssm_chunk_scan_pallas (body _ssm_scan_kernel; the pallas_call at :78). It
// computes what that body computes, not its schedule: on the TPU the grid's
// chunk axis runs in order on one core and a VMEM scratch carries the state
// from one chunk to the next; on Hopper blocks run in parallel and in no
// order, so nothing is carried between blocks. Channels are independent (A
// is per (d, n)), so each thread owns one (b, d, n) for the whole sequence
// and carries its state in a register: the chunk axis becomes the loop over
// t inside the thread, and T needs no chunk multiple.
//
// Design: a block of 256 threads holds 256 / NP channels of one batch row,
// NP = N rounded up to a power of two (at least 4): lane n of a channel's
// NP-lane group owns state n, lanes n >= N hold 0. The block stages delta,
// B and C (shared by all its channels) and u for a run of kRun timesteps in
// shared memory, then each thread steps through the run, the products
// unfused as the jnp oracle spells them (the build has -fmad=false) and
// the exponential by expf; y_t is a fixed-order __shfl_xor_sync butterfly
// over the NP lanes, written to shared memory and stored for the whole run
// at once (rows of 256 / NP consecutive floats). Grid: (ceil(D / (256 /
// NP)), B); at the hymba-1.5b serving cell (B 4, D 3200, N 16) 800 blocks,
// 204,800 threads.
//
// Bound on the H100 at that cell (T 32,768), per layer: bytes, u read and y
// written once, 3.36 GB: 1.0 ms at 3.35 TB/s; 6.71 G exponentials on the
// special function units (16 per SM per clock, 132 SMs): 1.6 ms at 1.98
// GHz; 6 float32 operations per (b, t, d, n) and one per (b, t, d), 40.7
// GFLOP: 0.6 ms at 67 TFLOP/s. The exponentials bound it. What the simple
// design gives up: the accurate expf costs about ten instructions where
// __expf costs one (kept for agreement with the plain version), every
// thread redoes delta * u per n, and the butterfly spends four shuffles per
// step where a chunked form could reduce over several steps at once.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 32;                  // timesteps staged per pass
constexpr int kMaxN = 32;
constexpr unsigned kFull = 0xffffffffu;

struct Views {                            // element strides (batch, time)
  long long u_b, u_t, d_b, d_t, b_b, b_t, c_b, c_t;
};

template <int NP>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const float* __restrict__ u, const float* __restrict__ dt,
                const float* __restrict__ bv, const float* __restrict__ cv,
                const float* __restrict__ a, const float* s0,
                float* __restrict__ y, float* s_out, int T, int D, int N,
                Views v) {
  constexpr int kCh = kThreads / NP;      // channels per block
  __shared__ float sh_dt[kRun];
  __shared__ float sh_b[kRun][kMaxN];
  __shared__ float sh_c[kRun][kMaxN];
  __shared__ float sh_u[kRun][kCh];
  __shared__ float sh_y[kRun][kCh];

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kCh;
  const int ch = threadIdx.x / NP, n = threadIdx.x - ch * NP;
  const int d = d0 + ch;
  const bool own = d < D && n < N;        // a real (d, n) of the state
  const long long si = (static_cast<long long>(b) * D + d) * N + n;
  const float a_dn = own ? a[static_cast<long long>(d) * N + n] : 0.f;
  float s = own ? s0[si] : 0.f;           // read before s_out is written

  const float* ub = u + b * v.u_b;
  const float* db = dt + b * v.d_b;
  const float* bb = bv + b * v.b_b;
  const float* cb = cv + b * v.c_b;
  float* yb = y + static_cast<long long>(b) * T * D;

  for (int t0 = 0; t0 < T; t0 += kRun) {
    const int nr = min(kRun, T - t0);
    for (int i = threadIdx.x; i < kRun; i += kThreads)
      sh_dt[i] = i < nr ? db[(t0 + i) * v.d_t] : 0.f;
    for (int i = threadIdx.x; i < kRun * kMaxN; i += kThreads) {
      const int r = i / kMaxN, k = i - r * kMaxN;
      const bool in = r < nr && k < N;
      sh_b[r][k] = in ? bb[(t0 + r) * v.b_t + k] : 0.f;
      sh_c[r][k] = in ? cb[(t0 + r) * v.c_t + k] : 0.f;
    }
    for (int i = threadIdx.x; i < kRun * kCh; i += kThreads) {
      const int r = i / kCh, c = i - r * kCh;
      sh_u[r][c] = (r < nr && d0 + c < D) ? ub[(t0 + r) * v.u_t + d0 + c]
                                          : 0.f;
    }
    __syncthreads();                      // the run is staged

    for (int r = 0; r < nr; ++r) {
      const float dr = sh_dt[r];
      const float decay = expf(dr * a_dn);
      const float w = (dr * sh_u[r][ch]) * sh_b[r][n];
      s = s * decay + w;                  // two roundings: no FMA
      float p = s * sh_c[r][n];
#pragma unroll
      for (int off = NP / 2; off > 0; off >>= 1)
        p += __shfl_xor_sync(kFull, p, off);
      if (n == 0) sh_y[r][ch] = p;
    }
    __syncthreads();                      // the run's y is in shared memory

    for (int i = threadIdx.x; i < kRun * kCh; i += kThreads) {
      const int r = i / kCh, c = i - r * kCh;
      if (r < nr && d0 + c < D)
        yb[static_cast<long long>(t0 + r) * D + d0 + c] = sh_y[r][c];
    }
    // the next run's staging writes no buffer read above, and its compute
    // writes sh_y only after the next __syncthreads
  }
  if (own) s_out[si] = s;
}

template <int NP>
cudaError_t launch(const float* u, const float* dt, const float* bv,
                   const float* cv, const float* a, const float* s0, float* y,
                   float* s_out, int B, int T, int D, int N, Views v,
                   cudaStream_t stream) {
  constexpr int kCh = kThreads / NP;
  const dim3 grid((D + kCh - 1) / kCh, B);
  ssm_scan_kernel<NP><<<grid, kThreads, 0, stream>>>(u, dt, bv, cv, a, s0, y,
                                                     s_out, T, D, N, v);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Strides are in elements: (batch, time) of u, delta, bv and cv.
int soar_ssm_scan(const void* u, const void* delta, const void* bv,
                  const void* cv, const void* a, const void* s0, void* y,
                  void* s_out, int B, int T, int D, int N, long long u_sb,
                  long long u_st, long long d_sb, long long d_st,
                  long long b_sb, long long b_st, long long c_sb,
                  long long c_st, void* stream_) {
  if (B < 1 || B > 65535 || T < 1 || D < 1 || N < 1 || N > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  const Views v{u_sb, u_st, d_sb, d_st, b_sb, b_st, c_sb, c_st};
  const auto* uf = static_cast<const float*>(u);
  const auto* df = static_cast<const float*>(delta);
  const auto* bf = static_cast<const float*>(bv);
  const auto* cf = static_cast<const float*>(cv);
  const auto* af = static_cast<const float*>(a);
  const auto* sf = static_cast<const float*>(s0);
  auto* yf = static_cast<float*>(y);
  auto* of = static_cast<float*>(s_out);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  cudaError_t err;
  if (N <= 4)
    err = launch<4>(uf, df, bf, cf, af, sf, yf, of, B, T, D, N, v, stream);
  else if (N <= 8)
    err = launch<8>(uf, df, bf, cf, af, sf, yf, of, B, T, D, N, v, stream);
  else if (N <= 16)
    err = launch<16>(uf, df, bf, cf, af, sf, yf, of, B, T, D, N, v, stream);
  else
    err = launch<32>(uf, df, bf, cf, af, sf, yf, of, B, T, D, N, v, stream);
  return static_cast<int>(err);
}

}  // extern "C"
