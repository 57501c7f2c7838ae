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
// is per (d, n)), so a thread owns states of one (b, d) for the whole
// sequence and carries them in registers: the chunk axis becomes the loop
// over t inside the thread, and T needs no chunk multiple.
//
// Bound on the H100 at the hymba-1.5b serving cell (B 4, T 32,768, D 3200,
// N 16), per layer: 6.71 G exponentials on the special function units (16
// per SM per clock, 132 SMs), 1.6 ms at 1.98 GHz; bytes (u read and y
// written once, 3.36 GB) 1.0 ms at 3.35 TB/s; 6 float32 operations per
// element, 0.6 ms at 67 TFLOP/s. The exponentials bound it; next come
// the issue slots of the other instructions (about 8 an element here).
//
// Design, to spend as little as possible beside the one SFU operation per
// element:
//  - a thread owns NS = 4 consecutive states n of one channel; a channel is
//    L = ceil(N / 4) lanes rounded up to a power of two (1, 2, 4 or 8;
//    hymba's N = 16 takes 4). States n >= N hold 0 and read zero B and C.
//    A block is 64 threads (64 / L channels of one batch row), which at the
//    cell gives 800 blocks, about six per SM, and keeps the last wave short;
//  - the block stages delta, B and C (shared by its channels) and u for a
//    run of 32 steps in shared memory, by asynchronous copies (cp.async)
//    into two buffers, so the next run arrives while this one is computed;
//    each thread's copies walk fixed strides from pointers set up once.
//    B and C are copied 4 bytes at a time: they are slices of a (B, T,
//    2N + 1) projection whose rows are not 16-byte aligned. A thread then
//    reads its four B and four C values with one 16-byte shared load each;
//  - per (t, d) the product du = delta * u once; per element the decay is
//    ex2.approx.ftz(delta * a2), with a2 = a * log2(e) computed once per
//    (d, n) in a register (one multiply and one SFU operation, where the
//    accurate expf took about ten instructions), w = du * b, and
//    s = fma(s, decay, w) (the library is built with -fmad=false, so the
//    one FMA is explicit);
//  - y: each thread sums its four products pairwise, then L consecutive
//    steps are reduced across the L lanes at once by a reduce-scatter: L - 1
//    shuffles for L steps, after which lane l holds y of step l. The order
//    of every sum is fixed, so repeated calls agree bit for bit;
//  - a full run passes the constant 32 for its step count, so the compiler
//    drops the per-step bound check, which held the steps of a group apart
//    (about a tenth of the time at the cell).
// What it gives up: on the H100 it runs at about 2.7 times the SFU bound.
// Experiments on the card with altered copies found that neither the
// exponentials (an FMA in their place was no faster) nor the shared-memory
// loads of B and C (a thread carrying two channels, half the loads, was no
// faster) hold it; the staging and the reduce-scatter each cost a part.
// Each thread walks all T steps in order, and at batch 1 the kernel still
// takes about half its time at batch 4 (chip_smoke.py times both): one
// thread's latency a step sets a floor (PERF.md). A form that spends fewer
// SFU operations (a polynomial on the FMA pipe for part of them) would need
// a new error bound. Its error against the exact recurrence is derived in
// chip_smoke.py (scan_f64_bound), from the rounding of the argument,
// ex2.approx's relative error, flush-to-zero and the order of the sums.
//
// The backward (ssm_scan_bwd_kernel, then ssm_scan_bwd_finish) has no TPU
// twin: the JAX package differentiates a jnp scan. With lambda_t the
// adjoint of s_t, gy the gradient of y, gs_final that of s_out and
// e_t = exp(delta_t A):
//
//   lambda_t = gy_t C_t + lambda_{t+1} e_{t+1}   (lambda_T: + gs_final)
//   gu_t = delta_t sum_n lambda_t B_t      gB_t = sum_d lambda_t delta_t u_t
//   gC_t = sum_d gy_t s_t                  gs0 = lambda_1 e_1
//   gdelta_t = sum_{d,n} lambda_t (u_t B_t + s_{t-1} e_t A)
//   gA = sum_{b,t} lambda_t s_{t-1} e_t delta_t
//
// Its design:
//  - the same threads and blocks as the forward (a thread owns 4 states of
//    one (b, d) for the whole sequence), so the forward's states can be
//    recomputed with the forward's own arithmetic (ex2.approx.ftz of
//    delta * a * log2 e, the explicit FMA; the library is built with
//    -fmad=false): the recomputed states are bitwise the forward's. The
//    forward is never run backwards (s_{t-1} = (s_t - w_t) / e_t): the
//    decay flushes to zero;
//  - pass 1 walks forward over runs of kRun = 32 steps, writes the state at
//    each run's start to a checkpoint scratch (B, ceil(T/32), D, 4 L) and
//    takes gC's partial sums, which need only gy and s_t; pass 2 walks the
//    runs in reverse: it recomputes the run's states from its checkpoint
//    into shared memory, then walks the run's steps backwards, carrying
//    lambda in registers;
//  - the sums across d (gB, gC, gdelta) are per-block partials, summed
//    over the block's channels in a fixed order in shared memory at the
//    end of each run, then over the blocks by the second kernel
//    (ssm_scan_bwd_finish), also in a fixed order, which also sums gA's
//    per-batch-row partials. No float atomics: repeated calls, and the
//    recompute of a checkpointed layer, agree bit for bit.
// What it gives up: each thread walks T steps twice (and recomputes each
// run once more), so, as the forward at batch 1, it is latency-bound at
// one sequence a worker; the inputs are staged with plain loads, not the
// forward's asynchronous copies. chip_smoke.py times it against its bound
// and holds it against the plain backward in float64.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kNS = 4;                    // states a thread owns
constexpr int kRun = 32;                  // timesteps staged per pass
constexpr int kMaxN = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

struct Views {                            // element strides (batch, time)
  long long u_b, u_t, d_b, d_t, b_b, b_t, c_b, c_t;
};

// 2^x on the special function unit; subnormal results flush to zero.
__device__ __forceinline__ float ex2(float x) {
#ifdef __CUDA_ARCH__
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
#else
  const float y = exp2f(x);               // host build of the same logic
  return y < 0x1p-126f ? 0.f : y;
#endif
}

// A 4-byte copy from global to shared memory that runs while the block
// computes (zeros where !in; src must still be a valid address).
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           bool in) {
#ifdef __CUDA_ARCH__
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 4 : 0));
#else
  *dst = in ? *src : 0.f;
#endif
}

__device__ __forceinline__ void copy_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void copy_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
#endif
}

// p[j] is this lane's partial sum of step j (j < L); the L lanes of a
// channel exchange halves at each level, so lane l ends with the whole sum
// of step l: L - 1 shuffles for L steps.
template <int L>
__device__ __forceinline__ float reduce_scatter(float (&p)[L], int lane) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) {
    const bool up = (lane & o) != 0;
#pragma unroll
    for (int i = 0; i < o; ++i) {
      const float send = up ? p[i] : p[i + o];
      const float keep = up ? p[i + o] : p[i];
      p[i] = keep + __shfl_xor_sync(kFull, send, o);
    }
  }
  return p[0];
}

template <int L>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const float* __restrict__ u, const float* __restrict__ dt,
                const float* __restrict__ bv, const float* __restrict__ cv,
                const float* __restrict__ a, const float* s0,
                float* __restrict__ y, float* s_out, int T, int D, int N,
                Views v) {
  constexpr int kCh = kThreads / L;       // channels per block
  constexpr int kCols = kNS * L;          // states of a channel, N padded
  // two buffers: the next run is copied in while this one is computed
  __shared__ float sh_dt[2][kRun];
  __shared__ __align__(16) float sh_b[2][kRun][kCols];
  __shared__ __align__(16) float sh_c[2][kRun][kCols];
  __shared__ float sh_u[2][kRun][kCh];
  __shared__ float sh_y[kRun][kCh];

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kCh;
  const int ch = threadIdx.x / L, lane = threadIdx.x - ch * L;
  const int d = d0 + ch;
  const int n0 = lane * kNS;
  const long long si = (static_cast<long long>(b) * D + d) * N;
  float a2[kNS], s[kNS];
#pragma unroll
  for (int i = 0; i < kNS; ++i) {
    const bool own = d < D && n0 + i < N;     // a real (d, n) of the state
    a2[i] = own ? a[static_cast<long long>(d) * N + n0 + i] * kLog2e : 0.f;
    s[i] = own ? s0[si + n0 + i] : 0.f;       // read before s_out is written
  }

  const float* ub = u + b * v.u_b;
  const float* db = dt + b * v.d_b;
  const float* bb = bv + b * v.b_b;
  const float* cb = cv + b * v.c_b;
  float* yb = y + static_cast<long long>(b) * T * D;

  // Copies of one run: each thread copies B and C column kb of rows rb,
  // rb + kRowsB, ..., and u of channel ku of rows ru, ru + kRowsU, ...
  // (zeros past N, D and T), from pointers advanced by a fixed stride.
  constexpr int kRowsB = kThreads / kCols, kRowsU = kThreads / kCh;
  const int kb = threadIdx.x % kCols, rb = threadIdx.x / kCols;
  const int ku = threadIdx.x % kCh, ru = threadIdx.x / kCh;
  const bool b_in = kb < N, u_in = d0 + ku < D;
  const float* pb = bb + rb * v.b_t + kb;
  const float* pc = cb + rb * v.c_t + kb;
  const float* pu = ub + ru * v.u_t + d0 + ku;
  auto stage = [&](int t0, int buf) {
    const int nr = min(kRun, T - t0);
    const int i = threadIdx.x;
    if (i < kRun) copy_async(&sh_dt[buf][i], i < nr ? db + (t0 + i) * v.d_t
                                                    : db, i < nr);
    const float* qb = pb + t0 * v.b_t;
    const float* qc = pc + t0 * v.c_t;
#pragma unroll
    for (int j = 0; j < kRun / kRowsB; ++j) {
      const bool in = b_in && rb + j * kRowsB < nr;
      copy_async(&sh_b[buf][rb + j * kRowsB][kb], in ? qb : bb, in);
      copy_async(&sh_c[buf][rb + j * kRowsB][kb], in ? qc : cb, in);
      qb += kRowsB * v.b_t;
      qc += kRowsB * v.c_t;
    }
    const float* qu = pu + t0 * v.u_t;
#pragma unroll
    for (int j = 0; j < kRun / kRowsU; ++j) {
      const bool in = u_in && ru + j * kRowsU < nr;
      copy_async(&sh_u[buf][ru + j * kRowsU][ku], in ? qu : ub, in);
      qu += kRowsU * v.u_t;
    }
    copy_commit();
  };

  // the nr steps of a run in buffer buf
  auto steps = [&](int nr, int buf) {
    for (int r = 0; r < nr; r += L) {
      float p[L];
#pragma unroll
      for (int j = 0; j < L; ++j) {
        const int rr = r + j;
        p[j] = 0.f;
        if (rr < nr) {                    // uniform across the block
          const float dtv = sh_dt[buf][rr];
          const float du = dtv * sh_u[buf][rr][ch];
          const float4 bq =
              *reinterpret_cast<const float4*>(&sh_b[buf][rr][n0]);
          const float4 cq =
              *reinterpret_cast<const float4*>(&sh_c[buf][rr][n0]);
          s[0] = __fmaf_rn(s[0], ex2(dtv * a2[0]), du * bq.x);
          s[1] = __fmaf_rn(s[1], ex2(dtv * a2[1]), du * bq.y);
          s[2] = __fmaf_rn(s[2], ex2(dtv * a2[2]), du * bq.z);
          s[3] = __fmaf_rn(s[3], ex2(dtv * a2[3]), du * bq.w);
          p[j] = (s[0] * cq.x + s[1] * cq.y) + (s[2] * cq.z + s[3] * cq.w);
        }
      }
      const float yv = reduce_scatter<L>(p, lane);
      if (r + lane < nr) sh_y[r + lane][ch] = yv;
    }
  };

  stage(0, 0);
  for (int t0 = 0, buf = 0; t0 < T; t0 += kRun, buf ^= 1) {
    const int nr = min(kRun, T - t0);
    if (t0 + kRun < T) {                  // the next run's copies in flight
      stage(t0 + kRun, buf ^ 1);
      copy_wait<1>();
    } else {
      copy_wait<0>();
    }
    __syncthreads();                      // this run is staged
    if (nr == kRun)
      steps(kRun, buf);                   // the constant drops the checks
    else
      steps(nr, buf);
    __syncthreads();                      // y is in shared memory, and this
                                          // run's buffer is free again

    for (int i = threadIdx.x; i < kRun * kCh; i += kThreads) {
      const int r = i / kCh, c = i - r * kCh;
      if (r < nr && d0 + c < D)
        yb[static_cast<long long>(t0 + r) * D + d0 + c] = sh_y[r][c];
    }
    // the next run writes sh_y only after its own __syncthreads, which
    // every thread reaches after these stores
  }
#pragma unroll
  for (int i = 0; i < kNS; ++i)
    if (d < D && n0 + i < N) s_out[si + n0 + i] = s[i];
}

template <int L>
cudaError_t launch(const float* u, const float* dt, const float* bv,
                   const float* cv, const float* a, const float* s0, float* y,
                   float* s_out, int B, int T, int D, int N, Views v,
                   cudaStream_t stream) {
  constexpr int kCh = kThreads / L;
  const dim3 grid((D + kCh - 1) / kCh, B);
  ssm_scan_kernel<L><<<grid, kThreads, 0, stream>>>(u, dt, bv, cv, a, s0, y,
                                                    s_out, T, D, N, v);
  return cudaGetLastError();
}

// Shared memory of the backward, in floats: the run's staged delta, B, C,
// u and gy, then gu and gdelta's per-thread terms, the run's states and the
// per-thread terms of gB (of gC in pass 1), the last two as float4.
template <int L>
struct BwdSmem {
  static constexpr int kCh = kThreads / L, kCols = kNS * L;
  static constexpr int dt = 0, b = dt + kRun, c = b + kRun * kCols,
                       u = c + kRun * kCols, g = u + kRun * kCh,
                       gu = g + kRun * kCh, gd = gu + kRun * kCh,
                       s = gd + kRun * kThreads, gb = s + kRun * kThreads * kNS,
                       floats = gb + kRun * kThreads * kNS;
  static_assert(s % 4 == 0 && b % 4 == 0 && c % 4 == 0, "float4 alignment");
};

template <int L>
__global__ void __launch_bounds__(kThreads)
ssm_scan_bwd_kernel(const float* __restrict__ u, const float* __restrict__ dt,
                    const float* __restrict__ bv, const float* __restrict__ cv,
                    const float* __restrict__ a, const float* __restrict__ s0,
                    const float* __restrict__ gy, const float* __restrict__ gsf,
                    float* __restrict__ gu, float* __restrict__ ck,
                    float* __restrict__ part_b, float* __restrict__ part_c,
                    float* __restrict__ part_d, float* __restrict__ ga_part,
                    float* __restrict__ gs0, int T, int D, int N, Views v) {
  using S = BwdSmem<L>;
  constexpr int kCh = S::kCh, kCols = S::kCols;
  extern __shared__ __align__(16) float smem[];
  float* sh_dt = smem + S::dt;
  float* sh_b = smem + S::b;
  float* sh_c = smem + S::c;
  float* sh_u = smem + S::u;
  float* sh_g = smem + S::g;
  float* sh_gu = smem + S::gu;
  float* sh_gd = smem + S::gd;
  float4* sh_s = reinterpret_cast<float4*>(smem + S::s);
  float4* sh_gb = reinterpret_cast<float4*>(smem + S::gb);

  const int B = gridDim.y, b = blockIdx.y, blk = blockIdx.x;
  const int tid = threadIdx.x;
  const int d0 = blk * kCh;
  const int ch = tid / L, lane = tid - ch * L;
  const int d = d0 + ch;
  const int n0 = lane * kNS;
  const int R = (T + kRun - 1) / kRun;
  const long long si = (static_cast<long long>(b) * D + d) * N;
  float a1[kNS], a2[kNS], s[kNS], carry[kNS], gA[kNS];
#pragma unroll
  for (int i = 0; i < kNS; ++i) {
    const bool own = d < D && n0 + i < N;
    a1[i] = own ? a[static_cast<long long>(d) * N + n0 + i] : 0.f;
    a2[i] = a1[i] * kLog2e;
    s[i] = own ? s0[si + n0 + i] : 0.f;
    carry[i] = own && gsf != nullptr ? gsf[si + n0 + i] : 0.f;
    gA[i] = 0.f;
  }
  const float* ub = u + b * v.u_b;
  const float* db = dt + b * v.d_b;
  const float* bb = bv + b * v.b_b;
  const float* cb = cv + b * v.c_b;
  const float* gb = gy + static_cast<long long>(b) * T * D;
  float4* ckb = reinterpret_cast<float4*>(ck) +
                (static_cast<long long>(b) * R * D + d) * L + lane;
  const long long ck_run = static_cast<long long>(D) * L;   // float4s a run
  // partials: part_x[blk][b][t][n], part_d[blk][b][t]
  const long long pbase = (static_cast<long long>(blk) * B + b) * T;

  auto stage = [&](int t0, int nr) {
    for (int i = tid; i < kRun; i += kThreads)
      sh_dt[i] = i < nr ? db[static_cast<long long>(t0 + i) * v.d_t] : 0.f;
    for (int i = tid; i < kRun * kCols; i += kThreads) {
      const int r = i / kCols, n = i - r * kCols;
      const bool in = r < nr && n < N;
      sh_b[i] = in ? bb[static_cast<long long>(t0 + r) * v.b_t + n] : 0.f;
      sh_c[i] = in ? cb[static_cast<long long>(t0 + r) * v.c_t + n] : 0.f;
    }
    for (int i = tid; i < kRun * kCh; i += kThreads) {
      const int r = i / kCh, c = i - r * kCh;
      const bool in = r < nr && d0 + c < D;
      sh_u[i] =
          in ? ub[static_cast<long long>(t0 + r) * v.u_t + d0 + c] : 0.f;
      sh_g[i] = in ? gb[static_cast<long long>(t0 + r) * D + d0 + c] : 0.f;
    }
  };
  // the forward's step r of the staged run, on s
  auto fwd_step = [&](int r) {
    const float dtv = sh_dt[r];
    const float du = dtv * sh_u[r * kCh + ch];
    const float4 bq =
        *reinterpret_cast<const float4*>(&sh_b[r * kCols + n0]);
    s[0] = __fmaf_rn(s[0], ex2(dtv * a2[0]), du * bq.x);
    s[1] = __fmaf_rn(s[1], ex2(dtv * a2[1]), du * bq.y);
    s[2] = __fmaf_rn(s[2], ex2(dtv * a2[2]), du * bq.z);
    s[3] = __fmaf_rn(s[3], ex2(dtv * a2[3]), du * bq.w);
  };
  // the sum over the block's channels of per-thread float4 terms: row r,
  // state n of the run -> out[(t0 + r) * N + n], channels in order
  auto sum_channels = [&](const float4* terms, float* out, int t0, int nr) {
    const float* f = reinterpret_cast<const float*>(terms);
    for (int i = tid; i < kRun * kCols; i += kThreads) {
      const int r = i / kCols, n = i - r * kCols;
      if (r < nr && n < N) {
        float acc = 0.f;
        for (int c = 0; c < kCh; ++c)
          acc += f[(r * kThreads + c * L) * kNS + n];
        out[static_cast<long long>(t0 + r) * N + n] = acc;
      }
    }
  };

  // pass 1: forward; checkpoints at run starts, gC's partials
  for (int k = 0; k < R; ++k) {
    const int t0 = k * kRun, nr = min(kRun, T - t0);
    if (d < D) ckb[k * ck_run] = make_float4(s[0], s[1], s[2], s[3]);
    stage(t0, nr);
    __syncthreads();
    for (int r = 0; r < nr; ++r) {
      fwd_step(r);
      const float g = sh_g[r * kCh + ch];
      sh_gb[r * kThreads + tid] = make_float4(g * s[0], g * s[1], g * s[2],
                                              g * s[3]);
    }
    __syncthreads();
    sum_channels(sh_gb, part_c + pbase * N, t0, nr);
    __syncthreads();
  }

  // pass 2: the runs in reverse
  for (int k = R - 1; k >= 0; --k) {
    const int t0 = k * kRun, nr = min(kRun, T - t0);
    const float4 c0 =
        d < D ? ckb[k * ck_run] : make_float4(0.f, 0.f, 0.f, 0.f);
    s[0] = c0.x, s[1] = c0.y, s[2] = c0.z, s[3] = c0.w;
    stage(t0, nr);
    __syncthreads();
    for (int r = 0; r < nr; ++r) {          // s_{t-1} of each step
      sh_s[r * kThreads + tid] = make_float4(s[0], s[1], s[2], s[3]);
      fwd_step(r);
    }
    for (int r = nr - 1; r >= 0; --r) {
      const float dtv = sh_dt[r];
      const float uv = sh_u[r * kCh + ch];
      const float du = dtv * uv;
      const float g = sh_g[r * kCh + ch];
      const float4 bq =
          *reinterpret_cast<const float4*>(&sh_b[r * kCols + n0]);
      const float4 cq =
          *reinterpret_cast<const float4*>(&sh_c[r * kCols + n0]);
      const float4 sp = sh_s[r * kThreads + tid];
      const float bb4[kNS] = {bq.x, bq.y, bq.z, bq.w};
      const float cc4[kNS] = {cq.x, cq.y, cq.z, cq.w};
      const float sp4[kNS] = {sp.x, sp.y, sp.z, sp.w};
      float lam[kNS], gdt = 0.f;
#pragma unroll
      for (int i = 0; i < kNS; ++i) {
        const float e = ex2(dtv * a2[i]);
        lam[i] = g * cc4[i] + carry[i];
        const float back = sp4[i] * e;                  // s_{t-1} e_t
        gdt += lam[i] * (uv * bb4[i] + back * a1[i]);
        gA[i] += lam[i] * back * dtv;
        carry[i] = lam[i] * e;
      }
      float pu = (lam[0] * bq.x + lam[1] * bq.y) +
                 (lam[2] * bq.z + lam[3] * bq.w);
#pragma unroll
      for (int o = 1; o < L; o <<= 1) pu += __shfl_xor_sync(kFull, pu, o);
      if (lane == 0) sh_gu[r * kCh + ch] = dtv * pu;
      sh_gb[r * kThreads + tid] = make_float4(du * lam[0], du * lam[1],
                                              du * lam[2], du * lam[3]);
      sh_gd[r * kThreads + tid] = gdt;
    }
    __syncthreads();
    sum_channels(sh_gb, part_b + pbase * N, t0, nr);
    for (int r = tid; r < nr; r += kThreads) {
      float acc = 0.f;
      for (int j = 0; j < kThreads; ++j) acc += sh_gd[r * kThreads + j];
      part_d[pbase + t0 + r] = acc;
    }
    float* gub = gu + static_cast<long long>(b) * T * D;
    for (int i = tid; i < kRun * kCh; i += kThreads) {
      const int r = i / kCh, c = i - r * kCh;
      if (r < nr && d0 + c < D)
        gub[static_cast<long long>(t0 + r) * D + d0 + c] = sh_gu[i];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kNS; ++i) {
    if (d < D && n0 + i < N) {
      gs0[si + n0 + i] = carry[i];
      ga_part[si + n0 + i] = gA[i];
    }
  }
}

// The blocks' partials summed in block order, and gA's batch rows in row
// order: gbv, gcv (B, T, N), gdelta (B, T), ga (D, N), all contiguous.
__global__ void ssm_scan_bwd_finish(const float* __restrict__ part_b,
                                    const float* __restrict__ part_c,
                                    const float* __restrict__ part_d,
                                    const float* __restrict__ ga_part,
                                    float* __restrict__ gbv,
                                    float* __restrict__ gcv,
                                    float* __restrict__ gdelta,
                                    float* __restrict__ ga, int nblk, int B,
                                    int T, int D, int N) {
  const long long btn = static_cast<long long>(B) * T * N;
  const long long bt = static_cast<long long>(B) * T;
  const long long dn = static_cast<long long>(D) * N;
  const long long total = 2 * btn + bt + dn;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float acc = 0.f;
    if (i < 2 * btn) {
      const bool is_b = i < btn;
      const long long j = is_b ? i : i - btn;
      const float* p = is_b ? part_b : part_c;
      for (int k = 0; k < nblk; ++k) acc += p[k * btn + j];
      (is_b ? gbv : gcv)[j] = acc;
    } else if (i < 2 * btn + bt) {
      const long long j = i - 2 * btn;
      for (int k = 0; k < nblk; ++k) acc += part_d[k * bt + j];
      gdelta[j] = acc;
    } else {
      const long long j = i - 2 * btn - bt;
      for (int k = 0; k < B; ++k) acc += ga_part[k * dn + j];
      ga[j] = acc;
    }
  }
}

template <int L>
cudaError_t launch_bwd(const float* u, const float* dt, const float* bv,
                       const float* cv, const float* a, const float* s0,
                       const float* gy, const float* gsf, float* gu,
                       float* gdelta, float* gbv, float* gcv, float* ga,
                       float* gs0, float* scratch, int B, int T, int D, int N,
                       Views v, cudaStream_t stream) {
  using S = BwdSmem<L>;
  const int nblk = (D + S::kCh - 1) / S::kCh;
  const long long R = (T + kRun - 1) / kRun;
  float* ck = scratch;
  float* part_b = ck + static_cast<long long>(B) * R * D * S::kCols;
  float* part_c = part_b + static_cast<long long>(nblk) * B * T * N;
  float* part_d = part_c + static_cast<long long>(nblk) * B * T * N;
  float* ga_part = part_d + static_cast<long long>(nblk) * B * T;
  constexpr int kSmem = S::floats * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      ssm_scan_bwd_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(nblk, B);
  ssm_scan_bwd_kernel<L><<<grid, kThreads, kSmem, stream>>>(
      u, dt, bv, cv, a, s0, gy, gsf, gu, ck, part_b, part_c, part_d, ga_part,
      gs0, T, D, N, v);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssm_scan_bwd_finish<<<1056, 256, 0, stream>>>(part_b, part_c, part_d,
                                                ga_part, gbv, gcv, gdelta, ga,
                                                nblk, B, T, D, N);
  return cudaGetLastError();
}

// Floats of the backward's scratch: the run checkpoints, the blocks'
// partials of gB, gC and gdelta, and gA's per-row partials.
template <int L>
long long bwd_scratch(int B, int T, int D, int N) {
  using S = BwdSmem<L>;
  const long long nblk = (D + S::kCh - 1) / S::kCh;
  const long long R = (T + kRun - 1) / kRun;
  return static_cast<long long>(B) * R * D * S::kCols +
         nblk * B * T * (2LL * N + 1) + static_cast<long long>(B) * D * N;
}

// max_rel[0] gets the largest |ex2(x) - 2^x| / 2^x over the float32 x with
// bits in [lo, lo + count) whose 2^x is a normal float, as float bits
// (non-negative floats order like their bits); 2^x in double precision.
__global__ void ex2_sweep_kernel(unsigned lo, unsigned long long count,
                                 unsigned* max_rel) {
  float worst = 0.f;
  const unsigned long long stride =
      static_cast<unsigned long long>(gridDim.x) * blockDim.x;
  for (unsigned long long i =
           static_cast<unsigned long long>(blockIdx.x) * blockDim.x +
           threadIdx.x;
       i < count; i += stride) {
    const float x = __uint_as_float(lo + static_cast<unsigned>(i));
    const double want = exp2(static_cast<double>(x));
    if (want >= 0x1p-126) {
      const double rel = fabs(static_cast<double>(ex2(x)) - want) / want;
      worst = fmaxf(worst, static_cast<float>(rel));
    }
  }
  for (int o = 16; o > 0; o >>= 1)
    worst = fmaxf(worst, __shfl_xor_sync(kFull, worst, o));
  if ((threadIdx.x & 31) == 0) atomicMax(max_rel, __float_as_uint(worst));
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
    err = launch<1>(uf, df, bf, cf, af, sf, yf, of, B, T, D, N, v, stream);
  else if (N <= 8)
    err = launch<2>(uf, df, bf, cf, af, sf, yf, of, B, T, D, N, v, stream);
  else if (N <= 16)
    err = launch<4>(uf, df, bf, cf, af, sf, yf, of, B, T, D, N, v, stream);
  else
    err = launch<8>(uf, df, bf, cf, af, sf, yf, of, B, T, D, N, v, stream);
  return static_cast<int>(err);
}

// Bytes of scratch the backward needs for (B, T, D, N), or -1 if invalid.
long long soar_ssm_scan_bwd_scratch(int B, int T, int D, int N) {
  if (B < 1 || B > 65535 || T < 1 || D < 1 || N < 1 || N > kMaxN) return -1;
  const long long f = N <= 4   ? bwd_scratch<1>(B, T, D, N)
                      : N <= 8  ? bwd_scratch<2>(B, T, D, N)
                      : N <= 16 ? bwd_scratch<4>(B, T, D, N)
                                : bwd_scratch<8>(B, T, D, N);
  return f * static_cast<long long>(sizeof(float));
}

// The backward: the forward's operands (strided as there), gy (B, T, D)
// and gs_final (B, D, N, or null for zero) contiguous -> gu (B, T, D),
// gdelta (B, T), gbv and gcv (B, T, N), ga (D, N), gs0 (B, D, N), all
// contiguous float32; scratch holds soar_ssm_scan_bwd_scratch bytes. Two
// kernels on the stream: the walk, then the fixed-order sums.
int soar_ssm_scan_bwd(const void* u, const void* delta, const void* bv,
                      const void* cv, const void* a, const void* s0,
                      const void* gy, const void* gs_final, void* gu,
                      void* gdelta, void* gbv, void* gcv, void* ga, void* gs0,
                      void* scratch, int B, int T, int D, int N,
                      long long u_sb, long long u_st, long long d_sb,
                      long long d_st, long long b_sb, long long b_st,
                      long long c_sb, long long c_st, void* stream_) {
  if (B < 1 || B > 65535 || T < 1 || D < 1 || N < 1 || N > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  const Views v{u_sb, u_st, d_sb, d_st, b_sb, b_st, c_sb, c_st};
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto w = [](void* p) { return static_cast<float*>(p); };
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  cudaError_t err;
#define SOAR_BWD(L)                                                         \
  launch_bwd<L>(f(u), f(delta), f(bv), f(cv), f(a), f(s0), f(gy),           \
                f(gs_final), w(gu), w(gdelta), w(gbv), w(gcv), w(ga),       \
                w(gs0), w(scratch), B, T, D, N, v, stream)
  if (N <= 4)
    err = SOAR_BWD(1);
  else if (N <= 8)
    err = SOAR_BWD(2);
  else if (N <= 16)
    err = SOAR_BWD(4);
  else
    err = SOAR_BWD(8);
#undef SOAR_BWD
  return static_cast<int>(err);
}

// The exponential the scan uses, swept over float32 arguments: max_rel
// (one uint32, zeroed by the caller) gets the largest relative error as
// float bits (see ex2_sweep_kernel).
int soar_ex2_sweep(unsigned lo, unsigned long long count, void* max_rel,
                   void* stream_) {
  const auto stream = static_cast<cudaStream_t>(stream_);
  ex2_sweep_kernel<<<1056, 256, 0, stream>>>(
      lo, count, static_cast<unsigned*>(max_rel));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
