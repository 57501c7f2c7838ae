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
// The backward has no TPU twin: the JAX package differentiates a jnp scan.
// With lambda_t the adjoint of s_t, gy the gradient of y, gs_final that of
// s_out and e_t = exp(delta_t A):
//
//   lambda_t = gy_t C_t + lambda_{t+1} e_{t+1}   (lambda_T: + gs_final)
//   gu_t = delta_t sum_n lambda_t B_t      gB_t = sum_d lambda_t delta_t u_t
//   gC_t = sum_d gy_t s_t                  gs0 = lambda_1 e_1
//   gdelta_t = sum_{d,n} lambda_t (u_t B_t + s_{t-1} e_t A)
//   gA = sum_{b,t} lambda_t s_{t-1} e_t delta_t
//
// Its design (three kernels on the stream):
//  - checkpoints: the forward kernel, given ck, stores each thread's four
//    states at the start of every 32-step run, (B, ceil(T/32), D, 4 L): one
//    float4 store a thread a run. The backward rebuilds a run's states from
//    its checkpoint with the forward's own arithmetic (ex2.approx.ftz of
//    delta * a * log2 e, the explicit FMA; the library is built with
//    -fmad=false), so they are bitwise the forward's. The forward is never
//    run backwards (s_{t-1} = (s_t - w_t) / e_t): the decay flushes to zero;
//  - parallel over T: the runs are cut into S segments of G runs, S chosen
//    from the card's resident blocks so that (D / channels a block) x B x S
//    blocks fill it about four times over (bwd_plan). The adjoint is
//    linear in its carry, so a segment's
//    carry out is c + P x (its carry in), c its carry out from a zero carry
//    in and P the product of its decays, which need only gy, C and delta.
//    ssm_scan_bwd_carry_kernel computes (c, P) of segments 1..S-1; each
//    block of ssm_scan_bwd_kernel then folds gs_final through the later
//    segments' (c, P), last first, and walks its own runs backwards from
//    that true carry;
//  - in registers: a run's checkpoint is stepped forward to the starts of
//    its four 8-step sub-runs; each sub-run's nine states and eight decays
//    are rebuilt into registers and walked back, carrying lambda. Nothing
//    of a thread's per-step terms goes through shared memory: gB and gC
//    (8 values a thread and step) are summed over the warp's channels by a
//    reduce-scatter of shuffles (7 a step at L = 4), gdelta and gu over a
//    sub-run's 8 steps at once; each warp writes one value per output to
//    shared memory, and the block sums its warps in order. A block is 64
//    channels (256 threads at L = 4; 32 channels at L = 8), about 58 KB of
//    shared memory at L = 4;
//  - staging: the run before the one being walked (delta, B, C, u, gy) is
//    copied in by cp.async while this one is walked, as in the forward;
//  - partials: per block (gB, gC, gdelta of each step: B T (2 N + 1)
//    floats) and per (batch row, segment) for gA, summed in a fixed order
//    by ssm_scan_bwd_finish, which writes gbv, gcv, gdelta and ga; segment
//    0 writes gs0. No float atomics: two calls on one card agree bit for
//    bit (S depends only on the shapes and the card).
// Bound at the hymba training cell's batch 1 (T 4,096, D 3,200, N 16):
// 21 float32 operations an element, 0.066 ms (one exponential an element,
// e_t, which the state and the adjoint share, takes 0.050 ms on the
// special function units; the bytes 0.048 ms). The kernels spend up to
// 2.75 exponentials an element (the carry pass 1 but in segment 0, the
// sub-run starts 0.75, the sub-run 1), and the walk about 167
// instructions a thread and step (4 elements), so its instruction count
// bounds it. chip_smoke.py times the three kernels
// against the bound and holds them against the plain backward in float64
// (ref.ssm_chunk_scan_bwd_seg_torch is the same order on the CPU).
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 64;
constexpr int kNS = 4;                    // states a thread owns
constexpr int kRun = 32;                  // timesteps staged per pass
constexpr int kSub = 8;                   // backward: steps held in registers
constexpr int kBwdChannels = 64;         // backward: channels a block
constexpr int kBwdMinBlocks = 2;          // backward: blocks an SM (registers)
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

template <int L, bool kCk>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const float* __restrict__ u, const float* __restrict__ dt,
                const float* __restrict__ bv, const float* __restrict__ cv,
                const float* __restrict__ a, const float* s0,
                float* __restrict__ y, float* s_out, float4* __restrict__ ck,
                int T, int D, int N, Views v) {
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
  // the run checkpoints of this thread's states, a run D * L float4s apart
  const int R = (T + kRun - 1) / kRun;
  float4* ckb = kCk ? ck + (static_cast<long long>(b) * R * D + d) * L + lane
                    : nullptr;

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
    if (kCk && d < D)                     // the state at this run's start
      ckb[static_cast<long long>(t0 / kRun) * D * L] =
          make_float4(s[0], s[1], s[2], s[3]);
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
                   float* s_out, float4* ck, int B, int T, int D, int N,
                   Views v, cudaStream_t stream) {
  constexpr int kCh = kThreads / L;
  const dim3 grid((D + kCh - 1) / kCh, B);
  if (ck != nullptr)
    ssm_scan_kernel<L, true><<<grid, kThreads, 0, stream>>>(
        u, dt, bv, cv, a, s0, y, s_out, ck, T, D, N, v);
  else                                    // serving: no checkpoint stores
    ssm_scan_kernel<L, false><<<grid, kThreads, 0, stream>>>(
        u, dt, bv, cv, a, s0, y, s_out, ck, T, D, N, v);
  return cudaGetLastError();
}

// Sums v[0..K) of each lane over the lanes that differ from it only in the
// lane bits O, O / 2, ..., LO, in a fixed tree: while more than one value
// is left, a level sends half of them to the partner lane and keeps the
// other half (a reduce-scatter); after that it adds the partner's one
// value. The lane ends with max(1, K >> levels) whole sums in v[0..),
// those of values held_first<K, O, LO>(lane), + 1, ...
template <int K, int O, int LO, int KA>
__device__ __forceinline__ void reduce_lanes(float (&v)[KA], int lane) {
  if constexpr (O >= LO && O > 0) {
    if constexpr (K > 1) {
      constexpr int H = K / 2;
      const bool up = (lane & O) != 0;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = up ? v[i] : v[i + H];
        const float keep = up ? v[i + H] : v[i];
        v[i] = keep + __shfl_xor_sync(kFull, send, O);
      }
      reduce_lanes<H, O / 2, LO>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(kFull, v[0], O);
      reduce_lanes<1, O / 2, LO>(v, lane);
    }
  }
}

template <int K, int O, int LO>
__device__ __forceinline__ int held_first(int lane) {
  if constexpr (O >= LO && O > 0 && K > 1)
    return ((lane & O) != 0 ? K / 2 : 0) + held_first<K / 2, O / 2, LO>(lane);
  else
    return 0;
}

// The backward's block: kBwdChannels channels of L lanes (at most 256
// threads: 32 channels at L = 8), and its shared memory in floats: two staging
// buffers of a run (delta, B and C of kCols columns, u and gy of the
// block's channels), then two buffers of the warps' sums of a sub-run (kW
// a step: gB and gC of kCols columns, gdelta).
template <int L>
struct Bwd {
  static constexpr int kThreads =
      kBwdChannels * L < 256 ? kBwdChannels * L : 256;
  static constexpr int kCh = kThreads / L, kCols = kNS * L;
  static constexpr int kWarps = kThreads / 32, kW = 2 * kCols + 1;
  static constexpr int dt = 0, b = dt + kRun, c = b + kRun * kCols,
                       u = c + kRun * kCols, g = u + kRun * kCh,
                       stage = g + kRun * kCh, w = 2 * stage,
                       floats = w + 2 * kWarps * kSub * kW;
  static constexpr int kSmem = floats * static_cast<int>(sizeof(float));
  static_assert(stage % 4 == 0 && b % 4 == 0 && c % 4 == 0,
                "float4 alignment");
};

// The copies of run [t0, t0 + kRun) into a staging buffer, in flight until
// copy_wait: delta, C and gy, and for the walk (kWalk) B and u; zeros past
// T, N and D. gb is gy of the batch row (contiguous, D a step).
template <int L, bool kWalk>
__device__ __forceinline__ void bwd_stage(float* buf, int t0, int T, int D,
                                          int N, int d0, const float* db,
                                          const float* bb, const float* cb,
                                          const float* ub, const float* gb,
                                          const Views& v) {
  using S = Bwd<L>;
  constexpr int kRowsB = S::kThreads / S::kCols, kRowsU = S::kThreads / S::kCh;
  const int nr = min(kRun, T - t0), tid = threadIdx.x;
  if (tid < kRun)
    copy_async(buf + S::dt + tid, tid < nr ? db + (t0 + tid) * v.d_t : db,
               tid < nr);
  const int kb = tid % S::kCols, rb = tid / S::kCols;
#pragma unroll
  for (int j = 0; j < kRun / kRowsB; ++j) {
    const int r = rb + j * kRowsB;
    const bool in = kb < N && r < nr;
    if (kWalk)
      copy_async(buf + S::b + r * S::kCols + kb,
                 in ? bb + (t0 + r) * v.b_t + kb : bb, in);
    copy_async(buf + S::c + r * S::kCols + kb,
               in ? cb + (t0 + r) * v.c_t + kb : cb, in);
  }
  const int ku = tid % S::kCh, ru = tid / S::kCh;
#pragma unroll
  for (int j = 0; j < kRun / kRowsU; ++j) {
    const int r = ru + j * kRowsU;
    const bool in = d0 + ku < D && r < nr;
    if (kWalk)
      copy_async(buf + S::u + r * S::kCh + ku,
                 in ? ub + (t0 + r) * v.u_t + d0 + ku : ub, in);
    copy_async(buf + S::g + r * S::kCh + ku,
               in ? gb + static_cast<long long>(t0 + r) * D + d0 + ku : gb,
               in);
  }
  copy_commit();
}

// Segment seg of B T's runs: runs [seg G, min(R, seg G + G)).
// ssm_scan_bwd_carry_kernel: grid (blocks over D, S - 1, B); segment
// blockIdx.y + 1 walks its steps backwards from a zero carry and writes,
// per state, its carry out c and the product P of its decays to
// sum_c/sum_p[(b S + seg) D L + d L + lane] (float4s of a thread's states).
template <int L>
__global__ void __launch_bounds__(Bwd<L>::kThreads)
ssm_scan_bwd_carry_kernel(const float* __restrict__ dt,
                          const float* __restrict__ cv,
                          const float* __restrict__ a,
                          const float* __restrict__ gy,
                          float4* __restrict__ sum_c,
                          float4* __restrict__ sum_p, int T, int D, int N,
                          int G, Views v) {
  using S = Bwd<L>;
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.z, seg = blockIdx.y + 1, nseg = gridDim.y + 1;
  const int tid = threadIdx.x, d0 = blockIdx.x * S::kCh;
  const int ch = tid / L, lane = tid - ch * L, d = d0 + ch, n0 = lane * kNS;
  const int R = (T + kRun - 1) / kRun;
  const int k_lo = seg * G, k_hi = min(R, k_lo + G);
  float a2[kNS], carry[kNS], prod[kNS];
#pragma unroll
  for (int i = 0; i < kNS; ++i) {
    const bool own = d < D && n0 + i < N;
    a2[i] = (own ? a[static_cast<long long>(d) * N + n0 + i] : 0.f) * kLog2e;
    carry[i] = 0.f;
    prod[i] = 1.f;
  }
  const float* db = dt + b * v.d_b;
  const float* cb = cv + b * v.c_b;
  const float* gb = gy + static_cast<long long>(b) * T * D;
  auto steps = [&](const float* sm, int nr, auto full) {
#pragma unroll
    for (int r = kRun - 1; r >= 0; --r) {
      if (!decltype(full)::value && r >= nr) continue;   // past T
      const float dtv = sm[S::dt + r];
      const float g = sm[S::g + r * S::kCh + ch];
      const float4 cq = *reinterpret_cast<const float4*>(
          &sm[S::c + r * S::kCols + n0]);
      const float cc[kNS] = {cq.x, cq.y, cq.z, cq.w};
#pragma unroll
      for (int i = 0; i < kNS; ++i) {
        const float e = ex2(dtv * a2[i]);
        const float lam = __fmaf_rn(g, cc[i], carry[i]);
        carry[i] = lam * e;
        prod[i] = prod[i] * e;
      }
    }
  };
  bwd_stage<L, false>(smem, (k_hi - 1) * kRun, T, D, N, d0, db, nullptr, cb,
                      nullptr, gb, v);
  for (int k = k_hi - 1, buf = 0; k >= k_lo; --k, buf ^= 1) {
    if (k > k_lo) {                       // the run before in flight
      bwd_stage<L, false>(smem + (buf ^ 1) * S::stage, (k - 1) * kRun, T, D,
                          N, d0, db, nullptr, cb, nullptr, gb, v);
      copy_wait<1>();
    } else {
      copy_wait<0>();
    }
    __syncthreads();                      // this run is staged
    const int nr = min(kRun, T - k * kRun);
    if (nr == kRun)
      steps(smem + buf * S::stage, nr, std::true_type{});
    else
      steps(smem + buf * S::stage, nr, std::false_type{});
    __syncthreads();                      // its buffer is free again
  }
  if (d < D) {
    const long long at = ((static_cast<long long>(b) * nseg + seg) * D + d) *
                             L + lane;
    sum_c[at] = make_float4(carry[0], carry[1], carry[2], carry[3]);
    sum_p[at] = make_float4(prod[0], prod[1], prod[2], prod[3]);
  }
}

// The walk: grid (blocks over D, S, B). Block (blk, seg, b) folds gs_final
// through segments S-1..seg+1's (c, P), then walks its runs backwards from
// the checkpoints ck (the forward's), writing gu, the block's partial sums
// part[((blk B + b) T + t) (2 N + 1) + x] (x: gB n, gC N + n, gdelta 2 N),
// gA's partial ga_part[(b S + seg) D N + d N + n] and, in segment 0, gs0.
template <int L>
__global__ void __launch_bounds__(Bwd<L>::kThreads, kBwdMinBlocks)
ssm_scan_bwd_kernel(const float* __restrict__ u, const float* __restrict__ dt,
                    const float* __restrict__ bv, const float* __restrict__ cv,
                    const float* __restrict__ a, const float* __restrict__ gy,
                    const float* __restrict__ gsf,
                    const float4* __restrict__ ck,
                    const float4* __restrict__ sum_c,
                    const float4* __restrict__ sum_p, float* __restrict__ gu,
                    float* __restrict__ part, float* __restrict__ ga_part,
                    float* __restrict__ gs0, int T, int D, int N, int G,
                    Views v) {
  using S = Bwd<L>;
  constexpr int kCh = S::kCh, kCols = S::kCols;
  extern __shared__ __align__(16) float smem[];
  const int B = gridDim.z, b = blockIdx.z, seg = blockIdx.y;
  const int nseg = gridDim.y, blk = blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, wl = tid & 31;
  const int d0 = blk * kCh;
  const int ch = tid / L, lane = tid - ch * L, d = d0 + ch, n0 = lane * kNS;
  const int R = (T + kRun - 1) / kRun;
  const int k_lo = seg * G, k_hi = min(R, k_lo + G);
  const int W = 2 * N + 1;
  const long long si = (static_cast<long long>(b) * D + d) * N;
  float a1[kNS], a2[kNS], carry[kNS], gA[kNS];
#pragma unroll
  for (int i = 0; i < kNS; ++i) {
    const bool own = d < D && n0 + i < N;
    a1[i] = own ? a[static_cast<long long>(d) * N + n0 + i] : 0.f;
    a2[i] = a1[i] * kLog2e;
    carry[i] = own && gsf != nullptr ? gsf[si + n0 + i] : 0.f;
    gA[i] = 0.f;
  }
  // the carry into this segment: gs_final through the later segments
  if (d < D) {
    for (int k = nseg - 1; k > seg; --k) {
      const long long at = ((static_cast<long long>(b) * nseg + k) * D + d) *
                               L + lane;
      const float4 c = sum_c[at], p = sum_p[at];
      carry[0] = __fmaf_rn(p.x, carry[0], c.x);
      carry[1] = __fmaf_rn(p.y, carry[1], c.y);
      carry[2] = __fmaf_rn(p.z, carry[2], c.z);
      carry[3] = __fmaf_rn(p.w, carry[3], c.w);
    }
  }
  const float* ub = u + b * v.u_b;
  const float* db = dt + b * v.d_b;
  const float* bb = bv + b * v.b_b;
  const float* cb = cv + b * v.c_b;
  const float* gb = gy + static_cast<long long>(b) * T * D;
  float* gub = gu + static_cast<long long>(b) * T * D;
  const float4* ckb = ck + (static_cast<long long>(b) * R * D + d) * L + lane;
  float* pb = part + (static_cast<long long>(blk) * B + b) * T * W;
  int wbuf = 0;                           // the warp sums' buffer
  // what the lane holds after the sums over lanes: gB/gC value xb (and
  // xb + 1 at L = 8) of each step, its column in a warp's row of sums;
  // gdelta of step rd; sum_n lambda B of steps ru, ru + 1, ...
  constexpr int kHeld = 2 * kNS * L / 32 > 1 ? 2 * kNS * L / 32 : 1;
  constexpr int kHeldU = kSub / L > 1 ? kSub / L : 1;
  const int xb = held_first<2 * kNS, 16, L>(wl);
  const int col_b = warp * kSub * S::kW + (xb / kNS) * kCols + n0 + xb % kNS;
  const int rd = held_first<kSub, 16, 1>(wl);
  const int ru = held_first<kSub, L / 2, 1>(wl);

  // the forward's step r of the staged run on s (none past T)
  auto fwd_step = [&](const float* sm, int r, bool live, float (&s)[kNS],
                      float (&e)[kNS]) {
    const float dtv = sm[S::dt + r];
    const float du = dtv * sm[S::u + r * kCh + ch];
    const float4 bq =
        *reinterpret_cast<const float4*>(&sm[S::b + r * kCols + n0]);
    const float bb4[kNS] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
    for (int i = 0; i < kNS; ++i) {
      e[i] = live ? ex2(dtv * a2[i]) : 1.f;
      s[i] = __fmaf_rn(s[i], e[i], du * bb4[i]);
    }
  };

  // one run: staged in sm, steps [t0, t0 + nr), its start's states c0
  auto walk = [&](const float* sm, int t0, int nr, float4 c0, auto full) {
    constexpr bool kFull = decltype(full)::value;
    constexpr int kQ = kRun / kSub;
    float st[kQ][kNS];                    // the sub-runs' first states
    st[0][0] = c0.x, st[0][1] = c0.y, st[0][2] = c0.z, st[0][3] = c0.w;
#pragma unroll
    for (int q = 1; q < kQ; ++q) {
      float e[kNS];
#pragma unroll
      for (int i = 0; i < kNS; ++i) st[q][i] = st[q - 1][i];
#pragma unroll
      for (int r = (q - 1) * kSub; r < q * kSub; ++r)
        fwd_step(sm, r, kFull || r < nr, st[q], e);
    }
#pragma unroll
    for (int q = kQ - 1; q >= 0; --q) {
      // the sub-run's states before each step and after its last, and its
      // decays (1 past T: the carry passes those steps unchanged)
      float sv[kSub + 1][kNS], ev[kSub][kNS];
#pragma unroll
      for (int i = 0; i < kNS; ++i) sv[0][i] = st[q][i];
#pragma unroll
      for (int r = 0; r < kSub; ++r) {
#pragma unroll
        for (int i = 0; i < kNS; ++i) sv[r + 1][i] = sv[r][i];
        fwd_step(sm, q * kSub + r, kFull || q * kSub + r < nr, sv[r + 1],
                 ev[r]);
      }
      float pu[kSub], pd[kSub];           // sum_n lambda B; gdelta's terms
      float* sw = smem + S::w + wbuf * (S::kWarps * kSub * S::kW);
#pragma unroll
      for (int r = kSub - 1; r >= 0; --r) {
        const int rr = q * kSub + r;
        const float dtv = sm[S::dt + rr];
        const float uv = sm[S::u + rr * kCh + ch];
        const float g = sm[S::g + rr * kCh + ch];
        const float du = dtv * uv;
        const float4 bq =
            *reinterpret_cast<const float4*>(&sm[S::b + rr * kCols + n0]);
        const float4 cq =
            *reinterpret_cast<const float4*>(&sm[S::c + rr * kCols + n0]);
        const float bb4[kNS] = {bq.x, bq.y, bq.z, bq.w};
        const float cc4[kNS] = {cq.x, cq.y, cq.z, cq.w};
        // gdelta_t's terms sum_n lambda (u B + s_{t-1} e A) = u sum_n
        // lambda B + sum_n lambda s_{t-1} e A, the first gu's sum too
        float lam[kNS], vals[2 * kNS], gda = 0.f;
#pragma unroll
        for (int i = 0; i < kNS; ++i) {
          lam[i] = __fmaf_rn(g, cc4[i], carry[i]);
          const float lb = lam[i] * (sv[r][i] * ev[r][i]);  // lambda s e
          gA[i] = __fmaf_rn(lb, dtv, gA[i]);
          gda = __fmaf_rn(lb, a1[i], gda);
          carry[i] = lam[i] * ev[r][i];
          vals[i] = du * lam[i];                           // gB's term
          vals[kNS + i] = g * sv[r + 1][i];                // gC's: gy s_t
        }
        const float lb4 = __fmaf_rn(lam[0], bb4[0], lam[1] * bb4[1]) +
                          __fmaf_rn(lam[2], bb4[2], lam[3] * bb4[3]);
        pu[r] = lb4;
        pd[r] = __fmaf_rn(uv, lb4, gda);
        // gB and gC over the warp's channels: one or two sums a lane
        reduce_lanes<2 * kNS, 16, L>(vals, wl);
#pragma unroll
        for (int j = 0; j < kHeld; ++j) sw[col_b + r * S::kW + j] = vals[j];
      }
      // gdelta over the warp, and gu over the channel's lanes, of the
      // sub-run's kSub steps at once
      reduce_lanes<kSub, 16, 1>(pd, wl);
      if ((wl & 3) == 0) sw[(warp * kSub + rd) * S::kW + 2 * kCols] = pd[0];
      reduce_lanes<kSub, L / 2, 1>(pu, wl);
#pragma unroll
      for (int j = 0; j < kHeldU; ++j) {
        const int rr = q * kSub + ru + j;
        if ((kFull || rr < nr) && d < D)
          gub[static_cast<long long>(t0 + rr) * D + d] =
              sm[S::dt + rr] * pu[j];
      }
      __syncthreads();                    // the warps' sums are in sw
      // the block's sums, warps in order
      for (int i = tid; i < kSub * W; i += S::kThreads) {
        const int r = i / W, x = i - r * W;
        const int col = x < N ? x : x < 2 * N ? kCols + x - N : 2 * kCols;
        float acc = 0.f;
#pragma unroll
        for (int w = 0; w < S::kWarps; ++w)
          acc += sw[(w * kSub + r) * S::kW + col];
        const int t = t0 + q * kSub + r;
        if (kFull || q * kSub + r < nr)
          pb[static_cast<long long>(t) * W + x] = acc;
      }
      wbuf ^= 1;  // the next sub-run writes the other buffer: this one is
                  // read until every thread reaches its __syncthreads
    }
  };

  bwd_stage<L, true>(smem, (k_hi - 1) * kRun, T, D, N, d0, db, bb, cb, ub,
                     gb, v);
  for (int k = k_hi - 1, buf = 0; k >= k_lo; --k, buf ^= 1) {
    const int t0 = k * kRun, nr = min(kRun, T - t0);
    const float4 c0 = d < D ? ckb[static_cast<long long>(k) * D * L]
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    if (k > k_lo) {                       // the run before in flight; its
      bwd_stage<L, true>(smem + (buf ^ 1) * S::stage, t0 - kRun, T, D, N,
                         d0, db, bb, cb, ub, gb, v);  // buffer was freed by
      copy_wait<1>();                     // the last sub-run's barrier
    } else {
      copy_wait<0>();
    }
    __syncthreads();                      // this run is staged
    if (nr == kRun)
      walk(smem + buf * S::stage, t0, nr, c0, std::true_type{});
    else
      walk(smem + buf * S::stage, t0, nr, c0, std::false_type{});
  }
#pragma unroll
  for (int i = 0; i < kNS; ++i) {
    if (d < D && n0 + i < N) {
      if (seg == 0) gs0[si + n0 + i] = carry[i];
      ga_part[(static_cast<long long>(b) * nseg + seg) * D * N +
              static_cast<long long>(d) * N + n0 + i] = gA[i];
    }
  }
}

// The partials summed in a fixed order: part's blocks in block order into
// gbv, gcv (B, T, N) and gdelta (B, T); ga_part's (batch row, segment)
// pairs in order into ga (D, N).
__global__ void ssm_scan_bwd_finish(const float* __restrict__ part,
                                    const float* __restrict__ ga_part,
                                    float* __restrict__ gbv,
                                    float* __restrict__ gcv,
                                    float* __restrict__ gdelta,
                                    float* __restrict__ ga, int nblk,
                                    int nga, int B, int T, int D, int N) {
  const int W = 2 * N + 1;
  const long long rows = static_cast<long long>(B) * T;
  const long long btw = rows * W;
  const long long dn = static_cast<long long>(D) * N;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < btw + dn; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float acc = 0.f;
    if (i < btw) {
      for (int k = 0; k < nblk; ++k) acc += part[k * btw + i];
      const long long row = i / W;
      const int x = static_cast<int>(i - row * W);
      if (x < N)
        gbv[row * N + x] = acc;
      else if (x < 2 * N)
        gcv[row * N + x - N] = acc;
      else
        gdelta[row] = acc;
    } else {
      const long long j = i - btw;
      for (int k = 0; k < nga; ++k) acc += ga_part[k * dn + j];
      ga[j] = acc;
    }
  }
}

// How the backward cuts T: S segments of G runs. The walk's blocks that the
// card holds at once (SMs x resident blocks, asked of the card once per
// device) set S: (D / channels a block) x B x S blocks make about kWaves
// times as many, so that the blocks that end last are short. On the H100
// at hymba's (1, 4096, 3200, 16) that gives 19 segments; 5 (one wave) took
// 5% longer, 32 4% (NVIDIA H100 80GB HBM3 at 700 W; 32 channels a block,
// no register cap or 3 blocks an SM each about 23% longer).
constexpr int kWaves = 4;

struct Plan {
  int S, G;
};

template <int L>
cudaError_t bwd_plan(int B, int T, int D, Plan* plan) {
  using S = Bwd<L>;
  static int slots[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (slots[dev] == 0) {
    err = cudaFuncSetAttribute(ssm_scan_bwd_kernel<L>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               S::kSmem);
    if (err != cudaSuccess) return err;
    int sms = 0, per = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per, ssm_scan_bwd_kernel<L>, S::kThreads, S::kSmem);
    if (err != cudaSuccess) return err;
    slots[dev] = sms * per > 0 ? sms * per : 1;
  }
  const long long per_seg =
      static_cast<long long>((D + S::kCh - 1) / S::kCh) * B;
  const int R = (T + kRun - 1) / kRun;
  const long long want = (kWaves * slots[dev] + per_seg / 2) / per_seg;
  const int s = static_cast<int>(want < 1 ? 1 : want > R ? R : want);
  const int g = (R + s - 1) / s;
  *plan = Plan{(R + g - 1) / g, g};
  return cudaSuccess;
}

// Floats of the backward's scratch: the segments' (c, P), the blocks'
// partials of gB, gC and gdelta, gA's (batch row, segment) partials.
template <int L>
long long bwd_scratch(int B, int T, int D, int N, const Plan& p) {
  using S = Bwd<L>;
  const long long nblk = (D + S::kCh - 1) / S::kCh;
  return 2LL * B * p.S * D * S::kCols + nblk * B * T * (2LL * N + 1) +
         static_cast<long long>(B) * p.S * D * N;
}

template <int L>
cudaError_t launch_bwd(const float* u, const float* dt, const float* bv,
                       const float* cv, const float* a, const float* gy,
                       const float* gsf, const float* ck, float* gu,
                       float* gdelta, float* gbv, float* gcv, float* ga,
                       float* gs0, float* scratch, int B, int T, int D, int N,
                       Views v, cudaStream_t stream) {
  using S = Bwd<L>;
  Plan p{};
  cudaError_t err = bwd_plan<L>(B, T, D, &p);
  if (err != cudaSuccess) return err;
  const int nblk = (D + S::kCh - 1) / S::kCh;
  const long long nsum = static_cast<long long>(B) * p.S * D * L;  // float4s
  auto* sum_c = reinterpret_cast<float4*>(scratch);
  float4* sum_p = sum_c + nsum;
  float* part = reinterpret_cast<float*>(sum_p + nsum);
  float* ga_part = part + static_cast<long long>(nblk) * B * T * (2 * N + 1);
  if (p.S > 1) {
    err = cudaFuncSetAttribute(ssm_scan_bwd_carry_kernel<L>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               2 * S::stage * static_cast<int>(sizeof(float)));
    if (err != cudaSuccess) return err;
    ssm_scan_bwd_carry_kernel<L>
        <<<dim3(nblk, p.S - 1, B), S::kThreads,
           2 * S::stage * sizeof(float), stream>>>(dt, cv, a, gy, sum_c,
                                                   sum_p, T, D, N, p.G, v);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  err = cudaFuncSetAttribute(ssm_scan_bwd_kernel<L>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             S::kSmem);
  if (err != cudaSuccess) return err;
  ssm_scan_bwd_kernel<L><<<dim3(nblk, p.S, B), S::kThreads, S::kSmem,
                           stream>>>(
      u, dt, bv, cv, a, gy, gsf, reinterpret_cast<const float4*>(ck), sum_c,
      sum_p, gu, part, ga_part, gs0, T, D, N, p.G, v);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssm_scan_bwd_finish<<<1056, 256, 0, stream>>>(part, ga_part, gbv, gcv,
                                                gdelta, ga, nblk, B * p.S, B,
                                                T, D, N);
  return cudaGetLastError();
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

// Strides are in elements: (batch, time) of u, delta, bv and cv. ck is
// null, or (B, ceil(T / 32), D, 4 L) float32 for the run checkpoints.
int soar_ssm_scan(const void* u, const void* delta, const void* bv,
                  const void* cv, const void* a, const void* s0, void* y,
                  void* s_out, void* ck, int B, int T, int D, int N,
                  long long u_sb, long long u_st, long long d_sb,
                  long long d_st, long long b_sb, long long b_st,
                  long long c_sb, long long c_st, void* stream_) {
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
  auto* kf = static_cast<float4*>(ck);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  cudaError_t err;
  if (N <= 4)
    err = launch<1>(uf, df, bf, cf, af, sf, yf, of, kf, B, T, D, N, v,
                    stream);
  else if (N <= 8)
    err = launch<2>(uf, df, bf, cf, af, sf, yf, of, kf, B, T, D, N, v,
                    stream);
  else if (N <= 16)
    err = launch<4>(uf, df, bf, cf, af, sf, yf, of, kf, B, T, D, N, v,
                    stream);
  else
    err = launch<8>(uf, df, bf, cf, af, sf, yf, of, kf, B, T, D, N, v,
                    stream);
  return static_cast<int>(err);
}

#define SOAR_BY_LANES(N, F) \
  ((N) <= 4 ? F(1) : (N) <= 8 ? F(2) : (N) <= 16 ? F(4) : F(8))

// The backward's cut of T on the current card: S segments of G runs of 32
// steps (plan[0] = S, plan[1] = G), for (B, T, D, N); a CUDA error code.
int soar_ssm_scan_bwd_plan(int B, int T, int D, int N, int* plan) {
  if (B < 1 || B > 65535 || T < 1 || D < 1 || N < 1 || N > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan p{};
#define SOAR_PLAN(L) bwd_plan<L>(B, T, D, &p)
  const cudaError_t err = SOAR_BY_LANES(N, SOAR_PLAN);
#undef SOAR_PLAN
  plan[0] = p.S;
  plan[1] = p.G;
  return static_cast<int>(err);
}

// Bytes of scratch the backward needs for (B, T, D, N) on the current
// card, or -1 if invalid.
long long soar_ssm_scan_bwd_scratch(int B, int T, int D, int N) {
  int plan[2];
  if (soar_ssm_scan_bwd_plan(B, T, D, N, plan) != 0) return -1;
  const Plan p{plan[0], plan[1]};
#define SOAR_SCRATCH(L) bwd_scratch<L>(B, T, D, N, p)
  return SOAR_BY_LANES(N, SOAR_SCRATCH) *
         static_cast<long long>(sizeof(float));
#undef SOAR_SCRATCH
}

// The backward: the forward's operands but s0 (strided as there), gy (B,
// T, D), gs_final (B, D, N, or null for zero) and the forward's run
// checkpoints ck (B, ceil(T / 32), D, 4 L), contiguous -> gu (B, T, D),
// gdelta (B, T), gbv and gcv (B, T, N), ga (D, N), gs0 (B, D, N), all
// contiguous float32; scratch holds soar_ssm_scan_bwd_scratch bytes.
// Kernels on the stream: the segments' carries (when S > 1), the walk,
// the fixed-order sums.
int soar_ssm_scan_bwd(const void* u, const void* delta, const void* bv,
                      const void* cv, const void* a, const void* gy,
                      const void* gs_final, const void* ck, void* gu,
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
#define SOAR_BWD(L)                                                         \
  launch_bwd<L>(f(u), f(delta), f(bv), f(cv), f(a), f(gy), f(gs_final),     \
                f(ck), w(gu), w(gdelta), w(gbv), w(gcv), w(ga), w(gs0),     \
                w(scratch), B, T, D, N, v, stream)
  const cudaError_t err = SOAR_BY_LANES(N, SOAR_BWD);
#undef SOAR_BWD
  return static_cast<int>(err);
}

#undef SOAR_BY_LANES

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
