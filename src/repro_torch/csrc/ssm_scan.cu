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
