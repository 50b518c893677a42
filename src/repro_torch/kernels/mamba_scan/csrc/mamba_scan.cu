// mamba_scan for Hopper (sm_90a): the Mamba (S6) selective scan, with the
// state carried in and out.
//
//   h[b, d, n]    <- a[b, t, d, n] * h[b, d, n] + bx[b, t, d, n]
//   y[b, t, d]     = sum_n h[b, d, n] * c[b, t, n]
//
// for t = 0 .. T-1 in order, from h = h0[b] (zeros when h0 is null); the
// final h is written to h_out[b].  a, bx [B, T, D, N] and c [B, T, N]
// contiguous, float32 or bfloat16 (one type), h0 and h_out float32
// [B, D, N]; y [B, T, D] in the inputs' type.  h_out may be h0: the serving
// path's decode writes the new state over the old one in place.  Every
// product and sum is float32.  What it computes is ref.py's mamba_scan_ref.
//
// Replaces the Pallas TPU kernel mamba_scan_p
// (src/repro/kernels/mamba_scan/mamba_scan.py:55), whose grid
// (B, D / bd, T / chunk) runs the chunks of one channel tile in order on
// one core with the [bd, N] state in VMEM scratch, starting from zeros and
// returning only y.  Here the time axis is a loop inside each thread, so T
// need not be a multiple of any chunk (a decode step is T = 1), D need not
// be a multiple of the tile, and the state comes in and goes out.
//
// Work of one block: 256 threads, one per (d, n) state element of
// 256 / N neighbouring channels of one batch row (16 channels at N = 16,
// 512 blocks at jamba's D = 8192).  The thread keeps its h in a register
// and walks T: it loads a and bx (the block's loads of one step are one
// contiguous run of 256 values), updates h with one FMA, and the N lanes
// of a channel sum h * c by a shuffle butterfly; lane 0 of the channel
// writes y.  The loads of U = 8 steps are issued before their updates, so
// each thread keeps 2 U loads in flight.
//
// What bounds it on the H100: the bytes, 2 B T D N * 4 of a and bx read
// once (1.61 GB at jamba's prefill of T = 1536: 0.48 ms at 3.35 TB/s);
// the 4 operations per state element and step are 0.012 ms at 67 TFLOP/s.
// The serving path does not materialise a and bx: it calls the fused
// kernel below, which forms them in registers.
//
// Determinism: no atomics; the sum over n is a butterfly in a fixed order,
// so reruns are bitwise and a channel does not depend on the others.
//
// ---------------------------------------------------------------------------
// mamba_scan_fused: the discretisation and the scan in one kernel.
//
//   a      = exp(dt[b, t, d] * A[d, n])            (the product rounded first)
//   bx     = (dt[b, t, d] * x[b, t, d]) * B[b, t, n]
//   h      = a * h + bx
//   y[b, t, d] = sum_n h * C[b, t, n]
//
// dt [B, T, D] float32 (softplus's output), x [B, T, D] and B, C [B, T, N]
// float32 or bfloat16 (the model's type; B and C may be the row-strided
// views of the x projection they are split from), A [D, N] float32, h0 and
// h_out [B, D, N] float32 (h_out may be h0), y [B, T, D] float32.  What it
// computes is ref.py's mamba_scan_fused_ref: the model's discretisation
// (models/ssm.py, the reference's src/repro/models/ssm.py:94-97) followed
// by mamba_scan_ref.  exp is the full-precision expf.
//
// What bounds it: the unfused kernel's interface is [B, T, D, N] float32 a
// and bx, 16x the [B, T, D] inputs they are made from; here only dt, x, B,
// C, A and the state are read and y written (110 MB at jamba's T = 1326,
// bf16: 0.033 ms at 3.35 TB/s), and the B T D N exponentials on the SFUs
// (16 a clock per SM: 0.042 ms) bound it harder.  Past both sits the
// instruction stream: a full-precision expf is 8 instructions, a state
// element and step about 17 in all, so at B = 1 the 1,024 warps issue for
// about 0.09 ms.  Design:
//
//   - a block owns CH = 128 / L channels of one batch row, a thread FS = 4
//     states of one channel (L = N / 4 lanes a channel), with its A and h
//     in registers for the whole call: 256 blocks of 128 threads at
//     jamba's D = 8192, N = 16;
//   - T is staged in chunks of TC steps (32 at N = 16) through a ring of
//     FSTAGES cp.async stages holding dt and x [TC, CH] and B, C [TC, N],
//     so chunk i + 1 loads while chunk i is scanned; each staged row of dt
//     is a contiguous run of 128 bytes;
//   - a chunk is scanned FU = 8 steps at a time: their inputs are loaded
//     first and their exponentials, which do not depend on h, overlap;
//   - the y sum crosses the L lanes of a channel by a shuffle butterfly in
//     a fixed order, and the chunk's y goes out as coalesced rows through
//     shared memory;
//   - a decode step (T = 1) is its own kernel: no staging, float4 state
//     loads and stores, dt and x read once a channel.
//
// Every step's arithmetic is the same whatever the chunking, so reruns are
// bitwise and a run split at any step is bitwise one run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int U = 8;                 // steps whose loads are issued together
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int N, typename T>
__global__ void __launch_bounds__(THREADS)
mamba_scan_kernel(const T* __restrict__ a, const T* __restrict__ bx,
                  const T* __restrict__ c, const float* h0,
                  T* __restrict__ y, float* h_out, int steps, int D) {
  constexpr int CH = THREADS / N;    // channels per block
  const int n = threadIdx.x % N;
  const int d = blockIdx.x * CH + threadIdx.x / N;
  const int b = blockIdx.y;
  const bool live = d < D;           // the last tile may be short
  const long long state = ((long long)b * D + d) * N + n;
  float h = (live && h0) ? h0[state] : 0.f;

  const long long step = (long long)D * N;
  const T* pa = a + (long long)b * steps * step + (long long)d * N + n;
  const T* pb = bx + (long long)b * steps * step + (long long)d * N + n;
  const T* pc = c + (long long)b * steps * N + n;
  T* py = y + (long long)b * steps * D + d;

  for (int t0 = 0; t0 < steps; t0 += U) {
    float av[U], bv[U], cv[U];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int t = t0 + i;
      const bool in = t < steps;
      av[i] = (in && live) ? to_f32(pa[t * step]) : 0.f;
      bv[i] = (in && live) ? to_f32(pb[t * step]) : 0.f;
      cv[i] = in ? to_f32(pc[(long long)t * N]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < U; ++i) {
      if (t0 + i >= steps) break;    // uniform across the block
      h = __fmaf_rn(av[i], h, bv[i]);
      float p = h * cv[i];
#pragma unroll
      for (int off = N / 2; off > 0; off >>= 1)
        p += __shfl_xor_sync(FULL, p, off, N);
      if (live && n == 0) py[(long long)(t0 + i) * D] = from_f32<T>(p);
    }
  }
  if (live) h_out[state] = h;
}

template <int N, typename T>
cudaError_t launch(const void* a, const void* bx, const void* c,
                   const float* h0, void* y, float* h_out, int B, int steps,
                   int D, cudaStream_t stream) {
  constexpr int CH = THREADS / N;
  const dim3 grid((unsigned)((D + CH - 1) / CH), (unsigned)B);
  mamba_scan_kernel<N, T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(bx),
      static_cast<const T*>(c), h0, static_cast<T*>(y), h_out, steps, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* a, const void* bx, const void* c,
                     const float* h0, void* y, float* h_out, int B,
                     int steps, int D, int N, cudaStream_t s) {
  switch (N) {
    case 8: return launch<8, T>(a, bx, c, h0, y, h_out, B, steps, D, s);
    case 16: return launch<16, T>(a, bx, c, h0, y, h_out, B, steps, D, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// mamba_scan_fused (see the note at the top)
constexpr int FTHREADS = 128;
constexpr int FS = 4;                // states a thread
constexpr int FSTAGES = 3;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from gmem to smem, or 16 zeros when `in` is false
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int K>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(K) : "memory");
}

// four neighbouring values as float
__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  o[0] = q.x; o[1] = q.y; o[2] = q.z; o[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&o)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  o[0] = __uint_as_float(q.x << 16);
  o[1] = __uint_as_float(q.x & 0xffff0000u);
  o[2] = __uint_as_float(q.y << 16);
  o[3] = __uint_as_float(q.y & 0xffff0000u);
}

// one step of one thread's FS states: h <- exp(dt A) h + (dt x) B, and the
// thread's part of y, sum_s h C in a fixed order
__device__ __forceinline__ float fused_step(float dtv, float xv,
                                            const float (&bv)[FS],
                                            const float (&cv)[FS],
                                            const float (&av)[FS],
                                            float (&h)[FS]) {
  const float dx = dtv * xv;
#pragma unroll
  for (int i = 0; i < FS; ++i) {
    const float a = expf(dtv * av[i]);
    h[i] = __fmaf_rn(a, h[i], dx * bv[i]);
  }
  float p = h[0] * cv[0];
#pragma unroll
  for (int i = 1; i < FS; ++i) p = __fmaf_rn(h[i], cv[i], p);
  return p;
}

// the sum of p over the L lanes of a channel, the same in every lane
template <int L>
__device__ __forceinline__ float lanes_sum(float p) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    p += __shfl_xor_sync(FULL, p, off, L);
  return p;
}

constexpr int FU = 8;                // steps scanned together

template <int N, typename T>
__global__ void __launch_bounds__(FTHREADS)
mamba_scan_fused_kernel(const float* __restrict__ dt,
                        const T* __restrict__ x, const T* __restrict__ Bm,
                        const T* __restrict__ Cm, long long bc_row,
                        long long bc_batch, const float* __restrict__ A,
                        const float* h0, float* __restrict__ y,
                        float* h_out, int steps, int D, int vec) {
  // FS states a thread, L lanes a channel, CH channels a block (a staged
  // dt row of 128 or 256 bytes), TC steps a chunk
  constexpr int L = N / FS, CH = FTHREADS / L, TC = 1024 / CH;
  constexpr int NT = FTHREADS;
  static_assert(TC % FU == 0, "a chunk is whole groups of steps");
  constexpr int XP = 16 / (int)sizeof(T);   // elements of x a 16-byte copy
  __shared__ __align__(16) float sdt[FSTAGES][TC][CH];
  __shared__ __align__(16) T sx[FSTAGES][TC][CH];
  __shared__ __align__(16) T sb[FSTAGES][TC][N];
  __shared__ __align__(16) T sc[FSTAGES][TC][N];
  __shared__ float sy[TC][CH];

  const int tid = threadIdx.x;
  const int lane = tid % L, ch = tid / L;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CH, d = d0 + ch, n0 = lane * FS;
  const bool live = d < D;
  float av[FS], h[FS];
#pragma unroll
  for (int i = 0; i < FS; ++i) {
    av[i] = live ? A[(long long)d * N + n0 + i] : 0.f;
    h[i] = (live && h0) ? h0[((long long)b * D + d) * N + n0 + i] : 0.f;
  }
  const float* dtb = dt + (long long)b * steps * D;
  const T* xb = x + (long long)b * steps * D;
  const T* bb = Bm + (long long)b * bc_batch;
  const T* cb = Cm + (long long)b * bc_batch;

  // chunk k's rows into stage s: cp.async when every row is 16-byte
  // aligned (the host's `vec`), else plain loads; zeros past T and D
  auto stage = [&](int k, int s) {
    const int t0 = k * TC;
    if (vec) {
      for (int q = tid; q < TC * CH / 4; q += NT) {
        const int t = q / (CH / 4), c = 4 * (q % (CH / 4));
        const bool in = t0 + t < steps && d0 + c < D;
        cp_async16(&sdt[s][t][c],
                   in ? dtb + (long long)(t0 + t) * D + d0 + c : dt, in);
      }
      for (int q = tid; q < TC * CH / XP; q += NT) {
        const int t = q / (CH / XP), c = XP * (q % (CH / XP));
        const bool in = t0 + t < steps && d0 + c < D;
        cp_async16(&sx[s][t][c],
                   in ? xb + (long long)(t0 + t) * D + d0 + c : x, in);
      }
      constexpr int BP = N / XP;      // 16-byte copies a row of B or C
      for (int q = tid; q < 2 * TC * BP; q += NT) {
        const int which = q / (TC * BP), t = q / BP % TC, n = XP * (q % BP);
        const bool in = t0 + t < steps;
        const T* src = (which ? cb : bb) + (long long)(t0 + t) * bc_row + n;
        cp_async16(which ? &sc[s][t][n] : &sb[s][t][n], in ? src : x, in);
      }
    } else {
      for (int e = tid; e < TC * CH; e += NT) {
        const int t = e / CH, c = e % CH;
        const bool in = t0 + t < steps && d0 + c < D;
        const long long at = (long long)(t0 + t) * D + d0 + c;
        sdt[s][t][c] = in ? dtb[at] : 0.f;
        sx[s][t][c] = in ? xb[at] : from_f32<T>(0.f);
      }
      for (int e = tid; e < TC * N; e += NT) {
        const int t = e / N, n = e % N;
        const bool in = t0 + t < steps;
        const long long at = (long long)(t0 + t) * bc_row + n;
        sb[s][t][n] = in ? bb[at] : from_f32<T>(0.f);
        sc[s][t][n] = in ? cb[at] : from_f32<T>(0.f);
      }
    }
  };

  const int chunks = (steps + TC - 1) / TC;
#pragma unroll
  for (int s = 0; s < FSTAGES - 1; ++s) {
    if (s < chunks) stage(s, s);
    cp_async_commit();
  }
  for (int k = 0; k < chunks; ++k) {
    cp_async_wait<FSTAGES - 2>();
    __syncthreads();     // chunk k landed; chunk k-1's stage and sy are free
    if (k + FSTAGES - 1 < chunks)
      stage(k + FSTAGES - 1, (k + FSTAGES - 1) % FSTAGES);
    cp_async_commit();
    const int s = k % FSTAGES, t0 = k * TC;
    const int n = min(TC, steps - t0);
    // FU steps at a time: their inputs loaded first, then their updates
    // (the exponentials of FU steps are independent of each other and of
    // h), then their y sums, so the loads need not wait on the stores
    auto group = [&](int t, bool guard) {
      float dtv[FU], xv[FU], bv[FU][FS], cv[FU][FS], p[FU];
#pragma unroll
      for (int u = 0; u < FU; ++u) {
        dtv[u] = sdt[s][t + u][ch];
        xv[u] = to_f32(sx[s][t + u][ch]);
        load4(&sb[s][t + u][n0], bv[u]);
        load4(&sc[s][t + u][n0], cv[u]);
      }
#pragma unroll
      for (int u = 0; u < FU; ++u) {
        p[u] = 0.f;
        if (!guard || t + u < n)
          p[u] = fused_step(dtv[u], xv[u], bv[u], cv[u], av, h);
      }
#pragma unroll
      for (int u = 0; u < FU; ++u) {
        const float q = lanes_sum<L>(p[u]);
        if (lane == 0) sy[t + u][ch] = q;
      }
    };
    if (n == TC) {
#pragma unroll 1
      for (int t = 0; t < TC; t += FU) group(t, false);
    } else {
#pragma unroll 1
      for (int t = 0; t < n; t += FU) group(t, true);
    }
    __syncthreads();
    for (int e = tid; e < n * CH; e += NT) {
      const int t = e / CH, c = e % CH;
      if (d0 + c < D) y[((long long)b * steps + t0 + t) * D + d0 + c] =
          sy[t][c];
    }
  }
  cp_async_wait<0>();
  if (live) {
#pragma unroll
    for (int i = 0; i < FS; ++i)
      h_out[((long long)b * D + d) * N + n0 + i] = h[i];
  }
}

// a decode step, T = 1: no staging; the state, A, B and C by 16- (or 8-)
// byte loads when the host's `vec` says they are aligned
template <int N, typename T>
__global__ void __launch_bounds__(FTHREADS)
mamba_scan_fused_step_kernel(const float* __restrict__ dt,
                             const T* __restrict__ x,
                             const T* __restrict__ Bm,
                             const T* __restrict__ Cm, long long bc_batch,
                             const float* __restrict__ A, const float* h0,
                             float* __restrict__ y, float* h_out, int D,
                             int vec) {
  constexpr int L = N / FS;
  constexpr int CH = FTHREADS / L;
  const int lane = threadIdx.x % L;
  const int b = blockIdx.y;
  const int d = blockIdx.x * CH + threadIdx.x / L, n0 = lane * FS;
  const bool live = d < D;
  const int dd = live ? d : D - 1;     // dead lanes read a live channel
  const long long st = ((long long)b * D + dd) * N + n0;
  float av[FS], h[FS] = {0.f, 0.f, 0.f, 0.f}, bv[FS], cv[FS];
  const T* bp = Bm + (long long)b * bc_batch + n0;
  const T* cp = Cm + (long long)b * bc_batch + n0;
  if (vec) {
    load4(A + (long long)dd * N + n0, av);
    if (h0) load4(h0 + st, h);
    load4(bp, bv);
    load4(cp, cv);
  } else {
#pragma unroll
    for (int i = 0; i < FS; ++i) {
      av[i] = A[(long long)dd * N + n0 + i];
      if (h0) h[i] = h0[st + i];
      bv[i] = to_f32(bp[i]);
      cv[i] = to_f32(cp[i]);
    }
  }
  const long long at = (long long)b * D + dd;
  const float p = lanes_sum<L>(
      fused_step(dt[at], to_f32(x[at]), bv, cv, av, h));
  if (!live) return;
  if (lane == 0) y[at] = p;
  if (vec) {
    *reinterpret_cast<float4*>(h_out + st) = make_float4(h[0], h[1], h[2],
                                                         h[3]);
  } else {
#pragma unroll
    for (int i = 0; i < FS; ++i) h_out[st + i] = h[i];
  }
}

template <int N, typename T>
cudaError_t launch_fused(const void* dt, const void* x, const void* Bm,
                         const void* Cm, long long bc_row, long long bc_batch,
                         const float* A, const float* h0, float* y,
                         float* h_out, int B, int steps, int D, int vec,
                         cudaStream_t stream) {
  constexpr int CH = FTHREADS / (N / FS);
  const dim3 grid((unsigned)((D + CH - 1) / CH), (unsigned)B);
  const float* dtf = static_cast<const float*>(dt);
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(Bm);
  const T* ct = static_cast<const T*>(Cm);
  if (steps == 1)
    mamba_scan_fused_step_kernel<N, T><<<grid, FTHREADS, 0, stream>>>(
        dtf, xt, bt, ct, bc_batch, A, h0, y, h_out, D, vec);
  else
    mamba_scan_fused_kernel<N, T><<<grid, FTHREADS, 0, stream>>>(
        dtf, xt, bt, ct, bc_row, bc_batch, A, h0, y, h_out, steps, D, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_fused(const void* dt, const void* x, const void* Bm,
                           const void* Cm, long long bc_row,
                           long long bc_batch, const float* A,
                           const float* h0, float* y, float* h_out, int B,
                           int steps, int D, int N, int vec,
                           cudaStream_t s) {
  switch (N) {
    case 8: return launch_fused<8, T>(dt, x, Bm, Cm, bc_row, bc_batch, A, h0,
                                      y, h_out, B, steps, D, vec, s);
    case 16: return launch_fused<16, T>(dt, x, Bm, Cm, bc_row, bc_batch, A,
                                        h0, y, h_out, B, steps, D, vec, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the CUDA error of the launch (0 on success); cudaErrorInvalidValue
// for a shape the kernel does not take (N other than 8 and 16, jamba's
// and the reduced configs'; B above the grid's 65535 rows).
extern "C" int mamba_scan_launch(const void* a, const void* bx, const void* c,
                                 const float* h0, void* y, float* h_out,
                                 int B, int steps, int D, int N, int bf16,
                                 void* stream) {
  if (B < 1 || B > 65535 || steps < 1 || D < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)dispatch<__nv_bfloat16>(a, bx, c, h0, y, h_out, B, steps, D,
                                        N, s);
  return (int)dispatch<float>(a, bx, c, h0, y, h_out, B, steps, D, N, s);
}

// The fused scan (see the note above): dt [B, T, D] float32, x [B, T, D]
// and B, C [B, T, N] (rows bc_row elements apart, batches bc_batch) in one
// type (bf16 set: bfloat16, else float32), A [D, N], h0 (or null: zeros)
// and h_out [B, D, N], y [B, T, D] float32.  `vec`: the host found every
// row the kernel stages or loads by 16 bytes 16-byte aligned.  Returns the
// CUDA error of the launch; cudaErrorInvalidValue for N other than 8 and
// 16 or B above the grid's 65535 rows.
extern "C" int mamba_scan_fused_launch(const void* dt, const void* x,
                                       const void* Bm, const void* Cm,
                                       long long bc_row, long long bc_batch,
                                       const float* A, const float* h0,
                                       float* y, float* h_out, int B,
                                       int steps, int D, int N, int bf16,
                                       int vec, void* stream) {
  if (B < 1 || B > 65535 || steps < 1 || D < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)dispatch_fused<__nv_bfloat16>(dt, x, Bm, Cm, bc_row, bc_batch,
                                              A, h0, y, h_out, B, steps, D, N,
                                              vec, s);
  return (int)dispatch_fused<float>(dt, x, Bm, Cm, bc_row, bc_batch, A, h0, y,
                                    h_out, B, steps, D, N, vec, s);
}
