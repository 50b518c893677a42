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
// Fusing the discretisation (a = exp(dt A), bx = dt x B) into the kernel
// would leave only the [B, T, D] and [B, T, N] inputs to read: later work.
//
// Determinism: no atomics; the sum over n is a butterfly in a fixed order,
// so reruns are bitwise and a channel does not depend on the others.

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
