// rwkv6_scan for Hopper (sm_90a): the RWKV6 "Finch" WKV recurrence, with
// the state carried in and out.
//
//   o[b, t, h, j] = sum_i r[b, t, h, i] * (S[i, j] + u[h, i] * kv[i, j])
//   S[i, j]      <- w[b, t, h, i] * S[i, j] + kv[i, j]
//   kv[i, j]      = k[b, t, h, i] * v[b, t, h, j]
//
// for t = 0 .. T-1 in order, per (b, h), from S = s0[b, h] (zeros when s0
// is null); the final S is written to s_out[b, h].  r, k, v, w [B, T, H, hd]
// contiguous, float32 or bfloat16 (one type), u float32 [H, hd], s0 and
// s_out float32 [B, H, hd, hd] (row i, column j), hd 64 or 128; o
// [B, T, H, hd] in the inputs' type.  s_out may be s0: the serving path's
// decode writes the new state over the old one in place.  Every product
// and sum is float32.  What it computes is ref.py's rwkv6_scan_ref.
//
// Replaces the Pallas TPU kernel rwkv6_scan_p
// (src/repro/kernels/rwkv6_scan/rwkv6_scan.py:59), whose grid
// (B, H, T / chunk) runs the chunks of one (b, h) in order on one core with
// the [hd, hd] state in VMEM scratch, starting from zeros and returning
// only o.  Here the time axis is a loop inside one block, so T need not be
// a multiple of any chunk, and the state comes in and goes out.
//
// Work of one block: one (b, h).  Thread j owns column j of the state, hd
// floats in registers.  The block stages CT = 2048 / hd time steps of r, k,
// w and v in shared memory (one coalesced row of hd values per step and
// input), then walks them in order: each step every thread reads r, k, w
// and u by broadcast from shared memory, so a step is 3 hd dependent-free
// FMAs a thread and one dot product over i, kept in four partial sums.
//
// What bounds it on the H100: the function needs 5 hd^2 + 5 hd operations
// per (b, t, h) step, since o[j] = sum_i r[i] S[i, j] + v[j] * sum_i r[i]
// u[i] k[i] (2 hd^2 + 5 hd) and the update is 3 hd^2 (1.02 GFLOP at
// rwkv6-1.6b's prefill of T = 1536, H = 32, hd = 64: 0.015 ms at 67
// TFLOP/s in float32), and it moves 5 B T H hd * 4 bytes (63 MB: 0.019
// ms), so it is bound by bytes.  This design is bound by neither (and
// spends 7 hd^2 a step, the bonus as a second rank-1 term inside the dot
// product): each block walks T in series, and at a prefill (B = 1) there
// are only H = 32 blocks of hd threads for 132 SMs, so the time is T steps
// of one block's latency.  A chunk-parallel form (the state's decay products within a chunk, then a
// scan over chunks) is later work.
//
// Determinism: no atomics; each output is one thread's sum over i in a
// fixed order, so reruns are bitwise and a (b, h) does not depend on the
// others.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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

template <int HD, typename T>
__global__ void __launch_bounds__(HD)
rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ w,
                  const float* __restrict__ u, const float* s0,
                  T* __restrict__ o, float* s_out, int steps, int H) {
  constexpr int CT = 2048 / HD;   // time steps staged per pass
  __shared__ float sr[CT][HD], sk[CT][HD], sw[CT][HD], sv[CT][HD];
  __shared__ float su[HD];
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int j = threadIdx.x;

  float S[HD];
  const long long sbase = (long long)bh * HD * HD + j;
#pragma unroll
  for (int i = 0; i < HD; ++i) S[i] = s0 ? s0[sbase + (long long)i * HD] : 0.f;
  su[j] = u[h * HD + j];

  const long long row = (long long)H * HD;          // stride of one step
  const long long base = (long long)b * steps * row + (long long)h * HD + j;
  for (int t0 = 0; t0 < steps; t0 += CT) {
    const int n = min(CT, steps - t0);
    __syncthreads();                                // previous pass done
    for (int i = 0; i < n; ++i) {
      const long long at = base + (long long)(t0 + i) * row;
      sr[i][j] = to_f32(r[at]);
      sk[i][j] = to_f32(k[at]);
      sw[i][j] = to_f32(w[at]);
      sv[i][j] = to_f32(v[at]);
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const float vj = sv[i][j];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < HD; ++c) {
        const float kv = sk[i][c] * vj;
        acc[c & 3] += sr[i][c] * (S[c] + su[c] * kv);
        S[c] = sw[i][c] * S[c] + kv;
      }
      o[base + (long long)(t0 + i) * row] =
          from_f32<T>((acc[0] + acc[1]) + (acc[2] + acc[3]));
    }
  }
#pragma unroll
  for (int i = 0; i < HD; ++i) s_out[sbase + (long long)i * HD] = S[i];
}

template <int HD, typename T>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const float* u, const float* s0, void* o,
                   float* s_out, int B, int steps, int H,
                   cudaStream_t stream) {
  rwkv6_scan_kernel<HD, T><<<(unsigned)(B * H), HD, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w), u, s0,
      static_cast<T*>(o), s_out, steps, H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* r, const void* k, const void* v,
                     const void* w, const float* u, const float* s0, void* o,
                     float* s_out, int B, int steps, int H, int hd,
                     cudaStream_t s) {
  switch (hd) {
    case 64: return launch<64, T>(r, k, v, w, u, s0, o, s_out, B, steps, H, s);
    case 128:
      return launch<128, T>(r, k, v, w, u, s0, o, s_out, B, steps, H, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the CUDA error of the launch (0 on success); cudaErrorInvalidValue
// for a shape the kernel does not take (hd other than 64, 128).
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const void* w, const float* u,
                                 const float* s0, void* o, float* s_out,
                                 int B, int steps, int H, int hd, int bf16,
                                 void* stream) {
  if (B < 1 || steps < 1 || H < 1 || (long long)B * H > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)dispatch<__nv_bfloat16>(r, k, v, w, u, s0, o, s_out, B,
                                        steps, H, hd, s);
  return (int)dispatch<float>(r, k, v, w, u, s0, o, s_out, B, steps, H, hd,
                              s);
}
