// moe_router for Hopper (sm_90a): the MoE layer's routing, one pass over
// the router logits.
//
//   p[t, :]     = softmax(logits[t, :]) over the E experts, float32
//   idx[t, j]   = the j-th largest p[t, :] (j < k), largest first, the
//                 lowest index first among equal values: k distinct indices
//   w[t, j]     = p[t, idx[t, j]] / sum_j' p[t, idx[t, j']], the sum taken
//                 in pick order
//   stats[i, e] = sum over the rows t of tile i (bt rows, the last tile
//                 its real rows only) of (e picked in row t) + p[t, e]
//
// logits float32 [T, E], contiguous, any T >= 1, E <= 256, k <= 8; w float32
// [T, k], idx int32 [T, k], stats float32 [ceil(T / bt), E].  What it
// computes is ref.py's moe_router_ref, the order of lax.top_k.
//
// Replaces the Pallas TPU kernel moe_router_p
// (src/repro/kernels/moe_router/moe_router.py:51), whose grid (T / bt,)
// runs one [bt, E] tile of VMEM per step: a softmax on the tile, then k
// argmax sweeps that mask each pick by multiplying by (1 - onehot).  This
// kernel does not copy two things of that body: a multiplied-out pick is
// picked again once the rest of the row is exactly 0 (probabilities that
// underflow), so here a pick is marked taken instead; and the tile need
// not divide T.
//
// Work of one block: one tile of bt rows.  Each of its 16 warps takes rows
// warp, warp + 16, ... of the tile, one row at a time: lane l holds
// experts l, l + 32, ... in registers (NV = ceil(E / 32) values, rounded
// up to 1, 2, 4 or 8), the max and the sum of the softmax are warp
// shuffles, and each of the k picks is a local best then a shuffle
// butterfly over (value, index) pairs under the order (larger value, then
// lower index), so every lane ends with the same pick.  The owner lane
// marks it taken.  Each lane also keeps the stats of its experts over its
// warp's rows in registers; at the end the warps' partials go through
// shared memory and thread e sums expert e's over the warps in warp order.
//
// What bounds it on the H100: the bytes, T * E * 4 read and T * k * 8 plus
// the stats written (470 KB at T = 1536, E = 64, k = 6: 0.14 us at
// 3.35 TB/s); at a decode step's T = 8 the launch latency.  The arithmetic
// is a few operations per logit and k shuffle butterflies per row, so this
// simple design is latency-bound: a row's picks are k dependent butterflies.
//
// Determinism: no atomics; every sum runs in a fixed order (lanes by a
// fixed butterfly, rows in a warp's order, warps in index order), so
// reruns are bitwise, and a row's weights and indices do not depend on the
// other rows.

#include <cuda_runtime.h>
#include <climits>
#include <cmath>

namespace {

constexpr int WARPS = 16;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_E = 256;
constexpr int MAX_K = 8;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// (v, e) comes before (bv, be): a larger value, or an equal one at a lower
// index
__device__ __forceinline__ bool before(float v, int e, float bv, int be) {
  return v > bv || (v == bv && e < be);
}

template <int NV>
__global__ void __launch_bounds__(THREADS)
moe_router_kernel(const float* __restrict__ logits, float* __restrict__ w,
                  int* __restrict__ idx, float* __restrict__ stats, int T,
                  int E, int k, int bt) {
  __shared__ float part[WARPS][MAX_E];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row0 = (long long)blockIdx.x * bt;
  const long long row_end = min(row0 + bt, (long long)T);

  float acc[NV];  // this warp's stats of experts lane + 32 v
#pragma unroll
  for (int v = 0; v < NV; ++v) acc[v] = 0.f;

  for (long long r = row0 + warp; r < row_end; r += WARPS) {
    const float* x = logits + r * E;
    float p[NV];
    unsigned pad = 0;  // bit v: expert lane + 32 v does not exist
    float m = -INFINITY;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int e = lane + 32 * v;
      if (e < E) {
        p[v] = x[e];
        m = fmaxf(m, p[v]);
      } else {
        p[v] = 0.f;
        pad |= 1u << v;
      }
    }
    m = warp_max(m);
    float s = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      if (!(pad >> v & 1u)) {
        p[v] = expf(p[v] - m);
        s += p[v];
      }
    }
    s = warp_sum(s);
#pragma unroll
    for (int v = 0; v < NV; ++v) p[v] = p[v] / s;

    unsigned taken = pad;
    float total = 0.f, my_w = 0.f;
    int my_i = 0;
    for (int j = 0; j < k; ++j) {
      float bv = -INFINITY;
      int be = INT_MAX;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int e = lane + 32 * v;
        if (!(taken >> v & 1u) && before(p[v], e, bv, be)) {
          bv = p[v];
          be = e;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(FULL, bv, off);
        const int oe = __shfl_xor_sync(FULL, be, off);
        if (before(ov, oe, bv, be)) {
          bv = ov;
          be = oe;
        }
      }
      if (be < E && (be & 31) == lane) taken |= 1u << (be >> 5);
      total += bv;
      if (lane == j) {
        my_w = bv;
        my_i = be;
      }
    }
    if (lane < k) {
      w[r * k + lane] = my_w / total;
      idx[r * k + lane] = my_i;
    }
#pragma unroll
    for (int v = 0; v < NV; ++v)
      if (!(pad >> v & 1u))
        acc[v] += ((taken >> v & 1u) ? 1.f : 0.f) + p[v];
  }

#pragma unroll
  for (int v = 0; v < NV; ++v)
    if (lane + 32 * v < E) part[warp][lane + 32 * v] = acc[v];
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += THREADS) {
    float s = part[0][e];
#pragma unroll
    for (int i = 1; i < WARPS; ++i) s += part[i][e];
    stats[(long long)blockIdx.x * E + e] = s;
  }
}

template <int NV>
cudaError_t launch(const float* logits, float* w, int* idx, float* stats,
                   int T, int E, int k, int bt, cudaStream_t stream) {
  const unsigned tiles = (unsigned)((T + (long long)bt - 1) / bt);
  moe_router_kernel<NV><<<tiles, THREADS, 0, stream>>>(logits, w, idx,
                                                       stats, T, E, k, bt);
  return cudaGetLastError();
}

}  // namespace

// Returns the CUDA error of the launch (0 on success); cudaErrorInvalidValue
// for a shape the kernel does not take.
extern "C" int moe_router_launch(const float* logits, float* w, int* idx,
                                 float* stats, int T, int E, int k, int bt,
                                 void* stream) {
  if (T < 1 || E < 1 || E > MAX_E || k < 1 || k > MAX_K || k > E || bt < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E <= 32) return (int)launch<1>(logits, w, idx, stats, T, E, k, bt, s);
  if (E <= 64) return (int)launch<2>(logits, w, idx, stats, T, E, k, bt, s);
  if (E <= 128) return (int)launch<4>(logits, w, idx, stats, T, E, k, bt, s);
  return (int)launch<8>(logits, w, idx, stats, T, E, k, bt, s);
}
