// vfl_matmul for Hopper (sm_90a): the whole De-VertiFL first layer of
// every client in one launch.
//
//   y[c, m, :] = sum_{k < sizes[c]} x[m, x_off[c] + k] * W[c, w_off[c] + k, :]
//
// x [M, Kx], W [n, Kw, N], y [n, M, N], all float32 and row-major;
// x_off, w_off, sizes are int32 [n] device arrays.
//
// Replaces the Pallas TPU kernel vfl_matmul_p
// (src/repro/kernels/vfl_matmul/vfl_matmul.py:42), which computes
// zeropad(x_local) @ W as x_local @ W[off:off+K_local] for ONE client
// per call, with a static offset that must be a multiple of its block.
// Here offsets and sizes are runtime values, every client is one
// z-slice of a single grid, and the K, M and N tails are masked in the
// kernel, so any partition (3-wide titanic slices, skewed sizes, dead
// padding slots with size 0) takes the same path.
//
// What bounds it on the H100: the bytes of x and W it reads.  It does
// 2*M*N flops per 4*M bytes of x, with N = 10 hidden units on the
// protocol's path, far below the card's ridge; and at a training
// batch (M = 64) the whole launch moves a few hundred KB, so launch
// latency bounds it before bandwidth does.  The design answers the
// latency with one launch for all clients instead of one per client,
// and the bandwidth by reading each x element of a client's slice
// once per N-tile (one N-tile covers N <= 16) through coalesced rows
// of shared memory.  TMA, wgmma and a persistent grid are later work.
//
// Determinism: each output element is accumulated by one thread in a
// fixed K order, with no atomics, so a client's result does not depend
// on the grid, on M-tiling or on how many (dead) clients ride along.
// Masked tail elements add +-0.0, which leaves every sum unchanged.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;       // rows of x per block
constexpr int BN = 16;       // output columns per block
constexpr int BK = 32;       // K depth staged per shared-memory tile
constexpr int THREADS = 256;
constexpr int TM = BM * BN / THREADS;   // outputs per thread (4 rows)

__global__ void __launch_bounds__(THREADS)
vfl_matmul_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const int* __restrict__ x_off,
                  const int* __restrict__ w_off,
                  const int* __restrict__ sizes, float* __restrict__ y,
                  int M, int Kx, int Kw, int N) {
  const int c = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int xo = x_off[c];
  const int wo = w_off[c];
  // the host validates the layout; clamping keeps a bad one in bounds
  int K = sizes[c];
  if (xo < 0 || wo < 0) K = 0;
  K = max(0, min(K, min(Kx - xo, Kw - wo)));

  // x tile stored K-major; the +1 pad makes the transposing store
  // conflict-free (row stride 65 words)
  __shared__ float xs[BK][BM + 1];
  __shared__ float ws[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % BN;          // output column within the tile
  const int ty = tid / BN;          // owns rows ty*TM .. ty*TM+TM-1
  const float* wc = w + (size_t)c * Kw * N;

  float acc[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // consecutive threads read consecutive k of one x row: coalesced
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, kk = e % BK;
      const int m = m0 + r, k = k0 + kk;
      xs[kk][r] = (m < M && k < K) ? x[(size_t)m * Kx + xo + k] : 0.f;
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int kk = e / BN, nn = e % BN;
      const int k = k0 + kk, n = n0 + nn;
      ws[kk][nn] = (k < K && n < N) ? wc[(size_t)(wo + k) * N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float b = ws[kk][tx];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        acc[i] = fmaf(xs[kk][ty * TM + i], b, acc[i]);
    }
    __syncthreads();
  }

  const int n = n0 + tx;
  if (n >= N) return;
  float* yc = y + (size_t)c * M * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m < M) yc[(size_t)m * N + n] = acc[i];   // size 0 writes zeros
  }
}

}  // namespace

// Enqueues the kernel on `stream` and returns cudaGetLastError(), so a
// refused launch is reported to the caller; it does not synchronise.
extern "C" int vfl_matmul_launch(const void* x, const void* w,
                                 const void* x_off, const void* w_off,
                                 const void* sizes, void* y,
                                 int n_clients, int M, int Kx, int Kw,
                                 int N, void* stream) {
  if (n_clients == 0 || M == 0 || N == 0) return (int)cudaSuccess;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, n_clients);
  vfl_matmul_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const int*>(x_off), static_cast<const int*>(w_off),
      static_cast<const int*>(sizes), static_cast<float*>(y),
      M, Kx, Kw, N);
  return (int)cudaGetLastError();
}
