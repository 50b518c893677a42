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
// What bounds it on the H100: at a training batch (M = 64, mnist's 5
// clients) the launch moves ~250 KB, 0.00007 ms of HBM time, so latency
// bounds it: the launch itself, the round trip to device memory a block
// waits on, and the K-long chain of dependent FMAs each output is (its
// sum order is fixed, below).  At the evaluation's M = 14,000 it is the
// 44 MB of x (2 N flops per 4 bytes of x: far below the card's ridge),
// and on the way there the shared-memory or L1 reads that feed the
// FMAs.  Two kernels, chosen on the host by ops.plan() from the shapes
// alone:
//
//   wave   (M <= ops.WAVE_MAX_M and the widest slice fits in shared
//          memory): a block owns WAVE_BM rows of one client and issues
//          every load of its slice at once -- x [WAVE_BM, K] and the
//          contiguous run W[c, w_off : w_off+K, :] -- by cp.async (16
//          bytes a copy where alignment allows), waits once, then
//          multiplies, a thread an output.  One round trip a block
//          instead of one per K-tile, and 4 x 5 = 20 blocks at mnist's
//          batch instead of 5; bn = min(N, 16) threads across the
//          columns of an N-tile, so at N = 10 none idles.
//   ring   (otherwise): a block owns RING_BM rows and walks K in
//          RING_BK-deep tiles through a ring of RING_STAGES cp.async
//          stages, so the next tiles load while this one is multiplied;
//          a thread keeps RING_TM rows of one column.  At M = 14,000 it
//          is bound by shared-memory reads (each x value read there
//          serves one product; a 16-byte read takes four passes of the
//          shared-memory pipe) and by the copies' issue; a thread owning
//          a row of every column, or streaming x from device memory into
//          registers, measured slower on the card (PERF.md).
//
// Numerics, the same in both kernels: each output is summed by one
// thread, acc = fmaf(x, w, acc), in ascending k from the client's slice
// start, float32 on the CUDA cores (no tensor cores, no split-K, no
// atomics).  So reruns are bitwise, and a client's result does not depend
// on the grid, the M tiling, the kernel chosen or the dead clients riding
// along.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// must agree with ops.py's plan(); the launcher refuses any other value
constexpr int WAVE_BM = 16;      // rows of x per wave block, one per thread
constexpr int RING_BM = 64;      // rows of x per ring block
constexpr int RING_TM = 4;       // rows per thread in the ring
constexpr int RING_BK = 32;      // K depth of a ring stage
constexpr int RING_STAGES = 4;
constexpr int RING_LDX = RING_BK + 4;  // padded x row: 16-byte aligned,
                                       // rows 4 banks apart
constexpr int BN_MAX = 16;       // columns of an N-tile
constexpr int SMEM_MAX = 232448; // a block's shared memory on sm_90

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from gmem to smem; only the first `bytes` are read, the rest
// of the 16 are written as zeros (bytes 0: all zeros, gmem not read)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(bytes));
}

// 4 bytes, the same way (bytes 0 or 4)
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// the client's slice length; the host validates the layout, clamping
// keeps a bad one in bounds
__device__ __forceinline__ int slice_len(const int* x_off, const int* w_off,
                                         const int* sizes, int c, int Kx,
                                         int Kw, int* xo, int* wo) {
  *xo = x_off[c];
  *wo = w_off[c];
  int K = sizes[c];
  if (*xo < 0 || *wo < 0) K = 0;
  return max(0, min(K, min(Kx - *xo, Kw - *wo)));
}

// ---------------------------------------------------------------------------
// wave: the whole slice in one round trip
__global__ void __launch_bounds__(WAVE_BM * BN_MAX)
vfl_matmul_wave_kernel(const float* __restrict__ x,
                       const float* __restrict__ w,
                       const int* __restrict__ x_off,
                       const int* __restrict__ w_off,
                       const int* __restrict__ sizes, float* __restrict__ y,
                       int M, int Kx, int Kw, int N, int bn, int ldx) {
  extern __shared__ __align__(16) float smem[];
  const int c = blockIdx.z;
  const int m0 = blockIdx.y * WAVE_BM;
  const int n0 = blockIdx.x * bn;
  const int tid = threadIdx.x, nt = blockDim.x;
  int xo, wo;
  const int K = slice_len(x_off, w_off, sizes, c, Kx, Kw, &xo, &wo);

  float* xs = smem;                       // [WAVE_BM][ldx]
  float* ws = smem + WAVE_BM * ldx;       // the run W[c, wo:wo+K, :]
  // x[m0 + r, xo : xo+K] into xs[r * ldx ..]; rows past M are zeros.
  // 16-byte copies when every row of the slice is 16-byte aligned (the
  // last copy of a row reads up to K and zero-fills the rest)
  if ((Kx % 4 == 0) && (xo % 4 == 0) && aligned16(x)) {
    const int groups = (K + 3) / 4;
    for (int e = tid; e < WAVE_BM * groups; e += nt) {
      const int r = e / groups, k = 4 * (e % groups);
      const int m = m0 + r;
      const int bytes = m < M ? 4 * min(4, K - k) : 0;
      cp_async16(xs + r * ldx + k, bytes ? x + (size_t)m * Kx + xo + k : x,
                 bytes);
    }
  } else {
    for (int e = tid; e < WAVE_BM * K; e += nt) {
      const int r = e / K, k = e % K;
      const int m = m0 + r;
      cp_async4(xs + r * ldx + k, m < M ? x + (size_t)m * Kx + xo + k : x,
                m < M ? 4 : 0);
    }
  }

  // W[c, wo:wo+K, 0:N] is one contiguous run of K*N floats; stored at
  // ws[shift + i] for run element i, so that shared and global addresses
  // agree mod 16 bytes and the middle of the run goes by 16-byte copies
  const size_t start = ((size_t)c * Kw + wo) * N;
  const int len = K * N;
  const float* run = w + start;
  const int shift = aligned16(w) ? (int)(start & 3) : 0;
  const int head = aligned16(w) ? min(len, (4 - shift) & 3) : len;
  const int groups = (len - head) / 4;
  for (int i = tid; i < head; i += nt) cp_async4(ws + shift + i, run + i, 4);
  for (int g = tid; g < groups; g += nt)
    cp_async16(ws + shift + head + 4 * g, run + head + 4 * g, 16);
  for (int i = head + 4 * groups + tid; i < len; i += nt)
    cp_async4(ws + shift + i, run + i, 4);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int r = tid / bn, n = n0 + tid % bn;   // threads: WAVE_BM * bn
  const float* xr = xs + r * ldx;
  const float* wn = ws + shift + min(n, N - 1);
  float acc = 0.f;
#pragma unroll 8
  for (int k = 0; k < K; ++k) acc = fmaf(xr[k], wn[(size_t)k * N], acc);
  const int m = m0 + r;
  if (m < M && n < N) y[((size_t)c * M + m) * N + n] = acc;  // size 0: 0
}

// ---------------------------------------------------------------------------
// ring: K-tiles through RING_STAGES cp.async stages; a thread keeps
// RING_TM rows of one column
__global__ void __launch_bounds__(RING_BM / RING_TM * BN_MAX)
vfl_matmul_ring_kernel(const float* __restrict__ x,
                       const float* __restrict__ w,
                       const int* __restrict__ x_off,
                       const int* __restrict__ w_off,
                       const int* __restrict__ sizes, float* __restrict__ y,
                       int M, int Kx, int Kw, int N, int bn) {
  extern __shared__ __align__(16) float smem[];
  float (*xs)[RING_BM][RING_LDX] =
      reinterpret_cast<float (*)[RING_BM][RING_LDX]>(smem);
  float (*ws)[RING_BK][BN_MAX] = reinterpret_cast<float (*)[RING_BK][BN_MAX]>(
      smem + RING_STAGES * RING_BM * RING_LDX);
  const int c = blockIdx.z;
  const int m0 = blockIdx.y * RING_BM;
  const int n0 = blockIdx.x * bn;
  const int tid = threadIdx.x, nt = blockDim.x;
  int xo, wo;
  const int K = slice_len(x_off, w_off, sizes, c, Kx, Kw, &xo, &wo);
  const bool vec_x = (Kx % 4 == 0) && (xo % 4 == 0) && aligned16(x);
  const float* wc = w + (size_t)c * Kw * N;
  const int tiles = (K + RING_BK - 1) / RING_BK;

  // tile t into stage s: x [RING_BM, RING_BK] and W [RING_BK, bn], the
  // elements past K, M or N zero-filled (the index arithmetic on
  // compile-time tile sizes: shifts, not divisions)
  auto load = [&](int t, int s) {
    const int k0 = t * RING_BK;
    if (vec_x) {
      constexpr int G = RING_BK / 4;      // 16-byte copies a row
      for (int e = tid; e < RING_BM * G; e += nt) {
        const int r = e / G, k = k0 + 4 * (e % G);
        const int m = m0 + r;
        const int bytes = m < M ? 4 * max(0, min(4, K - k)) : 0;
        cp_async16(&xs[s][r][4 * (e % G)],
                   bytes ? x + (size_t)m * Kx + xo + k : x, bytes);
      }
    } else {
      for (int e = tid; e < RING_BM * RING_BK; e += nt) {
        const int r = e / RING_BK, kk = e % RING_BK;
        const int m = m0 + r, k = k0 + kk;
        const bool in = m < M && k < K;
        cp_async4(&xs[s][r][kk], in ? x + (size_t)m * Kx + xo + k : x,
                  in ? 4 : 0);
      }
    }
    for (int e = tid; e < RING_BK * BN_MAX; e += nt) {
      const int kk = e / BN_MAX, nn = e % BN_MAX;
      const int k = k0 + kk, n = n0 + nn;
      const bool in = k < K && nn < bn && n < N;
      cp_async4(&ws[s][kk][nn], in ? wc + (size_t)(wo + k) * N + n : wc,
                in ? 4 : 0);
    }
  };

#pragma unroll
  for (int s = 0; s < RING_STAGES - 1; ++s) {
    if (s < tiles) load(s, s);
    cp_async_commit();
  }

  const int tx = tid % bn, ty = tid / bn;   // rows ty*RING_TM .. +RING_TM
  float acc[RING_TM];
#pragma unroll
  for (int i = 0; i < RING_TM; ++i) acc[i] = 0.f;

  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<RING_STAGES - 2>();
    __syncthreads();   // tile t landed; the stage of tile t-1 is free
    const int next = t + RING_STAGES - 1;
    if (next < tiles) load(next, next % RING_STAGES);
    cp_async_commit();
    const int s = t % RING_STAGES;
#pragma unroll
    for (int kk = 0; kk < RING_BK; kk += 4) {
      float b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[s][kk + j][tx];
#pragma unroll
      for (int i = 0; i < RING_TM; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(
            &xs[s][ty * RING_TM + i][kk]);
        acc[i] = fmaf(a.x, b[0], acc[i]);
        acc[i] = fmaf(a.y, b[1], acc[i]);
        acc[i] = fmaf(a.z, b[2], acc[i]);
        acc[i] = fmaf(a.w, b[3], acc[i]);
      }
    }
  }
  cp_async_wait<0>();

  const int n = n0 + tx;
  if (n >= N) return;
  float* yc = y + (size_t)c * M * N;
#pragma unroll
  for (int i = 0; i < RING_TM; ++i) {
    const int m = m0 + ty * RING_TM + i;
    if (m < M) yc[(size_t)m * N + n] = acc[i];   // size 0 writes zeros
  }
}

__global__ void empty_kernel() {}

}  // namespace

// Enqueues the kernel ops.plan() chose on `stream` and returns
// cudaGetLastError(), so a refused launch is reported to the caller; it
// does not synchronise.  `kind` 0 is the wave kernel, 1 the ring;
// `bm`, `bn`, `threads`, `ldx` and `smem` are the plan's, checked here
// against the kernels' constants (cudaErrorInvalidValue if they disagree).
extern "C" int vfl_matmul_launch(const void* x, const void* w,
                                 const void* x_off, const void* w_off,
                                 const void* sizes, void* y, int n_clients,
                                 int M, int Kx, int Kw, int N, int kind,
                                 int bm, int bn, int threads, int ldx,
                                 int smem, void* stream) {
  if (n_clients == 0 || M == 0 || N == 0) return (int)cudaSuccess;
  const bool bm_ok = kind ? bm == RING_BM : bm == WAVE_BM;
  const int want_threads = (kind ? RING_BM / RING_TM : WAVE_BM) * bn;
  if (!bm_ok || bn < 1 || bn > BN_MAX || bn > N ||
      threads != want_threads || smem < 0 || smem > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  // shared memory above 48 KB, asked once a device
  static unsigned opted_in = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 32 && !(opted_in >> dev & 1u)) {
    err = cudaFuncSetAttribute(vfl_matmul_wave_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    opted_in |= 1u << dev;
  }
  const dim3 grid((N + bn - 1) / bn, (M + bm - 1) / bm, n_clients);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const int* xo = static_cast<const int*>(x_off);
  const int* wo = static_cast<const int*>(w_off);
  const int* sz = static_cast<const int*>(sizes);
  float* yf = static_cast<float*>(y);
  if (kind) {
    if (smem != RING_STAGES * (RING_BM * RING_LDX + RING_BK * BN_MAX) * 4)
      return (int)cudaErrorInvalidValue;
    vfl_matmul_ring_kernel<<<grid, threads, smem, s>>>(xf, wf, xo, wo, sz,
                                                       yf, M, Kx, Kw, N, bn);
  } else {
    const int kmax = Kx < Kw ? Kx : Kw;
    if (ldx % 4 != 0 || ldx < kmax ||
        smem < (WAVE_BM * ldx + kmax * N + 3) * 4)
      return (int)cudaErrorInvalidValue;
    vfl_matmul_wave_kernel<<<grid, threads, smem, s>>>(
        xf, wf, xo, wo, sz, yf, M, Kx, Kw, N, bn, ldx);
  }
  return (int)cudaGetLastError();
}

// An empty kernel, one block of 32 threads: chip_smoke.py times it in the
// same CUDA-graph harness as the kernels, the launch floor a kernel of
// vfl_matmul's size cannot go under.
extern "C" int vfl_matmul_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
