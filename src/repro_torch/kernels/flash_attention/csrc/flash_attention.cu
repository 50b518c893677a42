// flash_attention for Hopper (sm_90a): forward attention with an
// online softmax, for the LM's prefill and decode.
//
//   o[b, h, i, :] = sum_j softmax_j(s[i, j]) * v[b, h / group, j, :]
//   s[i, j] = cap * tanh(scale * q[b, h, i, :] . k[b, h / group, j, :] / cap)
//
// over the keys j that row i sees:
//   k_pos[j] >= 0 && (k_pos[j] <= q_pos[i] if causal)
//                 && (q_pos[i] - k_pos[j] < window if window)
// with q_pos / k_pos an int32 [Sq] or [B, Sq] (resp. Skv) array, or,
// when null, the index itself.  A row that sees no key gives 0.
// q, k, v, o are read and written through element strides for the
// (b, head, position) axes, with unit stride along hd, so the model's
// [B, S, H, hd] activations and [B, size, KV, hd] cache are used with no
// transposing copy.  float32 or bfloat16 in and out; every sum is float32.
//
// Replaces the Pallas TPU kernel flash_attention_p
// (src/repro/kernels/flash_attention/flash_attention.py:88), whose grid
// (B, H, Sq/bq, Skv/bk) runs the kv axis in order on one core and keeps
// the running max, denominator and accumulator in VMEM scratch.  Here the
// kv axis is a loop inside the block and that state lives in registers.
//
// Work of one block: batch b, kv head kvh, and a tile of BQ "rows", a row
// being one (query position i, head of kvh's group) pair, position-major.
// So the group's GQA heads share every K/V tile the block loads (kv head
// h / group is indexed, never copied), and a decode step (Sq = 1) still
// fills a block with the group's heads.  Each warp owns RPW rows; lane j
// scores key j of a 32-key tile against them, then owns output dims
// lane, lane + 32, ... in the P.V sum.  A kv tile is skipped when its
// positions prove every element of it masked for every row of the block
// (causal future, outside the window, or unwritten ring slots with
// position -1); without explicit key positions the causal and window
// bounds also cut the loop's range, as the Pallas kernel's block skip does.
//
// What bounds it on the H100: in prefill, the operations (4 * hd flops per
// visible (query, key) pair, about 7.5 GFLOP per qwen2-7b layer at
// S = 1024); in decode, the bytes of the K/V cache (33.5 MB per layer at
// B = 8 over 2048 slots).  This first design computes on the CUDA cores
// in float32 (fmaf), reads each K/V tile once per block through shared
// memory with 16-byte loads, and skips masked tiles, so it is far from
// the tensor-core bound in prefill.  wgmma with TMA-fed tiles, warp
// specialisation and split-K decode are later work.
//
// Determinism: each output row is reduced by one warp over the kv tiles
// in a fixed order, with no atomics, and a row's arithmetic does not
// depend on which other rows share its block, so reruns are bitwise and
// the result does not depend on the batch.  A skipped or fully masked
// tile leaves a row's state exactly as it was.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int BK = 32;          // keys per tile: one per lane
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* q_pos;             // null: position = index
  const int* k_pos;
  long long qsb, qsh, qss;      // element strides of (b, head, position)
  long long ksb, ksh, kss;
  long long vsb, vsh, vss;
  long long osb, osh, oss;
  long long qpb, kpb;           // batch strides of q_pos, k_pos (0: shared)
  int group, Sq, Skv;
  int causal, window;           // window 0: none
  float softcap, scale;         // softcap 0: none
};

// 16 bytes of T (4 floats or 8 bf16) as floats
template <typename T>
__device__ __forceinline__ void load16(const T* src, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  if constexpr (std::is_same<T, float>::value) {
    dst[0] = __uint_as_float(raw.x);
    dst[1] = __uint_as_float(raw.y);
    dst[2] = __uint_as_float(raw.z);
    dst[3] = __uint_as_float(raw.w);
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      dst[2 * i] = f.x;
      dst[2 * i + 1] = f.y;
    }
  }
}

// n (4 or 8) floats to 16-byte-aligned shared memory, 16 bytes a store
__device__ __forceinline__ void store16(float* dst, const float* src,
                                        int n) {
#pragma unroll
  for (int i = 0; i < n; i += 4)
    *reinterpret_cast<float4*>(dst + i) =
        make_float4(src[i], src[i + 1], src[i + 2], src[i + 3]);
}

template <typename T>
__device__ __forceinline__ T from_float(float x) {
  if constexpr (std::is_same<T, float>::value) {
    return x;
  } else {
    return __float2bfloat16_rn(x);
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(FULL, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(FULL, x, off);
  return x;
}

__device__ __forceinline__ bool sees(int qp, int kp, const Params& p) {
  return kp >= 0 && (!p.causal || kp <= qp) &&
         (!p.window || (long long)qp - kp < p.window);
}

template <int HD, int RPW>
constexpr size_t smem_bytes() {
  // Q [BQ][HD], K [BK][HD + 4], V [BK][HD] as float, key and row positions
  return sizeof(float) * ((size_t)WARPS * RPW * HD + BK * (HD + 4) +
                          BK * HD) +
         sizeof(int) * (BK + WARPS * RPW);
}

template <typename T, int HD, int RPW>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const Params p) {
  constexpr int BQ = WARPS * RPW;
  constexpr int KST = HD + 4;          // K row stride: conflict-free float4
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int CPR = HD / VEC;        // 16-byte chunks per row
  constexpr int DPL = HD / 32;         // output dims per lane

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * HD;
  float* Vs = Ks + BK * KST;
  int* kpos_s = reinterpret_cast<int*>(Vs + BK * HD);
  int* qpos_s = kpos_s + BK;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int group = p.group;
  const int rows = p.Sq * group;
  const int row0 = blockIdx.x * BQ;

  const T* qb = static_cast<const T*>(p.q) + b * p.qsb;
  const T* kb = static_cast<const T*>(p.k) + b * p.ksb + kvh * p.ksh;
  const T* vb = static_cast<const T*>(p.v) + b * p.vsb + kvh * p.vsh;

  // the block's query rows, as float, and their positions
  for (int e = tid; e < BQ * CPR; e += THREADS) {
    const int r = e / CPR, c = e % CPR, row = row0 + r;
    float t[VEC];
    if (row < rows) {
      const int i = row / group, h = kvh * group + row % group;
      load16<T>(qb + h * p.qsh + i * p.qss + c * VEC, t);
    } else {
#pragma unroll
      for (int x = 0; x < VEC; ++x) t[x] = 0.f;
    }
    store16(Qs + r * HD + c * VEC, t, VEC);
  }
  if (tid < BQ) {
    const int row = row0 + tid, i = row / group;
    qpos_s[tid] = row < rows ? (p.q_pos ? p.q_pos[b * p.qpb + i] : i) : 0;
  }
  __syncthreads();

  int qmin = INT_MAX, qmax = INT_MIN;
  for (int r = 0; r < BQ && row0 + r < rows; ++r) {
    qmin = min(qmin, qpos_s[r]);
    qmax = max(qmax, qpos_s[r]);
  }

  float m[RPW], l[RPW], acc[RPW][DPL];
  int qp[RPW];
  bool live_row[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[r][d] = 0.f;
    qp[r] = qpos_s[warp * RPW + r];
    live_row[r] = row0 + warp * RPW + r < rows;
  }

  int t_begin = 0, t_end = (p.Skv + BK - 1) / BK;
  if (!p.k_pos) {                       // key j sits at position j
    if (p.causal) t_end = qmax < 0 ? 0 : min(t_end, qmax / BK + 1);
    if (p.window) {
      const long long first = (long long)qmin - p.window + 1;
      t_begin = first <= 0 ? 0 : (int)(first / BK);
    }
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();                    // the last tile's reads are done
    bool tile_live = false;
    if (tid < BK) {
      const int j = k0 + tid;
      int kp = -1;
      if (j < p.Skv) kp = p.k_pos ? p.k_pos[b * p.kpb + j] : j;
      kpos_s[tid] = kp;
      tile_live = kp >= 0 && (!p.causal || kp <= qmax) &&
                  (!p.window || (long long)qmin - kp < p.window);
    }
    if (!__syncthreads_or(tile_live)) continue;

    // K and V tiles as float; slots past Skv or at position < 0 are zero
    for (int e = tid; e < BK * CPR; e += THREADS) {
      const int j = e / CPR, c = e % CPR;
      float tk[VEC], tv[VEC];
      if (k0 + j < p.Skv && kpos_s[j] >= 0) {
        load16<T>(kb + (long long)(k0 + j) * p.kss + c * VEC, tk);
        load16<T>(vb + (long long)(k0 + j) * p.vss + c * VEC, tv);
      } else {
#pragma unroll
        for (int x = 0; x < VEC; ++x) tk[x] = tv[x] = 0.f;
      }
      store16(Ks + j * KST + c * VEC, tk, VEC);
      store16(Vs + j * HD + c * VEC, tv, VEC);
    }
    __syncthreads();

    // scores of key `lane` against the warp's rows
    float s[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) s[r] = 0.f;
    const float* krow = Ks + lane * KST;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(Qs + (warp * RPW + r) * HD + d);
        s[r] = fmaf(qv.x, kv.x, s[r]);
        s[r] = fmaf(qv.y, kv.y, s[r]);
        s[r] = fmaf(qv.z, kv.z, s[r]);
        s[r] = fmaf(qv.w, kv.w, s[r]);
      }
    }

    // online softmax: the running max m, denominator l and accumulator
    const int kp = kpos_s[lane];
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      float x = s[r] * p.scale;
      if (p.softcap != 0.f) x = p.softcap * tanhf(x / p.softcap);
      const bool ok = live_row[r] && sees(qp[r], kp, p);
      const float m_new = fmaxf(m[r], warp_max(ok ? x : -INFINITY));
      float pr = 0.f, alpha = 1.f;
      if (m_new != -INFINITY) {         // warp-uniform
        pr = ok ? expf(x - m_new) : 0.f;
        alpha = expf(m[r] - m_new);
      }
      l[r] = alpha * l[r] + warp_sum(pr);
#pragma unroll
      for (int d = 0; d < DPL; ++d) acc[r][d] *= alpha;
      m[r] = m_new;
      s[r] = pr;
    }

    // acc += p . V, key by key in order
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float vv[DPL];
#pragma unroll
      for (int d = 0; d < DPL; ++d) vv[d] = Vs[j * HD + lane + 32 * d];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float pj = __shfl_sync(FULL, s[r], j);
#pragma unroll
        for (int d = 0; d < DPL; ++d) acc[r][d] = fmaf(pj, vv[d], acc[r][d]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    if (!live_row[r]) continue;
    const int row = row0 + warp * RPW + r;
    const int i = row / group, h = kvh * group + row % group;
    T* orow = static_cast<T*>(p.o) + b * p.osb + h * p.osh + i * p.oss;
#pragma unroll
    for (int d = 0; d < DPL; ++d)
      orow[lane + 32 * d] =
          from_float<T>(l[r] == 0.f ? 0.f : acc[r][d] / l[r]);
  }
}

template <typename T, int HD, int RPW>
cudaError_t launch(const Params& p, int B, int KV, cudaStream_t stream) {
  constexpr int BQ = WARPS * RPW;
  constexpr size_t smem = smem_bytes<HD, RPW>();
  auto kernel = flash_attention_kernel<T, HD, RPW>;
  // above 48 KB a block's shared memory must be asked for; once per
  // instantiation (it is a property of the function, not of a launch)
  static cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  const long long rows = (long long)p.Sq * p.group;
  const dim3 grid((unsigned)((rows + BQ - 1) / BQ), KV, B);
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_hd(const Params& p, int B, int KV, cudaStream_t stream) {
  // a decode step's rows are the group's heads (7 for qwen2-7b): 2 rows
  // a warp keep the four warps busy; prefill takes 8 rows a warp
  if ((long long)p.Sq * p.group <= 2 * WARPS)
    return launch<T, HD, 2>(p, B, KV, stream);
  return launch<T, HD, 8>(p, B, KV, stream);
}

template <typename T>
cudaError_t launch_t(const Params& p, int B, int KV, int hd,
                     cudaStream_t stream) {
  switch (hd) {
    case 64: return launch_hd<T, 64>(p, B, KV, stream);
    case 128: return launch_hd<T, 128>(p, B, KV, stream);
    case 256: return launch_hd<T, 256>(p, B, KV, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 14 int64 values -- q (b, h, s), k (b, h, s), v (b, h, s),
// o (b, h, s), then the batch strides of q_pos and k_pos.  Returns the
// CUDA error of the launch (0 on success).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, const int* q_pos,
    const int* k_pos, int is_bf16, int B, int H, int KV, int Sq, int Skv,
    int hd, const long long* strides, int causal, int window, float softcap,
    float scale, void* stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Skv < 0 ||
      B > 65535 || KV > 65535)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.q_pos = q_pos; p.k_pos = k_pos;
  p.qsb = strides[0]; p.qsh = strides[1]; p.qss = strides[2];
  p.ksb = strides[3]; p.ksh = strides[4]; p.kss = strides[5];
  p.vsb = strides[6]; p.vsh = strides[7]; p.vss = strides[8];
  p.osb = strides[9]; p.osh = strides[10]; p.oss = strides[11];
  p.qpb = strides[12]; p.kpb = strides[13];
  p.group = H / KV; p.Sq = Sq; p.Skv = Skv;
  p.causal = causal; p.window = window;
  p.softcap = softcap; p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_t<__nv_bfloat16>(p, B, KV, hd, s)
              : launch_t<float>(p, B, KV, hd, s);
  return (int)err;
}
