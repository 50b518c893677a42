// flash_attention for Hopper (sm_90a) on the CUDA cores: forward
// attention with an online softmax, float32 sums, for what the tensor-core
// kernels of flash_attention_wgmma.cu do not take (float32), and the
// combine kernel of every split-K decode.  The wrapper (ops.py) picks the
// route by the call's shape and dtype.  The kernels also take bf16 (every
// head dim): no route sends it here, but chip_smoke.py times them on the
// tensor-core route's inputs as the "before" of that route.
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
// the running max, denominator and accumulator in VMEM scratch.
//
// Rows: a row is one (query position i, head of kv head kvh's group) pair,
// position-major, so the group's GQA heads share every K/V tile a block
// loads (kv head h / group is indexed, never copied), and a decode step
// (Sq = 1) still fills a block with the group's heads.
//
// "cuda_cores", flash_attention_kernel: float32 prefill.  One block per
// (batch, kv head, tile of rows); the kv axis a loop inside it, the
// online-softmax state in registers.  Each warp owns RPW rows; lane j
// scores key j of a 32-key tile against them,
// then owns output dims lane, lane + 32, ... in the P.V sum.  A kv tile is
// skipped when its positions prove every element of it masked for every row of
// the block (causal future, outside the window, or unwritten ring slots at
// position -1); without explicit key positions the causal and window bounds
// also cut the loop's range, as the Pallas kernel's block skip does.  Bound by
// operations (4 * hd flops per visible pair); it runs them as float32 FMAs, far
// from the card's peak: no served model is float32.
//
// "split_k", decode_partial_kernel + decode_combine_kernel: every call of at
// most 64 rows (a decode step: 7 rows for qwen2-7b, 1 for deepseek) in float32
// (bf16, the served models, takes flash_attention_wgmma.cu's split-K partials
// and this combine). Bound by the bytes of the K/V cache (a few flops a
// byte); the work is to spread the slots
// over the card and keep their bytes in flight.  The kv axis is cut into splits
// of SPLIT slots (the count depends on Skv alone, never on the batch), one
// block of 8 warps per (split, kv head, batch), one warp per 32-slot tile of
// the split.  A warp whose tile holds no key that a row of the block sees does
// nothing; otherwise lane j reads slot j's key row with 16-byte loads (4 in
// flight) and scores it against up to 8 rows at a time, then the warp reads the
// value rows coalesced, 8 in flight, each lane owning hd / 32 output dims.
// Slots at -1 are not read.  The block merges its warps' partials of a row in
// warp order and writes the row's (m, l, o[hd]) in float32 to a workspace the
// wrapper allocates; a split no row sees writes l = 0 and stops.  The combine
// kernel, one warp a row, merges a row's partials in split order:
//   o = sum_s e^(m_s - M) o_s / sum_s e^(m_s - M) l_s
// over the splits with l_s > 0.
//
// Determinism: each output row is reduced in a fixed order (cuda_cores: one
// warp over the kv tiles; split_k: one warp a tile, then one warp over the
// tiles of a split, then one over the splits), with no atomics, and a
// row's arithmetic does not depend on which other rows share its block
// (rows are scored and normalised one by one), so reruns are bitwise and
// the result does not depend on the batch.  A skipped or fully masked tile
// leaves a row's state exactly as it was.

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
constexpr int RPW = 8;          // flash_attention_kernel: rows per warp
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

template <int HD>
constexpr size_t smem_bytes() {
  // Q [BQ][HD], K [BK][HD + 4], V [BK][HD] as float, key and row positions
  return sizeof(float) * ((size_t)WARPS * RPW * HD + BK * (HD + 4) +
                          BK * HD) +
         sizeof(int) * (BK + WARPS * RPW);
}

template <typename T, int HD>
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

template <typename T, int HD>
cudaError_t launch(const Params& p, int B, int KV, cudaStream_t stream) {
  constexpr int BQ = WARPS * RPW;
  constexpr size_t smem = smem_bytes<HD>();
  auto kernel = flash_attention_kernel<T, HD>;
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

template <typename T>
cudaError_t launch_t(const Params& p, int B, int KV, int hd,
                     cudaStream_t stream) {
  switch (hd) {
    case 64: return launch<T, 64>(p, B, KV, stream);
    case 128: return launch<T, 128>(p, B, KV, stream);
    case 256: return launch<T, 256>(p, B, KV, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// route 2: split-K decode

constexpr int SPLIT = 256;               // kv slots a split (ops.SPLIT_SLOTS)
constexpr int DWARPS = SPLIT / BK;       // one warp a 32-slot tile
constexpr int DTHREADS = DWARPS * 32;
constexpr int MAX_ROWS = 64;             // ops.DECODE_ROWS
constexpr int CR = 8;                    // rows a warp carries at once

// shared memory of a partial block: key and row positions, tile flags,
// each warp's partials of CR rows (o[HD], m, l), the rows of q as float
template <int HD>
constexpr size_t decode_smem_bytes(int rows) {
  return sizeof(int) * (SPLIT + MAX_ROWS + DWARPS) +
         sizeof(float) * ((size_t)DWARPS * CR * (HD + 2) +
                          (size_t)((rows + CR - 1) / CR * CR) * HD);
}

// N consecutive elements of T (4 to 32 bytes, aligned to their size) as
// floats
template <typename T, int N>
__device__ __forceinline__ void load_n(const T* src, float* dst) {
  constexpr int BYTES = N * (int)sizeof(T);
  if constexpr (BYTES >= 16) {
    constexpr int E = 16 / sizeof(T);
#pragma unroll
    for (int i = 0; i < N; i += E) load16<T>(src + i, dst + i);
  } else if constexpr (std::is_same<T, float>::value) {
    const float2 f = *reinterpret_cast<const float2*>(src);   // 8 bytes
    dst[0] = f.x;
    dst[1] = f.y;
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(src);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      dst[2 * i] = f.x;
      dst[2 * i + 1] = f.y;
    }
  }
}

// One split of one (batch, kv head): each row's max m, denominator l and
// unnormalised o over the split's slots, to ws_ml [row][split][2] and
// ws_o [row][split][HD], row = (b * KV + kvh) * rows + r.  Warp w takes
// slots 32 w ... 32 w + 31 of the split (skipped when no row sees one of
// them) for CR rows at a time: lane j scores slot j, reading its key row
// with 16-byte loads, and owns dims DPL lane ... in the P.V sum, reading a
// value row coalesced; slots at -1 are not read.  The warps' partials of
// a row are then merged in warp order by one warp.
template <typename T, int HD>
__global__ void __launch_bounds__(DTHREADS)
decode_partial_kernel(const Params p, float* ws_o, float* ws_ml,
                      int splits) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = HD / VEC;
  constexpr int DPL = HD / 32;
  constexpr int PW = HD + 2;

  extern __shared__ float4 smem4[];
  int* kpos_s = reinterpret_cast<int*>(smem4);
  int* qpos_s = kpos_s + SPLIT;
  int* live_s = qpos_s + MAX_ROWS;
  float* part = reinterpret_cast<float*>(live_s + DWARPS);
  float* Qs = part + DWARPS * CR * PW;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int group = p.group, rows = p.Sq * group;
  const int rows_pad = (rows + CR - 1) / CR * CR;
  const int slot0 = split * SPLIT;

  const T* qb = static_cast<const T*>(p.q) + b * p.qsb;
  const T* kb = static_cast<const T*>(p.k) + b * p.ksb + kvh * p.ksh;
  const T* vb = static_cast<const T*>(p.v) + b * p.vsb + kvh * p.vsh;

  for (int e = tid; e < SPLIT; e += DTHREADS) {
    const int j = slot0 + e;
    kpos_s[e] = j < p.Skv ? (p.k_pos ? p.k_pos[b * p.kpb + j] : j) : -1;
  }
  for (int e = tid; e < rows_pad * CPR; e += DTHREADS) {
    const int r = e / CPR, c = e % CPR;
    float t[VEC];
    if (r < rows) {
      const int i = r / group, h = kvh * group + r % group;
      load16<T>(qb + h * p.qsh + (long long)i * p.qss + c * VEC, t);
    } else {
#pragma unroll
      for (int x = 0; x < VEC; ++x) t[x] = 0.f;
    }
    store16(Qs + r * HD + c * VEC, t, VEC);
  }
  if (tid < rows) {
    const int i = tid / group;
    qpos_s[tid] = p.q_pos ? p.q_pos[b * p.qpb + i] : i;
  }
  __syncthreads();

  int qmin = INT_MAX, qmax = INT_MIN;
  for (int r = 0; r < rows; ++r) {
    qmin = min(qmin, qpos_s[r]);
    qmax = max(qmax, qpos_s[r]);
  }
  const int kp = kpos_s[warp * BK + lane];      // this lane's slot
  {
    const bool live = kp >= 0 && (!p.causal || kp <= qmax) &&
                      (!p.window || (long long)qmin - kp < p.window);
    const unsigned any = __any_sync(FULL, live);
    if (lane == 0) live_s[warp] = any ? 1 : 0;
  }
  __syncthreads();
  bool any_live = false;
#pragma unroll
  for (int w = 0; w < DWARPS; ++w) any_live |= live_s[w] != 0;
  const long long rec0 =
      ((long long)b * gridDim.y + kvh) * rows * splits + split;
  if (!any_live) {                     // no row sees a key of this split
    if (tid < rows) {
      ws_ml[(rec0 + (long long)tid * splits) * 2] = -INFINITY;
      ws_ml[(rec0 + (long long)tid * splits) * 2 + 1] = 0.f;
    }
    return;
  }
  const bool my_live = live_s[warp] != 0;
  const int wslot0 = slot0 + warp * BK;
  const T* krow = kb + (long long)(kp >= 0 ? wslot0 + lane : 0) * p.kss;

  for (int r0 = 0; r0 < rows; r0 += CR) {
    float m[CR], l[CR], acc[CR][DPL];
#pragma unroll
    for (int r = 0; r < CR; ++r) {
      m[r] = -INFINITY;
      l[r] = 0.f;
#pragma unroll
      for (int d = 0; d < DPL; ++d) acc[r][d] = 0.f;
    }
    if (my_live) {
      // scores of slot `lane` against the chunk's rows
      float s[CR];
#pragma unroll
      for (int r = 0; r < CR; ++r) s[r] = 0.f;
      if (kp >= 0) {
#pragma unroll 4
        for (int c = 0; c < CPR; ++c) {
          float kf[VEC];
          load16<T>(krow + c * VEC, kf);
#pragma unroll
          for (int r = 0; r < CR; ++r) {
            const float* qr = Qs + (r0 + r) * HD + c * VEC;
#pragma unroll
            for (int x = 0; x < VEC; x += 4) {
              const float4 qv = *reinterpret_cast<const float4*>(qr + x);
              s[r] = fmaf(qv.x, kf[x], s[r]);
              s[r] = fmaf(qv.y, kf[x + 1], s[r]);
              s[r] = fmaf(qv.z, kf[x + 2], s[r]);
              s[r] = fmaf(qv.w, kf[x + 3], s[r]);
            }
          }
        }
      }
      // softmax over the tile's 32 slots, as flash_attention_kernel
#pragma unroll
      for (int r = 0; r < CR; ++r) {
        float x = s[r] * p.scale;
        if (p.softcap != 0.f) x = p.softcap * tanhf(x / p.softcap);
        const bool ok = r0 + r < rows && sees(qpos_s[min(r0 + r, rows - 1)],
                                              kp, p);
        const float mx = warp_max(ok ? x : -INFINITY);
        const float pr = mx == -INFINITY || !ok ? 0.f : expf(x - mx);
        m[r] = mx;
        l[r] = warp_sum(pr);
        s[r] = pr;
      }
      // acc += p . V, slot by slot in order; lane owns dims DPL lane ...
#pragma unroll 8
      for (int j = 0; j < BK; ++j) {
        float vv[DPL];
        if (kpos_s[warp * BK + j] >= 0) {
          load_n<T, DPL>(vb + (long long)(wslot0 + j) * p.vss + lane * DPL,
                         vv);
        } else {
#pragma unroll
          for (int d = 0; d < DPL; ++d) vv[d] = 0.f;
        }
#pragma unroll
        for (int r = 0; r < CR; ++r) {
          const float pj = __shfl_sync(FULL, s[r], j);
#pragma unroll
          for (int d = 0; d < DPL; ++d)
            acc[r][d] = fmaf(pj, vv[d], acc[r][d]);
        }
      }
    }
    float* pw = part + warp * CR * PW;
#pragma unroll
    for (int r = 0; r < CR; ++r) {
#pragma unroll
      for (int d = 0; d < DPL; ++d) pw[r * PW + lane * DPL + d] = acc[r][d];
      if (lane == 0) {
        pw[r * PW + HD] = m[r];
        pw[r * PW + HD + 1] = l[r];
      }
    }
    __syncthreads();
    // warp w merges rows r0 + w, r0 + w + DWARPS, ... over the split's
    // tiles, in order
    for (int r = warp; r < CR && r0 + r < rows; r += DWARPS) {
      float mx = -INFINITY;
      for (int w = 0; w < DWARPS; ++w) {
        const float* pr = part + (w * CR + r) * PW;
        if (pr[HD + 1] > 0.f) mx = fmaxf(mx, pr[HD]);
      }
      float lsum = 0.f, o[DPL];
#pragma unroll
      for (int d = 0; d < DPL; ++d) o[d] = 0.f;
      for (int w = 0; w < DWARPS; ++w) {
        const float* pr = part + (w * CR + r) * PW;
        if (!(pr[HD + 1] > 0.f)) continue;
        const float e = expf(pr[HD] - mx);
        lsum += e * pr[HD + 1];
#pragma unroll
        for (int d = 0; d < DPL; ++d)
          o[d] = fmaf(e, pr[lane * DPL + d], o[d]);
      }
      const long long rec = rec0 + (long long)(r0 + r) * splits;
#pragma unroll
      for (int d = 0; d < DPL; ++d) ws_o[rec * HD + lane * DPL + d] = o[d];
      if (lane == 0) {
        ws_ml[rec * 2] = mx;
        ws_ml[rec * 2 + 1] = lsum;
      }
    }
    __syncthreads();
  }
}

// One warp a row: the row's partials merged in split order.  The lanes
// find the largest m of the splits with l > 0 (32 splits at a time); then
// every lane walks the splits in order, 8 loads in flight.
template <typename T, int HD>
__global__ void __launch_bounds__(128)
decode_combine_kernel(const Params p, const float* ws_o, const float* ws_ml,
                      int splits, int KV, int total) {
  constexpr int DPL = HD / 32;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * 4 + (threadIdx.x >> 5);
  if (row >= total) return;
  const int rows = p.Sq * p.group;
  const int r = row % rows, kvh = (row / rows) % KV, b = row / (rows * KV);
  const float2* ml = reinterpret_cast<const float2*>(ws_ml) +
                     (long long)row * splits;
  const float* os = ws_o + (long long)row * splits * HD;

  float mx = -INFINITY;
  for (int s = lane; s < splits; s += 32) {
    const float2 x = ml[s];
    if (x.y > 0.f) mx = fmaxf(mx, x.x);
  }
  mx = warp_max(mx);
  float lsum = 0.f, acc[DPL];
#pragma unroll
  for (int d = 0; d < DPL; ++d) acc[d] = 0.f;
#pragma unroll 8
  for (int s = 0; s < splits; ++s) {
    const float2 x = ml[s];
    const bool live = x.y > 0.f;         // a dead split's o is not written
    const float w = live ? expf(x.x - mx) : 0.f;
    lsum += w * x.y;
#pragma unroll
    for (int d = 0; d < DPL; ++d) {
      const float v = os[(long long)s * HD + lane + 32 * d];
      acc[d] = fmaf(w, live ? v : 0.f, acc[d]);
    }
  }
  const int i = r / p.group, h = kvh * p.group + r % p.group;
  T* orow = static_cast<T*>(p.o) + b * p.osb + h * p.osh + (long long)i * p.oss;
#pragma unroll
  for (int d = 0; d < DPL; ++d)
    orow[lane + 32 * d] = from_float<T>(lsum == 0.f ? 0.f : acc[d] / lsum);
}

template <typename T, int HD>
cudaError_t launch_decode(const Params& p, int B, int KV, float* ws_o,
                          float* ws_ml, int splits, int phases,
                          cudaStream_t stream) {
  const int rows = p.Sq * p.group;
  if (phases & 1) {
    auto kernel = decode_partial_kernel<T, HD>;
    static cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)decode_smem_bytes<HD>(MAX_ROWS));
    if (attr != cudaSuccess) return attr;
    kernel<<<dim3(splits, KV, B), DTHREADS, decode_smem_bytes<HD>(rows),
             stream>>>(p, ws_o, ws_ml, splits);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (phases & 2) {
    const int total = B * KV * rows;
    decode_combine_kernel<T, HD><<<(total + 3) / 4, 128, 0, stream>>>(
        p, ws_o, ws_ml, splits, KV, total);
    return cudaGetLastError();
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_decode_t(const Params& p, int B, int KV, int hd,
                            float* ws_o, float* ws_ml, int splits, int phases,
                            cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch_decode<T, 64>(p, B, KV, ws_o, ws_ml, splits, phases,
                                  stream);
    case 128:
      return launch_decode<T, 128>(p, B, KV, ws_o, ws_ml, splits, phases,
                                   stream);
    case 256:
      return launch_decode<T, 256>(p, B, KV, ws_o, ws_ml, splits, phases,
                                   stream);
    default: return cudaErrorInvalidValue;
  }
}

Params make_params(const void* q, const void* k, const void* v, void* o,
                   const int* q_pos, const int* k_pos, int H, int KV, int Sq,
                   int Skv, const long long* strides, int causal, int window,
                   float softcap, float scale) {
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
  return p;
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
  const Params p = make_params(q, k, v, o, q_pos, k_pos, H, KV, Sq, Skv,
                               strides, causal, window, softcap, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_t<__nv_bfloat16>(p, B, KV, hd, s)
              : launch_t<float>(p, B, KV, hd, s);
  return (int)err;
}

// Route 2: the arguments of flash_attention_launch, then the workspace
// ws_o (float32 [B, KV, rows, splits, hd]) and ws_ml ([..., splits, 2]),
// rows = Sq * H / KV <= 64, splits = max(1, ceil(Skv / 256)), and which
// kernels to run: 1 the partials, 2 the combine, 3 both.  Returns the CUDA
// error of the launches (0 on success).
extern "C" int flash_attention_decode_launch(
    const void* q, const void* k, const void* v, void* o, const int* q_pos,
    const int* k_pos, int is_bf16, int B, int H, int KV, int Sq, int Skv,
    int hd, const long long* strides, int causal, int window, float softcap,
    float scale, float* ws_o, float* ws_ml, int splits, int phases,
    void* stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Skv < 0 ||
      B > 65535 || KV > 65535 || (long long)Sq * (H / KV) > MAX_ROWS ||
      splits != (Skv > SPLIT ? (Skv + SPLIT - 1) / SPLIT : 1) ||
      splits > 65535 || phases < 1 || phases > 3)
    return (int)cudaErrorInvalidValue;
  const Params p = make_params(q, k, v, o, q_pos, k_pos, H, KV, Sq, Skv,
                               strides, causal, window, softcap, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_decode_t<__nv_bfloat16>(p, B, KV, hd, ws_o, ws_ml,
                                               splits, phases, s)
              : launch_decode_t<float>(p, B, KV, hd, ws_o, ws_ml, splits,
                                       phases, s);
  return (int)err;
}
