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
// underflow), so here the picks are the k largest (value, index) keys,
// each taken once; and the tile need not divide T.
//
// What bounds it on the H100: the bytes, T * E * 4 read and T * k * 8 plus
// the stats written (470 KB at T = 1536, E = 64, k = 6: 0.14 us at
// 3.35 TB/s), far under any launch.  So the time is latency: the launch,
// one round trip to memory, the chain of dependent steps in a row, and
// the instructions of every row an SM holds.  The design keeps all short.
//
// Every row in flight at once.  A row is one group of L lanes (ops.plan:
// E / 4 rounded up to a power of two, at least 4 and at least k, at most
// 32: 16 at deepseek's E = 64, 4 at jamba's E = 16), lane l holding
// experts l, l + L, ... (V values: 4, or 8 above E = 128), so a warp
// holds 32 / L rows.  A tile's rows are spread over a thread-block cluster
// of C <= 8 blocks, R rows a block (16 rows in 8 warps at bt = 128,
// E = 64: 96 blocks at T = 1536); each group loads its row before any
// arithmetic, so the rows' round trips overlap.  A tile small enough for
// one block runs as one block without a cluster (a decode step's 8 rows;
// a jamba tile of 128 rows in 16 warps).
//
// k picks on packed keys.  key = (float bits of p) << 32 | (E - e): the
// bits of a non-negative float order as an unsigned integer, and a lower
// expert has the larger low word, so the largest key is lax.top_k's next
// pick, and every key differs.  Each lane sorts its V keys once (a
// bitonic network in registers); a pick is then one butterfly of log2 L
// steps (4 at E = 64) over the lanes' first keys, and the lane that owned
// it shifts its keys up by one.  No key is multiplied out: the picks are
// the keys at or above the last one, so a row that underflows to 0 still
// gets k distinct experts, lowest first, as lax.top_k gives them.  The
// softmax's max and sum are butterflies of the same length.  The weights
// are the picks over their sum, taken in pick order.
//
// Stats in a fixed order, no atomics.  Each lane keeps its experts' stats
// over its group's rows in registers; at the end a butterfly sums the
// groups of a warp, the warps' sums go through shared memory, and thread
// e sums expert e's over the warps in warp order: the block's partial.
// In a cluster every other block then stores its partial into block 0's
// shared memory (distributed shared memory) and arrives on the cluster
// barrier; block 0 waits on it and sums the partials in block order.  The barrier's first half is arrived at as
// a block starts and waited on before the stores, so every block is
// running by then; block 0, whose memory is written, is the last to exit.
// Reruns are bitwise, and a row's weights and indices do not depend on
// the other rows.

#include <cuda_runtime.h>
#include <cmath>

namespace {

constexpr int MAX_E = 256;
constexpr int MAX_K = 8;
constexpr int MAX_CLUSTER = 8;  // the portable cluster size
constexpr int MAX_THREADS = 512;
constexpr unsigned FULL = 0xffffffffu;

template <int L>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

template <int L>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

template <int L>
__device__ __forceinline__ unsigned long long group_max(unsigned long long v) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(FULL, v, off);
    v = o > v ? o : v;
  }
  return v;
}

// a lane's keys into falling order: a bitonic network of V (a power of
// two) keys, unrolled, so the keys stay in registers
template <int V>
__device__ __forceinline__ void sort_falling(unsigned long long (&a)[V]) {
#pragma unroll
  for (int size = 2; size <= V; size <<= 1) {
#pragma unroll
    for (int stride = size / 2; stride > 0; stride >>= 1) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int j = i ^ stride;
        if (j > i) {
          const unsigned long long x = a[i], y = a[j];
          const bool swap = (i & size) == 0 ? x < y : x > y;
          a[i] = swap ? y : x;
          a[j] = swap ? x : y;
        }
      }
    }
  }
}

// the cluster barrier's halves and a store into block 0's shared memory
// (PTX for sm_90)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ void store_in_block0(float* p, float v) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, 0;"
               : "=r"(remote)
               : "r"((unsigned)__cvta_generic_to_shared(p)));
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(remote), "f"(v)
               : "memory");
}

// the key of probability p at expert e of E; 0 for a missing expert
__device__ __forceinline__ unsigned long long packed(float p, int e, int E) {
  return e < E ? (unsigned long long)__float_as_uint(p) << 32 |
                     (unsigned)(E - e)
               : 0ull;
}

// shared-memory floats of a block: each warp's stats [warps][L * V], and
// in a cluster every block's partial stats [cluster][L * V] (block 0's
// are read); ops.plan computes the same
__host__ __device__ constexpr int smem_floats(int warps, int ep,
                                              int cluster) {
  return warps * ep + (cluster > 1 ? cluster * ep : 0);
}

template <int L, int V>
__global__ void __launch_bounds__(MAX_THREADS)
moe_router_kernel(const float* __restrict__ logits, float* __restrict__ w,
                  int* __restrict__ idx, float* __restrict__ stats, int T,
                  int E, int k, int bt, int cluster, int rows_per_block) {
  constexpr int EP = L * V;
  extern __shared__ float smem[];
  const int groups = blockDim.x / L;
  float* parts = smem;                          // [warps][EP]
  float* partials = smem + blockDim.x / 32 * EP;  // [cluster][EP]
  const int g = threadIdx.x / L, gl = threadIdx.x % L;

  const int tile = blockIdx.x / cluster, rank = blockIdx.x % cluster;
  const bool clustered = cluster > 1;
  const long long tile0 = (long long)tile * bt;
  const long long r0 = tile0 + (long long)rank * rows_per_block;
  const long long r1 = min(min(r0 + rows_per_block, tile0 + bt),
                           (long long)T);
  if (clustered) cluster_arrive_relaxed();

  float acc[V];  // stats of experts gl + L v over this group's rows
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;

  // every lane of a warp runs every pass (the shuffles take the whole
  // warp); a group past its block's rows computes on zeros, writes nothing
  for (int base = 0; base < rows_per_block; base += groups) {
    const long long r = r0 + base + g;
    const bool live = r < r1;
    float p[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int e = gl + L * v;
      p[v] = e >= E ? -INFINITY : live ? logits[r * E + e] : 0.f;
    }
    float m = p[0];
#pragma unroll
    for (int v = 1; v < V; ++v) m = fmaxf(m, p[v]);
    m = group_max<L>(m);
    float s = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      p[v] = expf(p[v] - m);  // 0 for a missing expert
      s += p[v];
    }
    s = group_sum<L>(s);
    unsigned long long key[V];  // 0: a missing expert
#pragma unroll
    for (int v = 0; v < V; ++v) {
      p[v] /= s;
      key[v] = packed(p[v], gl + L * v, E);
    }
    sort_falling<V>(key);

    unsigned long long pick = 0;
    float total = 0.f, mine = 0.f;
    int mine_e = 0;
#pragma unroll
    for (int j = 0; j < MAX_K; ++j) {
      if (j < k) {
        pick = group_max<L>(key[0]);
        const float pj = __uint_as_float((unsigned)(pick >> 32));
        total += pj;
        if (gl == j) {
          mine = pj;
          mine_e = E - (int)(unsigned)pick;
        }
        // the lane that owned the pick moves on to its next key
        const bool owner = key[0] == pick;
#pragma unroll
        for (int v = 0; v + 1 < V; ++v) key[v] = owner ? key[v + 1] : key[v];
        if (owner) key[V - 1] = 0;
      }
    }
    if (live && gl < k) {
      w[r * k + gl] = mine / total;
      idx[r * k + gl] = mine_e;
    }
    // the picks are the keys at or above the last one
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (live && gl + L * v < E)
        acc[v] += (packed(p[v], gl + L * v, E) >= pick ? 1.f : 0.f) + p[v];
  }

  // the block's stats: a warp's groups summed by a butterfly (the same
  // bits on every group), then the warps' sums in warp order
#pragma unroll
  for (int off = L; off < 32; off <<= 1) {
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] += __shfl_xor_sync(FULL, acc[v], off);
  }
  const int warp = threadIdx.x / 32, warps = blockDim.x / 32;
  if (threadIdx.x % 32 < L) {
#pragma unroll
    for (int v = 0; v < V; ++v) parts[warp * EP + gl + L * v] = acc[v];
  }
  __syncthreads();
  if (clustered) cluster_wait();  // every block has started
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    float s = parts[e];
#pragma unroll 4
    for (int i = 1; i < warps; ++i) s += parts[i * EP + e];
    if (!clustered)
      stats[(long long)tile * E + e] = s;
    else if (rank == 0)
      partials[e] = s;
    else
      store_in_block0(partials + rank * EP + e, s);
  }
  if (!clustered) return;
  cluster_arrive();  // the release orders this block's stores before it
  if (rank != 0) return;
  cluster_wait();
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    float s = partials[e];
    for (int c = 1; c < cluster; ++c) s += partials[c * EP + e];
    stats[(long long)tile * E + e] = s;
  }
}

template <int L, int V>
cudaError_t launch(const float* logits, float* w, int* idx, float* stats,
                   int T, int E, int k, int bt, int cluster,
                   int rows_per_block, int threads, int smem,
                   cudaStream_t stream) {
  if (smem != (int)sizeof(float) * smem_floats(threads / 32, L * V, cluster))
    return cudaErrorInvalidValue;
  const long long tiles = (T + (long long)bt - 1) / bt;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tiles * cluster));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(&cfg, moe_router_kernel<L, V>, logits,
                                       w, idx, stats, T, E, k, bt, cluster,
                                       rows_per_block);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// Launches ops.plan's plan: lanes a row, values a lane, blocks a tile
// (the cluster), rows a block, threads a block and dynamic shared-memory
// bytes.  Returns the CUDA error of the launch (0 on success);
// cudaErrorInvalidValue for a shape the kernel does not take or a plan
// that disagrees with this file.  A cluster launch that CUDA refuses
// returns its error: there is no other kernel to fall back to.
extern "C" int moe_router_launch(const float* logits, float* w, int* idx,
                                 float* stats, int T, int E, int k, int bt,
                                 int lanes, int per_lane, int cluster,
                                 int rows_per_block, int threads, int smem,
                                 void* stream) {
  if (T < 1 || E < 1 || E > MAX_E || k < 1 || k > MAX_K || k > E ||
      bt < 1 || bt > T)
    return (int)cudaErrorInvalidValue;
  int want = 4, values = 1;
  while (want < 32 && (want * 4 < E || want < k)) want *= 2;
  while (want * values < E) values *= 2;
  if (lanes != want || per_lane != values || cluster < 1 ||
      cluster > MAX_CLUSTER || rows_per_block < 1 ||
      (long long)cluster * rows_per_block < bt || threads < 32 ||
      threads > MAX_THREADS || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MOE_ROUTER_LAUNCH(L_, V_)                                          \
  return (int)launch<L_, V_>(logits, w, idx, stats, T, E, k, bt, cluster, \
                             rows_per_block, threads, smem, s)
  switch (lanes * 16 + per_lane) {  // every (lanes, values) ops.plan makes
    case 4 * 16 + 1: MOE_ROUTER_LAUNCH(4, 1);
    case 4 * 16 + 2: MOE_ROUTER_LAUNCH(4, 2);
    case 4 * 16 + 4: MOE_ROUTER_LAUNCH(4, 4);
    case 8 * 16 + 1: MOE_ROUTER_LAUNCH(8, 1);
    case 8 * 16 + 2: MOE_ROUTER_LAUNCH(8, 2);
    case 8 * 16 + 4: MOE_ROUTER_LAUNCH(8, 4);
    case 16 * 16 + 4: MOE_ROUTER_LAUNCH(16, 4);
    case 32 * 16 + 4: MOE_ROUTER_LAUNCH(32, 4);
    case 32 * 16 + 8: MOE_ROUTER_LAUNCH(32, 8);
  }
#undef MOE_ROUTER_LAUNCH
  return (int)cudaErrorInvalidValue;
}
