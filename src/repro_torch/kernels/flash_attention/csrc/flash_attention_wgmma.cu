// flash_attention on the tensor cores of Hopper (sm_90a): bf16 attention
// by wgmma, for prefill (the "wgmma" route: every bf16 call of more than 64
// rows at hd 64 or 128) and for the partials of a split-K decode (the
// "split_k_wgmma" route: at most 64 rows; flash_attention.cu's combine
// kernel merges them).  ops.py picks the route.
//
//   o[b, h, i, :] = sum_j softmax_j(s[i, j]) * v[b, h / group, j, :]
//   s[i, j] = cap * tanh(scale * q[b, h, i, :] . k[b, h / group, j, :] / cap)
//
// over the keys j that row i sees (the mask that flash_attention.cu and
// ref.py state).  bfloat16 in and out, head dims 64 and 128.
//
// Replaces, with flash_attention.cu, the Pallas TPU kernel
// flash_attention_p (src/repro/kernels/flash_attention/flash_attention.py:88).
//
// Work of one block, one warpgroup of 128 threads: batch b, kv head kvh and
// a tile of 64 rows (wgmma's M), a row being one (query position i, head of
// kvh's group) pair, position-major, so the group's GQA heads share every
// K/V tile (kv head h / group is indexed, never copied); split-K, also one
// split of 256 kv slots.  The kv axis is a loop over tiles of 64 keys:
//
//   - K and V tiles come into a ring of 2 stages in shared memory by
//     cp.async (16 bytes a copy, one tile ahead of the tile in use), written
//     in the 128-byte swizzled layout wgmma reads: a row of hd is cut into
//     64-column subtiles of 128-byte rows.  Keys past Skv and ring slots at
//     position -1 are zero-filled (cp.async with source size 0), so their
//     bytes are not read and no garbage meets a zero probability.  K is read
//     as the K-major B operand of S = Q.K^T, V as the MN-major (transposed)
//     B operand of O = P.V: no transpose in memory.  K and V are read through
//     their strides (the cache's [B, S, KV, hd] as a transposed view).  Each
//     thread copies one 16-byte column of rows 8k apart, so its addresses
//     and swizzle are computed once.  Split-K, the split's positions are
//     read once, with the set-up.
//   - The block's Q rows are copied to shared memory once, the same way.
//   - S = Q.K^T: wgmma m64n64k16, bf16 operands, float32 accumulator.
//   - Scale, softcap (tanhf, a template case) and mask in registers, branch
//     free; only a tile that straddles the causal diagonal, the window edge,
//     the end of the keys or a ring slot at -1 is masked element by element.
//     A tile that no row of the block sees is skipped; without key
//     positions the causal and window bounds also cut the loop's range.
//   - Online softmax in float32: a row's 64 scores sit in the 4 lanes of a
//     quad (16 each); max by two shuffles, e^x as 2^(x log2 e) by one FMA and
//     one MUFU op, and each lane keeps its part of the denominator l, the
//     sum of the unrounded float32 P, until the end.
//   - P is split into P_hi = bf16(P) and P_lo = bf16(P - P_hi), both fed from
//     registers (the accumulator layout of S is the A-fragment layout of P)
//     to two wgmma m64n{hd}k16 against the same V tile, into a tile
//     accumulator that O (float32) then adds on the CUDA cores.  A single bf16 rounding of P, as SDPA and FlashAttention do,
//     errs by ~2^-9 of sqrt(sum p^2 v^2) on every output, which on outputs
//     near zero is far over the float32-accurate contract chip_smoke.py
//     holds the kernel to; the split leaves ~2^-17 of it, below float32's
//     own reordering error, for 1.5x the MMA work of one rounding.
//
// What bounds it on the H100: in prefill, the operations, 4 * hd flops per
// visible (query, key) pair, at 989 TFLOP/s for bf16 (6 * hd done, with the
// split); in a decode step, the bytes of the K/V cache, which the split-K
// grid spreads over the card (a decode step's 7 rows fill 7 of wgmma's 64:
// the tensor cores' waste costs less than the CUDA cores' instructions).
// This design does not overlap the softmax with the MMAs of another tile
// (no producer warp, no setmaxnreg): each tile's MMAs and softmax run in
// series, so a block is bound by their latency.
//
// Determinism: each row's arithmetic is done by one quad in a fixed order,
// with no atomics, and does not depend on the other rows of its block
// (wgmma rows are independent; the tile skip and the element-wise mask only
// skip work that leaves a row's state exactly as it was), so reruns are
// bitwise and a row does not depend on the batch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

constexpr int BN = 64;           // keys a tile
constexpr int SUB = 64;          // hd columns of one 128-byte swizzled subtile
constexpr int BM = 64;           // rows a block: one warpgroup's wgmma M
constexpr int THREADS = 128;     // one warpgroup
constexpr int STAGES = 2;        // K/V ring
constexpr int SPLIT = 256;       // split-K: kv slots a split (ops.SPLIT_SLOTS)
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* q_pos;              // null: position = index
  const int* k_pos;
  long long qsb, qsh, qss;       // element strides of (b, head, position)
  long long ksb, ksh, kss;
  long long vsb, vsh, vss;
  long long osb, osh, oss;
  long long qpb, kpb;            // batch strides of q_pos, k_pos (0: shared)
  int group, Sq, Skv;
  int causal, window;            // window 0: none
  float softcap, scale;          // softcap 0: none
  int splits;                    // split-K: kv splits (1 otherwise)
  float* ws_o;                   // split-K: partials [row][split][hd]
  float* ws_ml;                  // split-K: (m, l) [row][split][2]
};

// shared memory of one block, byte offsets from a 1024-byte aligned base:
// Q [HD / 64][BM][128 B], K and V [2 stages][HD / 64][BN][128 B], key
// positions [2][BN], row positions [BM]
template <int HD>
struct Smem {
  static constexpr int NSUB = HD / SUB;
  static constexpr int Q_SUB = BM * 128;
  static constexpr int KV_SUB = BN * 128;
  static constexpr int KV_TILE = NSUB * KV_SUB;
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + NSUB * Q_SUB;
  static constexpr int V_OFF = K_OFF + STAGES * KV_TILE;
  static constexpr int KPOS_OFF = V_OFF + STAGES * KV_TILE;
  static constexpr int QPOS_OFF = KPOS_OFF + STAGES * BN * 4;
  static constexpr int SPOS_OFF = QPOS_OFF + BM * 4;     // split-K: [SPLIT]
  static constexpr int RED_OFF = SPOS_OFF + SPLIT * 4;   // [2][8 warps]
  static constexpr int BYTES = RED_OFF + 16 * 4 + 1024;  // + alignment
};

// byte offset of 16-byte chunk c of row r in a [NSUB][ROWS][128 B] array
// with the 128-byte swizzle (chunk c % 8 of a row stored at (c ^ r) % 8)
template <int ROWS>
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  return (uint32_t)((c >> 3) * ROWS * 128 + r * 128 +
                    (((c & 7) ^ (r & 7)) << 4));
}

// 16 bytes global -> shared; zero-filled (nothing read) when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// this thread's shared-memory writes, made visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from touching the accumulators across an async wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (all in 16-byte units)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// d (+)= A . B, m64n64k16, bf16 operands from shared memory (both
// K-major), float32 accumulator in registers
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t da,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A . B, m64n64k16, A (bf16) from registers, B (bf16) from shared
// memory MN-major (transposed), float32 accumulator in registers
__device__ __forceinline__ void mma_rs_n64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// d += A . B, m64n128k16, A (bf16) from registers, B (bf16) from shared
// memory MN-major (transposed), float32 accumulator in registers
__device__ __forceinline__ void mma_rs_n128(float (&d)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}


__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  uint32_t u;
  memcpy(&u, &v, sizeof(u));
  return u;
}

// 2^x (approximate, relative error ~2^-22; 0 for -inf)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Scale, softcap and (where MASK) mask a tile's scores, then the online
// softmax of the thread's two rows: element e of a chunk of 8 columns c8
// sits at row g + 8 (e / 2) of the warp's 16, column 8 c8 + 2 (lane % 4) +
// e % 2.  Branch-free: a row that has seen no key keeps m = -inf and takes
// 0 as its reference, so that each of its p and its alpha are 2^-inf = 0.
template <bool SOFTCAP, bool MASK, int NO>
__device__ __forceinline__ void online_softmax(
    float (&s)[32], float (&o)[NO], float (&m)[2], float (&l)[2],
    const Params& p, const int* kp_t, const int (&qp)[2],
    const bool (&live_row)[2], int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int c8 = 0; c8 < 8; ++c8) {
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int e = c8 * 4 + h * 2 + e2;
        float x = s[e] * p.scale;
        if constexpr (SOFTCAP) x = p.softcap * tanhf(x / p.softcap);
        if constexpr (MASK) {
          const int kp = kp_t[c8 * 8 + 2 * (lane & 3) + e2];
          const bool ok = live_row[h] & (kp >= 0) &
                          (!p.causal | (kp <= qp[h])) &
                          (!p.window | ((long long)qp[h] - kp < p.window));
          x = ok ? x : -INFINITY;
        }
        s[e] = x;
        mx = fmaxf(mx, x);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
    const float m_new = fmaxf(m[h], mx);
    // e^(x - m) as 2^(x log2 e - m log2 e): one FMA and one MUFU op
    const float ml = (m_new == -INFINITY ? 0.f : m_new) * LOG2E;
    const float alpha = ex2(fmaf(m[h], LOG2E, -ml));
    float sum = 0.f;
#pragma unroll
    for (int c8 = 0; c8 < 8; ++c8) {
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int e = c8 * 4 + h * 2 + e2;
        s[e] = ex2(fmaf(s[e], LOG2E, -ml));
        sum += s[e];
      }
    }
    l[h] = alpha * l[h] + sum;
    m[h] = m_new;
#pragma unroll
    for (int c8 = 0; c8 < NO / 4; ++c8) {
      o[c8 * 4 + h * 2] *= alpha;
      o[c8 * 4 + h * 2 + 1] *= alpha;
    }
  }
}

// HD: head dim (64, 128); SOFTCAP: p.softcap != 0; SPLITK: the block
// takes one split of SPLIT kv
// slots (blockIdx.x = row tile * splits + split) and writes its rows'
// partial (m, l, o) to the workspace, which flash_attention.cu's combine
// kernel merges; otherwise it walks every slot and writes o / l.
template <int HD, bool SOFTCAP, bool SPLITK>
__global__ void __launch_bounds__(THREADS)
flash_attention_wgmma_kernel(const Params p) {
  using L = Smem<HD>;
  constexpr int CPR = HD / 8;     // 16-byte chunks a row
  constexpr int NO = HD / 2;      // O accumulators a thread (m64n{HD})

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  int* kpos_s = reinterpret_cast<int*>(smem_raw + (base - raw) + L::KPOS_OFF);
  int* qpos_s = reinterpret_cast<int*>(smem_raw + (base - raw) + L::QPOS_OFF);
  int* spos_s = reinterpret_cast<int*>(smem_raw + (base - raw) + L::SPOS_OFF);
  int* red_s = reinterpret_cast<int*>(smem_raw + (base - raw) + L::RED_OFF);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int group = p.group, rows = p.Sq * group;
  const int split = SPLITK ? blockIdx.x % p.splits : 0;
  const int tiles_x = SPLITK ? gridDim.x / p.splits : gridDim.x;
  const int rtile = SPLITK ? blockIdx.x / p.splits : blockIdx.x;
  // the block's tile of rows, the last (longest under a causal mask) first
  const int row0 = (tiles_x - 1 - rtile) * BM;

  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(p.q) + b * p.qsb;
  const __nv_bfloat16* kb =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.ksb + kvh * p.ksh;
  const __nv_bfloat16* vb =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.vsb + kvh * p.vsh;

  // a thread copies 16-byte chunk c_me of rows r_me, r_me + RSTEP, ...:
  // rows 8k apart, so the swizzle of its chunk is the same in every one
  constexpr int RSTEP = THREADS / CPR;
  static_assert(RSTEP % 8 == 0, "a thread's rows share their swizzle");
  const int c_me = tid % CPR, r_me = tid / CPR;

  // key positions of tile t: split-K, from the split's; else read into
  // stage st as the tile is issued
  auto tile_pos = [&](int t, int st) -> int* {
    return SPLITK ? spos_s + (t * BN - split * SPLIT) : kpos_s + st * BN;
  };

  // K, V tile t (and, not split-K, its key positions) into stage st
  auto issue = [&](int t, int st) {
    const int k0 = t * BN;
    if (!SPLITK && tid < BN) {
      const int j = k0 + tid;
      kpos_s[st * BN + tid] =
          j < p.Skv ? (p.k_pos ? p.k_pos[b * p.kpb + j] : j) : -1;
    }
    const int* kp = tile_pos(t, st);
    const uint32_t kdst =
        base + L::K_OFF + st * L::KV_TILE + swizzled<BN>(r_me, c_me);
    const uint32_t vdst =
        base + L::V_OFF + st * L::KV_TILE + swizzled<BN>(r_me, c_me);
    const __nv_bfloat16* ksrc = kb + (long long)(k0 + r_me) * p.kss + c_me * 8;
    const __nv_bfloat16* vsrc = vb + (long long)(k0 + r_me) * p.vss + c_me * 8;
#pragma unroll
    for (int i = 0; i < BN / RSTEP; ++i) {
      const int r = r_me + i * RSTEP, j = k0 + r;
      const bool ok =
          j < p.Skv &&
          (!p.k_pos || (SPLITK ? kp[r] : p.k_pos[b * p.kpb + j]) >= 0);
      cp_async16(kdst + i * RSTEP * 128,
                 ok ? ksrc + (long long)i * RSTEP * p.kss : kb, ok);
      cp_async16(vdst + i * RSTEP * 128,
                 ok ? vsrc + (long long)i * RSTEP * p.vss : vb, ok);
    }
  };

  // the block's Q rows, swizzled; rows past the last are zero
#pragma unroll
  for (int r = r_me; r < BM; r += RSTEP) {
    const int row = row0 + r;
    const bool ok = row < rows;
    const __nv_bfloat16* src = qb;
    if (ok) {
      const int i = row / group, h = kvh * group + row % group;
      src = qb + h * p.qsh + (long long)i * p.qss + c_me * 8;
    }
    cp_async16(base + L::Q_OFF + swizzled<BM>(r, c_me), src, ok);
  }
  // row positions; their min and max over the block's rows, by warp
  // reductions (threads past BM and past the last row count for nothing)
  int qlo = INT_MAX, qhi = INT_MIN;
  if (tid < BM) {
    const int row = row0 + tid, i = row / group;
    const int qp = row < rows ? (p.q_pos ? p.q_pos[b * p.qpb + i] : i) : 0;
    qpos_s[tid] = qp;
    if (row < rows) qlo = qhi = qp;
  }
  qlo = __reduce_min_sync(FULL, qlo);
  qhi = __reduce_max_sync(FULL, qhi);
  if (lane == 0) {
    red_s[warp] = qlo;
    red_s[THREADS / 32 + warp] = qhi;
  }
  if (SPLITK) {              // the split's key positions, read once
    for (int e = tid; e < SPLIT; e += THREADS) {
      const int j = split * SPLIT + e;
      spos_s[e] = j < p.Skv ? (p.k_pos ? p.k_pos[b * p.kpb + j] : j) : -1;
    }
  }
  __syncthreads();
  int qmin = INT_MAX, qmax = INT_MIN;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) {
    qmin = min(qmin, red_s[w]);
    qmax = max(qmax, red_s[THREADS / 32 + w]);
  }

  // this thread's two rows: g and g + 8 of its warp's 16
  const int lrow = warp * 16 + (lane >> 2);
  int qp[2];
  bool live_row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qp[h] = qpos_s[lrow + 8 * h];
    live_row[h] = row0 + lrow + 8 * h < rows;
  }

  int t_begin = 0, t_end = (p.Skv + BN - 1) / BN;
  if (!p.k_pos) {                        // key j sits at position j
    if (p.causal) t_end = qmax < 0 ? 0 : min(t_end, qmax / BN + 1);
    if (p.window) {
      const long long first = (long long)qmin - p.window + 1;
      t_begin = first <= 0 ? 0 : (int)min(first / BN, (long long)INT_MAX);
    }
  }
  if (SPLITK) {                          // this split's tiles only
    t_begin = max(t_begin, split * (SPLIT / BN));
    t_end = min(t_end, (split + 1) * (SPLIT / BN));
  }


  float o[NO], pv[NO];
#pragma unroll
  for (int x = 0; x < NO; ++x) o[x] = pv[x] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const uint32_t qbase = base + L::Q_OFF;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {   // the first group holds Q too
    if (t_begin + i < t_end) issue(t_begin + i, i);
    cp_async_commit();
  }
  for (int t = t_begin; t < t_end; ++t) {
    const int st = (t - t_begin) % STAGES;
    __syncthreads();                     // tile t - 1's stage is free again
    if (t + STAGES - 1 < t_end)
      issue(t + STAGES - 1, (t - t_begin + STAGES - 1) % STAGES);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();         // tile t (and Q) have landed
    fence_proxy_async();
    const int* kp_t = tile_pos(t, st);
    bool mine_live = false, mine_full = true;
    if (tid < BN) {
      const int kp = kp_t[tid];
      mine_live = kp >= 0 && (!p.causal || kp <= qmax) &&
                  (!p.window || (long long)qmin - kp < p.window);
      mine_full = kp >= 0 && (!p.causal || kp <= qmin) &&
                  (!p.window || (long long)qmax - kp < p.window);
    }
    if (!__syncthreads_or(mine_live)) continue;
    const bool full = __syncthreads_and(mine_full);

    // S = Q . K^T over hd, 16 at a time
    const uint32_t kst = base + L::K_OFF + st * L::KV_TILE;
    float s[32];
#pragma unroll
    for (int x = 0; x < 32; ++x) s[x] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t koff = (kk & 3) * 32;   // within the 128-byte row
      mma_ss_n64(s,
                 smem_desc(qbase + (kk >> 2) * L::Q_SUB + koff, 16, 1024),
                 smem_desc(kst + (kk >> 2) * L::KV_SUB + koff, 16, 1024),
                 kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // only a tile that straddles a mask edge is masked element by element
    if (full)
      online_softmax<SOFTCAP, false>(s, o, m, l, p, kp_t, qp, live_row, lane);
    else
      online_softmax<SOFTCAP, true>(s, o, m, l, p, kp_t, qp, live_row, lane);

    // P = P_hi + P_lo in bf16, as the A fragments of 4 k-steps of 16 keys
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x0 = s[8 * kk + 2 * j], x1 = s[8 * kk + 2 * j + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
        const float2 hf = __bfloat1622float2(hi);
        ph[kk][j] = bits(hi);
        pl[kk][j] = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
      }
    }

    // pv = P_hi . V + P_lo . V for this tile alone (its first product
    // overwrites pv), then O += pv on the CUDA cores: the tensor cores'
    // accumulation, fed every tile of a long row into O, drifts (qwen2-7b's
    // 32,768-row prefill read up to 3.1x float32's own floor); a tile's 8
    // products summed there do not.  V MN-major: 64-column subtiles 8 KB
    // apart
    const uint32_t vst = base + L::V_OFF + st * L::KV_TILE;
    fence_regs(pv);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = smem_desc(vst + kk * 16 * 128, L::KV_SUB, 1024);
      if constexpr (HD == 64) {
        mma_rs_n64(pv, ph[kk], dv, kk > 0);
        mma_rs_n64(pv, pl[kk], dv, 1);
      } else {
        mma_rs_n128(pv, ph[kk], dv, kk > 0);
        mma_rs_n128(pv, pl[kk], dv, 1);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(pv);
#pragma unroll
    for (int x = 0; x < NO; ++x) o[x] += pv[x];
  }
  cp_async_wait<0>();

  // the denominator summed over the row's quad; then o / l (0 where
  // l == 0), or, split-K, the partial (m, l, o)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lsum = l[h] + __shfl_xor_sync(FULL, l[h], 1);
    lsum += __shfl_xor_sync(FULL, lsum, 2);
    if (!live_row[h]) continue;
    const int row = row0 + lrow + 8 * h;
    if constexpr (SPLITK) {
      const long long rec =
          (((long long)b * gridDim.y + kvh) * rows + row) * p.splits + split;
      float* orow = p.ws_o + rec * HD;
#pragma unroll
      for (int c8 = 0; c8 < HD / 8; ++c8)
        *reinterpret_cast<float2*>(orow + c8 * 8 + 2 * (lane & 3)) =
            make_float2(o[c8 * 4 + h * 2], o[c8 * 4 + h * 2 + 1]);
      if ((lane & 3) == 0)
        *reinterpret_cast<float2*>(p.ws_ml + rec * 2) =
            make_float2(m[h], lsum);
    } else {
      const int i = row / group, hh = kvh * group + row % group;
      __nv_bfloat16* orow = static_cast<__nv_bfloat16*>(p.o) + b * p.osb +
                            hh * p.osh + (long long)i * p.oss;
#pragma unroll
      for (int c8 = 0; c8 < HD / 8; ++c8) {
        const float a0 = lsum == 0.f ? 0.f : o[c8 * 4 + h * 2] / lsum;
        const float a1 = lsum == 0.f ? 0.f : o[c8 * 4 + h * 2 + 1] / lsum;
        *reinterpret_cast<__nv_bfloat162*>(orow + c8 * 8 + 2 * (lane & 3)) =
            __floats2bfloat162_rn(a0, a1);
      }
    }
  }
}

template <int HD, bool SOFTCAP, bool SPLITK>
cudaError_t launch(const Params& p, int B, int KV, cudaStream_t stream) {
  constexpr int smem = Smem<HD>::BYTES;
  auto kernel = flash_attention_wgmma_kernel<HD, SOFTCAP, SPLITK>;
  // above 48 KB a block's shared memory must be asked for; once per
  // instantiation (a property of the function, not of a launch)
  static cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const long long rows = (long long)p.Sq * p.group;
  const long long tiles = (rows + BM - 1) / BM * p.splits;
  kernel<<<dim3((unsigned)tiles, KV, B), THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int HD, bool SPLITK>
cudaError_t launch_hd(const Params& p, int B, int KV, cudaStream_t stream) {
  return p.softcap != 0.f ? launch<HD, true, SPLITK>(p, B, KV, stream)
                          : launch<HD, false, SPLITK>(p, B, KV, stream);
}

template <bool SPLITK>
int launch_any(const void* q, const void* k, const void* v, void* o,
               const int* q_pos, const int* k_pos, int is_bf16, int B, int H,
               int KV, int Sq, int Skv, int hd, const long long* strides,
               int causal, int window, float softcap, float scale,
               float* ws_o, float* ws_ml, int splits, void* stream) {
  if (!is_bf16 || B <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Skv < 0 ||
      B > 65535 || KV > 65535 || (hd != 64 && hd != 128) ||
      (SPLITK && ((long long)Sq * (H / KV) > 64 ||
                  splits != (Skv > SPLIT ? (Skv + SPLIT - 1) / SPLIT : 1))))
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
  p.splits = SPLITK ? splits : 1;
  p.ws_o = ws_o; p.ws_ml = ws_ml;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(hd == 64 ? launch_hd<64, SPLITK>(p, B, KV, s)
                        : launch_hd<128, SPLITK>(p, B, KV, s));
}

}  // namespace

// The arguments of flash_attention_launch (flash_attention.cu); is_bf16
// must be 1 and hd 64 or 128.  Returns the CUDA error of the launch.
extern "C" int flash_attention_wgmma_launch(
    const void* q, const void* k, const void* v, void* o, const int* q_pos,
    const int* k_pos, int is_bf16, int B, int H, int KV, int Sq, int Skv,
    int hd, const long long* strides, int causal, int window, float softcap,
    float scale, void* stream) {
  return launch_any<false>(q, k, v, o, q_pos, k_pos, is_bf16, B, H, KV, Sq,
                           Skv, hd, strides, causal, window, softcap, scale,
                           nullptr, nullptr, 1, stream);
}

// Split-K partials of a call of at most 64 rows, into the workspace of
// flash_attention_decode_launch (flash_attention.cu), whose combine (phases
// = 2) then writes o: ws_o float32 [B, KV, rows, splits, hd], ws_ml [...,
// splits, 2], splits = max(1, ceil(Skv / 256)).
extern "C" int flash_attention_wgmma_partials_launch(
    const void* q, const void* k, const void* v, void* o, const int* q_pos,
    const int* k_pos, int is_bf16, int B, int H, int KV, int Sq, int Skv,
    int hd, const long long* strides, int causal, int window, float softcap,
    float scale, float* ws_o, float* ws_ml, int splits, void* stream) {
  return launch_any<true>(q, k, v, o, q_pos, k_pos, is_bf16, B, H, KV, Sq,
                          Skv, hd, strides, causal, window, softcap, scale,
                          ws_o, ws_ml, splits, stream);
}

