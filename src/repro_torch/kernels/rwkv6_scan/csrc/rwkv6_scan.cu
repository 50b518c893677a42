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
// only o.  Here T need not be a multiple of any chunk, and the state comes
// in and goes out.
//
// What bounds it on the H100: the function needs 5 hd^2 + 5 hd operations
// per (b, t, h) step, since o[j] = sum_i r[i] S[i, j] + v[j] * sum_i r[i]
// u[i] k[i] (2 hd^2 + 5 hd) and the update is 3 hd^2 (1.02 GFLOP at
// rwkv6-1.6b's prefill of T = 1536, H = 32, hd = 64: 0.015 ms at 67
// TFLOP/s in float32), and it moves 5 B T H hd * 4 bytes (63 MB: 0.019
// ms), so it is bound by bytes.
//
// Two routes (ops.route picks one by shape):
//
// sequential (rwkv6_scan_launch; decode steps and short T).  One block per
// (b, h), thread j owns column j of the state, hd floats in registers.
// The block stages CT = 2048 / hd time steps of r, k, w and v in shared
// memory (one coalesced row of hd values per step and input), then walks
// them in order: each step every thread reads r, k, w and u by broadcast
// from shared memory, so a step is 3 hd dependent-free FMAs a thread and
// one dot product over i, kept in four partial sums.  It is bound by
// neither bytes nor operations: each block walks T in series, and at a
// prefill (B = 1) there are only H = 32 blocks of hd threads for 132 SMs,
// so the time is T steps of one block's latency (49x the bound at T =
// 1326).
//
// chunked (rwkv6_scan_chunked_launch; prefills).  The T steps are cut into
// chunks of CHUNK = 64 (the last one may be short), and three kernels run
// in parallel over (b, h, chunk) or (b, h, i, j):
//   A. rwkv6_chunk_summaries, a block per (b, h, c): k, v, w of the chunk
//      brought to shared memory by cp.async in passes, the last first (bf16
//      kept as is and upcast where it is read); the suffix products P_s =
//      prod_{s<tau<=last} w_tau by a backward running product, one thread
//      per row i, and the chunk's decay D_c = prod_tau w_tau; dS_c =
//      (K * P)^T V, an [hd x L] . [L x hd] product on the CUDA cores in
//      float32, an 8 x 8 register tile per thread.  dS_c goes to the
//      chunk's slot of a scratch buffer [B, H, nC, hd, hd], D_c to decay
//      [B, H, nC, hd].
//   B. rwkv6_chunk_states, a thread per (b, h, i, j): S_{c+1} = D_c[i] S_c
//      + dS_c in chunk order from s0, each chunk's start state S_c written
//      over dS_c in its slot, the last S to s_out.  Every thread reads its
//      own s0 element before it writes its s_out element, so s_out may be
//      s0; nothing later reads s0.
//   C. rwkv6_chunk_outputs, a block per (b, h, c): the recurrence replayed
//      over the chunk's <= 64 steps from S_c, read from the scratch slot,
//      each thread holding an 8-row (16 at hd 128) x 4-column tile of the
//      state.  The inter-chunk term, the intra-chunk term and the bonus u
//      come out of one exact float32 loop, o_t = r_t S + (r_t u k_t^T) v_t
//      then S <- w_t S + k_t^T v_t, the bonus taken as v_j sum_i r_i u_i
//      k_i.
// At T = 1326 that is 32 x 21 = 672 blocks each walking 64 steps, where
// the sequential route has 32 blocks walking 1326.  The decay enters as
// running products of numbers in [0, 1] only, never as exp(cumsum(log w))
// or a quotient of products: those lose the state's accuracy on strong
// decays and give NaN where w is 0, which products cannot (no overflow,
// no cancellation, w = 0 exact).  Chunks sit at multiples of CHUNK from
// the start of the call and the chunk scan runs in one order, so a run
// split at a multiple of CHUNK, both halves chunked, is bitwise one run.
// The route moves about twice the function's bytes: phase A reads k, v
// and w, phase C reads r, k, v and w again, and the chunk states go out
// and come back (4 B H nC hd^2 floats: 131 MB in all at T = 1326, H = 32,
// hd = 64, 0.039 ms at 3.35 TB/s, where the function's bound is 0.016).
//
// Determinism: no atomics; every sum is taken in a fixed order, so reruns
// are bitwise and a (b, h) does not depend on the others.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 64;          // the chunked route's L
constexpr int STATE_THREADS = 256; // phase B

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

// four consecutive values from shared memory as float (16 or 8 bytes)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(q.x << 16),
                     __uint_as_float(q.x & 0xffff0000u),
                     __uint_as_float(q.y << 16),
                     __uint_as_float(q.y & 0xffff0000u));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [s0, s0 + m) of the arrays src[a] (a < A; a step `row` elements
// apart, the first at `first`) into dst[a][0 .. m), by cp.async, 16 bytes
// a copy; NT threads share the copies.  The caller commits.
template <int HD, int CT, int A, int NT, typename T>
__device__ __forceinline__ void stage_rows(T (*dst)[CT][HD],
                                           const T* const (&src)[A],
                                           long long first, long long row,
                                           int s0, int m) {
  constexpr int PIECES = HD * (int)sizeof(T) / 16;  // copies a row
  for (int q = threadIdx.x; q < A * m * PIECES; q += NT) {
    const int a = q / (m * PIECES), st = q / PIECES % m, x = q % PIECES;
    cp_async16(reinterpret_cast<unsigned char*>(dst[a][st]) + 16 * x,
               reinterpret_cast<const unsigned char*>(
                   src[a] + first + (long long)(s0 + st) * row) +
                   16 * x);
  }
}

// sequential route: one block per (b, h) walks all T steps
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

// chunked route, phase A: a block per (b, h, c), blockIdx.x = bh * nC + c.
// Thread (ti, tj) owns an 8 x 8 tile of dS: rows 4 ti + hd/2 gi + a and
// columns 4 tj + hd/2 gj + e (gi, gj, a, e < 2, 2, 4, 4).  The chunk's
// steps come in passes of SUB, the last pass first, so that each thread
// of a row carries its running product of w from one pass to the next;
// the next pass's copies are in flight while a pass is summed.
template <int HD, typename T>
__global__ void __launch_bounds__(HD * HD / 64)
rwkv6_chunk_summaries(const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ w, float* __restrict__ dS,
                      float* __restrict__ decay, int steps, int H, int nC) {
  constexpr int NT = HD * HD / 64;                  // threads
  constexpr int TD = HD / 8;                        // tiles along a side
  constexpr int SUB = 1024 / HD;                    // steps a pass
  __shared__ __align__(16) T buf[2][3][SUB][HD];    // k, v, w; two passes
  __shared__ __align__(16) float kp[SUB][HD];       // K * P
  const int tid = threadIdx.x, ti = tid / TD, tj = tid % TD;
  const int c = blockIdx.x % nC;
  const long long bh = blockIdx.x / nC;
  const int b = (int)(bh / H), h = (int)(bh % H);
  const int t0 = c * CHUNK, n = min(CHUNK, steps - t0);
  const long long row = (long long)H * HD;
  const long long first = ((long long)b * steps + t0) * row +
                          (long long)h * HD;
  const T* const src[3] = {k, v, w};

  float acc[2][2][4][4] = {};
  float p = 1.f;               // thread i < hd: prod of w_i after step s
  const int last = (n - 1) / SUB;
  stage_rows<HD, SUB, 3, NT>(buf[last & 1], src, first, row, last * SUB,
                             n - last * SUB);
  cp_async_commit();
  for (int ps = last; ps >= 0; --ps) {
    const int s0 = ps * SUB, m = min(SUB, n - s0);
    const T(*sk)[HD] = buf[ps & 1][0];
    const T(*sv)[HD] = buf[ps & 1][1];
    const T(*sw)[HD] = buf[ps & 1][2];
    __syncthreads();                    // pass ps + 2's buffer read
    if (ps > 0) {
      stage_rows<HD, SUB, 3, NT>(buf[(ps - 1) & 1], src, first, row,
                                 s0 - SUB, SUB);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // P_s = prod_{s < tau < n} w_tau, kp[s] = k_s * P_s; 8 steps' reads
    // ahead of their products
    if (tid < HD) {
      for (int s = m - 1; s >= 0; s -= 8) {
        float ks[8], ws[8];
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (s - q >= 0) {
            ks[q] = to_f32(sk[s - q][tid]);
            ws[q] = to_f32(sw[s - q][tid]);
          }
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (s - q >= 0) {
            kp[s - q][tid] = ks[q] * p;
            p *= ws[q];
          }
      }
    }
    __syncthreads();

    // dS[i][j] += sum_s kp[s][i] v[s][j]
    for (int s = 0; s < m; ++s) {
      float4 x[2], y[2];
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        x[g] = load4(&kp[s][HD / 2 * g + 4 * ti]);
        y[g] = load4(&sv[s][HD / 2 * g + 4 * tj]);
      }
#pragma unroll
      for (int gi = 0; gi < 2; ++gi)
#pragma unroll
        for (int gj = 0; gj < 2; ++gj) {
          const float xs[4] = {x[gi].x, x[gi].y, x[gi].z, x[gi].w};
          const float ys[4] = {y[gj].x, y[gj].y, y[gj].z, y[gj].w};
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[gi][gj][a][e] += xs[a] * ys[e];
        }
    }
  }
  if (tid < HD) decay[blockIdx.x * (long long)HD + tid] = p;   // D_c
  float* out = dS + (long long)blockIdx.x * HD * HD;
#pragma unroll
  for (int gi = 0; gi < 2; ++gi)
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int gj = 0; gj < 2; ++gj)
        *reinterpret_cast<float4*>(out + (HD / 2 * gi + 4 * ti + a) * HD +
                                   HD / 2 * gj + 4 * tj) =
            make_float4(acc[gi][gj][a][0], acc[gi][gj][a][1],
                        acc[gi][gj][a][2], acc[gi][gj][a][3]);
}

// chunked route, phase B: a thread per (b, h, i, j), the scan over chunks
template <int HD>
__global__ void __launch_bounds__(STATE_THREADS)
rwkv6_chunk_states(const float* s0, float* __restrict__ slots,
                   const float* __restrict__ decay, float* s_out, int nC) {
  constexpr int BATCH = 8;                          // chunks read ahead
  const long long e = (long long)blockIdx.x * STATE_THREADS + threadIdx.x;
  const long long bh = e / (HD * HD);
  const int ij = (int)(e % (HD * HD)), i = ij / HD;
  float* slot = slots + bh * nC * HD * HD + ij;
  const float* d = decay + bh * nC * HD + i;
  float S = s0 ? s0[e] : 0.f;
  for (int c0 = 0; c0 < nC; c0 += BATCH) {
    const int m = min(BATCH, nC - c0);
    float ds[BATCH], dc[BATCH];
#pragma unroll
    for (int q = 0; q < BATCH; ++q)
      if (q < m) {
        ds[q] = slot[(long long)(c0 + q) * HD * HD];
        dc[q] = d[(long long)(c0 + q) * HD];
      }
#pragma unroll
    for (int q = 0; q < BATCH; ++q)
      if (q < m) {
        slot[(long long)(c0 + q) * HD * HD] = S;
        S = dc[q] * S + ds[q];
      }
  }
  s_out[e] = S;
}

// rows of the state a phase C thread holds (of four columns)
__host__ __device__ constexpr int outputs_rows(int hd) {
  return hd == 64 ? 8 : 16;
}
__host__ __device__ constexpr int outputs_threads(int hd) {
  return hd / outputs_rows(hd) * (hd / 4);
}

// chunked route, phase C: a block per (b, h, c) replays the chunk's steps
// from S_c.  Thread (g, cg) owns rows RG g .. RG g + RG - 1 of columns
// 4 cg .. 4 cg + 3 in registers, so each value of r, k and w it reads from
// shared memory serves four columns: reading them once per column (the
// sequential kernel's layout) made the shared-memory pipe, not the FMAs,
// the limit.  Each step a thread adds r_i S_ij over its rows,
// updates them, and adds v_j sum_i r_i u_i k_i over its rows (the bonus);
// the hd / 16 partial sums of an output meet in shared memory at the end
// of a pass, in row-group order.
template <int HD, typename T>
__global__ void __launch_bounds__(outputs_threads(HD))
rwkv6_chunk_outputs(const T* __restrict__ r, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ w,
                    const float* __restrict__ u,
                    const float* __restrict__ starts, T* __restrict__ o,
                    int steps, int H, int nC) {
  constexpr int NT = outputs_threads(HD);
  constexpr int RG = outputs_rows(HD);
  constexpr int NG = HD / RG, NCG = HD / 4;         // row, column groups
  constexpr int CT = 512 / HD;                      // steps a pass
  __shared__ __align__(16) T buf[2][4][CT][HD];     // r, k, w, v; 2 passes
  __shared__ __align__(16) float part[CT][NG][HD];
  const int tid = threadIdx.x, g = tid / NCG, cg = tid % NCG;
  const int c = blockIdx.x % nC;
  const int bh = blockIdx.x / nC;
  const int b = bh / H, h = bh % H;
  const T* const src[4] = {r, k, w, v};

  float S[RG][4], uu[RG];
  const float* s = starts + (long long)blockIdx.x * HD * HD +
                   (long long)RG * g * HD + 4 * cg;
#pragma unroll
  for (int x = 0; x < RG; ++x) {
    const float4 q = *reinterpret_cast<const float4*>(s + x * HD);
    S[x][0] = q.x, S[x][1] = q.y, S[x][2] = q.z, S[x][3] = q.w;
    uu[x] = u[h * HD + RG * g + x];
  }

  const long long row = (long long)H * HD;
  const int t0 = c * CHUNK, n_steps = min(CHUNK, steps - t0);
  const long long first = ((long long)b * steps + t0) * row +
                          (long long)h * HD;
  const int passes = (n_steps + CT - 1) / CT;
  stage_rows<HD, CT, 4, NT>(buf[0], src, first, row, 0, min(CT, n_steps));
  cp_async_commit();
  for (int ps = 0; ps < passes; ++ps) {
    const int p0 = ps * CT, n = min(CT, n_steps - p0);
    const T(*sr)[HD] = buf[ps & 1][0];
    const T(*sk)[HD] = buf[ps & 1][1];
    const T(*sw)[HD] = buf[ps & 1][2];
    const T(*sv)[HD] = buf[ps & 1][3];
    if (ps + 1 < passes) {        // its buffer was read before the last sync
      stage_rows<HD, CT, 4, NT>(buf[(ps + 1) & 1], src, first, row, p0 + CT,
                                min(CT, n_steps - p0 - CT));
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const float4 v4 = load4(&sv[i][4 * cg]);
      const float vs[4] = {v4.x, v4.y, v4.z, v4.w};
      float acc[4] = {0.f, 0.f, 0.f, 0.f}, bonus = 0.f;
#pragma unroll
      for (int x4 = 0; x4 < RG; x4 += 4) {
        const float4 r4 = load4(&sr[i][RG * g + x4]);
        const float4 k4 = load4(&sk[i][RG * g + x4]);
        const float4 w4 = load4(&sw[i][RG * g + x4]);
        const float rs[4] = {r4.x, r4.y, r4.z, r4.w};
        const float ks[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ws[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          float* Sx = S[x4 + a];
          bonus += rs[a] * (uu[x4 + a] * ks[a]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[e] += rs[a] * Sx[e];
            Sx[e] = ws[a] * Sx[e] + ks[a] * vs[e];
          }
        }
      }
      *reinterpret_cast<float4*>(&part[i][g][4 * cg]) =
          make_float4(acc[0] + vs[0] * bonus, acc[1] + vs[1] * bonus,
                      acc[2] + vs[2] * bonus, acc[3] + vs[3] * bonus);
    }
    __syncthreads();
    for (int q = tid; q < n * HD; q += NT) {
      const int i = q / HD, j = q % HD;
      float sum = part[i][0][j];
#pragma unroll
      for (int gg = 1; gg < NG; ++gg) sum += part[i][gg][j];
      o[first + (long long)(p0 + i) * row + j] = from_f32<T>(sum);
    }
  }
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

template <int HD, typename T>
cudaError_t launch_chunked(const void* r, const void* k, const void* v,
                           const void* w, const float* u, const float* s0,
                           void* o, float* s_out, float* slots,
                           float* decay, int B, int steps, int H,
                           cudaStream_t stream) {
  const int nC = (steps + CHUNK - 1) / CHUNK;
  const unsigned blocks = (unsigned)(B * H * nC);
  const T* rt = static_cast<const T*>(r);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* wt = static_cast<const T*>(w);
  rwkv6_chunk_summaries<HD, T><<<blocks, HD * HD / 64, 0, stream>>>(
      kt, vt, wt, slots, decay, steps, H, nC);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rwkv6_chunk_states<HD>
      <<<(unsigned)((long long)B * H * HD * HD / STATE_THREADS),
         STATE_THREADS, 0, stream>>>(s0, slots, decay, s_out, nC);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rwkv6_chunk_outputs<HD, T><<<blocks, outputs_threads(HD), 0, stream>>>(
      rt, kt, vt, wt, u, slots, static_cast<T*>(o), steps, H, nC);
  return cudaGetLastError();
}

template <int HD_, typename T_>
struct Instance {
  static constexpr int HD = HD_;
  using T = T_;
};

// f(Instance<hd, input type>{}) for the head dims and types the kernels take
template <typename F>
cudaError_t dispatch(int hd, int bf16, F f) {
  if (hd == 64)
    return bf16 ? f(Instance<64, __nv_bfloat16>{}) : f(Instance<64, float>{});
  if (hd == 128)
    return bf16 ? f(Instance<128, __nv_bfloat16>{})
                : f(Instance<128, float>{});
  return cudaErrorInvalidValue;
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
  return (int)dispatch(hd, bf16, [&](auto in) {
    using I = decltype(in);
    return launch<I::HD, typename I::T>(r, k, v, w, u, s0, o, s_out, B,
                                        steps, H, s);
  });
}

// The chunked route's three launches; slots float32 [B, H, nC, hd, hd] and
// decay float32 [B, H, nC, hd] are the caller's scratch, nC = ceil(steps /
// chunk).  r, k, v, w must sit on 16 bytes (cp.async).  Returns the first
// CUDA error (0 on success); cudaErrorInvalidValue for a shape or chunk
// the kernels do not take.
extern "C" int rwkv6_scan_chunked_launch(const void* r, const void* k,
                                         const void* v, const void* w,
                                         const float* u, const float* s0,
                                         void* o, float* s_out, float* slots,
                                         float* decay, int B, int steps,
                                         int H, int hd, int chunk, int bf16,
                                         void* stream) {
  const long long nC = (steps + (long long)CHUNK - 1) / CHUNK;
  if (chunk != CHUNK || B < 1 || steps < 1 || H < 1 ||
      (long long)B * H * nC > 2147483647LL ||
      (long long)B * H * hd * hd / STATE_THREADS > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)dispatch(hd, bf16, [&](auto in) {
    using I = decltype(in);
    return launch_chunked<I::HD, typename I::T>(
        r, k, v, w, u, s0, o, s_out, slots, decay, B, steps, H, s);
  });
}
