// The layer tail's phases as device code, shared by layer_tail_int8.cu (one
// layer per launch) and decode_step_int8.cu (every layer of a decode step in
// one launch). Inside one persistent cooperative launch:
//   x1 = (att @ wo) * s + x;  xn = bf16(x1 * rstd(x1) * gamma_mlp)
//   g, u = (xn @ [gate | up]) * s;  h = bf16(silu(g) * u)
//   x_out = (h @ down) * s + x1;  out = x_out in T
//   xq = bf16(x_out * rstd(x_out) * gamma_next);  qkv = (xq @ wqkv_next) * s
//
// This is the arithmetic of the TPU kernels mila_tpu/kernels/layer_stream.py:
// _stream_kernel and layer_fused.py:_tail_kernel: x1 and x_out stay f32 into
// the next RMSNorm, h and the normalised inputs are rounded to bf16.
//
// The weights are pack_layer's stream: [T, H, bn] int8 tiles in the order
// [wo | g0 u0 g1 u1 ... | down k-major | wqkv_next] with one f32 scale row
// [T, 1, bn] per tile; a tail reads tiles [base, base + n_tiles).
//
// Design. Every phase needs the whole output of the previous one (RMSNorm
// needs all of x1, down all of h, the next RMSNorm all of x_out); the TPU
// kernel gets that by running its tiles in order on one core. Here all
// blocks stay resident (cooperative launch, grid sized from the occupancy)
// and meet at grid-wide barriers between the phases:
//   1 wo     GEMV units -> f32 partials p_wo[slice][M][H]
//   2 fin1   x1 = x + sum of slices; per-block row sums of squares
//   3 gu     GEMV units with xn staged -> p_gu[slice][M][2I] (gate | up)
//   4 fin_h  h = bf16(silu(g) * u) from the slice sums -> hbuf [M][I]
//   5 down   GEMV units with h staged -> p_down[kchunk*slices + slice][M][H]
//   6 fin2   x_out = x1 + sum; out; row sums of squares
//   7 qkv    GEMV units with xq staged -> p_q[slice][M][Nq]   (not last layer)
//   8 fin3   qkv = sum of slices                               (not last layer)
// A GEMV unit is (tile, 128-column group, K slice of kc rows): the block
// stages its slice of the input as f32 [kc][MT] in shared memory, each lane
// streams 4 adjacent int8 columns as one 32-bit word per row (8 words per
// lane per batch, the next batch requested while the current one is
// summed, the first one before the input is staged), the 8 warps interleave
// over the rows and add their partials in shared memory in turns, and the
// sum times the tile's scale row is stored as that slice's partial.
// Partials are reduced in fixed order by the next phase: no atomics,
// deterministic sums. Data written inside the launch is read back with
// __ldcg (L2), never through the non-coherent or L1 paths. A thread stages
// its input values into registers first and stores them after, so their
// loads are in flight together (one L2 round trip, not one per value); the
// finish passes unroll their partial sums for the same reason. A phase
// gives each block at most one unit (plan_tail in kernels/layer_fused.py): a
// second round repeats a unit's latency chain. What bounds the phases at
// M <= 8 is instruction issue (8 f32 FMAs per weight byte), hence registers
// bounded for 2 resident blocks per SM.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace tail {

constexpr int COLS = 128, THREADS = 256, WARPS = THREADS / 32, UNROLL = 8;
constexpr int XS_BYTES = 32 * 1024;  // staged input slice: kc * MT * 4 bytes at most
constexpr int SPT = 16;  // staged values a thread loads before it stores them
#ifndef TAIL_MIN_BLOCKS
#define TAIL_MIN_BLOCKS 2  // resident blocks per SM the M <= 8 variants are built for
#endif

constexpr int smem_bytes(int mt) { return XS_BYTES + mt * COLS * 4; }

// A value written earlier in the same launch, read through L2.
__device__ __forceinline__ float ldcg_f(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ldcg_f(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p))));
}

struct Params {
  const __nv_bfloat16* att;  // [M, H]
  const void* x;             // [M, H] T
  const float* g_mlp;        // [H]
  const float* g_next;       // [H]
  const int8_t* w;           // [Ttot, H, bn]
  const float* s;            // [Ttot, 1, bn]
  void* out;                 // [M, H] T
  void* qkv;                 // [M, Nq] T
  float *p_wo, *x1, *ssq1, *p_gu, *hbuf, *p_down, *xo, *ssq2, *p_q;
  int M, H, I, bn, base, n_qkv, ks_wo, ks_gu, ks_down, ks_q;
  float eps;
};

template <int MT>
__device__ __forceinline__ void zero_red(float* red) {
  for (int i = threadIdx.x; i < MT * COLS; i += THREADS) red[i] = 0.f;
}

// One batch of weight words: rows r0 + u * WARPS (u < UNROLL) of the
// lane's 4 columns at qp (row stride ldw); rows >= kc read as 0.
__device__ __forceinline__ void load_batch(const int8_t* __restrict__ qp, int ldw, int r0, int kc,
                                           uint32_t (&wv)[UNROLL]) {
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int r = r0 + u * WARPS;
    wv[u] = r < kc ? __ldg(reinterpret_cast<const unsigned int*>(qp + (size_t)r * ldw)) : 0u;
  }
}

// red[m][c] = sum over kc rows r of xs[r][m] * w[r][c] for the lane's 4
// columns at qp; wv holds the warp's first batch already. xs must be
// staged and red zeroed before the barrier preceding this call; ends after
// a barrier.
template <int MT>
__device__ __forceinline__ void gemv_unit(const int8_t* __restrict__ qp, int ldw, int kc,
                                          uint32_t (&wv)[UNROLL], const float* xs, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;
  for (int r0 = warp; r0 < kc; r0 += WARPS * UNROLL) {
    uint32_t cur[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) cur[u] = wv[u];
    if (r0 + WARPS * UNROLL < kc) load_batch(qp, ldw, r0 + WARPS * UNROLL, kc, wv);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = r0 + u * WARPS;
      if (r >= kc) break;
      const float* xr = xs + r * MT;
      float wf[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) wf[j] = s8_to_f(cur[u], j);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float xv = xr[m];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[m][j] = fmaf(xv, wf[j], acc[m][j]);
      }
    }
  }
  for (int turn = 0; turn < WARPS; ++turn) {
    if (warp == turn) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) red[m * COLS + lane * 4 + j] += acc[m][j];
    }
    __syncthreads();
  }
}

// One GEMV phase over tiles [t0, t0 + n_tiles) of w: units (tile, group,
// K slice); stage(t, m, k) gives input value (m, k) of tile t, dst(t, sl, m,
// c) the address of that slice's partial for output column c of the tile.
template <int MT, typename Stage, typename Dst>
__device__ __forceinline__ void gemv_phase(const int8_t* w, const float* s, int H, int bn, int M,
                                           int t0, int n_tiles, int ks, float* smem, Stage stage,
                                           Dst dst) {
  float* xs = smem;                  // [kc][MT]
  float* red = smem + XS_BYTES / 4;  // [MT][COLS]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int groups = bn / COLS;
  const size_t tile_elems = (size_t)H * bn;
  const int kc = H / ks, units = n_tiles * groups * ks, n_st = kc * MT;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int sl = u % ks, grp = (u / ks) % groups, t = u / (ks * groups);
    const int k0 = sl * kc;
    const size_t tg = (size_t)(t0 + t);
    const int8_t* qp = w + tg * tile_elems + (size_t)k0 * bn + grp * COLS + lane * 4;
    uint32_t wv[UNROLL];
    load_batch(qp, bn, warp, kc, wv);  // in flight while the input is staged
    for (int c0 = 0; c0 < n_st; c0 += SPT * THREADS) {
      float sv[SPT];
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        const int i = c0 + tid + j * THREADS, m = i % MT;
        sv[j] = (i < n_st && m < M) ? stage(t, m, k0 + i / MT) : 0.f;
      }
      if (c0 == 0) __syncthreads();  // the previous unit is done with xs and red
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        const int i = c0 + tid + j * THREADS;
        if (i < n_st) xs[i] = sv[j];
      }
    }
    zero_red<MT>(red);
    __syncthreads();
    gemv_unit<MT>(qp, bn, kc, wv, xs, red);
    const float* srow = s + tg * bn + grp * COLS;
    for (int i = tid; i < M * COLS; i += THREADS) {
      const int m = i / COLS, c = i % COLS;
      *dst(t, sl, m, grp * COLS + c) = red[m * COLS + c] * srow[c];
    }
  }
}

// rstd[m] from the per-block row sums of squares of the previous phase.
__device__ __forceinline__ void row_rstd(const float* ssq, int M, int H, float eps,
                                         float* rstd) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int m = warp; m < M; m += WARPS) {
    float v = 0.f;
    for (int blk = lane; blk < (int)gridDim.x; blk += 32) v += __ldcg(ssq + (size_t)blk * M + m);
    v = warp_sum(v);
    if (lane == 0) rstd[m] = rsqrtf(v / H + eps);
  }
}

// Store the block's per-row sums of squares (accumulated in sq[]).
__device__ __forceinline__ void store_ssq(const float* sq, float* ssq, int M) {
  __syncthreads();
  for (int m = threadIdx.x; m < M; m += THREADS) ssq[(size_t)blockIdx.x * M + m] = sq[m];
}

// Phases 7-8: qkv = (bf16(src * rstd * gamma) @ tiles [t0, t0 + n_qkv)) * s,
// rstd from the row sums of squares ssq (stored before the last barrier).
// src [M, H] f32 was written in this launch. Ends without a barrier.
template <int MT, typename T>
__device__ void qkv_phases(const int8_t* w, const float* s, const float* src, const float* ssq,
                           const float* gamma, int M, int H, int bn, int t0, int n_qkv, int ks,
                           float eps, float* p_q, T* qkv, float* smem, float* rstd_s,
                           cg::grid_group& grid) {
  const int Nq = n_qkv * bn;
  row_rstd(ssq, M, H, eps, rstd_s);
  __syncthreads();
  gemv_phase<MT>(
      w, s, H, bn, M, t0, n_qkv, ks, smem,
      [&](int, int m, int k) {
        return round_bf16(__ldcg(src + (size_t)m * H + k) * rstd_s[m] * gamma[k]);
      },
      [&](int t, int sl, int m, int c) { return p_q + ((size_t)sl * M + m) * Nq + t * bn + c; });
  grid.sync();
  const int stride = gridDim.x * THREADS;
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < M * Nq; i += stride) {
    float v = 0.f;
#pragma unroll 8
    for (int sl = 0; sl < ks; ++sl) v += __ldcg(p_q + (size_t)sl * M * Nq + i);
    qkv[i] = from_f<T>(v);
  }
}

// Phases 1-8 of one layer; ends without a barrier (after fin3, or after
// fin2 when n_qkv == 0, with the row sums of squares of x_out in ssq2 and
// x_out itself in xo either way). att and x may have been written earlier
// in the same launch.
template <int MT, typename T>
__device__ void tail_phases(const Params& p, float* smem, cg::grid_group& grid) {
  __shared__ float rstd_s[32], sq_s[32];
  const int tid = threadIdx.x, lane = tid & 31;
  const int M = p.M, H = p.H, I = p.I, bn = p.bn;
  const int n_cols = H / bn, n_wo = n_cols, n_gu = 2 * I / bn, n_down = (I / H) * n_cols;
  const int t_wo = p.base, t_gu = t_wo + n_wo, t_down = t_gu + n_gu, t_q = t_down + n_down;
  const T* x = static_cast<const T*>(p.x);
  const int stride = gridDim.x * THREADS;

  // 1 wo.
  gemv_phase<MT>(
      p.w, p.s, H, bn, M, t_wo, n_wo, p.ks_wo, smem,
      [&](int, int m, int k) { return ldcg_f(p.att + (size_t)m * H + k); },
      [&](int t, int sl, int m, int c) {
        return p.p_wo + ((size_t)sl * M + m) * H + t * bn + c;
      });
  grid.sync();

  // 2 fin1: x1 = x + sum of the wo slices; row sums of squares.
  if (tid < 32) sq_s[tid] = 0.f;
  __syncthreads();
  for (int i = blockIdx.x * THREADS + tid; i < M * H; i += stride) {  // whole warps: H % 32 == 0
    float v = ldcg_f(x + i);
#pragma unroll 8
    for (int sl = 0; sl < p.ks_wo; ++sl) v += __ldcg(p.p_wo + (size_t)sl * M * H + i);
    p.x1[i] = v;
    const float sq = warp_sum(v * v);
    if (lane == 0) atomicAdd(&sq_s[i / H], sq);
  }
  store_ssq(sq_s, p.ssq1, M);
  grid.sync();

  // 3 gate | up, input bf16(x1 * rstd * gamma_mlp).
  row_rstd(p.ssq1, M, H, p.eps, rstd_s);
  __syncthreads();
  gemv_phase<MT>(
      p.w, p.s, H, bn, M, t_gu, n_gu, p.ks_gu, smem,
      [&](int, int m, int k) {
        return round_bf16(__ldcg(p.x1 + (size_t)m * H + k) * rstd_s[m] * p.g_mlp[k]);
      },
      [&](int t, int sl, int m, int c) {
        return p.p_gu + ((size_t)sl * M + m) * 2 * I + (t & 1) * I + (t >> 1) * bn + c;
      });
  grid.sync();

  // 4 fin_h: h = bf16(silu(g) * u).
  for (int i = blockIdx.x * THREADS + tid; i < M * I; i += stride) {
    const int m = i / I, n = i % I;
    float g = 0.f, u = 0.f;
#pragma unroll 4
    for (int sl = 0; sl < p.ks_gu; ++sl) {
      const float* row = p.p_gu + ((size_t)sl * M + m) * 2 * I;
      g += __ldcg(row + n);
      u += __ldcg(row + I + n);
    }
    p.hbuf[i] = round_bf16(g / (1.f + expf(-g)) * u);
  }
  grid.sync();

  // 5 down: tile d covers rows [kchunk * H, +H) of down, columns nc * bn.
  gemv_phase<MT>(
      p.w, p.s, H, bn, M, t_down, n_down, p.ks_down, smem,
      [&](int t, int m, int k) {
        return __ldcg(p.hbuf + (size_t)m * I + (t / n_cols) * H + k);
      },
      [&](int t, int sl, int m, int c) {
        return p.p_down + (((size_t)(t / n_cols) * p.ks_down + sl) * M + m) * H +
               (t % n_cols) * bn + c;
      });
  grid.sync();

  // 6 fin2: x_out = x1 + sum of the down partials.
  if (tid < 32) sq_s[tid] = 0.f;
  __syncthreads();
  const int n_dp = (I / H) * p.ks_down;
  T* out = static_cast<T*>(p.out);
  for (int i = blockIdx.x * THREADS + tid; i < M * H; i += stride) {
    float v = __ldcg(p.x1 + i);
#pragma unroll 8
    for (int sl = 0; sl < n_dp; ++sl) v += __ldcg(p.p_down + (size_t)sl * M * H + i);
    out[i] = from_f<T>(v);
    p.xo[i] = v;
    const float sq = warp_sum(v * v);
    if (lane == 0) atomicAdd(&sq_s[i / H], sq);
  }
  store_ssq(sq_s, p.ssq2, M);
  if (p.n_qkv == 0) return;  // the last layer has no next wqkv
  grid.sync();

  // 7-8 the next layer's wqkv, input bf16(x_out * rstd * gamma_next).
  qkv_phases<MT, T>(p.w, p.s, p.xo, p.ssq2, p.g_next, M, H, bn, t_q, p.n_qkv, p.ks_q, p.eps,
                    p.p_q, static_cast<T*>(p.qkv), smem, rstd_s, grid);
}

// Cooperative launch of kernel k (grid blocks of THREADS), opting the
// kernel into smem_bytes(m_tile) of dynamic shared memory on first use.
inline const void* opted(const void* k, int m_tile, bool* done) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64 || !done[dev]) {
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(m_tile));
    if (dev < 64) done[dev] = true;
  }
  return k;
}

inline int blocks_per_sm(const void* k, int m_tile, int* out) {
  *out = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, k, THREADS, smem_bytes(m_tile));
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

}  // namespace tail
