// flash_tf32_fwd: the causal grouped-query flash-attention forward in f32 at
// every D % 64 == 0, with or without its row statistics, on Hopper's TMA and
// tf32 warpgroup MMA.
//
// Replaces the TPU kernels mila_tpu/kernels/flash_attention.py:_fa_kernel
// and _fa_kernel_t (entry flash_attention -> _flash_attention_forward, with
// and without save_stats) for f32 inputs.
//
// Bound on the H100: tf32 tensor-core operations (4 Tq Tkv D per head, about
// half skipped by the causal tiles) against q, k, v read and o written once
// (at GPT-2's shape the bytes bound: 0.030 ms against 0.026 of operations).
// Design: a prep launch (prep_cols_kernel, 64 columns a block, at every D)
// writes K rounded to tf32 and V rounded and transposed ([D][Tkv] per KV
// head, its rows in row_at's order), since P V contracts over V's rows and
// tf32 wgmma takes no transpose bit.
// Then one block per (64 NWG query rows, head, batch row), the q tiles
// heaviest first: a producer warp loads the Q tile once by TMA (rows past
// Tq read zeros) and streams key tiles of BK (K [BK][D], V^T [D][BK])
// through a ring of NT stages; NWG consumer warpgroups of 64 rows (FwdCfg:
// 2 with 64-key tiles up to D 128, 1 with 32-key tiles at D 192 and 256)
// round their Q rows to tf32 in shared memory once, then per key tile run
// S = Q K^T on SS wgmma m64nBKk8, the online softmax in f32 on S's
// registers (4 lanes a row), and O += T(P) V on RS wgmma m64nDk8 (P from the
// accumulator, pack_a; V^T as B). A warpgroup skips the key tiles its rows
// do not see.
// Past D 256 (fwd_part_kernel, flash_part.cuh's plan): the same prep, then
// one block per (64 query rows, head and column part of up to 512 columns,
// batch row) whose two warpgroups both form the tile's whole S on 16-key
// tiles and each add P V into half of the part's columns (V^T's tiles are
// rows of 16 keys, 64 bytes, read with the 64-byte swizzle). Q stays in
// shared memory when it fits beside a K and a V stage (to D 640), else
// streams beside K in 32-column chunks, each rounded to tf32 as it lands.
//
// Built in four parts (kernels/_build.py: PARTS), one nvcc each: parts 1
// and 2 instantiate D 64 and 128, and D 192 and 256, part 3 the kernels past
// D 256; part 0 holds the C entry points.
//
// The TPU kernel's semantics: the causal tile skip
// with kv_offset; masked scores take the finite -0.7 * f32max (after the
// scaling); p = exp(s - m) rounded to tf32 before P V while l sums the f32
// p, both against the running max of the key tiles; 1 / l with l == 0
// guarded at the store; query head h reads KV head h / G. l and m (m of the
// scaled scores) are written per row when asked for: the statistics the
// backward reads. Layouts are the model's: q and out [B, Tq, NH, D], k and v
// [B, Tkv, NKV, D], f32, contiguous, 16-byte-aligned bases.
#include "flash_part.cuh"
#include "flash_tf32.cuh"

namespace tfwd_parts {  // one call's arguments, and each part's launches

struct Call {
  const float *q, *k, *v;
  float *out, *l_out, *m_out, *scratch;
  int B, Tq, Tkv, NH, NKV, D;
  float sm_scale;
  int kv_offset, causal;
  cudaStream_t stream;
};

int run_narrow(const Call& c);  // D 64, 128
int run_wide(const Call& c);    // D 192, 256
int run_part(const Call& c);    // D % 64 == 0 past 256

}  // namespace tfwd_parts

namespace {

using namespace ftf32;

constexpr float MASK_VALUE = -0.7f * 3.402823466e38f;

// Two warpgroups of 64 rows and key tiles of 64 up to D 128; at D 192 and
// 256, where O takes D / 2 registers a thread, one warpgroup and key tiles
// of 32.
template <int D>
struct FwdCfg {
  static constexpr int NWG = D <= 128 ? 2 : 1;
  static constexpr int BQ = 64 * NWG;           // query rows a block
  static constexpr int BK = D <= 128 ? 64 : 32;  // keys a tile
  static constexpr int NT = D == 64 ? 4 : D == 192 ? 3 : 2;
  static constexpr int CONSUMERS = 128 * NWG, THREADS = CONSUMERS + 32;
  static constexpr int Q_BYTES = BQ * D * 4;
  static constexpr int K_BYTES = BK * D * 4;  // one of K, V^T
  static constexpr int STAGE = 2 * K_BYTES;
  static constexpr int SMEM = Q_BYTES + NT * STAGE + (2 * NT + 1) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(FwdCfg<D>::THREADS, 1)
fwd_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
           const __grid_constant__ CUtensorMap mvt, float* __restrict__ out,
           float* __restrict__ l_out, float* __restrict__ m_out, int Tq, int Tkv, int NH,
           int NKV, float sm_scale, int kv_offset, int causal) {
  using C = FwdCfg<D>;
  constexpr int NT = C::NT, BQ = C::BQ, BK = C::BK, NO = D / 2, NS = BK / 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* qs = smem;                    // Q: [D / 32 panels][BQ rows][128 B]
  unsigned char* stages = qs + C::Q_BYTES;     // [NT][K, V^T]
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + NT * C::STAGE);
  uint64_t* empty = full + NT;
  uint64_t* q_full = empty + NT;

  const int tid = threadIdx.x;
  const int qt = gridDim.z - 1 - blockIdx.z;  // heaviest q tiles first
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (NH / NKV);
  const int q0 = qt * BQ;
  int n_kv = Tkv / BK;
  if (causal) {
    const int last = q0 + BQ - 1 + kv_offset;  // the TPU kernel's tile-skip rule
    n_kv = last < 0 ? 0 : min(n_kv, last / BK + 1);
  }
  if (tid == 0) {
    for (int s = 0; s < NT; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], C::CONSUMERS);
    }
    mbar_init(q_full, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == C::CONSUMERS) {  // the producer
    mbar_expect_tx(q_full, C::Q_BYTES);
#pragma unroll
    for (int p = 0; p < D / 32; ++p)
#pragma unroll
      for (int hf = 0; hf < C::NWG; ++hf)
        tma_load_3d(qs + p * BQ * PANEL_ROW + hf * 64 * PANEL_ROW, &mq, q_full, h * D + 32 * p,
                    q0 + 64 * hf, b);
    const int krow = (b * NKV + hk) * Tkv;
    for (int j = 0; j < n_kv; ++j) {
      const int s = j % NT;
      if (j >= NT) mbar_wait(&empty[s], (j / NT - 1) & 1);
      unsigned char* st = stages + s * C::STAGE;
      mbar_expect_tx(&full[s], C::STAGE);
#pragma unroll
      for (int p = 0; p < D / 32; ++p)
        tma_load_2d(st + p * BK * PANEL_ROW, &mk, &full[s], 32 * p, krow + j * BK);
#pragma unroll
      for (int y = 0; y < BK / 32; ++y)
        tma_load_2d(st + C::K_BYTES + y * D * PANEL_ROW, &mvt, &full[s], j * BK + 32 * y,
                    (b * NKV + hk) * D);
    }
  }
  if (tid >= C::CONSUMERS) return;

  // ---- consumer warpgroups: query rows [q0 + 64 wg, q0 + 64 wg + 64) ----
  const int wg = tid >> 7, lane = tid & 31, w = (tid >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = q0 + 64 * wg + 16 * w;  // the warp's first query row
  const int r0 = wrow + g;                 // this thread's rows r0 and r0 + 8
  unsigned char* qa = qs + wg * 64 * PANEL_ROW;  // the warpgroup's rows of each panel
  // The key tiles this warpgroup's rows see.
  int n_mine = n_kv;
  if (causal) n_mine = min(n_kv, (q0 + 64 * wg + 63 + kv_offset) / BK + 1);

  // Q's rows rounded to tf32 in place, once (the swizzle moves 16-byte
  // chunks, so each float stays a float of the same row).
  mbar_wait(q_full, 0);
  {
    const int ltid = tid & 127;
#pragma unroll
    for (int p = 0; p < D / 32; ++p)
#pragma unroll
      for (int i = 0; i < 64 * 8 / 128; ++i) {
        float4* f = reinterpret_cast<float4*>(qa + p * BQ * PANEL_ROW) + ltid + 128 * i;
        const float4 x = *f;
        *f = make_float4(tf32f(x.x), tf32f(x.y), tf32f(x.z), tf32f(x.w));
      }
    fence_proxy_async();  // the rounded rows are wgmma's operands
    named_bar_sync(1 + wg, 128);
  }

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int j = 0; j < n_mine; ++j) {
    const int s = j % NT, k0 = j * BK;
    const unsigned char* st = stages + s * C::STAGE;
    float sc[NS];
    mbar_wait(&full[s], (j / NT) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
      wgmma_tf32<BK>(sc, slice(qa, BQ, kk), slice(st, BK, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();  // S, and the last tile's P V
    wgmma_fence_operand<NS>(sc);
    wgmma_fence_operand<NO>(o);
    if (j > 0) mbar_arrive(&empty[(j - 1) % NT]);
    // The online softmax: sc[4 jj + i] is row r0 + 8 (i / 2), key k0 + 8 jj +
    // 2 t + i % 2; the mask only on tiles past the warp's first row.
    const bool diag = causal && k0 + BK - 1 > wrow + kv_offset;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int jj = 0; jj < BK / 8; ++jj)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = 4 * jj + i, hr = i >> 1;
        float val = sc[e] * sm_scale;
        if (diag && k0 + 8 * jj + 2 * t + (i & 1) > r0 + 8 * hr + kv_offset) val = MASK_VALUE;
        sc[e] = val;
        mx[hr] = fmaxf(mx[hr], val);
      }
    float alpha[2], ls[2] = {0.f, 0.f};
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
      const float m_new = fmaxf(m[hr], mx[hr]);
      alpha[hr] = ex2((m[hr] - m_new) * LOG2E);
      m[hr] = m_new;
    }
#pragma unroll
    for (int e = 0; e < NS; ++e) {
      const int hr = (e >> 1) & 1;
      const float p = ex2((sc[e] - m[hr]) * LOG2E);
      sc[e] = p;
      ls[hr] += p;
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      ls[hr] += __shfl_xor_sync(0xffffffffu, ls[hr], 1);
      ls[hr] += __shfl_xor_sync(0xffffffffu, ls[hr], 2);
      l[hr] = alpha[hr] * l[hr] + ls[hr];
    }
#pragma unroll
    for (int e = 0; e < NO; ++e) o[e] *= alpha[(e >> 1) & 1];
    uint32_t pa[BK / 8][4];
    pack_a<BK>(pa, sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk)
      wgmma_tf32_rs<D>(o, pa[kk], slice(st + C::K_BYTES, D, kk), 1);
    wgmma_commit();
  }
  wgmma_wait<0>();
  wgmma_fence_operand<NO>(o);
  // The key tiles past this warpgroup's rows: each released once it has
  // landed, so no release runs ahead of the stage's next load.
  for (int j = n_mine; j < n_kv; ++j) {
    if (j > 0) mbar_arrive(&empty[(j - 1) % NT]);
    mbar_wait(&full[j % NT], (j / NT) & 1);
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r0 + 8 * hr;
    if (row >= Tq) continue;
    const float inv = l[hr] == 0.f ? 1.f : 1.f / l[hr];
    if (l_out != nullptr && t == 0) {
      const size_t srow = ((size_t)b * NH + h) * Tq + row;
      l_out[srow] = l[hr];
      m_out[srow] = m[hr];
    }
    float* orow = out + (((size_t)b * Tq + row) * NH + h) * D;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj)
      *reinterpret_cast<float2*>(orow + 8 * jj + 2 * t) =
          make_float2(o[4 * jj + 2 * hr] * inv, o[4 * jj + 2 * hr + 1] * inv);
  }
}

constexpr int PREP_COLS = 64;  // columns a block of prep_cols_kernel

// The prep launch: K rounded to tf32 ([B NKV T][D]) and V rounded and
// transposed ([B NKV D][T], each 8 keys in row_at's order), for any D % 64
// == 0: one block per (32 keys, 64 columns, KV head, batch row), so its
// tile stays 8 KB at any D.
__global__ void __launch_bounds__(PREP_THREADS)
prep_cols_kernel(const float* __restrict__ k, const float* __restrict__ v,
                 float* __restrict__ kr, float* __restrict__ vt, int T, int H, int D) {
  __shared__ float tile[PREP_ROWS][PREP_COLS + 1];  // V's rows, rounded
  const int tid = threadIdx.x, ncol = D / PREP_COLS;
  const int t0 = blockIdx.x * PREP_ROWS, h = blockIdx.y / ncol;
  const int c0 = (blockIdx.y % ncol) * PREP_COLS, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  for (int i = tid; i < PREP_ROWS * PREP_COLS / 4; i += PREP_THREADS) {
    const int r = i / (PREP_COLS / 4), col = 4 * (i % (PREP_COLS / 4)), t = t0 + r;
    const size_t src = (((size_t)b * T + t) * H + h) * D + c0 + col;
    const float4 x = *reinterpret_cast<const float4*>(v + src);
    const float4 y = *reinterpret_cast<const float4*>(k + src);
    *reinterpret_cast<float4*>(kr + (bh * T + t) * D + c0 + col) =
        make_float4(tf32f(y.x), tf32f(y.y), tf32f(y.z), tf32f(y.w));
    float* pv = &tile[r][col];
    pv[0] = tf32f(x.x), pv[1] = tf32f(x.y), pv[2] = tf32f(x.z), pv[3] = tf32f(x.w);
  }
  __syncthreads();
  for (int i = tid; i < PREP_COLS * PREP_ROWS; i += PREP_THREADS) {
    const int d = i / PREP_ROWS, q = i % PREP_ROWS;
    vt[(bh * D + c0 + d) * T + t0 + q] = tile[row_at(q)][d];
  }
}


// The prep launch into the call's scratch: K rounded [B NKV Tkv][D], then V
// rounded and transposed [B NKV D][Tkv].
int launch_prep(const tfwd_parts::Call& c) {
  const size_t RK = (size_t)c.B * c.NKV * c.Tkv;
  prep_cols_kernel<<<dim3(c.Tkv / PREP_ROWS, c.NKV * (c.D / PREP_COLS), c.B), PREP_THREADS, 0,
                     c.stream>>>(c.k, c.v, c.scratch, c.scratch + RK * c.D, c.Tkv, c.NKV, c.D);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const tfwd_parts::Call& c) {
  using C = FwdCfg<D>;
  const size_t RK = (size_t)c.B * c.NKV * c.Tkv;
  float* kr = c.scratch;          // K rounded [RK][D]
  float* vt = c.scratch + RK * D;  // V rounded, transposed [B NKV D][Tkv]
  if (const int e = launch_prep(c)) return e;
  CUtensorMap mq, mk, mvt;
  if (!encode_3d(&mq, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, c.q, c.B, c.Tq, (uint64_t)c.NH * D, 64,
                 32, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_f32(&mk, kr, RK, D, C::BK) ||
      !encode_f32(&mvt, vt, (uint64_t)c.B * c.NKV * D, c.Tkv, D))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool sized[64] = {};
  auto kern = fwd_kernel<D>;
  const cudaError_t e = size_smem(kern, C::SMEM, sized);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<dim3(c.NH, c.B, (c.Tq + C::BQ - 1) / C::BQ), C::THREADS, C::SMEM, c.stream>>>(
      mq, mk, mvt, c.out, c.l_out, c.m_out, c.Tq, c.Tkv, c.NH, c.NKV, c.sm_scale, c.kv_offset,
      c.causal);
  return static_cast<int>(cudaGetLastError());
}

// ---- past D 256 (flash_part.cuh: the plan) ---------------------------------

// `panels` 32-column panels of Q (64 rows x 128 bytes each) rounded to tf32
// in place by the block's 256 threads, then fenced for wgmma and waited for
// by both warpgroups.
__device__ __forceinline__ void round_panels(unsigned char* q, int panels, int tid) {
  float4* f = reinterpret_cast<float4*>(q);
  for (int i = tid; i < panels * fpart::BQ * 8; i += fpart::THREADS) {
    const float4 x = f[i];
    f[i] = make_float4(tf32f(x.x), tf32f(x.y), tf32f(x.z), tf32f(x.w));
  }
  fence_proxy_async();
  named_bar_sync(fpart::ROUNDED, fpart::THREADS);
}

// O += T(P) V^T's rows [0, n) from vt (the warpgroup's first row of the V
// tile: rows of 16 keys, 64 bytes, 64-byte swizzle) for k-slice kk of 8 keys.
template <int N>
__device__ __forceinline__ void pv_rows(float* o, const uint32_t* pa, const unsigned char* vt,
                                       int kk) {
  wgmma_tf32_rs<N>(o, pa, wgmma_desc_64b(vt + 32 * kk, 512), 1);
}

// Past D 256, f32: the block of flash_fwd.cu's flash_fwd_part_kernel on tf32
// wgmma, after the prep launch. Both warpgroups form the same S = Q K^T of
// each 16-key tile (SS m64n16k8 over D / 8 k-slices) and run the same
// softmax; warpgroup wg adds P V into its half of the part's columns (RS
// m64nNk8, P from the accumulator, pack_a; V^T's rows as B), so O takes at
// most 128 registers a thread. The products always span DCMAX / 2 rows of
// V^T (past a narrower part's half: values never stored). Q resident (QRES)
// is rounded to tf32 once in shared memory; streamed, each chunk as it lands.
template <int DCMAX, bool QRES>
__global__ void __launch_bounds__(fpart::THREADS, 1)
fwd_part_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                const __grid_constant__ CUtensorMap mvt, float* __restrict__ out,
                float* __restrict__ l_out, float* __restrict__ m_out, const fpart::Args a) {
  constexpr int BK = 16, BQ = fpart::BQ, NO = DCMAX / 4, NS = BK / 2;
  constexpr int QP = BQ * PANEL_ROW;  // a Q panel's bytes
  const fpart::Plan& p = a.p;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* qs = smem;                  // Q resident: [D / 32][64 rows][128 B]
  unsigned char* kring = qs + p.q_bytes;     // K tiles [D / 32][16][128 B], or Q and K chunks
  unsigned char* vring = kring + p.nk * p.k_slot;  // V^T tiles [part's columns][64 B]
  uint64_t* full_k = reinterpret_cast<uint64_t*>(vring + p.nv * p.v_slot);
  uint64_t* empty_k = full_k + p.nk;
  uint64_t* full_v = empty_k + p.nk;
  uint64_t* empty_v = full_v + p.nv;
  uint64_t* q_full = empty_v + p.nv;

  const int tid = threadIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest q tiles first
  const int h = blockIdx.x / p.parts, part = blockIdx.x % p.parts, b = blockIdx.z;
  const int c0 = part * p.dc, nc = min(p.dc, a.D - c0);
  const int hk = h / (a.NH / a.NKV);
  const int q0 = qt * BQ;
  int n_kv = a.Tkv / BK;
  if (a.causal) {
    const int last = q0 + BQ - 1 + a.kv_offset;  // the TPU kernel's tile-skip rule
    n_kv = last < 0 ? 0 : min(n_kv, last / BK + 1);
  }
  const int chunks = QRES ? 1 : a.D / 32;
  const int n_k = n_kv * chunks;
  const int krow = (b * a.NKV + hk) * a.Tkv, vrow = (b * a.NKV + hk) * a.D + c0;
  if (tid == 0) {
    for (int s = 0; s < p.nk; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&empty_k[s], fpart::THREADS);
    }
    for (int s = 0; s < p.nv; ++s) {
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_v[s], fpart::THREADS);
    }
    mbar_init(q_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  auto load_k = [&](int kj) {
    const int s = kj % p.nk;
    if (kj >= p.nk) mbar_wait(&empty_k[s], (kj / p.nk - 1) & 1);
    unsigned char* dst = kring + s * p.k_slot;
    mbar_expect_tx(&full_k[s], p.k_slot);
    if constexpr (QRES) {  // the tile's D / 32 panels in one box
      tma_load_3d(dst, &mk, &full_k[s], 0, krow + kj * BK, 0);
    } else {  // chunk c of key tile kj / chunks: Q's panel c, then K's
      const int c = kj % chunks;
      tma_load_4d(dst, &mq, &full_k[s], 0, q0, h * a.D / 32 + c, b);
      tma_load_3d(dst + QP, &mk, &full_k[s], 0, krow + kj / chunks * BK, c);
    }
  };
  auto load_v = [&](int j) {  // V^T's rows of the part, 16 keys each
    const int s = j % p.nv;
    if (j >= p.nv) mbar_wait(&empty_v[s], (j / p.nv - 1) & 1);
    unsigned char* dst = vring + s * p.v_slot;  // dc rows in two boxes (past a
    mbar_expect_tx(&full_v[s], p.dc * BK * 4);   // narrower last part: never read)
    tma_load_2d(dst, &mvt, &full_v[s], j * BK, vrow);
    tma_load_2d(dst + p.dc / 2 * BK * 4, &mvt, &full_v[s], j * BK, vrow + p.dc / 2);
  };
  if (tid == fpart::ISSUER) {
    if constexpr (QRES) {
      mbar_expect_tx(q_full, p.q_bytes);
      tma_load_4d(qs, &mq, q_full, 0, q0, h * a.D / 32, b);
    }
    for (int kj = 0; kj < min(p.nk, n_k); ++kj) load_k(kj);
    for (int j = 0; j < min(p.nv, n_kv); ++j) load_v(j);
  }

  const int wg = tid >> 7, lane = tid & 31, w = (tid >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = q0 + 16 * w;  // both warpgroups hold the same 64 rows
  const int r0 = wrow + g;
  const int wcols = nc / 2, col0 = wg * wcols;  // this warpgroup's columns of the part

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  if constexpr (QRES) {
    mbar_wait(q_full, 0);
    round_panels(qs, a.D / 32, tid);
    if (n_kv > 0 && wg == 1) named_bar_arrive(fpart::SCHED, fpart::THREADS);
  }
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * BK;
    float sc[NS];
    if constexpr (QRES) {
      const int s = j % p.nk;
      const unsigned char* ks = kring + s * p.k_slot;
      mbar_wait(&full_k[s], (j / p.nk) & 1);
      named_bar_sync(fpart::SCHED + wg, fpart::THREADS);
      wgmma_fence();
#pragma unroll 1
      for (int c = 0; c < a.D / 32; ++c)  // 32-column panels, not unrolled: no remainder
#pragma unroll
        for (int i = 0; i < 4; ++i)
          wgmma_tf32<BK>(sc, slice(qs, BQ, 4 * c + i), slice(ks, BK, 4 * c + i), c > 0 || i > 0);
      wgmma_commit();
      named_bar_arrive(fpart::SCHED + 1 - wg, fpart::THREADS);
      wgmma_wait<0>();
      wgmma_fence_operand<NS>(sc);
      mbar_arrive(&empty_k[s]);
      if (tid == fpart::ISSUER && j + p.nk < n_k) load_k(j + p.nk);
    } else {
      for (int cc = 0; cc < chunks; ++cc) {
        const int kj = j * chunks + cc, s = kj % p.nk;
        unsigned char* st = kring + s * p.k_slot;
        mbar_wait(&full_k[s], (kj / p.nk) & 1);
        round_panels(st, 1, tid);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_tf32<BK>(sc, slice(st, BQ, kk), slice(st + QP, BK, kk), kk > 0 || cc > 0);
        wgmma_commit();
        wgmma_wait<0>();
        wgmma_fence_operand<NS>(sc);
        mbar_arrive(&empty_k[s]);
        if (tid == fpart::ISSUER && kj + p.nk < n_k) load_k(kj + p.nk);
      }
    }
    // The online softmax, as fwd_kernel's: sc[4 jj + i] is row r0 + 8 (i /
    // 2), key k0 + 8 jj + 2 t + i % 2; the mask only on tiles past the
    // warp's first row.
    const bool diag = a.causal && k0 + BK - 1 > wrow + a.kv_offset;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int jj = 0; jj < BK / 8; ++jj)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = 4 * jj + i, hr = i >> 1;
        float val = sc[e] * a.sm_scale;
        if (diag && k0 + 8 * jj + 2 * t + (i & 1) > r0 + 8 * hr + a.kv_offset) val = MASK_VALUE;
        sc[e] = val;
        mx[hr] = fmaxf(mx[hr], val);
      }
    float alpha[2], ls[2] = {0.f, 0.f};
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
      const float m_new = fmaxf(m[hr], mx[hr]);
      alpha[hr] = ex2((m[hr] - m_new) * LOG2E);
      m[hr] = m_new;
    }
#pragma unroll
    for (int e = 0; e < NS; ++e) {
      const int hr = (e >> 1) & 1;
      const float pe = ex2((sc[e] - m[hr]) * LOG2E);
      sc[e] = pe;
      ls[hr] += pe;
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      ls[hr] += __shfl_xor_sync(0xffffffffu, ls[hr], 1);
      ls[hr] += __shfl_xor_sync(0xffffffffu, ls[hr], 2);
      l[hr] = alpha[hr] * l[hr] + ls[hr];
    }
#pragma unroll
    for (int e = 0; e < NO; ++e) o[e] *= alpha[(e >> 1) & 1];
    uint32_t pa[BK / 8][4];
    pack_a<BK>(pa, sc);

    const int sv = j % p.nv;
    const unsigned char* vt = vring + sv * p.v_slot + col0 * 64;
    mbar_wait(&full_v[sv], (j / p.nv) & 1);
    if constexpr (QRES) named_bar_sync(fpart::SCHED + wg, fpart::THREADS);
    wgmma_fence_operand<NO>(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {  // DCMAX / 2 columns, past a narrower part's too
      if constexpr (DCMAX == 512) {
        pv_rows<256>(o, pa[kk], vt, kk);
      } else {
        pv_rows<128>(o, pa[kk], vt, kk);
        pv_rows<32>(o + 64, pa[kk], vt + 128 * 64, kk);
      }
    }
    wgmma_commit();
    if (QRES && (wg == 0 || j + 1 < n_kv))  // warpgroup 1 passed first
      named_bar_arrive(fpart::SCHED + 1 - wg, fpart::THREADS);
    wgmma_wait<0>();
    wgmma_fence_operand<NO>(o);
    mbar_arrive(&empty_v[sv]);
    if (tid == fpart::ISSUER && j + p.nv < n_kv) load_v(j + p.nv);
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r0 + 8 * hr;
    if (row >= a.Tq) continue;
    const float inv = l[hr] == 0.f ? 1.f : 1.f / l[hr];
    if (l_out != nullptr && part == 0 && wg == 0 && t == 0) {
      const size_t srow = ((size_t)b * a.NH + h) * a.Tq + row;
      l_out[srow] = l[hr];
      m_out[srow] = m[hr];
    }
    float* orow = out + (((size_t)b * a.Tq + row) * a.NH + h) * a.D + c0 + col0;
#pragma unroll
    for (int jj = 0; jj < NO / 4; ++jj)
      if (8 * jj < wcols)
        *reinterpret_cast<float2*>(orow + 8 * jj + 2 * t) =
            make_float2(o[4 * jj + 2 * hr] * inv, o[4 * jj + 2 * hr + 1] * inv);
  }
}

template <int DCMAX, bool QRES>
int launch_part(const tfwd_parts::Call& c, const fpart::Plan& p) {
  const size_t RK = (size_t)c.B * c.NKV * c.Tkv;
  float* kr = c.scratch;           // K rounded [RK][D]
  float* vt = c.scratch + RK * c.D;  // V rounded, transposed [B NKV D][Tkv]
  if (const int e = launch_prep(c)) return e;
  // Q [B][Tq][NH D] as [B][NH D / 32 panels][Tq][32 columns] and K rounded
  // [RK][D] as [D / 32 panels][RK][32 columns]: a box of `chunk` panels lands
  // as [panel][row][128 B], swizzled. V^T in boxes of half a part's rows.
  const auto f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  const int chunk = QRES ? c.D / 32 : 1;  // panels a Q or K box
  const uint64_t qw = (uint64_t)c.NH * c.D;
  const uint64_t q_dims[4] = {32, (uint64_t)c.Tq, qw / 32, (uint64_t)c.B};
  const uint64_t q_strides[3] = {qw * 4, 128, (uint64_t)c.Tq * qw * 4};
  const uint32_t q_box[4] = {32, fpart::BQ, (uint32_t)chunk, 1};
  const uint64_t k_dims[3] = {32, RK, (uint64_t)c.D / 32};
  const uint64_t k_strides[2] = {(uint64_t)c.D * 4, 128};
  const uint32_t k_box[3] = {32, 16, (uint32_t)chunk};
  CUtensorMap mq, mk, mvt;
  if (!encode_nd(&mq, f32, c.q, 4, q_dims, q_strides, q_box, sw) ||
      !encode_nd(&mk, f32, kr, 3, k_dims, k_strides, k_box, sw) ||
      !encode_2d(&mvt, f32, 4, vt, (uint64_t)c.B * c.NKV * c.D, c.Tkv, p.dc / 2, 16,
                 CU_TENSOR_MAP_SWIZZLE_64B))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = fwd_part_kernel<DCMAX, QRES>;
  static bool sized[64] = {};
  const cudaError_t e = size_smem(kern, fpart::SMEM_LIMIT, sized);
  if (e != cudaSuccess) return static_cast<int>(e);
  const fpart::Args a{c.Tq, c.Tkv, c.NH, c.NKV, c.D, c.sm_scale, c.kv_offset, c.causal, p};
  kern<<<dim3(c.NH * p.parts, (c.Tq + fpart::BQ - 1) / fpart::BQ, c.B), fpart::THREADS, p.smem,
         c.stream>>>(mq, mk, mvt, c.out, c.l_out, c.m_out, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#if IN_PART(1)
int tfwd_parts::run_narrow(const Call& c) {
  if (c.D == 64) return launch<64>(c);
  if (c.D == 128) return launch<128>(c);
  return static_cast<int>(cudaErrorInvalidValue);
}
#endif
#if IN_PART(2)
int tfwd_parts::run_wide(const Call& c) {
  if (c.D == 192) return launch<192>(c);
  if (c.D == 256) return launch<256>(c);
  return static_cast<int>(cudaErrorInvalidValue);
}
#endif

#if IN_PART(3)
int tfwd_parts::run_part(const Call& c) {
  if (c.D % 64) return static_cast<int>(cudaErrorInvalidValue);
  const fpart::Plan p = fpart::plan(c.D, 4);  // Q streams only past D 640, in parts of 512
  if (!p.q_res) return launch_part<fpart::DC_LARGE, false>(c, p);
  if (p.dcmax == fpart::DC_SMALL) return launch_part<fpart::DC_SMALL, true>(c, p);
  return launch_part<fpart::DC_LARGE, true>(c, p);
}
#endif

#if IN_PART(0)

// The f32 scratch flash_tf32_fwd needs for these shapes, in floats.
extern "C" long long flash_tf32_fwd_scratch(int B, int Tkv, int NKV, int D) {
  return 2LL * B * NKV * Tkv * D;
}

// q [B, Tq, NH, D], k and v [B, Tkv, NKV, D], out [B, Tq, NH, D], f32,
// contiguous, 16-byte-aligned bases; scratch f32 of flash_tf32_fwd_scratch
// floats, 16-byte aligned. D % 64 == 0 (else cudaErrorInvalidValue), Tkv %
// 128 == 0 and NH % NKV == 0 (checked by the Python wrapper). causal != 0
// masks key j for query i unless j <= i + kv_offset. l_out and m_out null, or f32 [B, NH, Tq]: each row's softmax
// sum l and max m of the scaled scores. Two launches on `stream`: the prep,
// the forward. Returns a cudaError_t.
extern "C" int flash_tf32_fwd(const void* q, const void* k, const void* v, void* out,
                              void* l_out, void* m_out, void* scratch, int B, int Tq, int Tkv,
                              int NH, int NKV, int D, float sm_scale, int kv_offset, int causal,
                              void* stream) {
  if (B <= 0 || Tq <= 0) return static_cast<int>(cudaGetLastError());
  const tfwd_parts::Call c{static_cast<const float*>(q),  static_cast<const float*>(k),
                           static_cast<const float*>(v),  static_cast<float*>(out),
                           static_cast<float*>(l_out),    static_cast<float*>(m_out),
                           static_cast<float*>(scratch),  B,
                           Tq,                            Tkv,
                           NH,                            NKV,
                           D,                             sm_scale,
                           kv_offset,                     causal,
                           static_cast<cudaStream_t>(stream)};
  return D <= 128 ? tfwd_parts::run_narrow(c)
         : D <= 256 ? tfwd_parts::run_wide(c)
                    : tfwd_parts::run_part(c);
}
#endif  // IN_PART(0)
