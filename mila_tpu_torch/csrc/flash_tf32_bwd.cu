// flash_tf32_bwd: the causal grouped-query flash-attention backward in f32
// at D 64 and 128, on Hopper's TMA and tf32 warpgroup MMA, from the
// forward's row statistics.
//
// Replaces the TPU kernels mila_tpu/kernels/flash_attention_bwd.py:
// _dkv_kernel (dK, dV) and _dq_kernel (dQ), entry flash_attention_bwd,
// reached from _fa_bwd (flash_attention.py), for f32 inputs. Per tile, as
// there:
//   p  = exp(s * scale - m) / l        (l == 0 taken as 1; masked p = 0)
//   dv += T(p)^T do
//   ds = p * (do v^T - D) * scale,     D = rowsum(o * do) in f32
//   dk += T(ds)^T q,  dq += T(ds) k
// with the causal tile skip under kv_offset >= 0; T(x) is x rounded to tf32
// (cvt.rna), as every operand of a product here is.
//
// Bound on the H100: tf32 tensor-core operations. The two passes run eleven
// products of 2 D multiply-adds per visible (query, key) pair and head: S
// and dP in each, dP on split operands (x = hi + lo, both tf32; hi hi + hi
// lo + lo hi, about f32's accuracy: dS = P (dP - D) cancels to 0 where a
// query sees one key, and a tf32 dP would leave 2^-11 of |dO| |V| there),
// then dQ, or dK and dV. Bytes: q, k, v, o, do, dq, dk, dv once, and the
// operand copies below.
//
// tf32 wgmma takes no transpose bit: both operands K-major. S = Q K^T and
// dP = dO V^T read Q, K, dO and V as they sit in memory, but dQ = dS K,
// dK = dS^T Q and dV = P^T dO contract over the rows of K, Q and dO. So one
// prep pass per side (two launches) writes every operand once as the
// products read it, rounded to tf32 (and split into hi and lo for dP):
//   Q side, per (batch, head) and Tq64 rows (Tq rounded up to 64, rows past
//     Tq zero): Q, dO hi, dO lo [rows][D]; Q^T and dO^T (hi) [D][rows]; lse2
//     = (m + ln l) log2(e) (+inf past Tq) and D (0 past Tq) per row;
//   K side, per (batch, KV head): K, V hi, V lo [Tkv][D]; K^T [D][Tkv].
// The transposed copies order each group of 8 rows as 0 2 4 6 1 3 5 7: the
// A fragment of tf32 wgmma holds k columns t and t + 4 of a lane, the S /
// dP accumulator columns 2 t and 2 t + 1, so dS (and P) pass from the
// accumulator to the next product's A fragment in the lane that holds them
// when B's k order is that one. Then every tile is a TMA box into 128-byte-
// swizzled f32 panels (32 columns, 128 bytes a row), and no pass rounds,
// splits or transposes in shared memory. The copies cost about 9 bytes
// written per 2 read (Q side) at GPT-2's shape, against K11 f32's eleven
// products.
//
//   dkv: one block per (64 NWG keys, KV head, batch row), the first key
//     blocks (the heaviest) first; NWG consumer warpgroups of 64 keys (2 at
//     D 64, 1 at D 128) and a producer warp. K, V hi and V lo stay in
//     shared memory; the block sweeps the (query head of the group, 32-row
//     q tile) steps that see its keys, each step's Q, dO hi, dO lo, Q^T,
//     dO^T, lse2 and D streaming through a ring of NT stages (3 at D 64, 1
//     at D 128, where a stage is 81 KB). Per step and warpgroup: S^T = K Q^T
//     and dP^T = V dO^T on SS wgmma m64n32k8; P^T and dS^T in their
//     registers; dV += T(P^T) dO^T^T and dK += T(dS^T) Q on RS wgmma
//     m64nDk8 (A from the accumulators, B the transposed copies). dK and dV
//     sum over the GQA group in the warpgroup's registers: no atomics.
//   dq: one block per (64 NWG query rows, head, batch row), the heaviest q
//     tiles first; NWG consumer warpgroups of 64 rows (2 at D 64, 1 at D
//     128) and a producer warp. Q, dO hi and dO lo stay in shared memory;
//     key tiles of BK (64 at D 64, 32 at D 128) K, V hi, V lo and K^T
//     stream through 2 stages. Per tile: S = Q K^T and dP = dO V^T on SS
//     wgmma, dS in dP's registers, dQ += T(dS) K on RS wgmma m64nDk8 (K^T
//     as B). The rows' lse2 and D stay in registers.
// dP sums its RN k-slices of 8 (3 products each) on the tensor cores into a
// zeroed tile, which is added to dP in f32 (round to nearest): the tensor
// cores truncate their own sums (ROADMAP §C.2).
// p = 2^(s scale log2(e) - lse2): one FFMA and one ex2 a score, no divide.
// Two calls are bit-equal: every sum is taken in a fixed order.
//
// Layouts are the model's: q, o, do, dq [B, Tq, NH, D], k, v, dk, dv [B,
// Tkv, NKV, D], f32, contiguous; l, m f32 [B, NH, Tq] from either f32
// forward (m of the scaled scores, l the f32 sum against the running max).
//
// Built in three parts (kernels/_build.py: PARTS), one nvcc each: parts 1
// and 2 instantiate D 64 and D 128; part 0 holds the C entry points.
#include "flash_tf32.cuh"

namespace tbwd_parts {  // one call's arguments, and each part's launches

struct Call {
  const float *q, *k, *v, *o, *dout, *l, *m;
  float *dq, *dk, *dv, *scratch;
  int B, Tq, Tkv, NH, NKV, D;
  float sm_scale;
  int kv_offset, causal;
  cudaStream_t stream;
};

int run_d64(const Call& c);
int run_d128(const Call& c);

}  // namespace tbwd_parts

namespace {

using namespace ftf32;

// k-slices of dP summed on the tensor cores before an f32 add (at most D / 8:
// tools/flash_f32_rows.py --truncating builds a copy with all of them).
constexpr int RN = 2;

// Where a call's operand copies sit in its f32 scratch (the top), in floats.
struct Scratch {
  size_t qs, qt, ks, kt, lse2, delta, total;
  int R, RK;  // rows of one Q-side / K-side tensor
  __host__ __device__ Scratch(int B, int Tq, int Tkv, int NH, int NKV, int D) {
    const int Tq64 = (Tq + TQ_ALIGN - 1) / TQ_ALIGN * TQ_ALIGN;
    R = B * NH * Tq64;
    RK = B * NKV * Tkv;
    qs = 0;                                 // Q, dO hi, dO lo [3][R][D]
    qt = qs + 3 * (size_t)R * D;            // Q^T, dO^T [2][B NH D][Tq64]
    ks = qt + 2 * (size_t)R * D;            // K, V hi, V lo [3][RK][D]
    kt = ks + 3 * (size_t)RK * D;           // K^T [B NKV D][Tkv]
    lse2 = kt + (size_t)RK * D;             // [R]
    delta = lse2 + R;                       // [R]
    total = delta + R;
  }
};

// ---- wgmma helpers -------------------------------------------------------------

// acc = A B^T over k-slices [k0, k0 + n) on split operands: hi hi + hi lo +
// lo hi (A rows from a_hi / a_lo, tiles of a_rows rows; B from b_hi / b_lo,
// N rows).
template <int N>
__device__ __forceinline__ void issue_split(float* acc, const unsigned char* a_hi,
                                            const unsigned char* a_lo, int a_rows,
                                            const unsigned char* b_hi,
                                            const unsigned char* b_lo, int k0, int n) {
#pragma unroll
  for (int kk = k0; kk < k0 + n; ++kk) {
    wgmma_tf32<N>(acc, slice(a_hi, a_rows, kk), slice(b_hi, N, kk), kk > k0);
    wgmma_tf32<N>(acc, slice(a_hi, a_rows, kk), slice(b_lo, N, kk), 1);
    wgmma_tf32<N>(acc, slice(a_lo, a_rows, kk), slice(b_hi, N, kk), 1);
  }
}

// S = A B^T (SS, all D / 8 k-slices) and dP's first RN k-slices into dp,
// committed as one group.
template <int D, int N>
__device__ __forceinline__ void issue_s_dp(float* sc, float* dp, const unsigned char* a,
                                           const unsigned char* a_hi, const unsigned char* a_lo,
                                           int a_rows, const unsigned char* b,
                                           const unsigned char* b_hi, const unsigned char* b_lo) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) wgmma_tf32<N>(sc, slice(a, a_rows, kk), slice(b, N, kk), kk > 0);
  issue_split<N>(dp, a_hi, a_lo, a_rows, b_hi, b_lo, 0, RN < D / 8 ? RN : D / 8);
  wgmma_commit();
}

// dP's other k-slices, RN at a time into a zeroed tile, each added to dp in
// f32 once its group retires; returns with no group pending (issue_s_dp's
// included).
template <int D, int N>
__device__ __forceinline__ void finish_dp(float* sc, float* dp, const unsigned char* a_hi,
                                          const unsigned char* a_lo, int a_rows,
                                          const unsigned char* b_hi, const unsigned char* b_lo) {
#pragma unroll
  for (int k0 = RN; k0 < D / 8; k0 += RN) {
    float acc[N / 2];
    wgmma_fence();
    issue_split<N>(acc, a_hi, a_lo, a_rows, b_hi, b_lo, k0, RN);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_operand<N / 2>(acc);
#pragma unroll
    for (int e = 0; e < N / 2; ++e) dp[e] += acc[e];
  }
  wgmma_wait<0>();
  wgmma_fence_operand<N / 2>(sc);
  wgmma_fence_operand<N / 2>(dp);
}

// ---- dkv -------------------------------------------------------------------------

template <int D>
struct KvCfg {
  static constexpr int NWG = D == 64 ? 2 : 1;
  static constexpr int BK = 64 * NWG;  // keys a block
  static constexpr int BQ = 32;        // queries a step: one 32-column panel of Q^T, dO^T
  static constexpr int NT = D == 64 ? 3 : 1;
  static constexpr int CONSUMERS = 128 * NWG, THREADS = CONSUMERS + 32;
  static constexpr int K_BYTES = BK * D * 4;   // one of K, V hi, V lo
  static constexpr int QR_BYTES = BQ * D * 4;  // one of Q, dO hi, dO lo (rows)
  static constexpr int QT_BYTES = D * BQ * 4;  // one of Q^T, dO^T
  static constexpr int STAGE = 3 * QR_BYTES + 2 * QT_BYTES + 1024;  // + lse2, D
  static constexpr int SMEM = 3 * K_BYTES + NT * STAGE + (2 * NT + 1) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(KvCfg<D>::THREADS, 1)
dkv_kernel(const __grid_constant__ CUtensorMap mk, const __grid_constant__ CUtensorMap mq,
           const __grid_constant__ CUtensorMap mqt, const float* __restrict__ lse2_in,
           const float* __restrict__ delta_in, float* __restrict__ dk_out,
           float* __restrict__ dv_out, int B, int Tq, int Tq64, int Tkv, int NH, int NKV,
           float sm_scale, int kv_offset, int causal) {
  using C = KvCfg<D>;
  constexpr int NT = C::NT, BQ = C::BQ, BK = C::BK, NO = D / 2, NS = BQ / 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* ks = smem;  // K, V hi, V lo: [3][D / 32 panels][BK rows][128 B]
  unsigned char* stages = ks + 3 * C::K_BYTES;  // [NT][Q, dO hi, dO lo, Q^T, dO^T, lse2 + D]
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + NT * C::STAGE);
  uint64_t* empty = full + NT;
  uint64_t* kv_full = empty + NT;

  const int tid = threadIdx.x;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * BK;  // the first key blocks see the most q tiles: they go first
  const int G = NH / NKV;
  const Scratch sc(B, Tq, Tkv, NH, NKV, D);
  // The steps: the q tiles that see key k0 or later (the TPU kernel's skip
  // rule, per 32-row tile), for every query head of the group.
  const int nq = (Tq + BQ - 1) / BQ;
  const int i0 = causal && k0 > kv_offset ? (k0 - kv_offset) / BQ : 0;
  const int per_head = nq > i0 ? nq - i0 : 0;
  const int n_it = per_head * G;

  if (tid == 0) {
    for (int s = 0; s < NT; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], C::CONSUMERS);
    }
    mbar_init(kv_full, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == C::CONSUMERS) {  // the producer
    // K, V hi, V lo in boxes of 64 keys per panel (keys past Tkv are read
    // but never stored).
    mbar_expect_tx(kv_full, 3 * C::K_BYTES);
    const int krow = (b * NKV + hk) * Tkv + k0;
#pragma unroll
    for (int x = 0; x < 3; ++x)
#pragma unroll
      for (int p = 0; p < D / 32; ++p)
#pragma unroll
        for (int hf = 0; hf < C::NWG; ++hf)
          tma_load_2d(ks + x * C::K_BYTES + p * BK * PANEL_ROW + hf * 64 * PANEL_ROW, &mk,
                      kv_full, 32 * p, x * sc.RK + krow + 64 * hf);
    for (int it = 0; it < n_it; ++it) {
      const int s = it % NT, h = hk * G + it / per_head, q0 = (i0 + it % per_head) * BQ;
      if (it >= NT) mbar_wait(&empty[s], (it / NT - 1) & 1);
      unsigned char* st = stages + s * C::STAGE;
      mbar_expect_tx(&full[s], C::STAGE - 1024 + 2 * BQ * 4);
      const int qrow = (b * NH + h) * Tq64 + q0;
#pragma unroll
      for (int x = 0; x < 3; ++x)
#pragma unroll
        for (int p = 0; p < D / 32; ++p)
          tma_load_2d(st + x * C::QR_BYTES + p * BQ * PANEL_ROW, &mq, &full[s], 32 * p,
                      x * sc.R + qrow);
#pragma unroll
      for (int x = 0; x < 2; ++x)
        tma_load_2d(st + 3 * C::QR_BYTES + x * C::QT_BYTES, &mqt, &full[s], q0,
                    x * B * NH * D + (b * NH + h) * D);
      float* stt = reinterpret_cast<float*>(st + 3 * C::QR_BYTES + 2 * C::QT_BYTES);
      bulk_load(stt, lse2_in + qrow, BQ * 4, &full[s]);
      bulk_load(stt + BQ, delta_in + qrow, BQ * 4, &full[s]);
    }
  }
  if (tid >= C::CONSUMERS) return;

  // ---- consumer warpgroups: keys [k0 + 64 wg, k0 + 64 wg + 64) ----
  const int wg = tid >> 7, lane = tid & 31, w = (tid >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int wkey = k0 + 64 * wg + 16 * w;  // the warp's first key
  const int r0 = wkey + g;                 // this thread's keys r0 and r0 + 8
  const float c = sm_scale * LOG2E;
  const unsigned char* ka = ks + wg * 64 * PANEL_ROW;  // the warpgroup's rows of each panel
  const unsigned char* vha = ka + C::K_BYTES;
  const unsigned char* vla = ka + 2 * C::K_BYTES;

  float dk[NO], dv[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dk[i] = dv[i] = 0.f;
  mbar_wait(kv_full, 0);
  for (int it = 0; it < n_it; ++it) {
    const int s = it % NT;
    const int q0 = (i0 + it % per_head) * BQ;
    const unsigned char* st = stages + s * C::STAGE;
    const unsigned char* qr = st;
    const unsigned char* ohs = st + C::QR_BYTES;
    const unsigned char* ols = st + 2 * C::QR_BYTES;
    const unsigned char* qts = st + 3 * C::QR_BYTES;
    const unsigned char* ots = qts + C::QT_BYTES;
    const float* stt = reinterpret_cast<const float*>(ots + C::QT_BYTES);
    float sc_[NS], dp[NS];
    mbar_wait(&full[s], (it / NT) & 1);
    // S^T = K Q^T, dP^T = V dO^T.
    issue_s_dp<D, BQ>(sc_, dp, ka, vha, vla, BK, qr, ohs, ols);
    finish_dp<D, BQ>(sc_, dp, vha, vla, BK, ohs, ols);
    // P^T and dS^T: sc_[4 jj + i] is key r0 + 8 (i / 2), query q0 + 8 jj + 2 t
    // + i % 2, whose lse2 and D are stt[8 jj + 2 t + i % 2] and stt[BQ + ...].
    const bool diag = causal && wkey + 15 > q0 + kv_offset;
#pragma unroll
    for (int jj = 0; jj < BQ / 8; ++jj) {
      const float2 ls = *reinterpret_cast<const float2*>(stt + 8 * jj + 2 * t);
      const float2 dl = *reinterpret_cast<const float2*>(stt + BQ + 8 * jj + 2 * t);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = 4 * jj + i;
        float p = ex2(fmaf(sc_[e], c, -((i & 1) ? ls.y : ls.x)));
        if (diag && r0 + 8 * (i >> 1) > q0 + 8 * jj + 2 * t + (i & 1) + kv_offset) p = 0.f;
        sc_[e] = p;
        dp[e] = (p * (dp[e] - ((i & 1) ? dl.y : dl.x))) * sm_scale;
      }
    }
    uint32_t pa[BQ / 8][4], da[BQ / 8][4];
    pack_a<BQ>(pa, sc_);
    pack_a<BQ>(da, dp);
    wgmma_fence_operand<NO>(dv);
    wgmma_fence_operand<NO>(dk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 8; ++kk) wgmma_tf32_rs<D>(dv, pa[kk], slice(ots, D, kk), 1);
#pragma unroll
    for (int kk = 0; kk < BQ / 8; ++kk) wgmma_tf32_rs<D>(dk, da[kk], slice(qts, D, kk), 1);
    wgmma_commit();
    // Retired within the step (a group left pending across the loop makes
    // ptxas serialize every wgmma); the stage is released.
    wgmma_wait<0>();
    wgmma_fence_operand<NO>(dk);
    wgmma_fence_operand<NO>(dv);
    mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int key = r0 + 8 * hr;
    if (key >= Tkv) continue;
    const size_t row = (((size_t)b * Tkv + key) * NKV + hk) * D;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      *reinterpret_cast<float2*>(dk_out + row + 8 * jj + 2 * t) =
          make_float2(dk[4 * jj + 2 * hr], dk[4 * jj + 2 * hr + 1]);
      *reinterpret_cast<float2*>(dv_out + row + 8 * jj + 2 * t) =
          make_float2(dv[4 * jj + 2 * hr], dv[4 * jj + 2 * hr + 1]);
    }
  }
}

// ---- dq --------------------------------------------------------------------------

template <int D>
struct DqCfg {
  static constexpr int NWG = D == 64 ? 2 : 1;
  static constexpr int BQ = 64 * NWG;        // query rows a block
  static constexpr int BK = D == 64 ? 64 : 32;  // keys a tile
  static constexpr int NT = 2;
  static constexpr int CONSUMERS = 128 * NWG, THREADS = CONSUMERS + 32;
  static constexpr int Q_BYTES = BQ * D * 4;   // one of Q, dO hi, dO lo
  static constexpr int KV_BYTES = BK * D * 4;  // one of K, V hi, V lo, K^T
  static constexpr int STAGE = 4 * KV_BYTES;
  static constexpr int SMEM = 3 * Q_BYTES + NT * STAGE + (2 * NT + 1) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(DqCfg<D>::THREADS, 1)
dq_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
          const __grid_constant__ CUtensorMap mkt, const float* __restrict__ lse2_in,
          const float* __restrict__ delta_in, float* __restrict__ dq_out, int B, int Tq,
          int Tq64, int Tkv, int NH, int NKV, float sm_scale, int kv_offset, int causal) {
  using C = DqCfg<D>;
  constexpr int NT = C::NT, BQ = C::BQ, BK = C::BK, NO = D / 2, NS = BK / 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* qs = smem;  // Q, dO hi, dO lo: [3][D / 32 panels][BQ rows][128 B]
  unsigned char* stages = qs + 3 * C::Q_BYTES;  // [NT][K, V hi, V lo, K^T]
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + NT * C::STAGE);
  uint64_t* empty = full + NT;
  uint64_t* q_full = empty + NT;

  const int tid = threadIdx.x;
  const int qt = gridDim.z - 1 - blockIdx.z;  // heaviest q tiles first
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (NH / NKV);
  const int q0 = qt * BQ;
  const Scratch sc(B, Tq, Tkv, NH, NKV, D);
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
    // Q, dO hi, dO lo in boxes of 64 rows per panel (rows past Tq are read
    // but never stored).
    mbar_expect_tx(q_full, 3 * C::Q_BYTES);
    const int qrow = (b * NH + h) * Tq64 + q0;
#pragma unroll
    for (int x = 0; x < 3; ++x)
#pragma unroll
      for (int p = 0; p < D / 32; ++p)
#pragma unroll
        for (int hf = 0; hf < C::NWG; ++hf)
          tma_load_2d(qs + x * C::Q_BYTES + p * BQ * PANEL_ROW + hf * 64 * PANEL_ROW, &mq,
                      q_full, 32 * p, x * sc.R + qrow + 64 * hf);
    const int krow = (b * NKV + hk) * Tkv;
    for (int j = 0; j < n_kv; ++j) {
      const int s = j % NT;
      if (j >= NT) mbar_wait(&empty[s], (j / NT - 1) & 1);
      unsigned char* st = stages + s * C::STAGE;
      mbar_expect_tx(&full[s], C::STAGE);
#pragma unroll
      for (int x = 0; x < 3; ++x)
#pragma unroll
        for (int p = 0; p < D / 32; ++p)
          tma_load_2d(st + x * C::KV_BYTES + p * BK * PANEL_ROW, &mk, &full[s], 32 * p,
                      x * sc.RK + krow + j * BK);
#pragma unroll
      for (int y = 0; y < BK / 32; ++y)
        tma_load_2d(st + 3 * C::KV_BYTES + y * D * PANEL_ROW, &mkt, &full[s], j * BK + 32 * y,
                    (b * NKV + hk) * D);
    }
  }
  if (tid >= C::CONSUMERS) return;

  // ---- consumer warpgroups: query rows [q0 + 64 wg, q0 + 64 wg + 64) ----
  const int wg = tid >> 7, lane = tid & 31, w = (tid >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = q0 + 64 * wg + 16 * w;  // the warp's first query row
  const int r0 = wrow + g;                 // this thread's rows r0 and r0 + 8
  const float c = sm_scale * LOG2E;
  const unsigned char* qa = qs + wg * 64 * PANEL_ROW;  // the warpgroup's rows of each panel
  const unsigned char* oha = qa + C::Q_BYTES;
  const unsigned char* ola = qa + 2 * C::Q_BYTES;
  float lse2[2], dl[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r0 + 8 * hr;
    const size_t s = ((size_t)b * NH + h) * Tq64 + row;
    lse2[hr] = row < Tq ? lse2_in[s] : INFINITY;
    dl[hr] = row < Tq ? delta_in[s] : 0.f;
  }

  float dq[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dq[i] = 0.f;
  mbar_wait(q_full, 0);
  for (int j = 0; j < n_kv; ++j) {
    const int s = j % NT;
    const unsigned char* st = stages + s * C::STAGE;
    float sc_[NS], dp[NS];
    mbar_wait(&full[s], (j / NT) & 1);
    // S = Q K^T, dP = dO V^T.
    issue_s_dp<D, BK>(sc_, dp, qa, oha, ola, BQ, st, st + C::KV_BYTES, st + 2 * C::KV_BYTES);
    finish_dp<D, BK>(sc_, dp, oha, ola, BQ, st + C::KV_BYTES, st + 2 * C::KV_BYTES);
    // dS in dP's registers: sc_[4 jj + i] is row r0 + 8 (i / 2), key j BK +
    // 8 jj + 2 t + i % 2 (the compare only on tiles past the warp's first row).
    const bool diag = causal && j * BK + BK - 1 > wrow + kv_offset;
#pragma unroll
    for (int jj = 0; jj < BK / 8; ++jj)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = 4 * jj + i, hr = i >> 1;
        float p = ex2(fmaf(sc_[e], c, -lse2[hr]));
        if (diag && j * BK + 8 * jj + 2 * t + (i & 1) > r0 + 8 * hr + kv_offset) p = 0.f;
        dp[e] = (p * (dp[e] - dl[hr])) * sm_scale;
      }
    uint32_t da[BK / 8][4];
    pack_a<BK>(da, dp);
    wgmma_fence_operand<NO>(dq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk)
      wgmma_tf32_rs<D>(dq, da[kk], slice(st + 3 * C::KV_BYTES, D, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();  // within the tile, as in dkv_kernel; the stage is released
    wgmma_fence_operand<NO>(dq);
    mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r0 + 8 * hr;
    if (row >= Tq) continue;
    float* out = dq_out + (((size_t)b * Tq + row) * NH + h) * D;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj)
      *reinterpret_cast<float2*>(out + 8 * jj + 2 * t) =
          make_float2(dq[4 * jj + 2 * hr], dq[4 * jj + 2 * hr + 1]);
  }
}

// ---- host --------------------------------------------------------------------------

template <int D>
int launch(const tbwd_parts::Call& c) {
  const int Tq64 = (c.Tq + TQ_ALIGN - 1) / TQ_ALIGN * TQ_ALIGN;
  const Scratch s(c.B, c.Tq, c.Tkv, c.NH, c.NKV, D);
  float* x = c.scratch;
  const size_t R = s.R, RK = s.RK;
  {
    constexpr int smem = 2 * PREP_ROWS * (D + 1) * 4;
    static bool sized_q[64] = {}, sized_k[64] = {};
    cudaError_t e = size_smem(prep_kernel<D, true>, smem, sized_q);
    if (e == cudaSuccess) e = size_smem(prep_kernel<D, false>, smem, sized_k);
    if (e != cudaSuccess) return static_cast<int>(e);
    prep_kernel<D, true><<<dim3(Tq64 / PREP_ROWS, c.NH, c.B), PREP_THREADS, smem, c.stream>>>(
        c.q, c.dout, c.o, c.l, c.m, x + s.qs, x + s.qs + R * D, x + s.qs + 2 * R * D, x + s.qt,
        x + s.qt + R * D, x + s.lse2, x + s.delta, c.Tq, Tq64, c.NH);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    prep_kernel<D, false><<<dim3(c.Tkv / PREP_ROWS, c.NKV, c.B), PREP_THREADS, smem,
                            c.stream>>>(c.k, c.v, nullptr, nullptr, nullptr, x + s.ks,
                                        x + s.ks + RK * D, x + s.ks + 2 * RK * D, x + s.kt,
                                        nullptr, nullptr, nullptr, c.Tkv, c.Tkv, c.NKV);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  using KC = KvCfg<D>;
  using QC = DqCfg<D>;
  CUtensorMap kv_k, kv_q, kv_qt, dq_q, dq_k, dq_kt;
  if (!encode_f32(&kv_k, x + s.ks, 3 * RK, D, 64) ||
      !encode_f32(&kv_q, x + s.qs, 3 * R, D, KC::BQ) ||
      !encode_f32(&kv_qt, x + s.qt, 2 * (uint64_t)c.B * c.NH * D, Tq64, D) ||
      !encode_f32(&dq_q, x + s.qs, 3 * R, D, 64) ||
      !encode_f32(&dq_k, x + s.ks, 3 * RK, D, QC::BK) ||
      !encode_f32(&dq_kt, x + s.kt, (uint64_t)c.B * c.NKV * D, c.Tkv, D))
    return static_cast<int>(cudaErrorInvalidValue);
  {
    static bool sized[64] = {};
    auto kern = dkv_kernel<D>;
    const cudaError_t e = size_smem(kern, KC::SMEM, sized);
    if (e != cudaSuccess) return static_cast<int>(e);
    kern<<<dim3(c.NKV, c.B, (c.Tkv + KC::BK - 1) / KC::BK), KC::THREADS, KC::SMEM, c.stream>>>(
        kv_k, kv_q, kv_qt, x + s.lse2, x + s.delta, c.dk, c.dv, c.B, c.Tq, Tq64, c.Tkv, c.NH,
        c.NKV, c.sm_scale, c.kv_offset, c.causal);
    const cudaError_t e2 = cudaGetLastError();
    if (e2 != cudaSuccess) return static_cast<int>(e2);
  }
  static bool sized[64] = {};
  auto kern = dq_kernel<D>;
  const cudaError_t e = size_smem(kern, QC::SMEM, sized);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<dim3(c.NH, c.B, (c.Tq + QC::BQ - 1) / QC::BQ), QC::THREADS, QC::SMEM, c.stream>>>(
      dq_q, dq_k, dq_kt, x + s.lse2, x + s.delta, c.dq, c.B, c.Tq, Tq64, c.Tkv, c.NH, c.NKV,
      c.sm_scale, c.kv_offset, c.causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#if IN_PART(1)
int tbwd_parts::run_d64(const Call& c) { return launch<64>(c); }
#endif
#if IN_PART(2)
int tbwd_parts::run_d128(const Call& c) { return launch<128>(c); }
#endif

#if IN_PART(0)

// The f32 scratch flash_tf32_bwd needs for these shapes, in floats.
extern "C" long long flash_tf32_bwd_scratch(int B, int Tq, int Tkv, int NH, int NKV, int D) {
  return static_cast<long long>(Scratch(B, Tq, Tkv, NH, NKV, D).total);
}

// ptrs: q, k, v, o, do, l, m, dq, dk, dv. q, o, do, dq [B, Tq, NH, D]; k, v,
// dk, dv [B, Tkv, NKV, D]; f32, contiguous, 16-byte-aligned bases; l, m f32
// [B, NH, Tq] (the forward's row sum and max); scratch f32 of
// flash_tf32_bwd_scratch floats, 16-byte aligned. Needs D 64 or 128, Tkv %
// 64 == 0, NH % NKV == 0 and, when causal, kv_offset >= 0 (checked by the
// Python wrapper). Four launches on `stream`: the two preps, dK/dV, dQ.
// Returns a cudaError_t (cudaErrorInvalidValue for another D, or when a TMA
// descriptor cannot be encoded).
extern "C" int flash_tf32_bwd(void* const* ptrs, void* scratch, int B, int Tq, int Tkv, int NH,
                              int NKV, int D, float sm_scale, int kv_offset, int causal,
                              void* stream) {
  if (B <= 0 || Tq <= 0 || Tkv <= 0) return static_cast<int>(cudaGetLastError());
  const tbwd_parts::Call c{static_cast<const float*>(ptrs[0]),
                           static_cast<const float*>(ptrs[1]),
                           static_cast<const float*>(ptrs[2]),
                           static_cast<const float*>(ptrs[3]),
                           static_cast<const float*>(ptrs[4]),
                           static_cast<const float*>(ptrs[5]),
                           static_cast<const float*>(ptrs[6]),
                           static_cast<float*>(ptrs[7]),
                           static_cast<float*>(ptrs[8]),
                           static_cast<float*>(ptrs[9]),
                           static_cast<float*>(scratch),
                           B,
                           Tq,
                           Tkv,
                           NH,
                           NKV,
                           D,
                           sm_scale,
                           kv_offset,
                           causal,
                           static_cast<cudaStream_t>(stream)};
  if (D == 64) return tbwd_parts::run_d64(c);
  if (D == 128) return tbwd_parts::run_d128(c);
  return static_cast<int>(cudaErrorInvalidValue);
}
#endif  // IN_PART(0)
