// flash_bwd: the causal grouped-query flash-attention backward, bf16 or fp16
// in and out (the element type T of every template here; fp16 reads the
// same fragments and descriptors through wgmma's .f16 form and TMA's
// FLOAT16 maps), from the forward's row statistics, on Hopper's TMA and
// warpgroup MMA, at every D % 64 == 0 (past 256: the part kernels below).
//
// Replaces the TPU kernels mila_tpu/kernels/flash_attention_bwd.py:
// _dkv_kernel (dK, dV) and _dq_kernel (dQ), entry flash_attention_bwd,
// reached from _fa_bwd (flash_attention.py). Per tile, as there:
//   p  = exp(s * scale - m) / l        (l == 0 taken as 1; masked p = 0)
//   dv += T(p)^T do
//   ds = p * (do v^T - D) * scale,     D = rowsum(o * do) in f32
//   dk += T(ds)^T q,  dq += T(ds) k
// with the causal tile skip under kv_offset >= 0. dq is rounded to q's
// dtype, dk and dv to k's.
//
// Bound on the H100: tensor-core operations (five products of 2 * D
// multiply-adds per visible (query, key) pair and head; the two passes here
// run seven, S and dP in each) against q, k, v, o, do, dq, dk, dv read or
// written once. Three launches:
//   stats: per (batch, head, query row) D = sum_d o do in f32 and lse2 =
//     (m + ln l) log2(e) (l == 0 taken as 1), 8 lanes a row at D 64 and 192
//     (one and three 16-byte loads of o and do each) and past 256, 16 at D
//     128, 32 at D 256, in the model layout, into
//     f32 [B, NH, Tq64] (Tq rounded up to 64; rows past Tq get lse2 = +inf
//     and D = 0, so their p is 0). Both passes then form p = 2^(s c - lse2)
//     with c = scale log2(e): one FFMA and one ex2 a score, no divide.
//   dkv: one block per key block, KV head and batch row, the first key
//     blocks (which see the most q tiles) first, with NWG consumer
//     warpgroups (3 at D 64, where one's dK, dV, S^T and dP^T fit the 168
//     registers a thread has at 384 threads; 2 from D 128) and no producer
//     warp: one thread loads the block's K and V once by TMA and the first
//     stages of a ring; the block sweeps the (query head of the group,
//     64-row q tile) pairs that see its keys, Q, dO and the tile's lse2 and
//     D streaming through the ring (full / empty mbarriers; a consumer
//     thread refills a stage once its users are done). Two block shapes:
//     64 NWG keys, warpgroup wg on keys 64 wg .. 64 wg + 63, all on every
//     step (each Q/dO tile loaded once for 64 NWG keys); or, where those
//     blocks would not fill the card twice over (few batch rows and KV
//     heads: the heaviest first blocks would set the time), 64 keys, every
//     warpgroup on all of them, taking the steps in turn, which divides the
//     heaviest block's time by NWG; the warpgroups' f32 dK and dV are then
//     added at the end in a fixed order. Per step and warpgroup: S^T = K
//     Q^T and dP^T = V dO^T as SS wgmma m64n64k16 (both operands K-major, as
//     TMA writes them); P^T and dS^T in their registers, the statistics of
//     a lane's 16 query columns read from the stage (the reads broadcast);
//     dV += bf16(P^T) dO and dK += bf16(dS^T) Q as RS wgmma (the
//     accumulators pack into A's fragments, dO and Q read MN-major through
//     the transpose bit). Nothing round-trips through shared memory; dK and
//     dV sum over the GQA group inside the block, deterministically. (Issuing
//     a step's dV, dK with the next step's S^T, dP^T, and turns between the
//     warpgroups, both measured slower.)
//     At D 192 and 256 the dK and dV of 64 keys take D registers a thread
//     in one warpgroup (dK and dV, f32): too many beside S^T, dP^T and
//     their A fragments. So a third block shape: 64 keys, both warpgroups
//     on all of them and on every step, warpgroup 0 owning dK's and dV's
//     first 128 columns and warpgroup 1 the rest (128 at D 256, 64 at D
//     192): per thread 64 + 64 registers of dK and dV, 32 + 32 of S^T and
//     dP^T and 32 of fragments, as at D 128. S^T and dP^T are formed once:
//     warpgroup 0 forms S^T and P^T, warpgroup 1 dP^T and dS^T, and they
//     hand P^T (f32) and T(dS^T) to each other through shared memory, two
//     named barriers a step; warpgroup 0 issues dV while dS^T is formed.
//     Against both warpgroups forming both (two of the pass's four products
//     run twice), 12 % faster at D 192 and 4 % at D 256, bit-equal.
//     Shared memory: K and V (64 D
//     2 bytes each), a ring of Q/dO stages (64 D 2 bytes each; 3 at D 192,
//     2 at D 256) and the 24 KB handed over: 218 KB.
//   past D 256 (flash_part.cuh: plan_bwd): the same two passes on column
//     parts, dK/dV first, then dQ (flash_bwd_dkv_part_kernel,
//     flash_bwd_dq_part_kernel). A block takes 64 rows and a part of its
//     output (dQ: the forward's parts of up to 512 columns; dK/dV: 256),
//     and its two warpgroups form S (S^T) and dP (dP^T) once a tile and part
//     between them, over all D columns, as the D 192/256 dK/dV shape does:
//     warpgroup 0 S and P, warpgroup 1 dP and dS, P handed over in f32 and
//     T(dS) back; then each adds into its own half of the part (dQ: up to
//     128 f32 registers a thread; dK, dV: 64 + 64). A producer warp streams
//     every operand through one ring of 16 KB jobs (two 64-row panels of 64
//     columns, one box each through 5-D maps over [B][heads][D / 64][T][64]):
//     the other side's panels of S and dP, then the part's
//     columns of the accumulated products' operand, read again. The block's
//     own operands of S and dP stay in shared memory where they fit beside
//     a ring of 4 jobs (to D 512), else stream as jobs of their own. Each
//     warpgroup's products span a fixed number of panels, whatever the
//     part's width: no wgmma sits in a branch. The producer warp takes the
//     block to 288 threads and each thread to 168 registers: dK/dV and dQ at
//     512-column parts spill a little and ptxas serializes their wgmma
//     (C7512). A consumer thread issuing the loads (256 threads, 255
//     registers) ran slower: it waits on the other warpgroup at every job;
//     so did setmaxnreg (tools/flash_variants.py --bwd). The loads bound it.
//   dq: the forward's skeleton (flash_fwd.cu): one block per (64 NWG query
//     rows, head, batch row), heaviest q tiles first; one thread loads Q and
//     dO once and streams 64-key K/V tiles through a TMA ring (3-D maps over
//     [B][T][heads * D], boxes {64 columns, 64 rows, 1}, 128-byte swizzle;
//     rows past T read zeros within their batch row): a producer warp at D
//     64 (288 threads), a consumer thread at D 128 (256 threads, so that dQ,
//     S, dP and dS fit in 255 registers without spilling). NWG consumer
//     warpgroups of 64 rows run S = Q K^T and dP = dO V^T as SS wgmma
//     m64n64k16, form dS in S's registers, and dQ += T(dS) K as RS wgmma
//     (dS packs into A's fragment, K read MN-major through the transpose
//     bit; past 128 columns a second product on K's panels from column
//     128). Each issues S and dP of tile j with dQ of tile j - 1 behind
//     them; at D 64 and 128 two warpgroups take turns to issue (named
//     barriers), so one warpgroup's exponentials run under the other's
//     products. At D 192 and 256 one warpgroup of 64 rows and a producer
//     warp (160 threads): its dQ takes D / 2 registers, S and dP 64, their
//     fragments 16, within the 255 a thread gets; 64 Q and 64 dO rows leave
//     room for 3 (D 192) or 2 (D 256) K/V stages (193 KB). The rows' lse2
//     and D stay in registers.
// Layouts are the model's: q, o, do, dq [B, Tq, NH, D], k, v, dk, dv [B,
// Tkv, NKV, D], contiguous, 16-byte-aligned bases; l, m f32 [B, NH, Tq],
// from the forward (flash_fwd.cu: m of the scaled scores, l the f32 sum
// against the running max).
//
// Built in nine parts (kernels/_build.py: PARTS), one nvcc each: parts 1
// and 2 instantiate bf16 and fp16 at D 64 and 128, parts 3 and 4 bf16 and
// fp16 at D 192 and 256, parts 5 and 6 the dK/dV part kernels, 7 and 8 the
// dQ part kernels; part 0 holds the C entry point and the statistics past D
// 256.
#include "common.cuh"
#include "flash_part.cuh"
#include "mma.cuh"
#include "sm90.cuh"

namespace fbwd_parts {  // one call's arguments, and each part's launches

struct Call {
  const void *q, *k, *v, *o, *dout;
  const float *l, *m;
  float *lse2, *delta;
  void *dq, *dk, *dv;
  int B, Tq, Tkv, NH, NKV, D;
  float sm_scale;
  int kv_offset, causal;
  cudaStream_t stream;
};

int run_bf16(const Call& c);       // D 64, 128
int run_f16(const Call& c);
int run_bf16_wide(const Call& c);  // D 192, 256
int run_f16_wide(const Call& c);
int dkv_part_bf16(const Call& c);  // past D 256: the dK/dV and dQ kernels
int dkv_part_f16(const Call& c);
int dq_part_bf16(const Call& c);
int dq_part_f16(const Call& c);

}  // namespace fbwd_parts

namespace {

constexpr int STATS_THREADS = 256;
constexpr int TQ_ALIGN = 64;  // the statistics rows are padded to this

// ---- stats -------------------------------------------------------------------

// A pair of T as two f32.
__device__ __forceinline__ float2 pair_f2(__nv_bfloat162 v) { return __bfloat1622float2(v); }
__device__ __forceinline__ float2 pair_f2(__half2 v) { return __half22float2(v); }

template <typename T>
using Pair = typename std::conditional<std::is_same<T, __half>::value, __half2,
                                       __nv_bfloat162>::type;

// The lanes a statistics row takes at head size D: the largest power of two
// up to 32 that divides D / 8; past D 256 (D = 0: the head size a runtime
// argument, a multiple of 64) 8.
__host__ __device__ constexpr int stats_lanes(int D) {
  return D == 0 ? 8 : ((D / 8) & -(D / 8)) > 32 ? 32 : (D / 8) & -(D / 8);
}

// Rows in the model's order (b, t, h), LPR lanes a row (stats_lanes), each
// lane CH chunks of 8 values (16 bytes) LPR chunks apart; the sum over the
// row's lanes by shuffles. D = 0: the head size is d_run.
template <typename T, int D>
__global__ void __launch_bounds__(STATS_THREADS)
flash_bwd_stats_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       const float* __restrict__ l, const float* __restrict__ m,
                       float* __restrict__ lse2, float* __restrict__ delta, int B, int Tq,
                       int Tq64, int NH, int d_run) {
  constexpr int LPR = stats_lanes(D);
  const int hd = D ? D : d_run;
  const int CH = hd / 8 / LPR;
  const int part = threadIdx.x % LPR;
  const long long r = (long long)blockIdx.x * (STATS_THREADS / LPR) + threadIdx.x / LPR;
  const long long rows = (long long)B * Tq64 * NH;
  const int h = static_cast<int>(r % NH);
  const int t = static_cast<int>((r / NH) % Tq64);
  const int b = static_cast<int>(r / ((long long)NH * Tq64));
  const bool live = r < rows && t < Tq;
  float acc = 0.f;
  if (live) {
    const size_t off = (((size_t)b * Tq + t) * NH + h) * hd + 8 * part;
#pragma unroll
    for (int ch = 0; ch < CH; ++ch) {
      const uint4 ov = *reinterpret_cast<const uint4*>(o + off + 8 * LPR * ch);
      const uint4 dv = *reinterpret_cast<const uint4*>(dout + off + 8 * LPR * ch);
      const Pair<T>* o2 = reinterpret_cast<const Pair<T>*>(&ov);
      const Pair<T>* d2 = reinterpret_cast<const Pair<T>*>(&dv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 a = pair_f2(o2[i]), c = pair_f2(d2[i]);
        acc = fmaf(a.x, c.x, acc);
        acc = fmaf(a.y, c.y, acc);
      }
    }
  }
#pragma unroll
  for (int s = LPR / 2; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (r < rows && part == 0) {
    const size_t out = ((size_t)b * NH + h) * Tq64 + t;
    if (live) {
      const size_t in = ((size_t)b * NH + h) * Tq + t;
      const float lv = l[in];
      lse2[out] = fmaf(m[in], LOG2E, log2f(lv == 0.f ? 1.f : lv));
      delta[out] = acc;
    } else {
      lse2[out] = INFINITY;
      delta[out] = 0.f;
    }
  }
}

// ---- wgmma helpers (both passes) ---------------------------------------------

constexpr int SCHED = 1;  // named barriers SCHED + wg: warpgroup wg's turn to issue
constexpr int PANEL64 = 64 * 128;  // 64 rows of one 64-column panel, bytes

// The dQ pass's two consumer warpgroups (at D 64 and 128) take turns to
// issue their products, so one's element-wise work runs under the other's
// wgmma: wait for this warpgroup's turn, and pass the turn to the other one.
__device__ __forceinline__ void sched_wait(int wg) { named_bar_sync(SCHED + wg, 256); }
__device__ __forceinline__ void sched_pass(int wg) { named_bar_arrive(SCHED + 1 - wg, 256); }

// acc = A B^T for a warpgroup's 64 rows of A (a, K-major) against 64 rows of
// B (b, K-major): D / 16 k-slices, 32 bytes apart in a panel's 128-byte
// rows; a_panel and b_panel the bytes between their 64-column panels.
// Issued and committed as one group.
template <typename T, int D>
__device__ __forceinline__ void issue_abt(float* acc, const unsigned char* a, int a_panel,
                                          const unsigned char* b, int b_panel) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int p = kk / 4, off = 32 * (kk % 4);
    wgmma_m64n64k16<T, 0>(acc, wgmma_desc(a + p * a_panel + off, 16, 1024),
                          wgmma_desc(b + p * b_panel + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// acc += T(A) B for A's 64 rows x 64 in registers (4 k-slices of 16) and
// the first NC columns of B, a 64-row tile read MN-major (the k-th slice
// 2048 k bytes in, LBO the bytes between its 64-column panels): one product
// of NC (64 or 128) columns, or past 128 a second one on the panels from
// column 128 into acc + 64. Issued and committed as one group.
template <typename T, int NC>
__device__ __forceinline__ void issue_ab(float* acc, const uint32_t (*a)[4],
                                         const unsigned char* b, int b_panel) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t bd = wgmma_desc(b + 2048 * kk, b_panel, 1024);
    if constexpr (NC == 64)
      wgmma_m64n64k16_rs<T, 1>(acc, a[kk], bd, 1);
    else
      wgmma_m64n128k16_rs<T, 1>(acc, a[kk], bd, 1);
    if constexpr (NC > 128) {
      const uint64_t bd2 = wgmma_desc(b + 2 * b_panel + 2048 * kk, b_panel, 1024);
      if constexpr (NC == 192)
        wgmma_m64n64k16_rs<T, 1>(acc + 64, a[kk], bd2, 1);
      else
        wgmma_m64n128k16_rs<T, 1>(acc + 64, a[kk], bd2, 1);
    }
  }
  wgmma_commit();
}

// An accumulator of 64 x 64 packs into the A fragments of the next product
// (d[8 kk .. 8 kk + 7] are the four pairs of T of k-slice kk).
template <typename T>
__device__ __forceinline__ void pack_a(uint32_t (*a)[4], const float* d) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack2_as<T>(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
}

// ---- dkv (wgmma) ---------------------------------------------------------------

constexpr int KV_BQ = 64;  // queries per tile of the sweep
constexpr int RED = SCHED + 2;  // named barrier of the end-of-block sum

// NWG consumer warpgroups (3 at D 64, where a warpgroup's dK, dV, S^T and
// dP^T fit in the 168 registers a thread has at 384 threads; 2 from D 128).
// Three block shapes (the top): SPLIT, a block of 64 keys, every warpgroup
// on all of them and all columns, taking the sweep's steps in turn; COLS (D
// 192 and 256), a block of 64 keys, both warpgroups on every step,
// warpgroup 0 on columns 0-127 of dK and dV and warpgroup 1 on the rest,
// S^T and dP^T formed once between them; else a block of 64 NWG keys,
// warpgroup wg on keys 64 wg .. 64 wg + 63, all on every step (each Q/dO
// tile loaded once for NWG times the keys).
template <int D, bool SPLIT>
struct KvCfg {
  static constexpr bool COLS = D > 128;
  static_assert(!(SPLIT && COLS), "past D 128 the warpgroups split the columns, not the steps");
  static constexpr int NWG = D == 64 ? 3 : 2;
  static constexpr int THREADS = 128 * NWG;
  static constexpr int BK = SPLIT || COLS ? 64 : 64 * NWG;  // keys per block
  static constexpr int NC0 = COLS ? 128 : D;                // warpgroup 0's columns
  static constexpr int NC1 = COLS ? D - 128 : D;            // the others'
  static constexpr int PANELS = D / 64;
  static constexpr int K_PANEL = BK * 128, Q_PANEL = PANEL64;
  static constexpr int K_TILE = PANELS * K_PANEL, Q_TILE = PANELS * Q_PANEL;
  static constexpr int ST = 2 * KV_BQ * 4;  // a tile's lse2 and D, bytes
  // Stages of the Q/dO ring (SPLIT: NT / NWG each).
  static constexpr int NT = D == 64 ? 6 : D == 128 ? 4 : D == 192 ? 3 : 2;
  static constexpr int STEP = SPLIT ? NWG : 1;  // sweep steps between a warpgroup's steps
  static_assert(!SPLIT || NT % NWG == 0, "a warpgroup's steps keep to its own stages");
  // COLS: P^T (f32) and T(dS^T) handed between the warpgroups, 24 KB.
  static constexpr int SHARE = COLS ? 3 * PANEL64 : 0;
  static constexpr int SMEM =
      2 * K_TILE + NT * (2 * Q_TILE + ST) + (2 * NT + 1) * 8 + SHARE + 1024;
};

// P^T and dS^T of one tile in place of S^T and dP^T: sc[4 jj + i] is key
// r0 + 8 (i / 2), query q0 + 8 jj + 2 t + i % 2, whose lse2 and D are st[8 jj
// + 2 t + i % 2] and st[KV_BQ + ...] (a lane's columns depend on t only, so
// the reads broadcast). p = 2^(s c - lse2), 0 where masked (the compare only
// on tiles that reach past the warp's last key, wkey + 15); ds = p (dp - D)
// scale.
__device__ __forceinline__ void dst_cols(float* sc, float* dp, int q0, int wkey, int r0, int t,
                                         int kv_offset, int causal, float c, const float* st,
                                         float scale) {
  const bool diag = causal && wkey + 15 > q0 + kv_offset;
#pragma unroll
  for (int jj = 0; jj < KV_BQ / 8; ++jj) {
    const float2 ls = *reinterpret_cast<const float2*>(st + 8 * jj + 2 * t);
    const float2 dl = *reinterpret_cast<const float2*>(st + KV_BQ + 8 * jj + 2 * t);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = 4 * jj + i;
      float p = ex2(fmaf(sc[e], c, -((i & 1) ? ls.y : ls.x)));
      if (diag && r0 + 8 * (i >> 1) > q0 + 8 * jj + 2 * t + (i & 1) + kv_offset) p = 0.f;
      sc[e] = p;
      dp[e] = (p * (dp[e] - ((i & 1) ? dl.y : dl.x))) * scale;
    }
  }
}

template <typename T, int D, bool SPLIT>
__global__ void __launch_bounds__(KvCfg<D, SPLIT>::THREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tmq, const __grid_constant__ CUtensorMap tmk,
                     const __grid_constant__ CUtensorMap tmv, const __grid_constant__ CUtensorMap tmo,
                     const float* __restrict__ lse2_in, const float* __restrict__ delta_in,
                     T* __restrict__ dk_out, T* __restrict__ dv_out, int Tq, int Tq64, int Tkv,
                     int NH, int NKV, float sm_scale, int kv_offset, int causal) {
  using C = KvCfg<D, SPLIT>;
  constexpr int NT = C::NT, Q_TILE = C::Q_TILE, STEP = C::STEP, NWG = C::NWG;
  // dK's (and dV's) f32 registers (warpgroup 0's columns, the most), S^T's.
  constexpr int NO = C::NC0 / 2, NS = KV_BQ / 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (sm90_smem(smem_raw) & 1023)) & 1023);
  unsigned char* ks = smem;            // [PANELS][BK][64] of T, swizzled
  unsigned char* vs = ks + C::K_TILE;  // the same
  unsigned char* qs = vs + C::K_TILE;  // [NT][PANELS][64][64]
  unsigned char* os = qs + NT * Q_TILE;
  float* st = reinterpret_cast<float*>(os + NT * Q_TILE);  // [NT][lse2, D][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(st + NT * 2 * KV_BQ);
  uint64_t* empty = full + NT;
  uint64_t* kv_full = empty + NT;

  const int tid = threadIdx.x;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * C::BK;  // the first key blocks see the most q tiles: they go first
  const int G = NH / NKV;
  // The sweep: the q tiles that see key k0 or later, from the tile holding
  // query k0 - kv_offset on (the TPU kernel's skip rule, per 64-row tile),
  // for every query head of the group.
  const int nq = (Tq + KV_BQ - 1) / KV_BQ;
  const int i0 = causal && k0 > kv_offset ? (k0 - kv_offset) / KV_BQ : 0;
  const int per_head = nq > i0 ? nq - i0 : 0;
  const int n_it = per_head * G;

  // One thread fills stage it % NT with sweep step it: the q tile's Q and
  // dO, and its rows' lse2 and D.
  auto load_stage = [&](int it) {
    const int s = it % NT, h = hk * G + it / per_head, q0 = (i0 + it % per_head) * KV_BQ;
    mbar_expect_tx(&full[s], 2 * Q_TILE + C::ST);
#pragma unroll
    for (int p = 0; p < C::PANELS; ++p) {
      tma_load_3d(qs + s * Q_TILE + p * PANEL64, &tmq, &full[s], h * D + 64 * p, q0, b);
      tma_load_3d(os + s * Q_TILE + p * PANEL64, &tmo, &full[s], h * D + 64 * p, q0, b);
    }
    const size_t row = ((size_t)b * NH + h) * Tq64 + q0;
    bulk_load(st + s * 2 * KV_BQ, lse2_in + row, KV_BQ * 4, &full[s]);
    bulk_load(st + s * 2 * KV_BQ + KV_BQ, delta_in + row, KV_BQ * 4, &full[s]);
  };
  if (tid == 0) {
    for (int s = 0; s < NT; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], SPLIT ? 128 : C::THREADS);
    }
    mbar_init(kv_full, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    // K and V in boxes of 64 keys per panel; a box that starts past Tkv (in
    // the last block when Tkv is not a multiple of BK) is not loaded: its
    // keys are never stored.
    const int boxes = min(C::BK, Tkv - k0) / 64;
    mbar_expect_tx(kv_full, 2 * boxes * C::PANELS * PANEL64);
#pragma unroll
    for (int p = 0; p < C::PANELS; ++p)
      for (int x = 0; x < boxes; ++x) {
        const int off = p * C::K_PANEL + x * PANEL64;
        tma_load_3d(ks + off, &tmk, kv_full, hk * D + 64 * p, k0 + 64 * x, b);
        tma_load_3d(vs + off, &tmv, kv_full, hk * D + 64 * p, k0 + 64 * x, b);
      }
    for (int it = 0; it < min(NT, n_it); ++it) load_stage(it);
  }

  // ---- consumer warpgroups ----
  const int wg = tid >> 7, lane = tid & 31, w = (tid >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int kw = SPLIT || C::COLS ? 0 : 64 * wg;  // the warpgroup's first key in the block
  const int wkey = k0 + kw + 16 * w;              // the warp's first key
  const int r0 = wkey + g;                        // this thread's keys r0 and r0 + 8
  const int cw = C::COLS && wg ? 128 : 0;         // the warpgroup's first column of dK, dV
  const float c = sm_scale * LOG2E;
  const unsigned char* kt = ks + kw * 128;
  const unsigned char* vt = vs + kw * 128;

  float dk[NO], dv[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dk[i] = dv[i] = 0.f;
  mbar_wait(kv_full, 0);
  const int first = SPLIT ? wg : 0;
  if constexpr (C::COLS) {
    // S^T and dP^T formed once: warpgroup 0 forms S^T and P^T and hands P^T
    // over in f32; warpgroup 1 forms dP^T and dS^T and hands T(dS^T) back
    // (two named barriers a step); each runs dV and dK on its own columns.
    float* pbuf = reinterpret_cast<float*>(kv_full + 1);           // [NS][128] f32 P^T
    uint32_t* dbuf = reinterpret_cast<uint32_t*>(pbuf + NS * 128);  // [16][128] T(dS^T)
    const int ltid = tid & 127;
    for (int it = 0; it < n_it; ++it) {
      const int s = it % NT;
      const int q0 = (i0 + it % per_head) * KV_BQ;
      const float* stp = st + s * 2 * KV_BQ;
      const unsigned char* ot = os + s * Q_TILE + (cw / 64) * PANEL64;
      const unsigned char* qt = qs + s * Q_TILE + (cw / 64) * PANEL64;
      const bool diag = causal && wkey + 15 > q0 + kv_offset;
      float sc[NS];
      uint32_t pa[4][4], da[4][4];
      mbar_wait(&full[s], (it / NT) & 1);
      wgmma_fence();
      if (wg == 0) {
        issue_abt<T, D>(sc, kt, C::K_PANEL, qs + s * Q_TILE, PANEL64);
        wgmma_wait<0>();
        wgmma_fence_operand<NS>(sc);
#pragma unroll
        for (int jj = 0; jj < KV_BQ / 8; ++jj) {
          const float2 ls = *reinterpret_cast<const float2*>(stp + 8 * jj + 2 * t);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int e = 4 * jj + i;
            float p = ex2(fmaf(sc[e], c, -((i & 1) ? ls.y : ls.x)));
            if (diag && r0 + 8 * (i >> 1) > q0 + 8 * jj + 2 * t + (i & 1) + kv_offset) p = 0.f;
            sc[e] = p;
          }
        }
#pragma unroll
        for (int e = 0; e < NS; ++e) pbuf[e * 128 + ltid] = sc[e];
        named_bar_arrive(RED + 1, C::THREADS);
        pack_a<T>(pa, sc);
        wgmma_fence_operand<NO>(dv);
        wgmma_fence();
        issue_ab<T, C::NC0>(dv, pa, ot, PANEL64);
        named_bar_sync(RED + 2, C::THREADS);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) da[kk][r] = dbuf[(4 * kk + r) * 128 + ltid];
        wgmma_fence_operand<NO>(dk);
        wgmma_fence();
        issue_ab<T, C::NC0>(dk, da, qt, PANEL64);
      } else {
        float dp[NS];
        issue_abt<T, D>(dp, vt, C::K_PANEL, os + s * Q_TILE, PANEL64);
        wgmma_wait<0>();
        wgmma_fence_operand<NS>(dp);
        named_bar_sync(RED + 1, C::THREADS);
#pragma unroll
        for (int e = 0; e < NS; ++e) sc[e] = pbuf[e * 128 + ltid];
#pragma unroll
        for (int jj = 0; jj < KV_BQ / 8; ++jj) {
          const float2 dl = *reinterpret_cast<const float2*>(stp + KV_BQ + 8 * jj + 2 * t);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int e = 4 * jj + i;
            dp[e] = (sc[e] * (dp[e] - ((i & 1) ? dl.y : dl.x))) * sm_scale;
          }
        }
        pack_a<T>(da, dp);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) dbuf[(4 * kk + r) * 128 + ltid] = da[kk][r];
        named_bar_arrive(RED + 2, C::THREADS);
        pack_a<T>(pa, sc);
        wgmma_fence_operand<NO>(dv);
        wgmma_fence_operand<NO>(dk);
        wgmma_fence();
        issue_ab<T, C::NC1>(dv, pa, ot, PANEL64);
        issue_ab<T, C::NC1>(dk, da, qt, PANEL64);
      }
      wgmma_wait<0>();
      wgmma_fence_operand<NO>(dv);
      wgmma_fence_operand<NO>(dk);
      mbar_arrive(&empty[s]);
      if (tid == 128 && it + NT < n_it) {
        mbar_wait(&empty[s], (it / NT) & 1);
        load_stage(it + NT);
      }
    }
  } else {
    for (int it = first; it < n_it; it += STEP) {
      const int s = it % NT;
      float sc[NS], dp[NS];
      uint32_t pa[4][4], da[4][4];  // T(P^T), T(dS^T): the A fragments of dV and dK
      mbar_wait(&full[s], (it / NT) & 1);
      wgmma_fence();
      issue_abt<T, D>(sc, kt, C::K_PANEL, qs + s * Q_TILE, PANEL64);  // S^T = K Q^T
      issue_abt<T, D>(dp, vt, C::K_PANEL, os + s * Q_TILE, PANEL64);  // dP^T = V dO^T
      wgmma_wait<0>();
      wgmma_fence_operand<NS>(sc);
      wgmma_fence_operand<NS>(dp);
      dst_cols(sc, dp, (i0 + it % per_head) * KV_BQ, wkey, r0, t, kv_offset, causal, c,
               st + s * 2 * KV_BQ, sm_scale);
      pack_a<T>(pa, sc);
      pack_a<T>(da, dp);
      wgmma_fence_operand<NO>(dv);
      wgmma_fence_operand<NO>(dk);
      wgmma_fence();
      issue_ab<T, D>(dv, pa, os + s * Q_TILE, PANEL64);  // dV += P^T dO
      issue_ab<T, D>(dk, da, qs + s * Q_TILE, PANEL64);  // dK += dS^T Q
      wgmma_wait<0>();
      wgmma_fence_operand<NO>(dv);
      wgmma_fence_operand<NO>(dk);
      // The stage is done with: refill it once all its users are (SPLIT: the
      // warpgroup's own first thread; else the last warpgroup's).
      mbar_arrive(&empty[s]);
      if ((SPLIT ? (tid & 127) == 0 : tid == 128 * (NWG - 1)) && it + NT < n_it) {
        mbar_wait(&empty[s], (it / NT) & 1);
        load_stage(it + NT);
      }
    }
  }

  if constexpr (SPLIT) {
    // dK and dV of the block: warpgroup 0's sums plus those of warpgroups
    // 1 .. NWG - 1, in that order, through the ring's shared memory (Q's
    // and dO's stages) once all are done with it.
    static_assert((NWG - 1) * D * 128 * 4 <= 2 * NT * Q_TILE, "the sums fit the ring");
    float* red = reinterpret_cast<float*>(qs);  // [NWG - 1][2 NO][128]
    const int ltid = tid & 127;
    named_bar_sync(RED, C::THREADS);
    if (wg > 0) {
      float* mine = red + (wg - 1) * 2 * NO * 128;
#pragma unroll
      for (int i = 0; i < NO; ++i) {
        mine[i * 128 + ltid] = dk[i];
        mine[(NO + i) * 128 + ltid] = dv[i];
      }
    }
    named_bar_sync(RED, C::THREADS);
    if (wg > 0) return;
    for (int x = 0; x < NWG - 1; ++x) {
      const float* theirs = red + x * 2 * NO * 128;
#pragma unroll
      for (int i = 0; i < NO; ++i) {
        dk[i] += theirs[i * 128 + ltid];
        dv[i] += theirs[(NO + i) * 128 + ltid];
      }
    }
  }
  const int nc = wg ? C::NC1 : C::NC0;  // this warpgroup's columns
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int key = r0 + 8 * hr;
    if (key >= Tkv) continue;
    const size_t row = (((size_t)b * Tkv + key) * NKV + hk) * D + cw;
#pragma unroll
    for (int jj = 0; jj < C::NC0 / 8; ++jj) {
      if (8 * jj >= nc) break;
      *reinterpret_cast<uint32_t*>(dk_out + row + 8 * jj + 2 * t) =
          pack2_as<T>(dk[4 * jj + 2 * hr], dk[4 * jj + 2 * hr + 1]);
      *reinterpret_cast<uint32_t*>(dv_out + row + 8 * jj + 2 * t) =
          pack2_as<T>(dv[4 * jj + 2 * hr], dv[4 * jj + 2 * hr + 1]);
    }
  }
}

// ---- dq (wgmma) ----------------------------------------------------------------

constexpr int DQ_BKV = 64;

template <int D>
struct DqCfg {
  // NWG consumer warpgroups of 64 rows (2 at D 64 and 128, taking turns to
  // issue; 1 at D 192 and 256, the top). WARP: a producer warp loads (D 64,
  // 192, 256); else one of the consumers' threads (D 128: 256 threads, so
  // up to 255 registers each).
  static constexpr int NWG = D <= 128 ? 2 : 1;
  static constexpr int CONSUMERS = 128 * NWG;
  static constexpr int BQ = 64 * NWG;
  static constexpr bool WARP = D != 128;
  static constexpr int THREADS = WARP ? CONSUMERS + 32 : CONSUMERS;
  static constexpr int PANELS = D / 64;
  static constexpr int Q_PANEL = BQ * 128, KV_PANEL = PANEL64;
  static constexpr int Q_TILE = PANELS * Q_PANEL, KV_TILE = PANELS * KV_PANEL;
  static constexpr int NT = D <= 128 ? 4 : D == 192 ? 3 : 2;  // stages of the K/V ring
  static constexpr int SMEM = 2 * Q_TILE + NT * 2 * KV_TILE + (2 * NT + 1) * 8 + 1024;
};

// dS of one S tile in place of dP: sc[4 jj + i] is row r0 + 8 (i / 2), key
// k0 + 8 jj + 2 t + i % 2. p = 2^(s c - lse2) (0 where masked; the compare
// only on tiles that reach past the warp's first row, wrow), ds = p (dp -
// D) scale.
__device__ __forceinline__ void ds_rows(const float* sc, float* dp, int k0, int wrow, int r0,
                                        int t, int kv_offset, int causal, float c,
                                        const float* lse2, const float* dl, float scale) {
  const bool diag = causal && k0 + DQ_BKV - 1 > wrow + kv_offset;
#pragma unroll
  for (int jj = 0; jj < DQ_BKV / 8; ++jj)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = 4 * jj + i, hr = i >> 1;
      float p = ex2(fmaf(sc[e], c, -lse2[hr]));
      if (diag && k0 + 8 * jj + 2 * t + (i & 1) > r0 + 8 * hr + kv_offset) p = 0.f;
      dp[e] = (p * (dp[e] - dl[hr])) * scale;
    }
}

template <typename T, int D>
__global__ void __launch_bounds__(DqCfg<D>::THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tmq, const __grid_constant__ CUtensorMap tmk,
                    const __grid_constant__ CUtensorMap tmv, const __grid_constant__ CUtensorMap tmo,
                    const float* __restrict__ lse2_in, const float* __restrict__ delta_in,
                    T* __restrict__ dq_out, int Tq, int Tq64, int Tkv, int NH, int NKV,
                    float sm_scale, int kv_offset, int causal) {
  using C = DqCfg<D>;
  constexpr int NT = C::NT, KV_TILE = C::KV_TILE, CONSUMERS = C::CONSUMERS;
  constexpr bool TURNS = C::NWG == 2;  // the two warpgroups take turns to issue
  constexpr int NO = D / 2, NS = DQ_BKV / 2;  // dQ's and S's f32 registers
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (sm90_smem(smem_raw) & 1023)) & 1023);
  unsigned char* qs = smem;            // [PANELS][BQ][64] of T, swizzled
  unsigned char* os = qs + C::Q_TILE;  // dO, the same
  unsigned char* ks = os + C::Q_TILE;  // [NT][PANELS][64][64]
  unsigned char* vs = ks + NT * KV_TILE;
  uint64_t* full = reinterpret_cast<uint64_t*>(vs + NT * KV_TILE);
  uint64_t* empty = full + NT;
  uint64_t* q_full = empty + NT;

  const int tid = threadIdx.x;
  const int qt = gridDim.z - 1 - blockIdx.z;  // heaviest q tiles first
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (NH / NKV);
  const int q0 = qt * C::BQ;
  int n_kv = Tkv / DQ_BKV;
  if (causal) {
    const int last = q0 + C::BQ - 1 + kv_offset;  // the TPU kernel's tile-skip rule
    n_kv = last < 0 ? 0 : min(n_kv, last / DQ_BKV + 1);
  }
  if (tid == 0) {
    for (int s = 0; s < NT; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_init(q_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  auto load_kv = [&](int j) {  // one thread: K/V tile j into stage j % NT
    const int s = j % NT;
    mbar_expect_tx(&full[s], 2 * KV_TILE);
#pragma unroll
    for (int p = 0; p < C::PANELS; ++p) {
      const int col = hk * D + 64 * p;
      tma_load_3d(ks + s * KV_TILE + p * PANEL64, &tmk, &full[s], col, j * DQ_BKV, b);
      tma_load_3d(vs + s * KV_TILE + p * PANEL64, &tmv, &full[s], col, j * DQ_BKV, b);
    }
  };
  if (tid == (C::WARP ? CONSUMERS : 0)) {
    // Q and dO in boxes of 64 rows per panel; a box that starts past Tq is
    // not loaded (its warpgroup's rows are never stored).
    const int halves = min(C::NWG, (Tq - q0 + 63) / 64);
    mbar_expect_tx(q_full, 2 * halves * C::PANELS * PANEL64);
#pragma unroll
    for (int p = 0; p < C::PANELS; ++p)
      for (int hf = 0; hf < halves; ++hf) {
        const int off = p * C::Q_PANEL + hf * PANEL64;
        tma_load_3d(qs + off, &tmq, q_full, h * D + 64 * p, q0 + 64 * hf, b);
        tma_load_3d(os + off, &tmo, q_full, h * D + 64 * p, q0 + 64 * hf, b);
      }
    for (int j = 0; j < (C::WARP ? n_kv : min(NT, n_kv)); ++j) {
      if (j >= NT) mbar_wait(&empty[j % NT], (j / NT - 1) & 1);
      load_kv(j);
    }
  }
  if (tid >= CONSUMERS) return;  // the producer warp (WARP)

  // ---- consumer warpgroups: query rows [q0 + 64 wg, q0 + 64 wg + 64) ----
  const int wg = tid >> 7, lane = tid & 31, w = (tid >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = q0 + 64 * wg + 16 * w;  // the warp's first query row
  const int r0 = wrow + g;                 // this thread's rows r0 and r0 + 8
  const float c = sm_scale * LOG2E;
  const unsigned char* qw = qs + wg * PANEL64;  // the warpgroup's 64 rows of each panel
  const unsigned char* ow = os + wg * PANEL64;
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
  uint32_t da[4][4];  // T(dS) of the last tile, the A fragments of dQ += dS K
  mbar_wait(q_full, 0);
  if (n_kv > 0) {
    // Each turn issues S and dP of tile j and dQ of tile j - 1; then tile
    // j's dS. Warpgroup 0 takes the first turn; each takes n_kv + 1 turns.
    if (TURNS && wg == 1) sched_pass(wg);
    {
      float sc[NS], dp[NS];
      mbar_wait(&full[0], 0);
      if (TURNS) sched_wait(wg);
      wgmma_fence();
      issue_abt<T, D>(sc, qw, C::Q_PANEL, ks, PANEL64);
      issue_abt<T, D>(dp, ow, C::Q_PANEL, vs, PANEL64);
      if (TURNS) sched_pass(wg);
      wgmma_wait<0>();
      wgmma_fence_operand<NS>(sc);
      wgmma_fence_operand<NS>(dp);
      ds_rows(sc, dp, 0, wrow, r0, t, kv_offset, causal, c, lse2, dl, sm_scale);
      pack_a<T>(da, dp);
    }
    for (int j = 1; j < n_kv; ++j) {
      float sc[NS], dp[NS];
      const int s = j % NT, sp = (j - 1) % NT;
      mbar_wait(&full[s], (j / NT) & 1);
      if (TURNS) sched_wait(wg);
      wgmma_fence();
      issue_abt<T, D>(sc, qw, C::Q_PANEL, ks + s * KV_TILE, PANEL64);
      issue_abt<T, D>(dp, ow, C::Q_PANEL, vs + s * KV_TILE, PANEL64);
      wgmma_fence_operand<NO>(dq);
      issue_ab<T, D>(dq, da, ks + sp * KV_TILE, PANEL64);
      if (TURNS) sched_pass(wg);
      wgmma_wait<1>();
      wgmma_fence_operand<NS>(sc);
      wgmma_fence_operand<NS>(dp);
      ds_rows(sc, dp, j * DQ_BKV, wrow, r0, t, kv_offset, causal, c, lse2, dl, sm_scale);
      wgmma_wait<0>();
      wgmma_fence_operand<NO>(dq);
      mbar_arrive(&empty[sp]);
      if (!C::WARP && tid == 128 && j - 1 + NT < n_kv) {  // warpgroup 1 issues second:
        mbar_wait(&empty[sp], ((j - 1) / NT) & 1);       // both are done with sp
        load_kv(j - 1 + NT);
      }
      pack_a<T>(da, dp);
    }
    const int sp = (n_kv - 1) % NT;
    if (TURNS) sched_wait(wg);
    wgmma_fence_operand<NO>(dq);
    wgmma_fence();
    issue_ab<T, D>(dq, da, ks + sp * KV_TILE, PANEL64);
    if (TURNS && wg == 0) sched_pass(wg);  // warpgroup 1's last turn follows; nothing follows it
    wgmma_wait<0>();
    wgmma_fence_operand<NO>(dq);
    mbar_arrive(&empty[sp]);
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r0 + 8 * hr;
    if (row >= Tq) continue;
    T* drow = dq_out + ((size_t)b * Tq + row) * NH * D + (size_t)h * D;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj)
      *reinterpret_cast<uint32_t*>(drow + 8 * jj + 2 * t) =
          pack2_as<T>(dq[4 * jj + 2 * hr], dq[4 * jj + 2 * hr + 1]);
  }
}

template <typename T, int D, bool SPLIT>
cudaError_t launch_dkv(const CUtensorMap& tmq, const CUtensorMap& tmk, const CUtensorMap& tmv,
                       const CUtensorMap& tmo, const fbwd_parts::Call& c, int Tq64) {
  using KC = KvCfg<D, SPLIT>;
  static bool sized[64] = {};
  auto kern = flash_bwd_dkv_kernel<T, D, SPLIT>;
  const cudaError_t e = size_smem(kern, KC::SMEM, sized);
  if (e != cudaSuccess) return e;
  kern<<<dim3(c.NKV, c.B, (c.Tkv + KC::BK - 1) / KC::BK), KC::THREADS, KC::SMEM, c.stream>>>(
      tmq, tmk, tmv, tmo, c.lse2, c.delta, static_cast<T*>(c.dk), static_cast<T*>(c.dv), c.Tq,
      Tq64, c.Tkv, c.NH, c.NKV, c.sm_scale, c.kv_offset, c.causal);
  return cudaGetLastError();
}

int tq64_of(int Tq) { return (Tq + TQ_ALIGN - 1) / TQ_ALIGN * TQ_ALIGN; }

// The statistics launch (D = 0: the head size c.D, past 256).
template <typename T, int D>
cudaError_t launch_stats(const fbwd_parts::Call& c) {
  const int Tq64 = tq64_of(c.Tq);
  constexpr int per_block = STATS_THREADS / stats_lanes(D);
  const long long rows = (long long)c.B * Tq64 * c.NH;
  const unsigned blocks = static_cast<unsigned>((rows + per_block - 1) / per_block);
  flash_bwd_stats_kernel<T, D><<<blocks, STATS_THREADS, 0, c.stream>>>(
      static_cast<const T*>(c.o), static_cast<const T*>(c.dout), c.l, c.m, c.lse2, c.delta, c.B,
      c.Tq, Tq64, c.NH, c.D);
  return cudaGetLastError();
}

template <typename T, int D>
int launch(const fbwd_parts::Call& c) {
  const int Tq64 = tq64_of(c.Tq);
  if (const cudaError_t e = launch_stats<T, D>(c)) return static_cast<int>(e);

  using C = DqCfg<D>;
  CUtensorMap tmq, tmk, tmv, tmo;
  const auto ty = tma_type<T>();
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!encode_3d(&tmq, ty, 2, c.q, c.B, c.Tq, (uint64_t)c.NH * D, 64, 64, sw) ||
      !encode_3d(&tmo, ty, 2, c.dout, c.B, c.Tq, (uint64_t)c.NH * D, 64, 64, sw) ||
      !encode_3d(&tmk, ty, 2, c.k, c.B, c.Tkv, (uint64_t)c.NKV * D, 64, 64, sw) ||
      !encode_3d(&tmv, ty, 2, c.v, c.B, c.Tkv, (uint64_t)c.NKV * D, 64, 64, sw))
    return static_cast<int>(cudaErrorInvalidValue);
  {
    cudaError_t e;
    if constexpr (D <= 128) {
      // Blocks of 64 NWG keys load each Q/dO tile once for all warpgroups;
      // where they would not fill the card twice over (few batch rows and
      // KV heads: the first, heaviest blocks would set the time), 64-key
      // blocks divide the heaviest block's work by NWG instead.
      static int sms[64] = {};
      int dev = 0;
      cudaGetDevice(&dev);
      int n_sm = dev < 64 ? sms[dev] : 0;
      if (n_sm == 0) {
        cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
        if (dev < 64) sms[dev] = n_sm;
      }
      constexpr int BK = KvCfg<D, false>::BK;
      const bool split = (long long)c.B * c.NKV * ((c.Tkv + BK - 1) / BK) < 2LL * n_sm;
      e = split ? launch_dkv<T, D, true>(tmq, tmk, tmv, tmo, c, Tq64)
                : launch_dkv<T, D, false>(tmq, tmk, tmv, tmo, c, Tq64);
    } else {
      e = launch_dkv<T, D, false>(tmq, tmk, tmv, tmo, c, Tq64);  // the COLS shape
    }
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  static bool sized_dq[64] = {};
  auto kern = flash_bwd_dq_kernel<T, D>;
  cudaError_t e = size_smem(kern, C::SMEM, sized_dq);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(c.NH, c.B, (c.Tq + C::BQ - 1) / C::BQ);
  kern<<<grid, C::THREADS, C::SMEM, c.stream>>>(tmq, tmk, tmv, tmo, c.lse2, c.delta,
                                                 static_cast<T*>(c.dq), c.Tq, Tq64, c.Tkv, c.NH,
                                                 c.NKV, c.sm_scale, c.kv_offset, c.causal);
  return static_cast<int>(cudaGetLastError());
}

// ---- past D 256 (flash_part.cuh: plan_bwd) ------------------------------------

namespace bpart {

constexpr int THREADS = 288;              // two consumer warpgroups, a producer warp
constexpr int CONSUMERS = 256;            // the producer warp's first thread issues the loads
constexpr int P_READY = 1, DS_READY = 2;  // named barriers: P, then T(dS), handed over

// Both kernels' shared memory (plan_bwd): the block's own operands of S and
// dP when resident, the ring of jobs, each job's statistics (dK/dV), the
// hand-over and the barriers.
struct Smem {
  unsigned char* res;   // two [D / 64][64][128 B] (dQ: Q, dO; dK/dV: K, V)
  unsigned char* ring;  // [ring][2][64][128 B]: warpgroup 0's panel, warpgroup 1's
  float* st;            // [ring][lse2, D][64]
  float* pbuf;          // [32][128]: P (f32), element e of thread i of a warpgroup at [e][i]
  uint32_t* dbuf;       // [16][128]: T(dS) as A fragments, the same way
  uint64_t *full, *empty, *res_full;
  __device__ Smem(unsigned char* raw, const fpart::PlanBwd& p) {
    res = raw + ((1024 - (sm90_smem(raw) & 1023)) & 1023);
    ring = res + p.res_bytes;
    st = reinterpret_cast<float*>(ring + p.ring * fpart::BWD_SLOT);
    pbuf = st + p.ring * 128;
    dbuf = reinterpret_cast<uint32_t*>(pbuf + 32 * 128);
    full = reinterpret_cast<uint64_t*>(dbuf + 16 * 128);
    empty = full + p.ring;
    res_full = empty + p.ring;
  }
  __device__ unsigned char* slot(int s) const { return ring + s * fpart::BWD_SLOT; }
  __device__ void init(int ring) const {
    for (int s = 0; s < ring; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_init(res_full, 1);
    mbar_fence_init();
  }
};

// Job n into slot n % ring (the producer), once every consumer has released
// job n - ring there: panel p0 of map m0 (head h0) for warpgroup 0 and p1
// of m1 (h1) for warpgroup 1, 64 rows from `row` of batch row b; a negative
// panel is not loaded (the warpgroup's products on it are never stored). A
// dK/dV step's last S job also brings its queries' lse2 and D (64 each).
__device__ __forceinline__ void load_job(const Smem& sm, int ring, int n, const CUtensorMap* m0,
                                         int p0, int h0, const CUtensorMap* m1, int p1, int h1,
                                         int row, int b, const float* lse2 = nullptr,
                                         const float* delta = nullptr) {
  const int s = n % ring;
  if (n >= ring) mbar_wait(&sm.empty[s], (n / ring - 1) & 1);
  unsigned char* dst = sm.slot(s);
  const uint32_t bytes =
      (p0 >= 0 ? PANEL64 : 0) + (p1 >= 0 ? PANEL64 : 0) + (lse2 ? fpart::BWD_STATS : 0);
  mbar_expect_tx(&sm.full[s], bytes);
  if (p0 >= 0) tma_load_5d(dst, m0, &sm.full[s], 0, row, p0, h0, b);
  if (p1 >= 0) tma_load_5d(dst + PANEL64, m1, &sm.full[s], 0, row, p1, h1, b);
  if (lse2) {
    bulk_load(sm.st + s * 128, lse2, 64 * 4, &sm.full[s]);
    bulk_load(sm.st + s * 128 + 64, delta, 64 * 4, &sm.full[s]);
  }
}

// A consumer thread's side of the ring: jobs in order, each released by
// every consumer.
struct Ring {
  const Smem& sm;
  int ring, s = 0, ph = 0;
  __device__ int wait() {
    mbar_wait(&sm.full[s], ph);
    const int got = s;
    if (++s == ring) s = 0, ph ^= 1;
    return got;
  }
  __device__ void release(int slot) const { mbar_arrive(&sm.empty[slot]); }
};

// x += A B^T for one 64-column panel of A's and of B's 64 rows, both
// K-major (as TMA writes them): SS wgmma m64n64k16, issued and retired.
template <typename T>
__device__ __forceinline__ void s_panel(float* x, const unsigned char* a, const unsigned char* b) {
  wgmma_fence_operand<32>(x);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n64k16<T, 0>(x, wgmma_desc(a + 32 * kk, 16, 1024), wgmma_desc(b + 32 * kk, 16, 1024),
                          1);
  wgmma_commit();
  wgmma_wait<0>();
  wgmma_fence_operand<32>(x);
}

// x (S or S^T, then dP or dP^T) over all D / 64 panels of a tile: the
// warpgroup's own operand (resident, or its job's panel) against the next
// job's. The last job is held, not released, when `hold` (its statistics);
// its slot is returned.
template <typename T, bool RES>
__device__ __forceinline__ int s_tile(float* x, Ring& rg, const unsigned char* own, int P, int wg,
                                      bool hold) {
#pragma unroll
  for (int e = 0; e < 32; ++e) x[e] = 0.f;
  int last = 0;
  for (int pp = 0; pp < P; ++pp) {
    const unsigned char* a;
    int sa = 0;
    if constexpr (RES) {
      a = own + pp * PANEL64;
    } else {
      sa = rg.wait();
      a = rg.sm.slot(sa) + wg * PANEL64;
    }
    const int sb = rg.wait();
    s_panel<T>(x, a, rg.sm.slot(sb) + wg * PANEL64);
    if constexpr (!RES) rg.release(sa);
    if (hold && pp + 1 == P)
      last = sb;
    else
      rg.release(sb);
  }
  return last;
}

// acc[32 x ..] += T(A) B_x over the next NP jobs' panels (this warpgroup's
// half of each): A 64 rows x 64 in registers, each panel 64 k rows read
// MN-major. Issued as one group and retired, the jobs then released.
template <typename T, int NP>
__device__ __forceinline__ void acc_panels(float* acc, const uint32_t (*a)[4], Ring& rg, int wg) {
  int sl[NP];
#pragma unroll
  for (int x = 0; x < NP; ++x) sl[x] = rg.wait();
  wgmma_fence_operand<32 * NP>(acc);
  wgmma_fence();
#pragma unroll
  for (int x = 0; x < NP; ++x)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64k16_rs<T, 1>(
          acc + 32 * x, a[kk],
          wgmma_desc(rg.sm.slot(sl[x]) + wg * PANEL64 + 2048 * kk, PANEL64, 1024), 1);
  wgmma_commit();
  wgmma_wait<0>();
  wgmma_fence_operand<32 * NP>(acc);
#pragma unroll
  for (int x = 0; x < NP; ++x) rg.release(sl[x]);
}

}  // namespace bpart

// dQ past D 256: one block per (64 query rows, head and column part, batch
// row), the heaviest q tiles of every head first. Per key tile: warpgroup 0
// forms S = Q K^T and P, warpgroup 1 dP = dO V^T and dS (P handed over in
// f32, T(dS) handed back); then each adds T(dS) K into its OP panels of the
// part (the first (np + 1) / 2 of the part's np panels to warpgroup 0),
// K's panels of the part streamed again. The rows' lse2 and D stay in
// registers.
template <typename T, int OP, bool RES>
__global__ void __launch_bounds__(bpart::THREADS, 1)
flash_bwd_dq_part_kernel(const __grid_constant__ CUtensorMap tmq,
                         const __grid_constant__ CUtensorMap tmo,
                         const __grid_constant__ CUtensorMap tmk,
                         const __grid_constant__ CUtensorMap tmv,
                         const __grid_constant__ CUtensorMap tmq_all,
                         const __grid_constant__ CUtensorMap tmo_all,
                         const float* __restrict__ lse2_in, const float* __restrict__ delta_in,
                         T* __restrict__ dq_out, const fpart::ArgsBwd a) {
  constexpr int NO = 32 * OP;
  const fpart::PlanBwd& p = a.p;
  extern __shared__ unsigned char smem_raw[];
  const bpart::Smem sm(smem_raw, p);
  const int tid = threadIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int h = blockIdx.x / p.dq_parts, part = blockIdx.x % p.dq_parts, b = blockIdx.z;
  const int c0 = part * p.dq_dc, np = min(p.dq_dc, a.D - c0) / 64, np0 = (np + 1) / 2;
  const int hk = h / (a.NH / a.NKV);
  const int q0 = qt * 64, P = a.D / 64;
  int n_kv = a.Tkv / 64;
  if (a.causal) {
    const int last = q0 + 63 + a.kv_offset;  // the TPU kernel's tile-skip rule
    n_kv = last < 0 ? 0 : min(n_kv, last / 64 + 1);
  }
  // A key tile's jobs: per panel (Q and dO's, when streamed, then) K and
  // V's; then the part's K panels, warpgroup 0's and 1's.
  const int JS = RES ? P : 2 * P, JT = JS + OP;
  auto issue = [&](int n) {
    const int j = n / JT, i = n % JT, pp = RES ? i : i / 2;
    if (i >= JS) {
      const int x = i - JS;
      bpart::load_job(sm, p.ring, n, &tmk, x < np0 ? c0 / 64 + x : -1, hk, &tmk,
                      x < np - np0 ? c0 / 64 + np0 + x : -1, hk, 64 * j, b);
    } else if (!RES && i % 2 == 0) {
      bpart::load_job(sm, p.ring, n, &tmq, pp, h, &tmo, pp, h, q0, b);
    } else {
      bpart::load_job(sm, p.ring, n, &tmk, pp, hk, &tmv, pp, hk, 64 * j, b);
    }
  };
  if (tid == 0) sm.init(p.ring);
  __syncthreads();
  if (tid >= bpart::CONSUMERS) {  // the producer warp: one thread issues every job
    if (tid == bpart::CONSUMERS) {
      if constexpr (RES) {
        mbar_expect_tx(sm.res_full, p.res_bytes);
        tma_load_5d(sm.res, &tmq_all, sm.res_full, 0, q0, 0, h, b);
        tma_load_5d(sm.res + p.res_bytes / 2, &tmo_all, sm.res_full, 0, q0, 0, h, b);
      }
      for (int n = 0; n < n_kv * JT; ++n) issue(n);
    }
    return;
  }
  bpart::Ring rg{sm, p.ring};

  const int wg = tid >> 7, ltid = tid & 127, lane = tid & 31, w = ltid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = q0 + 16 * w;  // the warp's first query row (both warpgroups)
  const int r0 = wrow + g;       // this thread's rows r0 and r0 + 8
  const float c = a.sm_scale * LOG2E;
  float lse2[2], dl[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r0 + 8 * hr;
    const size_t s = ((size_t)b * a.NH + h) * a.Tq64 + row;
    lse2[hr] = row < a.Tq ? lse2_in[s] : INFINITY;
    dl[hr] = row < a.Tq ? delta_in[s] : 0.f;
  }
  float dq[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dq[i] = 0.f;
  uint32_t da[4][4];  // T(dS): the A fragments of dQ += T(dS) K
  const unsigned char* own = sm.res + wg * (p.res_bytes / 2);  // Q or dO (resident)
  if constexpr (RES) mbar_wait(sm.res_full, 0);
  for (int j = 0; j < n_kv; ++j) {
    float x[32];  // warpgroup 0: S, then P; warpgroup 1: dP, then dS
    bpart::s_tile<T, RES>(x, rg, own, P, wg, false);
    const int k0 = 64 * j;
    if (wg == 0) {
      const bool diag = a.causal && k0 + 63 > wrow + a.kv_offset;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = 4 * jj + i, hr = i >> 1;
          float pv = ex2(fmaf(x[e], c, -lse2[hr]));
          if (diag && k0 + 8 * jj + 2 * t + (i & 1) > r0 + 8 * hr + a.kv_offset) pv = 0.f;
          sm.pbuf[e * 128 + ltid] = pv;
        }
      named_bar_arrive(bpart::P_READY, bpart::CONSUMERS);
      named_bar_sync(bpart::DS_READY, bpart::CONSUMERS);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) da[kk][r] = sm.dbuf[(4 * kk + r) * 128 + ltid];
    } else {
      named_bar_sync(bpart::P_READY, bpart::CONSUMERS);
#pragma unroll
      for (int e = 0; e < 32; ++e)
        x[e] = (sm.pbuf[e * 128 + ltid] * (x[e] - dl[(e & 3) >> 1])) * a.sm_scale;
      pack_a<T>(da, x);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) sm.dbuf[(4 * kk + r) * 128 + ltid] = da[kk][r];
      named_bar_arrive(bpart::DS_READY, bpart::CONSUMERS);
    }
    bpart::acc_panels<T, OP>(dq, da, rg, wg);
  }

  const int pan0 = wg ? np0 : 0, mine = wg ? np - np0 : np0;  // the warpgroup's panels
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r0 + 8 * hr;
    if (row >= a.Tq) continue;
    T* drow = dq_out + ((size_t)b * a.Tq + row) * a.NH * a.D + (size_t)h * a.D + c0 + 64 * pan0;
#pragma unroll
    for (int jj = 0; jj < NO / 4; ++jj)
      if (jj < 8 * mine)
        *reinterpret_cast<uint32_t*>(drow + 8 * jj + 2 * t) =
            pack2_as<T>(dq[4 * jj + 2 * hr], dq[4 * jj + 2 * hr + 1]);
  }
}

// dK/dV past D 256: one block per (64 keys, KV head and column part of
// BWD_KV_DC columns, batch row), the first key blocks (which see the most q
// tiles) first, sweeping the (query head of the group, 64-row q tile) steps
// that see its keys, as K11 does. Per step: warpgroup 0 forms S^T = K Q^T
// and P^T, warpgroup 1 dP^T = V dO^T and dS^T (P^T handed over in f32,
// T(dS^T) handed back); then each adds, on its own 128 columns of the part,
// T(P^T) dO into dV (warpgroup 0 while warpgroup 1 forms dS^T) and T(dS^T) Q
// into dK, the step's dO and Q columns of the part streamed again. dK and dV
// sum over the group in the block's registers, deterministically.
template <typename T, bool RES>
__global__ void __launch_bounds__(bpart::THREADS, 1)
flash_bwd_dkv_part_kernel(const __grid_constant__ CUtensorMap tmq,
                          const __grid_constant__ CUtensorMap tmo,
                          const __grid_constant__ CUtensorMap tmk,
                          const __grid_constant__ CUtensorMap tmv,
                          const __grid_constant__ CUtensorMap tmk_all,
                          const __grid_constant__ CUtensorMap tmv_all,
                          const float* __restrict__ lse2_in, const float* __restrict__ delta_in,
                          T* __restrict__ dk_out, T* __restrict__ dv_out,
                          const fpart::ArgsBwd a) {
  const fpart::PlanBwd& p = a.p;
  extern __shared__ unsigned char smem_raw[];
  const bpart::Smem sm(smem_raw, p);
  const int tid = threadIdx.x;
  const int hk = blockIdx.x / p.kv_parts, part = blockIdx.x % p.kv_parts, b = blockIdx.z;
  const int k0 = blockIdx.y * 64;
  const int c0 = part * fpart::BWD_KV_DC, nc = min(fpart::BWD_KV_DC, a.D - c0);
  const int G = a.NH / a.NKV, P = a.D / 64;
  // The sweep: the q tiles that see key k0 or later, from the tile holding
  // query k0 - kv_offset on (the TPU kernel's skip rule, per 64-row tile),
  // for every query head of the group.
  const int nq = (a.Tq + 63) / 64;
  const int i0 = a.causal && k0 > a.kv_offset ? (k0 - a.kv_offset) / 64 : 0;
  const int per_head = nq > i0 ? nq - i0 : 0;
  const int n_it = per_head * G;
  // A step's jobs: per panel (K and V's, when streamed, then) Q and dO's,
  // the last with the queries' lse2 and D; then the part's dO columns and
  // Q's, warpgroup 0's first 128 and warpgroup 1's next.
  const int JS = RES ? P : 2 * P, JT = JS + 4, cp = c0 / 64;
  auto issue = [&](int n) {
    const int it = n / JT, i = n % JT, pp = RES ? i : i / 2;
    const int h = hk * G + it / per_head, q0 = (i0 + it % per_head) * 64;
    if (i >= JS) {
      const int x = (i - JS) % 2;
      const CUtensorMap* m = i - JS < 2 ? &tmo : &tmq;
      bpart::load_job(sm, p.ring, n, m, 64 * x < nc ? cp + x : -1, h, m,
                      128 + 64 * x < nc ? cp + 2 + x : -1, h, q0, b);
    } else if (!RES && i % 2 == 0) {
      bpart::load_job(sm, p.ring, n, &tmk, pp, hk, &tmv, pp, hk, k0, b);
    } else {
      const size_t srow = ((size_t)b * a.NH + h) * a.Tq64 + q0;
      const bool last = i == JS - 1;
      bpart::load_job(sm, p.ring, n, &tmq, pp, h, &tmo, pp, h, q0, b,
                      last ? lse2_in + srow : nullptr, last ? delta_in + srow : nullptr);
    }
  };
  if (tid == 0) sm.init(p.ring);
  __syncthreads();
  if (tid >= bpart::CONSUMERS) {  // the producer warp: one thread issues every job
    if (tid == bpart::CONSUMERS) {
      if constexpr (RES) {
        mbar_expect_tx(sm.res_full, p.res_bytes);
        tma_load_5d(sm.res, &tmk_all, sm.res_full, 0, k0, 0, hk, b);
        tma_load_5d(sm.res + p.res_bytes / 2, &tmv_all, sm.res_full, 0, k0, 0, hk, b);
      }
      for (int n = 0; n < n_it * JT; ++n) issue(n);
    }
    return;
  }
  bpart::Ring rg{sm, p.ring};

  const int wg = tid >> 7, ltid = tid & 127, lane = tid & 31, w = ltid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wkey = k0 + 16 * w;  // the warp's first key (both warpgroups)
  const int r0 = wkey + g;       // this thread's keys r0 and r0 + 8
  const float c = a.sm_scale * LOG2E;
  float dk[64], dv[64];  // the warpgroup's 128 columns of the part
#pragma unroll
  for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;
  uint32_t pa[4][4], da[4][4];  // T(P^T), T(dS^T): the A fragments of dV and dK
  const unsigned char* own = sm.res + wg * (p.res_bytes / 2);  // K or V (resident)
  if constexpr (RES) mbar_wait(sm.res_full, 0);
  for (int it = 0; it < n_it; ++it) {
    const int q0 = (i0 + it % per_head) * 64;
    float x[32];  // warpgroup 0: S^T, then P^T; warpgroup 1: dP^T, then dS^T
    const int sl = bpart::s_tile<T, RES>(x, rg, own, P, wg, true);
    const float* stp = sm.st + sl * 128;  // the step's lse2 and D (a lane's reads broadcast)
    if (wg == 0) {
      const bool diag = a.causal && wkey + 15 > q0 + a.kv_offset;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float2 ls = *reinterpret_cast<const float2*>(stp + 8 * jj + 2 * t);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = 4 * jj + i;
          float pv = ex2(fmaf(x[e], c, -((i & 1) ? ls.y : ls.x)));
          if (diag && r0 + 8 * (i >> 1) > q0 + 8 * jj + 2 * t + (i & 1) + a.kv_offset) pv = 0.f;
          x[e] = pv;
          sm.pbuf[e * 128 + ltid] = pv;
        }
      }
      named_bar_arrive(bpart::P_READY, bpart::CONSUMERS);
      rg.release(sl);
      pack_a<T>(pa, x);
    } else {
      named_bar_sync(bpart::P_READY, bpart::CONSUMERS);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int e = 8 * kk + 2 * r;  // key r0 + 8 (r % 2), queries 8 (e / 4) + 2 t and + 1
          const float2 dl = *reinterpret_cast<const float2*>(stp + 64 + 8 * (e >> 2) + 2 * t);
          const float p0 = sm.pbuf[e * 128 + ltid], p1 = sm.pbuf[(e + 1) * 128 + ltid];
          pa[kk][r] = pack2_as<T>(p0, p1);
          x[e] = (p0 * (x[e] - dl.x)) * a.sm_scale;
          x[e + 1] = (p1 * (x[e + 1] - dl.y)) * a.sm_scale;
        }
      rg.release(sl);
      pack_a<T>(da, x);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) sm.dbuf[(4 * kk + r) * 128 + ltid] = da[kk][r];
      named_bar_arrive(bpart::DS_READY, bpart::CONSUMERS);
    }
    bpart::acc_panels<T, 2>(dv, pa, rg, wg);  // dV += T(P^T) dO
    if (wg == 0) {
      named_bar_sync(bpart::DS_READY, bpart::CONSUMERS);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) da[kk][r] = sm.dbuf[(4 * kk + r) * 128 + ltid];
    }
    bpart::acc_panels<T, 2>(dk, da, rg, wg);  // dK += T(dS^T) Q
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const size_t row = (((size_t)b * a.Tkv + r0 + 8 * hr) * a.NKV + hk) * a.D + c0 + 128 * wg;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj)
      if (128 * wg + 8 * jj < nc) {
        *reinterpret_cast<uint32_t*>(dk_out + row + 8 * jj + 2 * t) =
            pack2_as<T>(dk[4 * jj + 2 * hr], dk[4 * jj + 2 * hr + 1]);
        *reinterpret_cast<uint32_t*>(dv_out + row + 8 * jj + 2 * t) =
            pack2_as<T>(dv[4 * jj + 2 * hr], dv[4 * jj + 2 * hr + 1]);
      }
  }
}

// [B][len][heads][D] as [B][heads][D / 64 panels][len][64 columns], read in
// boxes of `panels` panels of 64 rows: one lands as [panel][row][128 B],
// swizzled; rows past len read zeros within their batch row.
template <typename T>
bool view_panels(CUtensorMap* map, const void* ptr, int B, int len, int heads, int D, int panels) {
  const uint64_t dims[5] = {64, (uint64_t)len, (uint64_t)D / 64, (uint64_t)heads, (uint64_t)B};
  const uint64_t strides[4] = {(uint64_t)heads * D * 2, 128, (uint64_t)D * 2,
                               (uint64_t)len * heads * D * 2};
  const uint32_t box[5] = {64, 64, (uint32_t)panels, 1, 1};
  return encode_nd(map, tma_type<T>(), ptr, 5, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// The four operands in one-panel boxes (m[0..3]: q, do, k, v) and the
// block's own two in whole-head boxes (m[4], m[5]: dQ's q and do, dK/dV's k
// and v).
template <typename T>
bool part_maps(CUtensorMap* m, const fbwd_parts::Call& c, bool dq) {
  const int P = c.D / 64;
  return view_panels<T>(&m[0], c.q, c.B, c.Tq, c.NH, c.D, 1) &&
         view_panels<T>(&m[1], c.dout, c.B, c.Tq, c.NH, c.D, 1) &&
         view_panels<T>(&m[2], c.k, c.B, c.Tkv, c.NKV, c.D, 1) &&
         view_panels<T>(&m[3], c.v, c.B, c.Tkv, c.NKV, c.D, 1) &&
         (dq ? view_panels<T>(&m[4], c.q, c.B, c.Tq, c.NH, c.D, P) &&
                   view_panels<T>(&m[5], c.dout, c.B, c.Tq, c.NH, c.D, P)
             : view_panels<T>(&m[4], c.k, c.B, c.Tkv, c.NKV, c.D, P) &&
                   view_panels<T>(&m[5], c.v, c.B, c.Tkv, c.NKV, c.D, P));
}

template <typename T, int OP, bool RES>
int launch_dq_part(const fbwd_parts::Call& c, const fpart::PlanBwd& p) {
  CUtensorMap m[6];
  if (!part_maps<T>(m, c, true)) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = flash_bwd_dq_part_kernel<T, OP, RES>;
  static bool sized[64] = {};
  if (const cudaError_t e = size_smem(kern, fpart::SMEM_LIMIT, sized)) return static_cast<int>(e);
  const fpart::ArgsBwd a{c.Tq, tq64_of(c.Tq), c.Tkv, c.NH, c.NKV, c.D, c.sm_scale,
                         c.kv_offset, c.causal, p};
  const dim3 grid(c.NH * p.dq_parts, (c.Tq + 63) / 64, c.B);
  kern<<<grid, bpart::THREADS, p.smem, c.stream>>>(m[0], m[1], m[2], m[3], m[4], m[5], c.lse2,
                                                   c.delta, static_cast<T*>(c.dq), a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool RES>
int launch_dkv_part(const fbwd_parts::Call& c, const fpart::PlanBwd& p) {
  CUtensorMap m[6];
  if (!part_maps<T>(m, c, false)) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = flash_bwd_dkv_part_kernel<T, RES>;
  static bool sized[64] = {};
  if (const cudaError_t e = size_smem(kern, fpart::SMEM_LIMIT, sized)) return static_cast<int>(e);
  const fpart::ArgsBwd a{c.Tq, tq64_of(c.Tq), c.Tkv, c.NH, c.NKV, c.D, c.sm_scale,
                         c.kv_offset, c.causal, p};
  const dim3 grid(c.NKV * p.kv_parts, c.Tkv / 64, c.B);
  kern<<<grid, bpart::THREADS, p.smem, c.stream>>>(m[0], m[1], m[2], m[3], m[4], m[5], c.lse2,
                                                   c.delta, static_cast<T*>(c.dk),
                                                   static_cast<T*>(c.dv), a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dq_part(const fbwd_parts::Call& c) {
  const fpart::PlanBwd p = fpart::plan_bwd(c.D);
  if (fpart::bwd_op(c.D) == 3)
    return p.res ? launch_dq_part<T, 3, true>(c, p) : launch_dq_part<T, 3, false>(c, p);
  return p.res ? launch_dq_part<T, 4, true>(c, p) : launch_dq_part<T, 4, false>(c, p);
}

template <typename T>
int dkv_part(const fbwd_parts::Call& c) {
  const fpart::PlanBwd p = fpart::plan_bwd(c.D);
  return p.res ? launch_dkv_part<T, true>(c, p) : launch_dkv_part<T, false>(c, p);
}

// Past D 256 (D % 64 == 0): the statistics, dK/dV, dQ.
template <typename T>
int by_plan(const fbwd_parts::Call& c, int (*dkv)(const fbwd_parts::Call&),
            int (*dq)(const fbwd_parts::Call&)) {
  if (const cudaError_t e = launch_stats<T, 0>(c)) return static_cast<int>(e);
  if (const int e = dkv(c)) return e;
  return dq(c);
}

template <typename T>
int narrow(const fbwd_parts::Call& c) {
  if (c.D == 64) return launch<T, 64>(c);
  if (c.D == 128) return launch<T, 128>(c);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int wide(const fbwd_parts::Call& c) {
  if (c.D == 192) return launch<T, 192>(c);
  if (c.D == 256) return launch<T, 256>(c);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

#if IN_PART(1)
int fbwd_parts::run_bf16(const Call& c) { return narrow<__nv_bfloat16>(c); }
#endif
#if IN_PART(2)
int fbwd_parts::run_f16(const Call& c) { return narrow<__half>(c); }
#endif
#if IN_PART(3)
int fbwd_parts::run_bf16_wide(const Call& c) { return wide<__nv_bfloat16>(c); }
#endif
#if IN_PART(4)
int fbwd_parts::run_f16_wide(const Call& c) { return wide<__half>(c); }
#endif
#if IN_PART(5)
int fbwd_parts::dkv_part_bf16(const Call& c) { return dkv_part<__nv_bfloat16>(c); }
#endif
#if IN_PART(6)
int fbwd_parts::dkv_part_f16(const Call& c) { return dkv_part<__half>(c); }
#endif
#if IN_PART(7)
int fbwd_parts::dq_part_bf16(const Call& c) { return dq_part<__nv_bfloat16>(c); }
#endif
#if IN_PART(8)
int fbwd_parts::dq_part_f16(const Call& c) { return dq_part<__half>(c); }
#endif

#if IN_PART(0)

// q, o, dout, dq [B, Tq, NH, D]; k, v, dk, dv [B, Tkv, NKV, D], of one type
// (dtype: 1 bf16, 2 fp16), contiguous, with 16-byte-aligned bases (TMA); l,
// m f32 [B, NH, Tq] (the forward's row sum and max); lse2, delta f32
// scratch [B, NH, Tq64], Tq64 = Tq rounded up to 64. Needs D in {64, 128,
// 192, 256} or D % 64 == 0 past 256, Tkv % 64 == 0, NH % NKV == 0 and,
// when causal, kv_offset >= 0 (checked by the Python wrapper). Three
// launches on `stream`: the statistics, dK/dV, dQ. Returns a cudaError_t
// (cudaErrorInvalidValue when a TMA descriptor cannot be encoded, or D or
// dtype is not one of those).
extern "C" int flash_bwd(const void* q, const void* k, const void* v, const void* o,
                         const void* dout, const void* l, const void* m, void* lse2, void* delta,
                         void* dq, void* dk, void* dv, int B, int Tq, int Tkv, int NH, int NKV,
                         int D, int dtype, float sm_scale, int kv_offset, int causal,
                         void* stream) {
  if (B <= 0 || Tq <= 0 || Tkv <= 0) return static_cast<int>(cudaGetLastError());
  const fbwd_parts::Call c{q,
                           k,
                           v,
                           o,
                           dout,
                           static_cast<const float*>(l),
                           static_cast<const float*>(m),
                           static_cast<float*>(lse2),
                           static_cast<float*>(delta),
                           dq,
                           dk,
                           dv,
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
  if (dtype != 1 && dtype != 2) return static_cast<int>(cudaErrorInvalidValue);
  const bool bf = dtype == 1;
  if (D > 256) {
    if (D % 64) return static_cast<int>(cudaErrorInvalidValue);
    return bf ? by_plan<__nv_bfloat16>(c, fbwd_parts::dkv_part_bf16, fbwd_parts::dq_part_bf16)
              : by_plan<__half>(c, fbwd_parts::dkv_part_f16, fbwd_parts::dq_part_f16);
  }
  const bool wide_d = D == 192 || D == 256;
  if (bf) return wide_d ? fbwd_parts::run_bf16_wide(c) : fbwd_parts::run_bf16(c);
  return wide_d ? fbwd_parts::run_f16_wide(c) : fbwd_parts::run_f16(c);
}
#endif  // IN_PART(0)
