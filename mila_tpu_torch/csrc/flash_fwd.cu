// flash_fwd: causal grouped-query flash-attention forward, bf16 or fp16 in
// and out (the element type T of every template here), on Hopper's TMA and
// warpgroup MMA.
//
// Replaces the TPU kernels mila_tpu/kernels/flash_attention.py:_fa_kernel
// (D >= 128) and _fa_kernel_t (D < 128), entry flash_attention ->
// _flash_attention_forward, with and without save_stats (below). The
// TPU's transposed layout for D < 128 exists for its 128-lane matrix unit
// only; here one kernel serves D 64, 128, 192 and 256.
//
// Bound on the H100: tensor-core operations at prefill lengths (4 Tq Tkv D
// per head, about half skipped by the causal tiles, against Tq + 2 Tkv rows
// of D bf16 values), and at D 64 nearly as much the exponentials: one MUFU
// op per score at 16 a clock per SM takes as long as the score's 4 D = 256
// tensor-core operations. Measured, the softmax sets the pace: without the
// products it takes 70-80 % of the kernel's time (tools/flash_variants).
// Design: one block of 288 threads per (q tile of 128 rows, head, batch
// row), the q tiles heaviest first (the causal skip leaves the last tiles
// the most keys):
//   warp 8, one thread: TMA loads of the q tile (once) and of each K and V
//     tile of BKV keys into a ring of NT stages (full / empty mbarriers),
//     128-byte swizzled, through 3-D maps over [B][T][heads * D] in boxes of
//     {64 columns, rows, 1}: rows past Tq or Tkv read zeros inside their own
//     batch row. D 128 is two 64-column panels per tile.
//   warpgroups 0-1 (consumers, 64 query rows each, sharing every K/V tile):
//     S = Q K^T as wgmma m64nBKVk16 with both operands in shared memory (K
//     K-major, as TMA writes it); the online softmax in f32 on S's
//     registers (row max and sum over the 4 lanes of a row); O += P V as
//     wgmma with P in registers (S's accumulator packs into P's A fragment
//     without a shuffle) and V read MN-major (the transpose bit): m64n64k16
//     at D 64, m64n128k16 at D 128, two or three products past it.
//   Each consumer issues S of tile j, rescales O while it runs, issues P V
//     of tile j - 1 behind it, and runs tile j's softmax once S is in. The
//     two warpgroups take turns to issue (two named barriers), so one's
//     softmax runs under the other's products. (ptxas issues the wait for
//     P V before the softmax, not after it: forcing it after, behind a
//     branch, measured slower; tools/flash_variants.)
// BKV is 128 at D 64 and 64 from D 128: S, O and the last tile's P live at
// once, and at D 128 with 128-key tiles they would need more than the 168
// registers a thread has under one 288-thread block per SM (ptxas spills).
// At D 192, 256 and 320 (flash_fwd_wide_kernel), O alone takes 96, 128 and
// 160 of them: the block runs the two consumer warpgroups alone (256
// threads, 255 registers a thread) and one consumer thread issues the
// loads; the ring keeps 3, 2 and 3 stages beside the 48, 64 and 80 KB q
// tile (32-key tiles at D 320, where S, O and P fit in 219 registers), and
// at D 256 P V of a tile goes right after its softmax, freeing its stage a
// turn earlier. At D 320 this takes 0.14 ms where the column-part kernel
// below takes 0.22 (bf16 at T 2048, tools/flash_variants).
// (Measured on the card, tools/flash_variants, bf16 at T 2048: a producer
// warpgroup handing its registers to the consumers with setmaxnreg left
// ptxas at 168 registers a thread, spilling, 0.26 ms at D 256; a producer
// warp, 0.37; this, 0.13. K and V in rings of their own ran 14-42 %
// slower; 32-key tiles at D 256, 20 %.)
// The softmax keeps the row max m of the raw scores q.k and folds sm_scale *
// log2(e) into one FFMA per score: p = 2^(s c - m c) with c = sm_scale *
// log2(e), which is exp(s sm_scale - m sm_scale).
//
// With l_out/m_out (the launch under autograd, _flash_attention_forward(
// save_stats=True)) it also writes each row's final sum l and max m, f32
// [B, NH, Tq], without the TPU's 128-lane padding; m in natural units (the
// max of the scaled scores, m_raw sm_scale), which flash_bwd reads.
//
// The TPU kernel's semantics: the causal tile skip with kv_offset (a key
// tile runs when its first key <= the q tile's last row + kv_offset);
// masked scores take the finite -0.7 * f32max (as raw scores, before the
// scaling, so that s c cannot overflow to -inf for sm_scale < 1); p is
// rounded to V's dtype (T) before P V while l sums the f32 p, both
// against the running max of the key tiles; 1 / l with l == 0 guarded
// at the store; query head h reads KV head h / G (G = NH / NKV, natural
// order). Layouts are the model's: q and out [B, Tq, NH, D], k and v [B,
// Tkv, NKV, D], contiguous, 16-byte-aligned bases. Rows past Tq in the last
// q tile are computed on zeros and never stored. fp16 takes the bf16 path
// as it stands: wgmma's .f16 form reads the same fragments, descriptors and
// transpose bits, TMA's FLOAT16 maps the same boxes.
//
// Past D 320 (flash_fwd_part_kernel, every D % 64 == 0; flash_part.cuh's
// plan): a block takes 64 query rows and a column part of O of up to 512
// columns, and its two warpgroups both form the tile's whole S, each adding
// P V into its own half of the part's columns, so S is formed once a tile and
// part. Q stays in shared memory when it fits beside a K and a V stage (to
// D 1024), else streams beside K in 64-column chunks.
//
// Built in seven parts (kernels/_build.py: PARTS), one nvcc each: parts 1
// and 2 instantiate the bf16 and fp16 kernels at D 64 and 128, parts 3 and 4
// at D 192, 256 and 320, parts 5 and 6 past D 320, part 0 holds the C entry
// point.
#include "common.cuh"
#include "flash_part.cuh"
#include "mma.cuh"
#include "sm90.cuh"

namespace fwd_parts {  // one call's arguments, and each input type's launches

struct Call {
  const void *q, *k, *v;
  void* out;
  float *l_out, *m_out;
  int B, Tq, Tkv, NH, NKV, D;
  float sm_scale;
  int kv_offset, causal;
  cudaStream_t stream;
};

int run_bf16(const Call& c);       // D 64, 128
int run_f16(const Call& c);
int run_bf16_wide(const Call& c);  // D 192, 256, 320
int run_f16_wide(const Call& c);
int run_bf16_part(const Call& c);  // D % 64 == 0 past 320
int run_f16_part(const Call& c);

}  // namespace fwd_parts

namespace {

constexpr int BQ = 128;
constexpr int THREADS = 288;  // warpgroups 0-1 consume, warp 8 loads (D 64, 128)
constexpr int CONSUMERS = 256;
constexpr int ISSUER = 128;   // past D 128: no producer warp, this consumer thread loads
constexpr int SCHED = 1;  // named barriers SCHED + wg: warpgroup wg's turn to issue
constexpr float MASK_VALUE = -0.7f * 3.402823466e38f;

// BKV keys per K/V tile (see above). A panel is 64 columns (128 bytes) of a
// tile's rows. NT stages of the K/V ring: past D 128, what fits beside the
// 48, 64 or 80 KB q tile in 227 KB.
template <int D>
struct Cfg {
  static constexpr int BKV = D == 64 ? 128 : D <= 256 ? 64 : 32;
  static constexpr int PANELS = D / 64;
  static constexpr int Q_PANEL = BQ * 128, KV_PANEL = BKV * 128;
  static constexpr int Q_TILE = PANELS * Q_PANEL, KV_TILE = PANELS * KV_PANEL;
  static constexpr int NT = D == 64 ? 3 : D == 128 ? 4 : D == 256 ? 2 : 3;
  // Past D 128: P V of tile j - 1 issued beside S of tile j (D 192, 320), or
  // P V of tile j right after its softmax, in a turn of its own, which frees
  // the tile's stage a turn earlier (D 256, where the ring holds 2 stages).
  static constexpr bool PV_BEHIND = D != 256;
  static constexpr int SMEM = Q_TILE + NT * 2 * KV_TILE + (2 * NT + 1) * 8 + 1024;
};

// The two consumer warpgroups take turns to issue their products, so one's
// softmax runs under the other's wgmma: wait for this warpgroup's turn, and
// pass the turn to the other one.
__device__ __forceinline__ void sched_wait(int wg) { named_bar_sync(SCHED + wg, CONSUMERS); }
__device__ __forceinline__ void sched_pass(int wg) { named_bar_arrive(SCHED + 1 - wg, CONSUMERS); }

// S = Q K^T for the warpgroup's 64 rows (qw) against one K tile (kt): D /
// 16 k-slices, 32 bytes apart in a panel's 128-byte rows. Issued and
// committed as one group.
template <typename T, int D>
__device__ __forceinline__ void issue_s(float* sc, const unsigned char* qw,
                                        const unsigned char* kt) {
  using C = Cfg<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int p = kk / 4, off = 32 * (kk % 4);
    const uint64_t a = wgmma_desc(qw + p * C::Q_PANEL + off, 16, 1024);
    const uint64_t b = wgmma_desc(kt + p * C::KV_PANEL + off, 16, 1024);
    if constexpr (C::BKV == 128)
      wgmma_m64n128k16<T, 0>(sc, a, b, kk > 0);
    else if constexpr (C::BKV == 64)
      wgmma_m64n64k16<T, 0>(sc, a, b, kk > 0);
    else
      wgmma_m64n32k16<T, 0>(sc, a, b, kk > 0);
  }
  wgmma_commit();
}

// O += T(P) V for one V tile (vt): BKV / 16 k-slices of 16 keys, 2048
// bytes apart in V's panels; LBO the bytes between V's 64-column panels. Past
// D 128, O's columns in products of 128 (two panels) and, at D 192, one of
// 64: o[64 n ..] holds columns 128 n.. as one product's fragment would.
template <typename T, int D>
__device__ __forceinline__ void issue_pv(float* o, const uint32_t (*pa)[4],
                                         const unsigned char* vt) {
  using C = Cfg<D>;
#pragma unroll
  for (int kk = 0; kk < C::BKV / 16; ++kk) {
    const unsigned char* vk = vt + 2048 * kk;
    if constexpr (D == 64) {
      wgmma_m64n64k16_rs<T, 1>(o, pa[kk], wgmma_desc(vk, C::KV_PANEL, 1024), 1);
    } else {
#pragma unroll
      for (int n = 0; n < D / 128; ++n)
        wgmma_m64n128k16_rs<T, 1>(o + 64 * n, pa[kk],
                                  wgmma_desc(vk + 2 * n * C::KV_PANEL, C::KV_PANEL, 1024), 1);
      if constexpr (D % 128)
        wgmma_m64n64k16_rs<T, 1>(o + 64 * (D / 128), pa[kk],
                                 wgmma_desc(vk + 2 * (D / 128) * C::KV_PANEL, C::KV_PANEL, 1024),
                                 1);
    }
  }
  wgmma_commit();
}

// The online softmax of one S tile, in place: sc[4 jj + i] is row r0 + 8
// (i / 2), key k0 + 8 jj + 2 t + i % 2. Masks (only tiles that reach past
// the warp's first row, wrow), takes the new row max m of the raw scores
// over the 4 lanes of each row, alpha = 2^((m_old - m) c), this thread's
// share of l rescaled and summed, and p = 2^(s c - m c) (one FFMA and one
// ex2 a score) left in sc.
template <int BKV>
__device__ __forceinline__ void softmax_tile(float* sc, float* m, float* l, float* alpha, int k0,
                                             int wrow, int r0, int t, int kv_offset, int causal,
                                             float c) {
  if (causal && k0 + BKV - 1 > wrow + kv_offset) {
#pragma unroll
    for (int jj = 0; jj < BKV / 8; ++jj)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (k0 + 8 * jj + 2 * t + (i & 1) > r0 + 8 * (i >> 1) + kv_offset)
          sc[4 * jj + i] = MASK_VALUE;
  }
  float mx[2] = {m[0], m[1]}, mc[2];
#pragma unroll
  for (int jj = 0; jj < BKV / 8; ++jj) {
    mx[0] = fmaxf(mx[0], fmaxf(sc[4 * jj], sc[4 * jj + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(sc[4 * jj + 2], sc[4 * jj + 3]));
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
    mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
    alpha[hr] = ex2((m[hr] - mx[hr]) * c);
    m[hr] = mx[hr];
    mc[hr] = mx[hr] * c;
    l[hr] *= alpha[hr];
  }
#pragma unroll
  for (int e = 0; e < BKV / 2; ++e) {
    sc[e] = ex2(fmaf(sc[e], c, -mc[(e >> 1) & 1]));
    l[(e >> 1) & 1] += sc[e];
  }
}

// O *= alpha per row (alpha of the tile whose P V comes next).
template <int NO>
__device__ __forceinline__ void rescale_o(float* o, const float* alpha) {
#pragma unroll
  for (int i = 0; i < NO; i += 4) {
    o[i] *= alpha[0];
    o[i + 1] *= alpha[0];
    o[i + 2] *= alpha[1];
    o[i + 3] *= alpha[1];
  }
}

// p packs into P V's A fragments: d[8 kk .. 8 kk + 7] of S are the four
// pairs of T of k-slice kk.
template <typename T, int BKV>
__device__ __forceinline__ void pack_p(uint32_t (*pa)[4], const float* sc) {
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = pack2_as<T>(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
}

// The rows' output O / l (l == 0 taken as 1) and, with l_out, l and m (of
// the scaled scores): this thread's rows r0 and r0 + 8, l summed over the 4
// lanes of a row first.
template <typename T, int D>
__device__ __forceinline__ void store_out(const float* o, const float* m, float* l, T* out,
                                          float* l_out, float* m_out, int r0, int t, int b, int h,
                                          int Tq, int NH, float sm_scale) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
    const int row = r0 + 8 * hr;
    if (row >= Tq) continue;
    const float inv = l[hr] == 0.f ? 1.f : 1.f / l[hr];
    if (l_out != nullptr && t == 0) {  // the backward's row statistics
      const size_t srow = ((size_t)b * NH + h) * Tq + row;
      l_out[srow] = l[hr];
      m_out[srow] = m[hr] * sm_scale;
    }
    T* orow = out + ((size_t)b * Tq + row) * NH * D + (size_t)h * D;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj)
      *reinterpret_cast<uint32_t*>(orow + 8 * jj + 2 * t) =
          pack2_as<T>(o[4 * jj + 2 * hr] * inv, o[4 * jj + 2 * hr + 1] * inv);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tmq, const __grid_constant__ CUtensorMap tmk,
                 const __grid_constant__ CUtensorMap tmv, T* __restrict__ out,
                 float* __restrict__ l_out, float* __restrict__ m_out, int Tq, int Tkv, int NH,
                 int NKV, float sm_scale, int kv_offset, int causal) {
  using C = Cfg<D>;
  constexpr int NT = C::NT, BKV = C::BKV, KV_TILE = C::KV_TILE;
  constexpr int NO = D / 2, NS = BKV / 2;  // O's and S's f32 registers
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (sm90_smem(smem_raw) & 1023)) & 1023);
  unsigned char* qs = smem;            // [PANELS][BQ][64] of T, swizzled
  unsigned char* ks = qs + C::Q_TILE;  // [NT][PANELS][BKV][64]
  unsigned char* vs = ks + NT * KV_TILE;
  uint64_t* full = reinterpret_cast<uint64_t*>(vs + NT * KV_TILE);
  uint64_t* empty = full + NT;
  uint64_t* q_full = empty + NT;

  const int tid = threadIdx.x;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (NH / NKV);
  const int q0 = qt * BQ;
  int n_kv = Tkv / BKV;
  if (causal) {
    const int last = q0 + BQ - 1 + kv_offset;  // the TPU kernel's tile-skip rule
    n_kv = last < 0 ? 0 : min(n_kv, last / BKV + 1);
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

  if (tid >= CONSUMERS) {  // warp 8, one thread: the TMA ring
    if (tid == CONSUMERS) {
      mbar_expect_tx(q_full, C::Q_TILE);
#pragma unroll
      for (int p = 0; p < C::PANELS; ++p)
        tma_load_3d(qs + p * C::Q_PANEL, &tmq, q_full, h * D + 64 * p, q0, b);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % NT;
        if (j >= NT) mbar_wait(&empty[s], (j / NT - 1) & 1);
        mbar_expect_tx(&full[s], 2 * KV_TILE);
#pragma unroll
        for (int p = 0; p < C::PANELS; ++p) {
          const int col = hk * D + 64 * p;
          tma_load_3d(ks + s * KV_TILE + p * C::KV_PANEL, &tmk, &full[s], col, j * BKV, b);
          tma_load_3d(vs + s * KV_TILE + p * C::KV_PANEL, &tmv, &full[s], col, j * BKV, b);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: query rows [q0 + 64 wg, q0 + 64 wg + 64) ----
  const int wg = tid >> 7, lane = tid & 31, w = (tid >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = q0 + 64 * wg + 16 * w;  // the warp's first query row
  const int r0 = wrow + g;                 // this thread's rows r0 and r0 + 8
  const float c = sm_scale * 1.4426950408889634f;
  const unsigned char* qw = qs + wg * 64 * 128;  // the warpgroup's 64 rows of each panel

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // l: this thread's columns
  float alpha[2];
  uint32_t pa[BKV / 16][4];  // T(p) of the last tile, the A fragments of P V
  mbar_wait(q_full, 0);
  if (n_kv > 0) {
    // Each turn issues S of tile j, rescales O while it runs and issues P V
    // of tile j - 1; then tile j's softmax. Warpgroup 0 takes the first
    // turn; each warpgroup takes n_kv + 1 turns.
    if (wg == 1) sched_pass(wg);
    {
      float sc[NS];
      mbar_wait(&full[0], 0);
      sched_wait(wg);
      wgmma_fence();
      issue_s<T, D>(sc, qw, ks);
      sched_pass(wg);
      wgmma_wait<0>();
      wgmma_fence_operand<NS>(sc);
      softmax_tile<BKV>(sc, m, l, alpha, 0, wrow, r0, t, kv_offset, causal, c);
      pack_p<T, BKV>(pa, sc);
    }
    for (int j = 1; j < n_kv; ++j) {
      float sc[NS];
      const int s = j % NT, sp = (j - 1) % NT;
      mbar_wait(&full[s], (j / NT) & 1);
      sched_wait(wg);
      wgmma_fence();
      issue_s<T, D>(sc, qw, ks + s * KV_TILE);
      rescale_o<NO>(o, alpha);
      wgmma_fence_operand<NO>(o);
      wgmma_fence();
      issue_pv<T, D>(o, pa, vs + sp * KV_TILE);
      sched_pass(wg);
      wgmma_wait<1>();
      wgmma_fence_operand<NS>(sc);
      softmax_tile<BKV>(sc, m, l, alpha, j * BKV, wrow, r0, t, kv_offset, causal, c);
      wgmma_wait<0>();
      wgmma_fence_operand<NO>(o);
      mbar_arrive(&empty[sp]);
      pack_p<T, BKV>(pa, sc);
    }
    const int sp = (n_kv - 1) % NT;
    sched_wait(wg);
    rescale_o<NO>(o, alpha);
    wgmma_fence_operand<NO>(o);
    wgmma_fence();
    issue_pv<T, D>(o, pa, vs + sp * KV_TILE);
    if (wg == 0) sched_pass(wg);  // warpgroup 1's last turn follows; nothing follows it
    wgmma_wait<0>();
    wgmma_fence_operand<NO>(o);
    mbar_arrive(&empty[sp]);
  }

  store_out<T, D>(o, m, l, out, l_out, m_out, r0, t, b, h, Tq, NH, sm_scale);
}

// Past D 128 (D 192, 256 and 320): the same two consumer warpgroups taking the
// same turns, but no producer warp: 256 threads may hold 255 registers
// each (O alone takes D / 2). Thread ISSUER (in warpgroup 1, which issues
// second in each turn) loads the q tile and the first NT K/V tiles, then at
// the end of each turn the tile whose stage both warpgroups' P V has just
// freed. One block an SM: the grid runs the heaviest q tiles of every head
// first, so the last blocks to start are the shortest.
template <typename T, int D>
__global__ void __launch_bounds__(CONSUMERS, 1)
flash_fwd_wide_kernel(const __grid_constant__ CUtensorMap tmq,
                      const __grid_constant__ CUtensorMap tmk,
                      const __grid_constant__ CUtensorMap tmv, T* __restrict__ out,
                      float* __restrict__ l_out, float* __restrict__ m_out, int Tq, int Tkv,
                      int NH, int NKV, float sm_scale, int kv_offset, int causal) {
  using C = Cfg<D>;
  constexpr int NT = C::NT, BKV = C::BKV, KV_TILE = C::KV_TILE;
  constexpr int NO = D / 2, NS = BKV / 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (sm90_smem(smem_raw) & 1023)) & 1023);
  unsigned char* qs = smem;
  unsigned char* ks = qs + C::Q_TILE;
  unsigned char* vs = ks + NT * KV_TILE;
  uint64_t* full = reinterpret_cast<uint64_t*>(vs + NT * KV_TILE);
  uint64_t* empty = full + NT;
  uint64_t* q_full = empty + NT;

  const int tid = threadIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // the heaviest q tiles of every head first
  const int h = blockIdx.x, b = blockIdx.z;
  const int hk = h / (NH / NKV);
  const int q0 = qt * BQ;
  int n_kv = Tkv / BKV;
  if (causal) {
    const int last = q0 + BQ - 1 + kv_offset;
    n_kv = last < 0 ? 0 : min(n_kv, last / BKV + 1);
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

  auto load_kv = [&](int j) {  // K/V tile j into stage j % NT, once it is free
    const int s = j % NT;
    if (j >= NT) mbar_wait(&empty[s], (j / NT - 1) & 1);
    mbar_expect_tx(&full[s], 2 * KV_TILE);
#pragma unroll
    for (int p = 0; p < C::PANELS; ++p) {
      const int col = hk * D + 64 * p;
      tma_load_3d(ks + s * KV_TILE + p * C::KV_PANEL, &tmk, &full[s], col, j * BKV, b);
      tma_load_3d(vs + s * KV_TILE + p * C::KV_PANEL, &tmv, &full[s], col, j * BKV, b);
    }
  };
  if (tid == ISSUER) {
    mbar_expect_tx(q_full, C::Q_TILE);
#pragma unroll
    for (int p = 0; p < C::PANELS; ++p)
      tma_load_3d(qs + p * C::Q_PANEL, &tmq, q_full, h * D + 64 * p, q0, b);
    for (int j = 0; j < min(NT, n_kv); ++j) load_kv(j);
  }

  const int wg = tid >> 7, lane = tid & 31, w = (tid >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = q0 + 64 * wg + 16 * w;
  const int r0 = wrow + g;
  const float c = sm_scale * 1.4426950408889634f;
  const unsigned char* qw = qs + wg * 64 * 128;

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float alpha[2];
  uint32_t pa[BKV / 16][4];
  mbar_wait(q_full, 0);
  if (n_kv > 0 && !C::PV_BEHIND) {
    // P V of tile j right after its softmax, each product in a turn of its
    // own, so tile j's stage comes free a turn earlier.
    if (wg == 1) sched_pass(wg);
    for (int j = 0; j < n_kv; ++j) {
      float sc[NS];
      const int s = j % NT;
      mbar_wait(&full[s], (j / NT) & 1);
      sched_wait(wg);
      wgmma_fence();
      issue_s<T, D>(sc, qw, ks + s * KV_TILE);
      sched_pass(wg);
      wgmma_wait<0>();
      wgmma_fence_operand<NS>(sc);
      softmax_tile<BKV>(sc, m, l, alpha, j * BKV, wrow, r0, t, kv_offset, causal, c);
      pack_p<T, BKV>(pa, sc);
      rescale_o<NO>(o, alpha);
      sched_wait(wg);
      wgmma_fence_operand<NO>(o);
      wgmma_fence();
      issue_pv<T, D>(o, pa, vs + s * KV_TILE);
      if (wg == 0 || j + 1 < n_kv) sched_pass(wg);  // warpgroup 1 passed first
      wgmma_wait<0>();
      wgmma_fence_operand<NO>(o);
      mbar_arrive(&empty[s]);
      if (tid == ISSUER && j + NT < n_kv) load_kv(j + NT);
    }
  } else if (n_kv > 0) {
    if (wg == 1) sched_pass(wg);
    {
      float sc[NS];
      mbar_wait(&full[0], 0);
      sched_wait(wg);
      wgmma_fence();
      issue_s<T, D>(sc, qw, ks);
      sched_pass(wg);
      wgmma_wait<0>();
      wgmma_fence_operand<NS>(sc);
      softmax_tile<BKV>(sc, m, l, alpha, 0, wrow, r0, t, kv_offset, causal, c);
      pack_p<T, BKV>(pa, sc);
    }
    for (int j = 1; j < n_kv; ++j) {
      float sc[NS];
      const int s = j % NT, sp = (j - 1) % NT;
      mbar_wait(&full[s], (j / NT) & 1);
      sched_wait(wg);
      wgmma_fence();
      issue_s<T, D>(sc, qw, ks + s * KV_TILE);
      rescale_o<NO>(o, alpha);
      wgmma_fence_operand<NO>(o);
      wgmma_fence();
      issue_pv<T, D>(o, pa, vs + sp * KV_TILE);
      sched_pass(wg);
      wgmma_wait<1>();
      wgmma_fence_operand<NS>(sc);
      softmax_tile<BKV>(sc, m, l, alpha, j * BKV, wrow, r0, t, kv_offset, causal, c);
      wgmma_wait<0>();
      wgmma_fence_operand<NO>(o);
      mbar_arrive(&empty[sp]);
      if (tid == ISSUER && j - 1 + NT < n_kv) load_kv(j - 1 + NT);
      pack_p<T, BKV>(pa, sc);
    }
    const int sp = (n_kv - 1) % NT;
    sched_wait(wg);
    rescale_o<NO>(o, alpha);
    wgmma_fence_operand<NO>(o);
    wgmma_fence();
    issue_pv<T, D>(o, pa, vs + sp * KV_TILE);
    if (wg == 0) sched_pass(wg);
    wgmma_wait<0>();
    wgmma_fence_operand<NO>(o);
  }
  store_out<T, D>(o, m, l, out, l_out, m_out, r0, t, b, h, Tq, NH, sm_scale);
}

// ---- past D 320 (flash_part.cuh: the plan) ---------------------------------

// S = Q K^T over `panels` 64-column panels of Q (64 rows, 8 KB apart) and
// of K (BK rows), four k-slices of 16 columns a panel; the first slice
// accumulates when acc0 (a streamed chunk after the first). The panel loop
// is not unrolled, so no wgmma sits in a remainder branch. Issued, not
// committed.
template <typename T, int BK>
__device__ __forceinline__ void issue_s_cols(float* sc, const unsigned char* qs,
                                             const unsigned char* ks, int panels, int acc0) {
#pragma unroll 1
  for (int p = 0; p < panels; ++p) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t a = wgmma_desc(qs + p * (fpart::BQ * 128) + 32 * kk, 16, 1024);
      const uint64_t b = wgmma_desc(ks + p * (BK * 128) + 32 * kk, 16, 1024);
      if constexpr (BK == 64)
        wgmma_m64n64k16<T, 0>(sc, a, b, p > 0 || kk > 0 || acc0);
      else
        wgmma_m64n32k16<T, 0>(sc, a, b, p > 0 || kk > 0 || acc0);
    }
  }
}

// O += T(P) V on OP 64-column panels of the V tile from vt (panels BK x 128
// bytes apart), two panels a product: o[32 q ..] holds panel q. Always all
// OP panels (flash_part.cuh: v_cols), whatever the part's width. Issued and
// committed.
template <typename T, int BK, int OP>
__device__ __forceinline__ void issue_pv_cols(float* o, const uint32_t (*pa)[4],
                                              const unsigned char* vt) {
  constexpr int KP = BK * 128;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const unsigned char* vk = vt + 2048 * kk;
#pragma unroll
    for (int q = 0; q + 1 < OP; q += 2)
      wgmma_m64n128k16_rs<T, 1>(o + 32 * q, pa[kk], wgmma_desc(vk + q * KP, KP, 1024), 1);
    if constexpr (OP % 2)
      wgmma_m64n64k16_rs<T, 1>(o + 32 * (OP - 1), pa[kk],
                               wgmma_desc(vk + (OP - 1) * KP, KP, 1024), 1);
  }
  wgmma_commit();
}

// Past D 320: one block of two warpgroups per (64 query rows, head and
// column part, batch row), the heaviest q tiles of every head first. Both
// warpgroups form the same S of each key tile over all D columns and run the
// same softmax; warpgroup wg then adds P V into its own 64-column panels of
// the part (the first half, rounded up, to warpgroup 0), so S is formed once
// a tile and part and O takes at most 4 panels (128 registers) a thread.
// Thread ISSUER loads Q (resident) or Q and K's chunks (streamed), and each
// K and V tile into rings of their own, a stage as soon as both warpgroups
// have released it; with Q resident (QRES) the warpgroups take turns to
// issue S and P V (the turns of flash_fwd_wide_kernel's D 256 path), so
// one's softmax runs under the other's products. Each warpgroup's P V spans
// OP panels: those past its share of the part (warpgroup 1's third at D 320)
// hold values that are never stored.
template <typename T, int DCMAX, int BK, bool QRES>
__global__ void __launch_bounds__(fpart::THREADS, 1)
flash_fwd_part_kernel(const __grid_constant__ CUtensorMap tmq,
                      const __grid_constant__ CUtensorMap tmk,
                      const __grid_constant__ CUtensorMap tmv, T* __restrict__ out,
                      float* __restrict__ l_out, float* __restrict__ m_out,
                      const fpart::Args a) {
  constexpr int OP = (DCMAX / 64 + 1) / 2, NO = 32 * OP, NS = BK / 2;
  constexpr int KP = BK * 128;  // bytes of a K or V panel: BK rows of 64 columns
  const fpart::Plan& p = a.p;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (sm90_smem(smem_raw) & 1023)) & 1023);
  unsigned char* qs = smem;                  // Q resident: [D / 64][64 rows][128 B]
  unsigned char* kring = qs + p.q_bytes;     // K tiles [D / 64][BK][128 B], or Q and K chunks
  unsigned char* vring = kring + p.nk * p.k_slot;  // V tiles [part's panels][BK][128 B]
  uint64_t* full_k = reinterpret_cast<uint64_t*>(vring + p.nv * p.v_slot);
  uint64_t* empty_k = full_k + p.nk;
  uint64_t* full_v = empty_k + p.nk;
  uint64_t* empty_v = full_v + p.nv;
  uint64_t* q_full = empty_v + p.nv;

  const int tid = threadIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int h = blockIdx.x / p.parts, part = blockIdx.x % p.parts, b = blockIdx.z;
  const int c0 = part * p.dc, nc = min(p.dc, a.D - c0);
  const int hk = h / (a.NH / a.NKV);
  const int q0 = qt * fpart::BQ;
  int n_kv = a.Tkv / BK;
  if (a.causal) {
    const int last = q0 + fpart::BQ - 1 + a.kv_offset;  // the TPU kernel's tile-skip rule
    n_kv = last < 0 ? 0 : min(n_kv, last / BK + 1);
  }
  const int chunks = QRES ? 1 : a.D / 64;  // K jobs a key tile
  const int n_k = n_kv * chunks;
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

  auto load_k = [&](int kj) {  // K job kj into its stage, once both warpgroups freed it
    const int s = kj % p.nk;
    if (kj >= p.nk) mbar_wait(&empty_k[s], (kj / p.nk - 1) & 1);
    unsigned char* dst = kring + s * p.k_slot;
    mbar_expect_tx(&full_k[s], p.k_slot);
    if constexpr (QRES) {  // the tile's D / 64 panels in one box
      tma_load_4d(dst, &tmk, &full_k[s], 0, kj * BK, hk * a.D / 64, b);
    } else {  // chunk c of key tile kj / chunks: Q's panel c, then K's
      const int c = kj % chunks;
      tma_load_4d(dst, &tmq, &full_k[s], 0, q0, h * a.D / 64 + c, b);
      tma_load_4d(dst + fpart::BQ * 128, &tmk, &full_k[s], 0, kj / chunks * BK, hk * a.D / 64 + c,
                  b);
    }
  };
  auto load_v = [&](int j) {  // the part's columns of V tile j
    const int s = j % p.nv;
    if (j >= p.nv) mbar_wait(&empty_v[s], (j / p.nv - 1) & 1);
    unsigned char* dst = vring + s * p.v_slot;  // dc / 64 panels in one box (past a
    mbar_expect_tx(&full_v[s], p.dc / 64 * KP);  // narrower last part: never read)
    tma_load_4d(dst, &tmv, &full_v[s], 0, j * BK, (hk * a.D + c0) / 64, b);
  };
  if (tid == fpart::ISSUER) {
    if constexpr (QRES) {
      mbar_expect_tx(q_full, p.q_bytes);
      tma_load_4d(qs, &tmq, q_full, 0, q0, h * a.D / 64, b);
    }
    for (int kj = 0; kj < min(p.nk, n_k); ++kj) load_k(kj);
    for (int j = 0; j < min(p.nv, n_kv); ++j) load_v(j);
  }

  const int wg = tid >> 7, lane = tid & 31, w = (tid >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = q0 + 16 * w;  // both warpgroups hold the same 64 rows
  const int r0 = wrow + g;
  const float c = a.sm_scale * LOG2E;
  const int np = nc / 64, np0 = (np + 1) / 2;  // the part's panels, warpgroup 0's
  const int pan0 = wg ? np0 : 0, mine = wg ? np - np0 : np0;

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float alpha[2];
  uint32_t pa[BK / 16][4];
  if constexpr (QRES) {
    mbar_wait(q_full, 0);
    if (n_kv > 0 && wg == 1) sched_pass(wg);
  }
  for (int j = 0; j < n_kv; ++j) {
    float sc[NS];
    if constexpr (QRES) {
      const int s = j % p.nk;
      mbar_wait(&full_k[s], (j / p.nk) & 1);
      sched_wait(wg);
      wgmma_fence();
      issue_s_cols<T, BK>(sc, qs, kring + s * p.k_slot, a.D / 64, 0);
      wgmma_commit();
      sched_pass(wg);
      wgmma_wait<0>();
      wgmma_fence_operand<NS>(sc);
      mbar_arrive(&empty_k[s]);
      if (tid == fpart::ISSUER && j + p.nk < n_k) load_k(j + p.nk);
    } else {
      for (int cc = 0; cc < chunks; ++cc) {
        const int kj = j * chunks + cc, s = kj % p.nk;
        const unsigned char* st = kring + s * p.k_slot;
        mbar_wait(&full_k[s], (kj / p.nk) & 1);
        wgmma_fence();
        issue_s_cols<T, BK>(sc, st, st + fpart::BQ * 128, 1, cc > 0);
        wgmma_commit();
        wgmma_wait<0>();
        wgmma_fence_operand<NS>(sc);
        mbar_arrive(&empty_k[s]);
        if (tid == fpart::ISSUER && kj + p.nk < n_k) load_k(kj + p.nk);
      }
    }
    softmax_tile<BK>(sc, m, l, alpha, j * BK, wrow, r0, t, a.kv_offset, a.causal, c);
    pack_p<T, BK>(pa, sc);
    // O *= alpha, skipped where no row of the warp has a new max (alpha is
    // exactly 1 there): later key tiles seldom raise a row's max.
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) rescale_o<NO>(o, alpha);
    const int sv = j % p.nv;
    mbar_wait(&full_v[sv], (j / p.nv) & 1);
    if constexpr (QRES) sched_wait(wg);
    wgmma_fence_operand<NO>(o);
    wgmma_fence();
    issue_pv_cols<T, BK, OP>(o, pa, vring + sv * p.v_slot + pan0 * KP);
    if (QRES && (wg == 0 || j + 1 < n_kv)) sched_pass(wg);  // warpgroup 1 passed first
    wgmma_wait<0>();
    wgmma_fence_operand<NO>(o);
    mbar_arrive(&empty_v[sv]);
    if (tid == fpart::ISSUER && j + p.nv < n_kv) load_v(j + p.nv);
  }

  // The rows' output O / l on the warpgroup's panels; l and m (of the scaled
  // scores) by warpgroup 0 of the part that holds column 0.
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
    const int row = r0 + 8 * hr;
    if (row >= a.Tq) continue;
    const float inv = l[hr] == 0.f ? 1.f : 1.f / l[hr];
    if (l_out != nullptr && part == 0 && wg == 0 && t == 0) {
      const size_t srow = ((size_t)b * a.NH + h) * a.Tq + row;
      l_out[srow] = l[hr];
      m_out[srow] = m[hr] * a.sm_scale;
    }
    T* orow = out + ((size_t)b * a.Tq + row) * a.NH * a.D + (size_t)h * a.D + c0 + 64 * pan0;
#pragma unroll
    for (int jj = 0; jj < NO / 4; ++jj)
      if (jj < 8 * mine)
        *reinterpret_cast<uint32_t*>(orow + 8 * jj + 2 * t) =
            pack2_as<T>(o[4 * jj + 2 * hr] * inv, o[4 * jj + 2 * hr + 1] * inv);
  }
}

template <typename T, int DCMAX, int BK, bool QRES>
int launch_part(const fwd_parts::Call& c, const fpart::Plan& p) {
  // [B][len][heads * D] as [B][heads * D / 64 panels][len][64 columns]: a box of
  // `panels` panels of `rows` rows lands as [panel][row][128 B], swizzled.
  const auto view = [](CUtensorMap* map, const void* ptr, int B, int len, int HD, int rows,
                       int panels) {
    const uint64_t dims[4] = {64, (uint64_t)len, (uint64_t)HD / 64, (uint64_t)B};
    const uint64_t strides[3] = {(uint64_t)HD * 2, 128, (uint64_t)len * HD * 2};
    const uint32_t box[4] = {64, (uint32_t)rows, (uint32_t)panels, 1};
    return encode_nd(map, tma_type<T>(), ptr, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
  };
  CUtensorMap tmq, tmk, tmv;
  const int chunk = QRES ? c.D / 64 : 1;  // panels a Q or K box
  if (!view(&tmq, c.q, c.B, c.Tq, c.NH * c.D, fpart::BQ, chunk) ||
      !view(&tmk, c.k, c.B, c.Tkv, c.NKV * c.D, BK, chunk) ||
      !view(&tmv, c.v, c.B, c.Tkv, c.NKV * c.D, BK, p.dc / 64))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = flash_fwd_part_kernel<T, DCMAX, BK, QRES>;
  static bool sized[64] = {};
  if (const cudaError_t e = size_smem(kern, fpart::SMEM_LIMIT, sized)) return static_cast<int>(e);
  const fpart::Args a{c.Tq, c.Tkv, c.NH, c.NKV, c.D, c.sm_scale, c.kv_offset, c.causal, p};
  const dim3 grid(c.NH * p.parts, (c.Tq + fpart::BQ - 1) / fpart::BQ, c.B);
  kern<<<grid, fpart::THREADS, p.smem, c.stream>>>(tmq, tmk, tmv, static_cast<T*>(c.out), c.l_out,
                                                   c.m_out, a);
  return static_cast<int>(cudaGetLastError());
}

// bf16 and fp16 past D 320: parts of up to 320 columns on 64-key tiles, of
// up to 512 on 32-key tiles; Q streams only past D 1024, in parts of 512.
template <typename T>
int by_plan(const fwd_parts::Call& c) {
  const fpart::Plan p = fpart::plan(c.D, 2);
  if (!p.q_res) return launch_part<T, fpart::DC_LARGE, 32, false>(c, p);
  if (p.dcmax == fpart::DC_SMALL) return launch_part<T, fpart::DC_SMALL, 64, true>(c, p);
  return launch_part<T, fpart::DC_LARGE, 32, true>(c, p);
}

template <typename T, int D>
int launch(const fwd_parts::Call& c) {
  using C = Cfg<D>;
  CUtensorMap tmq, tmk, tmv;
  const auto ty = tma_type<T>();
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!encode_3d(&tmq, ty, 2, c.q, c.B, c.Tq, (uint64_t)c.NH * D, BQ, 64, sw) ||
      !encode_3d(&tmk, ty, 2, c.k, c.B, c.Tkv, (uint64_t)c.NKV * D, C::BKV, 64, sw) ||
      !encode_3d(&tmv, ty, 2, c.v, c.B, c.Tkv, (uint64_t)c.NKV * D, C::BKV, 64, sw))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kern = [] {
    if constexpr (D <= 128)
      return flash_fwd_kernel<T, D>;
    else
      return flash_fwd_wide_kernel<T, D>;
  }();
  constexpr int threads = D <= 128 ? THREADS : CONSUMERS;
  static bool sized[64] = {};
  if (const cudaError_t e = size_smem(kern, C::SMEM, sized)) return static_cast<int>(e);
  const int q_tiles = (c.Tq + BQ - 1) / BQ;  // past D 128 the grid's x runs over heads
  const dim3 grid = D <= 128 ? dim3(q_tiles, c.NH, c.B) : dim3(c.NH, q_tiles, c.B);
  kern<<<grid, threads, C::SMEM, c.stream>>>(tmq, tmk, tmv, static_cast<T*>(c.out), c.l_out,
                                             c.m_out, c.Tq, c.Tkv, c.NH, c.NKV, c.sm_scale,
                                             c.kv_offset, c.causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_d(const fwd_parts::Call& c) {
  if (c.D == 64) return launch<T, 64>(c);
  if (c.D == 128) return launch<T, 128>(c);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int by_d_wide(const fwd_parts::Call& c) {
  if (c.D == 192) return launch<T, 192>(c);
  if (c.D == 256) return launch<T, 256>(c);
  if (c.D == 320) return launch<T, 320>(c);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

#if IN_PART(1)
int fwd_parts::run_bf16(const Call& c) { return by_d<__nv_bfloat16>(c); }
#endif
#if IN_PART(2)
int fwd_parts::run_f16(const Call& c) { return by_d<__half>(c); }
#endif
#if IN_PART(3)
int fwd_parts::run_bf16_wide(const Call& c) { return by_d_wide<__nv_bfloat16>(c); }
#endif
#if IN_PART(4)
int fwd_parts::run_f16_wide(const Call& c) { return by_d_wide<__half>(c); }
#endif

#if IN_PART(5)
int fwd_parts::run_bf16_part(const Call& c) { return by_plan<__nv_bfloat16>(c); }
#endif
#if IN_PART(6)
int fwd_parts::run_f16_part(const Call& c) { return by_plan<__half>(c); }
#endif

#if IN_PART(0)

// q [B, Tq, NH, D], k and v [B, Tkv, NKV, D], out [B, Tq, NH, D], of one type
// (dtype: 1 bf16, 2 fp16), contiguous, with 16-byte-aligned bases (TMA).
// Needs D % 64 == 0, Tkv % 128 == 0 and NH % NKV == 0 (checked by the
// Python wrapper). causal != 0 masks key j for query i unless j <= i +
// kv_offset. l_out and m_out are null (the primal launch) or f32 [B, NH,
// Tq]: each row's softmax sum l and max m (of the scaled scores), the
// statistics flash_bwd recomputes p from. Returns a cudaError_t
// (cudaErrorInvalidValue when a TMA descriptor cannot be encoded, D is not
// a multiple of 64 or dtype is neither).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* out, void* l_out,
                         void* m_out, int B, int Tq, int Tkv, int NH, int NKV, int D, int dtype,
                         float sm_scale, int kv_offset, int causal, void* stream) {
  if (B <= 0 || Tq <= 0) return static_cast<int>(cudaGetLastError());
  const fwd_parts::Call c{q,  k,   v, out, static_cast<float*>(l_out), static_cast<float*>(m_out),
                          B,  Tq,  Tkv, NH, NKV, D, sm_scale, kv_offset, causal,
                          static_cast<cudaStream_t>(stream)};
  if (dtype != 1 && dtype != 2) return static_cast<int>(cudaErrorInvalidValue);
  const bool bf = dtype == 1;
  if (D > 256 && D != 320) {
    if (D % 64) return static_cast<int>(cudaErrorInvalidValue);
    return bf ? fwd_parts::run_bf16_part(c) : fwd_parts::run_f16_part(c);
  }
  if (D > 128) return bf ? fwd_parts::run_bf16_wide(c) : fwd_parts::run_f16_wide(c);
  return bf ? fwd_parts::run_bf16(c) : fwd_parts::run_f16(c);
}
#endif  // IN_PART(0)
