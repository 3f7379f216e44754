// decode_step_int8: a whole decode step (giga) or one decoder layer (mega)
// as ONE persistent cooperative launch over a tile stream: int8; fp8
// (e4m3fn, e5m2) in the mega launch over pack_decode_megalayers of fp8
// params (the giga pack requantizes fp8 to int8, as the JAX package does);
// bf16 with unit scales in the giga launch over pack_decode_giga(...,
// bf16_stream=True) of an unquantized model, its head the padded tied
// wte^T.
//
// Replaces two TPU kernels:
//   mila_tpu/kernels/decode_giga.py:_giga_kernel (giga_decode_step): the
//       embedding rows and RoPE tables (tokens mode), RMSNorm + the first
//       wqkv, then for every layer GQA attention with the cache write and the
//       layer tail with the next layer's RMSNorm + wqkv, then norm_f, the
//       head and its argmax; the K/V pools [L, B, T, KD] are written in place;
//   mila_tpu/kernels/layer_mega.py:_mega_kernel (layer_megakernel): one
//       layer of the above from a given raw qkv row and residual.
//
// Arithmetic follows the TPU kernels: the residual stays f32 across every
// layer (the giga tail runs in f32: x1, x_out, qkv), the normalised inputs,
// q and h are rounded to bf16, k and v stay f32 until they are written to the
// cache as bf16 and join the softmax from registers as f32, and the
// probabilities are rounded to bf16 before the product with V (the MXU's
// operand). The plain version (_giga_ref) rounds the residual to bf16 at
// every layer instead, so the two drift apart with depth.
//
// Slot head order. wq's columns and wo's rows come permuted at pack time
// (layer_mega.slot_order): query slot n holds head (n % NKV) * G + n / NKV
// and attends KV head n % NKV, so KV head j serves slots j, j + NKV, ...
// (not heads j * G .. j * G + G - 1 as in dense_decode_attn.cu).
//
// fp8 tiles take tail_phases.cuh's fp8 branch (F8Pair's exact decode, the
// pack's fixup divided out of each scale row) and bf16 tiles its bf16 branch
// (32-row ring stages of 2-byte rows, the pairs taken as they are), one
// instantiation per weight kind (bf16: the giga launch's f32 activations
// only). The kinds' instantiations need their own registers, hence their
// own resident blocks: the occupancy query and the Python wrapper's grid
// cache take the format.
//
// Built in four parts (kernels/_build.py: PARTS), one nvcc each: parts 1, 2
// and 3 instantiate the int8, fp8 and bf16 kinds, part 0 holds the C entry
// points.
//
// Bound on the H100: the bytes of the stream (1.24 GB of int8 tiles and
// scale rows at Llama-3.2-1B: every layer's wo, gate|up, down and next wqkv,
// the first wqkv and the padded head) plus the K/V rows read.
//
// Design. Phases separated by grid barriers, all blocks resident:
//   prologue (giga)  residual rows (the wte rows of the tokens, rounded to
//                    bf16, in tokens mode), RoPE tables from lens x freq with
//                    sincosf (the angles reach hundreds of radians), row sums
//                    of squares; then RMSNorm + wqkv_0 (tail_phases.cuh's
//                    qkv_phases) into an f32 qkv row;
//   attention        units (row b, KV head j): RoPE of the G query slots and
//                    of k from the raw qkv row, online softmax over the
//                    lens[b] cached rows in chunks of 128 (8-byte words,
//                    HD / 4 neighbouring threads per row), the current token
//                    from registers, the output in slot order; the new k/v
//                    row written at lens[b] (not at lens[b] == T; the token
//                    is attended all the same). A unit reads rows < lens[b]
//                    and writes row lens[b] of its own head only;
//   tail             tail_phases.cuh: wo, fin1, gate|up, fin_h, down, fin2,
//                    next wqkv, fin3;
//   head (giga)      norm_f, the head GEMV, the bf16 logits of every column,
//                    each block's best column per row (columns < vocab,
//                    strict >, so the first index wins ties), then block 0
//                    merges the blocks in order (larger value, then lower
//                    index) into the token.
// Attention units number B * NKV (64 at the served shape); the other blocks
// wait at the barrier. Every GEMV (the first wqkv, each layer's four, the
// head) is tail_phases.cuh's gemv_phase on the tensor cores.
#include <climits>

#include "tail_phases.cuh"

namespace {

using namespace tail;

constexpr int MAXG = 8, MAXHD = 128, CH = 128, VEC = 4;
constexpr int WFMT_BF16 = 3;  // the wfmt of a bf16 stream (gemv.cuh's WFMT_* are one-byte)

struct StepParams {
  const int* lens;        // [M] cached rows per sequence (the current token excluded)
  const int* tok_in;      // [M] token ids (tokens mode)
  const void* x_in;       // giga: x [M, H] or wte [V, H] (f32 if x_is_f32, else bf16); mega: x [M, H] T
  const float* cos_in;    // [M, KD] tiled cos, or the [KD] freq row (tokens mode)
  const float* sin_in;    // [M, KD] pre-signed sin, or the [KD] sign row (tokens mode)
  const void* qkv_in;     // mega: raw qkv [M, NQ + 2 KD] T, q in slot order
  const float* ga;        // giga: [L, H] ln_attn gammas; mega: gamma_next [H]
  const float* gm;        // giga: [L, H] ln_mlp gammas; mega: gamma_mlp [H]
  const float* gf;        // giga: [H] norm_f gamma
  const int8_t* w;        // [NTOT, H, bn]
  const float* s;         // [NTOT, 1, bn]
  __nv_bfloat16* kp;      // [L, M, Tlen, KD]
  __nv_bfloat16* vp;
  void* x_out;            // giga: the f32 residual [M, H]; mega: x_out [M, H] T
  void* qkv_out;          // giga: the f32 qkv row [M, NQ + 2 KD]; mega: [M, n_qkv * bn] T or null
  int* tok_out;           // giga: [M]
  __nv_bfloat16* logits;  // giga: [M, n_head * bn]
  float *cos_t, *sin_t;   // giga tokens mode: [M, KD]
  __nv_bfloat16* att;     // [M, NQ]
  float *p_wo, *x1, *ssq1, *p_gu, *hbuf, *p_down, *xo, *ssq2, *p_q, *p_head, *best_v;
  int* best_i;            // [grid, M]
  int giga, tokens_mode, x_is_f32, M, H, I, bn, NH, NKV, HD, Tlen, L, n_qkv, n_head, vocab;
  int ks_wo, ks_gu, ks_down, ks_q, ks_head, cols_wo, cols_gu, cols_down, cols_q, cols_head;
  int wfmt;  // WFMT_* of the tiles (gemv.cuh), or WFMT_BF16
  float eps, scale;
};
constexpr int N_PTRS = 32, N_INTS = 26, N_FLOATS = 2;

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// One attention unit: row b's KV head j. qrow [NQ + 2 KD] raw qkv (written
// in this launch: read through L2); cb, sb [KD] its RoPE tables; kc, vc
// [Tlen, KD] its layer's cache rows; arow [NQ] its output in slot order.
template <typename T>
__device__ void attention_unit(const T* qrow, const float* cb, const float* sb,
                               __nv_bfloat16* kc, __nv_bfloat16* vc, int old, int Tlen, int NH,
                               int NKV, int HD, int j, float scale, __nv_bfloat16* arow,
                               float* smem) {
  float* q_s = smem;                // [MAXG][MAXHD]
  float* s_s = q_s + MAXG * MAXHD;  // [MAXG][CH]
  float* o_s = s_s + MAXG * CH;     // [MAXG][MAXHD]
  float* kn_s = o_s + MAXG * MAXHD;
  float* vn_s = kn_s + MAXHD;
  float* m_s = vn_s + MAXHD;
  float* l_s = m_s + MAXG;
  float* alpha_s = l_s + MAXG;
  float* pcur_s = alpha_s + MAXG;
  const int G = NH / NKV, KD = NKV * HD, NQ = NH * HD, half = HD / 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(max(old, 0), Tlen);
  const float* cj = cb + j * HD;
  const float* sj = sb + j * HD;

  for (int i = tid; i < G * HD; i += THREADS) {
    const int g = i / HD, d = i % HD;
    const T* qr = qrow + (j + NKV * g) * HD;
    const float a = round_bf16(ldcg_f(qr + d)), r = round_bf16(ldcg_f(qr + (d + half) % HD));
    q_s[g * MAXHD + d] = round_bf16(a * cj[d] + r * sj[d]);
    o_s[g * MAXHD + d] = 0.f;
  }
  for (int d = tid; d < HD; d += THREADS) {
    const T* kr = qrow + NQ + j * HD;
    kn_s[d] = ldcg_f(kr + d) * cj[d] + ldcg_f(kr + (d + half) % HD) * sj[d];
    vn_s[d] = ldcg_f(qrow + NQ + KD + j * HD + d);
  }
  if (tid < MAXG) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  const int CPR = HD / VEC, TPB = THREADS / CPR;
  const int tok = tid / CPR, word = tid % CPR;
  float qv[MAXG][VEC], acc[MAXG][VEC];
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      qv[g][e] = g < G ? q_s[g * MAXHD + word * VEC + e] : 0.f;
      acc[g][e] = 0.f;
    }
  const __nv_bfloat16* kb = kc + j * HD + word * VEC;
  const __nv_bfloat16* vb = vc + j * HD + word * VEC;

  for (int c0 = 0; c0 < len; c0 += CH) {
    const int n = min(CH, len - c0);
    // Scores: every lane runs CH / TPB passes (the CPR lanes of a row
    // shuffle together, so the loop count must not depend on the row).
    for (int t = tok; t < CH; t += TPB) {
      float kv[VEC];
      const bool live = t < n;
      if (live) {
        load4(kb + (size_t)(c0 + t) * KD, kv);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kv[e] = 0.f;
      }
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g >= G) break;
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) dot = fmaf(qv[g][e], kv[e], dot);
        for (int o = CPR / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
        if (word == 0) s_s[g * CH + t] = live ? dot * scale : -INFINITY;
      }
    }
    __syncthreads();
    // Online softmax, one warp per query slot.
    for (int g = warp; g < G; g += WARPS) {
      float mx = -INFINITY;
      for (int t = lane; t < CH; t += 32) mx = fmaxf(mx, s_s[g * CH + t]);
      mx = warp_max(mx);
      const float m_new = fmaxf(m_s[g], mx);
      float sum = 0.f;
      for (int t = lane; t < CH; t += 32) {
        const float pr = t < n ? expf(s_s[g * CH + t] - m_new) : 0.f;
        s_s[g * CH + t] = pr;
        sum += pr;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m_s[g] - m_new);
        alpha_s[g] = a;
        l_s[g] = l_s[g] * a + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // Values, with the probabilities rounded to bf16 as the TPU's MXU operand.
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
      const float a = alpha_s[g];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[g][e] *= a;
    }
    for (int t = tok; t < n; t += TPB) {
      float vv[VEC];
      load4(vb + (size_t)(c0 + t) * KD, vv);
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g >= G) break;
        const float pr = round_bf16(s_s[g * CH + t]);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(pr, vv[e], acc[g][e]);
      }
    }
    __syncthreads();  // s_s is rewritten by the next chunk
  }

  // Row groups of a warp add up by shuffles, then warps in turns.
  for (int o = CPR; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
  }
  for (int turn = 0; turn < WARPS; ++turn) {
    if (warp == turn && lane < CPR) {
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g >= G) break;
#pragma unroll
        for (int e = 0; e < VEC; ++e) o_s[g * MAXHD + word * VEC + e] += acc[g][e];
      }
    }
    __syncthreads();
  }

  // The current token joins from registers: q (bf16 values) . k (f32).
  for (int g = warp; g < G; g += WARPS) {
    float dot = 0.f;
    for (int d = lane; d < HD; d += 32) dot = fmaf(q_s[g * MAXHD + d], kn_s[d], dot);
    dot = warp_sum(dot) * scale;
    if (lane == 0) {
      const float m_fin = fmaxf(m_s[g], dot);
      const float a = expf(m_s[g] - m_fin), pr = expf(dot - m_fin);
      l_s[g] = l_s[g] * a + pr;
      alpha_s[g] = a;
      pcur_s[g] = pr;
    }
  }
  __syncthreads();
  for (int i = tid; i < G * HD; i += THREADS) {
    const int g = i / HD, d = i % HD;
    const float o = o_s[g * MAXHD + d] * alpha_s[g] + pcur_s[g] * vn_s[d];
    const float l = l_s[g];
    arow[(j + NKV * g) * HD + d] = __float2bfloat16_rn(l > 0.f ? o / l : 0.f);
  }
  if (old >= 0 && old < Tlen) {
    const size_t r = (size_t)old * KD + j * HD;
    for (int d = tid; d < HD; d += THREADS) {
      kc[r + d] = __float2bfloat16_rn(kn_s[d]);
      vc[r + d] = __float2bfloat16_rn(vn_s[d]);
    }
  }
  __syncthreads();  // the next unit reuses the shared arrays
}

// (v, i) <- the better of (v, i) and (v2, i2): larger value, then lower index.
__device__ __forceinline__ void merge(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float v2 = __shfl_xor_sync(0xffffffffu, v, o);
    const int i2 = __shfl_xor_sync(0xffffffffu, i, o);
    merge(v, i, v2, i2);
  }
}

template <int MT, typename T, int WK>
__global__ void __launch_bounds__(THREADS, MT == 8 ? TAIL_MIN_BLOCKS : 1)
step_kernel(StepParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float rstd_s[32], sq_w[WARPS][32], bv_s[WARPS];
  __shared__ int bi_s[WARPS];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int M = p.M, H = p.H, I = p.I, bn = p.bn;
  const int KD = p.NKV * p.HD, NQ = p.NH * p.HD;
  const int tpl = H / bn + 2 * I / bn + (I / H) * (H / bn) + p.n_qkv;
  const int stride = gridDim.x * THREADS;
  const float* cosp = p.giga && p.tokens_mode ? p.cos_t : p.cos_in;
  const float* sinp = p.giga && p.tokens_mode ? p.sin_t : p.sin_in;
  const int head_base = p.n_qkv + p.L * tpl - p.n_qkv;
  const Phase qkv0{0, p.n_qkv, p.ks_q, p.cols_q}, head{head_base, p.n_head, p.ks_head, p.cols_head};

  if (p.giga) {
    // Prologue: residual rows, RoPE tables, row sums of squares; RMSNorm + wqkv_0.
    float* xres = static_cast<float*>(p.x_out);
    const float* xf = static_cast<const float*>(p.x_in);
    const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(p.x_in);
    clear_sq(sq_w);
    for (int i = blockIdx.x * THREADS + tid; i < M * H; i += stride) {  // whole warps: H % 32 == 0
      const int m = i / H;
      const size_t src = p.tokens_mode ? (size_t)p.tok_in[m] * H + i % H : (size_t)i;
      float v = p.x_is_f32 ? xf[src] : __bfloat162float(xb[src]);
      if (p.tokens_mode) v = round_bf16(v);
      xres[i] = v;
      const float sq = warp_sum(v * v);
      if (lane == 0) sq_w[warp][m] += sq;
    }
    if (p.tokens_mode) {
      for (int i = blockIdx.x * THREADS + tid; i < M * KD; i += stride) {
        const int m = i / KD, k = i % KD;
        float sn, cs;
        sincosf(static_cast<float>(p.lens[m]) * p.cos_in[k], &sn, &cs);
        p.cos_t[i] = cs;
        p.sin_t[i] = p.sin_in[k] * sn;
      }
    }
    store_ssq(sq_w, p.ssq2, M);
    grid.sync();
    qkv_phases<MT, float, WK>(p.w, p.s, xres, p.ssq2, p.ga, M, H, bn, qkv0, p.eps, p.p_q,
                              static_cast<float*>(p.qkv_out), smem, rstd_s, grid, p.wfmt);
  }

  const T* qkv_src = static_cast<const T*>(p.giga ? p.qkv_out : p.qkv_in);
  const int layers = p.giga ? p.L : 1;
  for (int l = 0; l < layers; ++l) {
    if (p.giga) grid.sync();  // this layer's qkv row (the prologue's or the previous fin3)
    const size_t pool = (size_t)l * M * p.Tlen * KD;
    for (int u = blockIdx.x; u < M * p.NKV; u += gridDim.x) {
      const int b = u / p.NKV, j = u % p.NKV;
      const size_t rows = pool + (size_t)b * p.Tlen * KD;
      attention_unit<T>(qkv_src + (size_t)b * (NQ + 2 * KD), cosp + (size_t)b * KD,
                        sinp + (size_t)b * KD, p.kp + rows, p.vp + rows, p.lens[b], p.Tlen,
                        p.NH, p.NKV, p.HD, j, p.scale, p.att + (size_t)b * NQ,
                        reinterpret_cast<float*>(smem + RING_BYTES));
    }
    grid.sync();
    const bool last = l + 1 == layers;
    Params tp{p.att,
              p.giga ? p.x_out : p.x_in,
              p.giga ? p.gm + (size_t)l * H : p.gm,
              p.giga ? (last ? p.ga : p.ga + (size_t)(l + 1) * H) : p.ga,
              p.w, p.s, p.x_out, p.qkv_out,
              p.p_wo, p.x1, p.ssq1, p.p_gu, p.hbuf, p.p_down, p.xo, p.ssq2, p.p_q,
              M, H, I, bn,
              p.giga ? p.n_qkv + l * tpl : 0,
              p.giga && last ? 0 : p.n_qkv,
              p.ks_wo, p.ks_gu, p.ks_down, p.ks_q,
              p.cols_wo, p.cols_gu, p.cols_down, p.cols_q, p.eps, p.wfmt};
    tail_phases<MT, T, WK>(tp, smem, grid);
  }
  if (!p.giga) return;

  // Head: norm_f, the head GEMV, logits, the argmax.
  grid.sync();  // x_out of the last layer and its row sums of squares
  const int Nh = p.n_head * bn;
  row_rstd(p.ssq2, M, H, p.eps, rstd_s);
  __syncthreads();
  gemv_phase<MT, WK>(
      p.w, p.s, H, bn, M, head, smem, NoOffset{},
      [&](int m, int k, float(&v)[8]) {
        norm8(p.xo + (size_t)m * H + k, rstd_s[m], p.gf + k, v);
      },
      [&](int t, int sl, int m, int c) {
        return p.p_head + ((size_t)sl * M + m) * Nh + t * bn + c;
      },
      p.wfmt);
  grid.sync();
  for (int m = 0; m < M; ++m) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int c = blockIdx.x * THREADS + tid; c < Nh; c += stride) {
      float v = 0.f;
      for (int sl = 0; sl < p.ks_head; ++sl) v += __ldcg(p.p_head + ((size_t)sl * M + m) * Nh + c);
      p.logits[(size_t)m * Nh + c] = __float2bfloat16_rn(v);
      if (c < p.vocab && v > bv) {  // a thread's columns rise: the first wins
        bv = v;
        bi = c;
      }
    }
    warp_best(bv, bi);
    if (lane == 0) {
      bv_s[warp] = bv;
      bi_s[warp] = bi;
    }
    __syncthreads();
    if (tid == 0) {
      for (int w2 = 1; w2 < WARPS; ++w2) merge(bv, bi, bv_s[w2], bi_s[w2]);
      p.best_v[(size_t)blockIdx.x * M + m] = bv;
      p.best_i[(size_t)blockIdx.x * M + m] = bi;
    }
    __syncthreads();
  }
  grid.sync();
  if (blockIdx.x == 0) {
    for (int m = warp; m < M; m += WARPS) {
      float bv = -INFINITY;
      int bi = INT_MAX;
      for (int blk = lane; blk < (int)gridDim.x; blk += 32)
        merge(bv, bi, __ldcg(p.best_v + (size_t)blk * M + m), __ldcg(p.best_i + (size_t)blk * M + m));
      warp_best(bv, bi);
      if (lane == 0) p.tok_out[m] = bi;
    }
  }
}

template <int MT, typename T, int WK>
const void* kernel_ptr() {
  static bool done[64] = {};
  return opted(reinterpret_cast<const void*>(step_kernel<MT, T, WK>), done);
}

template <int WK>
const void* pick_kind(int m_tile, int is_f32) {
  if (m_tile == 8)
    return is_f32 ? kernel_ptr<8, float, WK>() : kernel_ptr<8, __nv_bfloat16, WK>();
  return is_f32 ? kernel_ptr<32, float, WK>() : kernel_ptr<32, __nv_bfloat16, WK>();
}

}  // namespace

namespace step_parts {  // each kind's instantiation of (m_tile, is_f32), in its own part

const void* pick_int8(int m_tile, int is_f32);
const void* pick_fp8(int m_tile, int is_f32);
const void* pick_bf16(int m_tile, int is_f32);

#if IN_PART(1)
const void* pick_int8(int m_tile, int is_f32) { return pick_kind<WK_INT8>(m_tile, is_f32); }
#endif
#if IN_PART(2)
const void* pick_fp8(int m_tile, int is_f32) { return pick_kind<WK_FP8>(m_tile, is_f32); }
#endif
#if IN_PART(3)
// Null for bf16 activations (no launch takes one).
const void* pick_bf16(int m_tile, int is_f32) {
  if (!is_f32) return nullptr;
  return m_tile == 8 ? kernel_ptr<8, float, WK_BF16>() : kernel_ptr<32, float, WK_BF16>();
}
#endif

}  // namespace step_parts

#if IN_PART(0)
namespace {

// The instantiation of (m_tile, is_f32, wfmt).
const void* pick(int m_tile, int is_f32, int wfmt) {
  if (wfmt == WFMT_BF16) return step_parts::pick_bf16(m_tile, is_f32);
  return wfmt == WFMT_INT8 ? step_parts::pick_int8(m_tile, is_f32)
                           : step_parts::pick_fp8(m_tile, is_f32);
}

}  // namespace

// Co-resident blocks per SM of the instantiation (m_tile 8 or 32; is_f32:
// the tail's activations are f32, as in every giga launch; wfmt the tiles'
// format, WFMT_* of gemv.cuh or WFMT_BF16).
extern "C" int decode_step_int8_blocks_per_sm(int m_tile, int is_f32, int wfmt, int* out) {
  const void* k = wfmt < WFMT_INT8 || wfmt > WFMT_BF16 ? nullptr : pick(m_tile, is_f32, wfmt);
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return tail::blocks_per_sm(k, out);
}

// ptrs, ints and floats in StepParams' order (32 pointers: lens .. best_i;
// 26 ints: giga .. cols_head, wfmt; 2 floats: eps, scale). The Python wrapper
// (kernels/layer_mega.py:launch_step) checks shapes, dtypes and the plan.
// grid must not exceed tail::blocks_per_sm * SMs, nor tail::MAX_GRID (512:
// the row sums row_rstd reads; a larger grid returns cudaErrorInvalidValue).
extern "C" int decode_step_int8(void* const* ptrs, int n_ptrs, const int* ints, int n_ints,
                                const float* floats, int n_floats, int grid, int m_tile,
                                int is_f32, void* stream) {
  if (n_ptrs != N_PTRS || n_ints != N_INTS || n_floats != N_FLOATS || grid < 1 ||
      grid > tail::MAX_GRID || ints[N_INTS - 1] < WFMT_INT8 || ints[N_INTS - 1] > WFMT_BF16)
    return static_cast<int>(cudaErrorInvalidValue);
  StepParams p;
  void* const* q = ptrs;
  p.lens = static_cast<const int*>(*q++);
  p.tok_in = static_cast<const int*>(*q++);
  p.x_in = *q++;
  p.cos_in = static_cast<const float*>(*q++);
  p.sin_in = static_cast<const float*>(*q++);
  p.qkv_in = *q++;
  p.ga = static_cast<const float*>(*q++);
  p.gm = static_cast<const float*>(*q++);
  p.gf = static_cast<const float*>(*q++);
  p.w = static_cast<const int8_t*>(*q++);
  p.s = static_cast<const float*>(*q++);
  p.kp = static_cast<__nv_bfloat16*>(*q++);
  p.vp = static_cast<__nv_bfloat16*>(*q++);
  p.x_out = *q++;
  p.qkv_out = *q++;
  p.tok_out = static_cast<int*>(*q++);
  p.logits = static_cast<__nv_bfloat16*>(*q++);
  p.cos_t = static_cast<float*>(*q++);
  p.sin_t = static_cast<float*>(*q++);
  p.att = static_cast<__nv_bfloat16*>(*q++);
  float** f[] = {&p.p_wo, &p.x1, &p.ssq1, &p.p_gu, &p.hbuf, &p.p_down,
                 &p.xo,   &p.ssq2, &p.p_q, &p.p_head, &p.best_v};
  for (float** dst : f) *dst = static_cast<float*>(*q++);
  p.best_i = static_cast<int*>(*q++);
  int* iv[] = {&p.giga, &p.tokens_mode, &p.x_is_f32, &p.M, &p.H, &p.I, &p.bn,
               &p.NH,   &p.NKV,         &p.HD,       &p.Tlen, &p.L, &p.n_qkv, &p.n_head,
               &p.vocab, &p.ks_wo,      &p.ks_gu,    &p.ks_down, &p.ks_q, &p.ks_head,
               &p.cols_wo, &p.cols_gu,  &p.cols_down, &p.cols_q, &p.cols_head, &p.wfmt};
  for (int i = 0; i < N_INTS; ++i) *iv[i] = ints[i];
  p.eps = floats[0];
  p.scale = floats[1];
  const void* kern = pick(m_tile, is_f32, p.wfmt);
  if (kern == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&p};
  const cudaError_t e =
      cudaLaunchCooperativeKernel(kern, dim3(grid), dim3(tail::THREADS), args, tail::SMEM_BYTES,
                                  static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}
#endif  // IN_PART(0)
