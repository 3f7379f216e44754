// dense_decode_attn: one-query GQA decode attention over the contiguous,
// token-major KV cache [B, T, NKV, HD], split along each row's own length.
//
// Replaces two TPU kernels of mila_tpu/kernels/dense_attention.py, each
// over bf16 or f32 caches under a bf16 or f32 query (the TPU kernels stage
// the caches in their own type and write out in q's: the speculative
// engine's f32 draft decodes over a bf16 cache):
//   _dense_kernel (dense_decode_attention): lens[b] valid rows (the current
//       token included, already in the cache);
//   _fused_kernel (fused_decode_attention): RoPE of q and of the new k from
//       the raw fused qkv row with tiled tables (x * cos + swap_halves(x) *
//       sin, cos duplicated over the halves, sin pre-signed [-sin | sin]; q
//       takes the table's first HD columns), attention over the old_lens[b]
//       cached rows plus the current token, and the write of the roped k and
//       the raw v into row old_lens[b] of the caches (skipped when
//       old_lens[b] >= T).
//
// Bound on the H100: the K/V bytes of the live rows (2 operations per byte).
// One block per (row, KV head) walking the whole row leaves most SMs idle
// and waits on one chunk's loads at a time, so the grid is (B * NKV, S): S
// comes from shapes only (kernels/dense_attention.py:plan_splits, from B,
// NKV, T and the SM count), and each block reads lens[b] on the device. A
// row of len tokens takes n = min(S, max(1, len / MIN_TOKENS)) splits;
// split s < n owns tokens [s len / n, (s + 1) len / n), splits s >= n exit
// at once. So no block idles on a short row in a long cache, and a split
// holds at least MIN_TOKENS tokens unless the row is shorter. The G = NH /
// NKV query heads of KV head h share the block, so each K/V element is read
// once. A block of 128 threads:
//   requests its first NST chunks of CH tokens (K and V rows of head h,
//     cp.async into a ring of padded shared-memory rows) before any math,
//     so a split of up to NST * CH tokens is in flight whole;
//   loads (or ropes) q meanwhile; split 0 of a fused call also writes k_new
//     and the cache row old_lens[b], which no split reads (each reads rows
//     below old_lens[b]);
//   per chunk: scores (two threads per token, each half the head dims, all
//     G heads), the chunk max as the one block-wide reduction, an online
//     softmax in f32, values (thread (d, part) owns head dim d over a run of
//     the chunk's tokens); four barriers per chunk;
//   sums its row sums and value parts in a fixed order.
// With n == 1 the block normalises and stores the row itself. Otherwise
// each split writes its unnormalised f32 partial (o [B, NH, S, HD], m and l
// [B, NH, S]) to scratch and counts itself in counters[b * NKV + h]; the
// split that arrives last merges the n partials of its (row, KV head) with
// the log-sum-exp rescale, in a fixed order, so two calls are bit-equal,
// and resets the counter to 0 for the next launch (and the next replay of
// a captured graph). The merge in the last split was kept over a second
// merge launch (K3's design): on the card it was as fast for the dense
// entry and 1.4 us faster for the fused one at B 8 (which re-ropes q in a
// merge launch), 0.4-0.8 us faster at B 1 (PERF.md §6). The current token
// of a fused call enters the softmax once, in that final step, after the
// splits' partials. A dense row of length 0 gives zeros (as the TPU kernel;
// the plain reference gives the mean of V there).
// Built in four parts (kernels/_build.py: PARTS), one per (q, cache) type
// pair, each with the dense and the fused kernels at every head size; part
// 0 (bf16 over bf16) also holds the C entry points.
// The head size is a template parameter, so every per-chunk loop unrolls:
// with a runtime head size the chunk's loops ran as dependent shared-memory
// round trips (4.5 us a 64-token chunk on the card; 2.8 us unrolled).
#include "common.cuh"
#include "mma.cuh"

namespace dense_parts {  // one call's arguments, and each type pair's launches

struct Call {
  const void* src;  // q, or the fused qkv rows
  const void *cos_t, *sin_t;
  void *k, *v;
  const void* lens;
  void *out, *k_new, *o_part, *m_part, *l_part, *counters;
  int B, T_len, NH, NKV, HD, S;
  float scale;
  bool fused;
  cudaStream_t stream;
};

int run_bf16_bf16(const Call& c);
int run_f32_f32(const Call& c);
int run_f32_bf16(const Call& c);
int run_bf16_f32(const Call& c);

}  // namespace dense_parts

namespace {

constexpr int THREADS = 128, WARPS = THREADS / 32;
constexpr int CH = THREADS / 2;  // tokens per chunk: two threads per token in the scores
constexpr int NST = 3;           // chunk stages, all requested before the first wait
constexpr int MAXG = 8;
constexpr int MIN_TOKENS = 32;   // SPLIT_MIN_TOKENS of kernels/dense_attention.py
constexpr int MAX_SPLITS = 64;   // SPLIT_MAX of kernels/dense_attention.py

// T: q (or the fused qkv rows), out and k_new; TC: the caches.
template <typename T, typename TC>
struct Params {
  const T* src;          // q [B, NH, HD], or the fused qkv rows [B, NH*HD + 2*KD]
  const float* cos_t;    // [B, KD] (fused)
  const float* sin_t;
  TC* kc;                // [B, T, NKV, HD]
  TC* vc;
  const int* lens;       // rows incl. the current token; fused: old rows
  T* out;                // [B, NH, HD]
  T* k_new;              // [B, KD] (fused)
  float* o_part;         // [B, NH, S, HD] (S > 1)
  float* m_part;         // [B, NH, S]
  float* l_part;
  int* counters;         // [B * NKV], 0 between launches (S > 1)
  int T_len, NH, NKV, S;
  float scale;
};

// Shared memory of a block (bytes), laid out as the kernels read it; T is
// the caches' type.
template <typename T, int HD>
struct Smem {
  static constexpr int ROW = HD * (int)sizeof(T) + 16;  // a padded K or V row
  static constexpr int STAGE = 2 * CH * ROW;            // a chunk's K rows, then V rows
  static constexpr int RING = NST * STAGE;
  // after the ring, f32: q [MAXG][HD], p [MAXG][CH], red [MAXG][WARPS], o parts
  // [THREADS / HD][MAXG][HD], kn [HD], vn [HD], m, l, cur [MAXG] each
  static constexpr int P = MAXG * HD, RED = P + MAXG * CH, O = RED + MAXG * WARPS;
  static constexpr int KN = O + MAXG * THREADS, VN = KN + HD, M = VN + HD, L = M + MAXG,
                       CUR = L + MAXG;
  static constexpr int BYTES = RING + 4 * (CUR + MAXG);
};

__device__ __forceinline__ int split_count(int len, int S) {
  return min(S, max(1, len / MIN_TOKENS));
}

// Four consecutive values from shared memory (8- or 16-byte aligned).
__device__ __forceinline__ void lds4(const __nv_bfloat16* p, float* v) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ void lds4(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

// cp.async of tokens [t0, t0 + n) of one KV head's K and V rows (16-byte
// words) into the stage at `base`.
template <typename T, int HD>
__device__ __forceinline__ void load_chunk(unsigned char* base, const T* kb, const T* vb, int t0,
                                           int n, int KD) {
  constexpr int E = 16 / sizeof(T), WPR = HD / E, ROW = Smem<T, HD>::ROW;
  const int words = n * WPR;
  for (int i = threadIdx.x; i < 2 * words; i += THREADS) {
    const int which = i >= words, r = i - which * words, tok = r / WPR, w = r % WPR;
    cp_async16(base + (which * CH + tok) * ROW + w * 16,
               (which ? vb : kb) + (size_t)(t0 + tok) * KD + w * E);
  }
}

// q of (b, KV head h) and, fused, the new row of head h: load() issues the
// global loads into registers (before the row's length is known, so both
// are in flight at once); store() writes q (fused: roped, rounded to T as
// the reference rounds it) to q_s [G][HD] as f32, the roped k and raw v as
// the cache holds them (rounded to TC) to kn_s and vn_s, and, where `write`
// (split 0), k_new (in T) and cache row old_lens[b] (when it lies in the
// cache), which no split reads.
template <typename T, typename TC, bool FUSED, int HD>
struct Queries {
  static constexpr int QE = (MAXG * HD + THREADS - 1) / THREADS;  // q elements a thread at most
  float qa[QE], qb[QE], ca[QE], sa[QE];
  float kx = 0.f, ky = 0.f, kcos = 0.f, ksin = 0.f;
  T vraw;

  __device__ __forceinline__ void load(const Params<T, TC>& a, int b, int h) {
    const int tid = threadIdx.x, G = a.NH / a.NKV, KD = a.NKV * HD;
    const T* row = a.src + (size_t)b * (FUSED ? a.NH * HD + 2 * KD : a.NH * HD);
#pragma unroll
    for (int k = 0; k < QE; ++k) {
      const int i = tid + k * THREADS;
      if (i < G * HD) {
        const int d = i % HD;
        const T* qr = row + (h * G + i / HD) * HD;
        qa[k] = to_f(qr[d]);
        if (FUSED) {
          qb[k] = to_f(qr[(d + HD / 2) % HD]);
          ca[k] = a.cos_t[(size_t)b * KD + d];
          sa[k] = a.sin_t[(size_t)b * KD + d];
        }
      }
    }
    if (FUSED && tid < HD) {
      const T* kr = row + a.NH * HD + h * HD;
      const int c = h * HD + tid;
      kx = to_f(kr[tid]);
      ky = to_f(kr[(tid + HD / 2) % HD]);
      kcos = a.cos_t[(size_t)b * KD + c];
      ksin = a.sin_t[(size_t)b * KD + c];
      vraw = row[a.NH * HD + KD + c];
    }
  }

  __device__ __forceinline__ void store(const Params<T, TC>& a, int b, int h, bool write,
                                        int old, float* q_s, float* kn_s, float* vn_s) const {
    const int tid = threadIdx.x, G = a.NH / a.NKV, KD = a.NKV * HD;
#pragma unroll
    for (int k = 0; k < QE; ++k) {
      const int i = tid + k * THREADS;
      if (i < G * HD) q_s[i] = FUSED ? to_f(from_f<T>(qa[k] * ca[k] + qb[k] * sa[k])) : qa[k];
    }
    if (FUSED && tid < HD) {
      const T kn = from_f<T>(kx * kcos + ky * ksin);
      const TC kc = from_f<TC>(to_f(kn)), vc = from_f<TC>(to_f(vraw));
      kn_s[tid] = to_f(kc);
      vn_s[tid] = to_f(vc);
      if (write) {
        const int c = h * HD + tid;
        a.k_new[(size_t)b * KD + c] = kn;
        if (old >= 0 && old < a.T_len) {
          const size_t r = ((size_t)b * a.T_len + old) * KD + c;
          a.kc[r] = kc;
          a.vc[r] = vc;
        }
      }
    }
  }
};

// The current token's scaled score per head (fused), one warp per head.
template <int HD>
__device__ void current_scores(const float* q_s, const float* kn_s, int G, float scale,
                               float* cur_s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int g = warp; g < G; g += WARPS) {
    float dot = 0.f;
#pragma unroll
    for (int d = lane; d < HD; d += 32) dot = fmaf(q_s[g * HD + d], kn_s[d], dot);
    dot = warp_sum(dot);
    if (lane == 0) cur_s[g] = dot * scale;
  }
}

// out = O / L after the current token (fused) joins (M, L, O) last.
template <typename T, typename TC, bool FUSED, int HD>
__device__ __forceinline__ void store_out(const Params<T, TC>& a, size_t r, int d, float M,
                                          float L, float O, float cur, const float* vn_s) {
  if (FUSED) {
    const float Mf = fmaxf(M, cur), al = expf(M - Mf), pc = expf(cur - Mf);
    L = L * al + pc;
    O = O * al + pc * vn_s[d];
  }
  a.out[r * HD + d] = from_f<T>(L > 0.f ? O / L : 0.f);
}

// Merge of the n partials of (b, KV head h), written by the splits of this
// launch and read through L2, in the ring's shared
// memory: the maxima and row sums first, one warp per head turning them
// into weights exp(m_s - M) and the merged row sum (a fixed shuffle tree);
// the o partials meanwhile by cp.async in runs of splits, each thread
// adding its outputs over a run in split order. Every load of a run is in
// flight at once.
template <typename T, typename TC, bool FUSED, int HD>
__device__ void merge_store(const Params<T, TC>& a, int b, int h, int n, unsigned char* buf,
                            const float* cur_s, const float* vn_s) {
  constexpr int OUTS = (MAXG * HD + THREADS - 1) / THREADS;  // outputs a thread owns at most
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = a.NH / a.NKV, S = a.S, GH = G * HD;
  const size_t row0 = (size_t)b * a.NH + h * G;
  float* w_s = reinterpret_cast<float*>(buf);  // [MAXG][MAX_SPLITS]: m, then the weights
  float* l_s = w_s + MAXG * MAX_SPLITS;        // [MAXG][MAX_SPLITS]
  float* ML_s = l_s + MAXG * MAX_SPLITS;       // [2][MAXG]: M, L
  float* o_s = ML_s + 2 * MAXG;                // runs of [per][G][HD]
  const int per = (Smem<TC, HD>::RING - 4 * (2 * MAXG * MAX_SPLITS + 2 * MAXG)) / (GH * 4);
  auto issue = [&](int s0) {
    constexpr int Q4 = HD / 4;
    const int cnt = min(per, n - s0);
    for (int i = tid; i < cnt * G * Q4; i += THREADS) {
      const int s = i / (G * Q4), r = i % (G * Q4), g = r / Q4, d = 4 * (r % Q4);
      cp_async16(o_s + s * GH + g * HD + d, a.o_part + ((row0 + g) * S + s0 + s) * HD + d);
    }
    cp_async_commit();
  };
  issue(0);
  for (int i = tid; i < G * n; i += THREADS) {
    const int g = i / n, s = i % n;
    w_s[g * MAX_SPLITS + s] = __ldcg(a.m_part + (row0 + g) * S + s);
    l_s[g * MAX_SPLITS + s] = __ldcg(a.l_part + (row0 + g) * S + s);
  }
  __syncthreads();
  for (int g = warp; g < G; g += WARPS) {
    float* wg = w_s + g * MAX_SPLITS;
    const float* lg = l_s + g * MAX_SPLITS;
    const bool in0 = lane < n, in1 = lane + 32 < n;
    const float m0 = in0 ? wg[lane] : -INFINITY, m1 = in1 ? wg[lane + 32] : -INFINITY;
    const float M = warp_max(fmaxf(m0, m1));
    const float w0 = in0 ? expf(m0 - M) : 0.f, w1 = in1 ? expf(m1 - M) : 0.f;
    const float l = warp_sum((in0 ? lg[lane] * w0 : 0.f) + (in1 ? lg[lane + 32] * w1 : 0.f));
    if (in0) wg[lane] = w0;
    if (in1) wg[lane + 32] = w1;
    if (lane == 0) {
      ML_s[g] = M;
      ML_s[MAXG + g] = l;
    }
  }
  float O[OUTS];
#pragma unroll
  for (int k = 0; k < OUTS; ++k) O[k] = 0.f;
  for (int s0 = 0; s0 < n; s0 += per) {
    cp_async_wait<0>();
    __syncthreads();  // the run (and, first, the weights) for every thread
    const int cnt = min(per, n - s0);
#pragma unroll
    for (int k = 0; k < OUTS; ++k) {
      const int i = tid + k * THREADS;
      if (i < GH) {
        const float* wg = w_s + (i / HD) * MAX_SPLITS + s0;
        for (int s = 0; s < cnt; ++s) O[k] = fmaf(o_s[s * GH + i], wg[s], O[k]);
      }
    }
    if (s0 + per < n) {
      __syncthreads();  // the run fully read
      issue(s0 + per);
    }
  }
#pragma unroll
  for (int k = 0; k < OUTS; ++k) {
    const int i = tid + k * THREADS;
    if (i < GH) {
      const int g = i / HD;
      store_out<T, TC, FUSED, HD>(a, row0 + g, i % HD, ML_s[g], ML_s[MAXG + g], O[k],
                                  FUSED ? cur_s[g] : 0.f, vn_s);
    }
  }
}

template <typename T, typename TC, bool FUSED, int HD>
__global__ void __launch_bounds__(THREADS) split_kernel(const Params<T, TC> a) {
  using SM = Smem<TC, HD>;
  constexpr int DH = HD / 2;                // head dims a thread dots in the scores
  constexpr int R = THREADS / HD, SPAN = CH / R;  // values: R parts of SPAN tokens
  constexpr int RS = SM::ROW / (int)sizeof(TC);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last_s;
  float* f = reinterpret_cast<float*>(smem + SM::RING);
  float *q_s = f, *p_s = f + SM::P, *red_s = f + SM::RED, *o_s = f + SM::O, *kn_s = f + SM::KN,
        *vn_s = f + SM::VN, *m_s = f + SM::M, *l_s = f + SM::L, *cur_s = f + SM::CUR;

  const int NKV = a.NKV, G = a.NH / NKV, KD = NKV * HD;
  const int b = blockIdx.x / NKV, h = blockIdx.x % NKV, s = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lraw = a.lens[b];
  Queries<T, TC, FUSED, HD> qv;
  qv.load(a, b, h);
  const int len = min(max(lraw, 0), a.T_len);
  const int n = split_count(len, a.S);
  if (s >= n) return;
  const int lo = (int)((long long)s * len / n), hi = (int)((long long)(s + 1) * len / n);
  const int ntok = hi - lo, nch = (ntok + CH - 1) / CH;
  const TC* kb = a.kc + (size_t)b * a.T_len * KD + h * HD;
  const TC* vb = a.vc + (size_t)b * a.T_len * KD + h * HD;

  // The split's first NST chunks are in flight before any math: one commit
  // group per chunk (empty past the end).
#pragma unroll
  for (int c = 0; c < NST; ++c) {
    if (c < nch) load_chunk<TC, HD>(smem + c * SM::STAGE, kb, vb, lo + c * CH,
                                    min(CH, ntok - c * CH), KD);
    cp_async_commit();
  }
  qv.store(a, b, h, s == 0, lraw, q_s, kn_s, vn_s);

  // Scores: token t of the chunk, head dims [p DH, (p + 1) DH). Values: head
  // dim dv over the chunk's tokens [part SPAN, (part + 1) SPAN).
  const int t = tid >> 1, p = tid & 1;
  const int dv = tid % HD, part = tid / HD;
  float m_run[MAXG], l_run[MAXG], acc[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m_run[g] = -INFINITY;
    l_run[g] = 0.f;
    acc[g] = 0.f;
  }

  for (int c = 0; c < nch; ++c) {
    cp_async_wait<NST - 1>();  // NST + c groups committed: chunk c has landed
    __syncthreads();           // ... for every thread (and q_s is written)
    const unsigned char* base = smem + (c % NST) * SM::STAGE;
    const TC* Ks = reinterpret_cast<const TC*>(base);
    const TC* Vs = reinterpret_cast<const TC*>(base + CH * SM::ROW);
    const int nc = min(CH, ntok - c * CH);
    const bool valid = t < nc;

    float sc[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) sc[g] = 0.f;
    if (valid) {
      float kv[DH];
#pragma unroll
      for (int d = 0; d < DH; d += 4) lds4(Ks + t * RS + p * DH + d, kv + d);
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < G) {
          const float* qg = q_s + g * HD + p * DH;
#pragma unroll
          for (int d = 0; d < DH; d += 4) {
            const float4 q4 = *reinterpret_cast<const float4*>(qg + d);
            sc[g] = fmaf(q4.x, kv[d], fmaf(q4.y, kv[d + 1], fmaf(q4.z, kv[d + 2],
                                                                 fmaf(q4.w, kv[d + 3], sc[g]))));
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      sc[g] += __shfl_xor_sync(0xffffffffu, sc[g], 1);
      sc[g] = valid ? sc[g] * a.scale : -INFINITY;
      const float mx = warp_max(sc[g]);
      if (lane == 0 && g < G) red_s[g * WARPS + warp] = mx;
    }
    __syncthreads();  // the chunk's per-warp maxima

    // Online softmax: the running max is block-uniform; every thread
    // rescales its own share of l and its accumulators.
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
        float cm = red_s[g * WARPS];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) cm = fmaxf(cm, red_s[g * WARPS + w]);
        const float m_new = fmaxf(m_run[g], cm);
        const float alpha = expf(m_run[g] - m_new);
        m_run[g] = m_new;
        const float pr = valid ? expf(sc[g] - m_new) : 0.f;
        if (p == 0) {
          p_s[g * CH + t] = pr;
          l_run[g] = l_run[g] * alpha + pr;
        }
        acc[g] *= alpha;
      }
    }
    __syncthreads();  // the chunk's probabilities (0 past the chunk's tokens)

    // Values, 4 tokens a step; rows past the chunk's tokens are not read.
#pragma unroll
    for (int jj = 0; jj < SPAN; jj += 4) {
      const int j = part * SPAN + jj;
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = j + u < nc ? to_f(Vs[(j + u) * RS + dv]) : 0.f;
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < G) {
          const float4 p4 = *reinterpret_cast<const float4*>(p_s + g * CH + j);
          acc[g] = fmaf(p4.w, v[3], fmaf(p4.z, v[2], fmaf(p4.y, v[1], fmaf(p4.x, v[0], acc[g]))));
        }
      }
    }
    __syncthreads();  // stage c and p_s fully read
    if (c + NST < nch)
      load_chunk<TC, HD>(smem + (c % NST) * SM::STAGE, kb, vb, lo + (c + NST) * CH,
                         min(CH, ntok - (c + NST) * CH), KD);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // The split's row sums (over the threads) and outputs (over the parts).
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < G) {
      const float lw = warp_sum(l_run[g]);
      if (lane == 0) red_s[g * WARPS + warp] = lw;
      o_s[(part * MAXG + g) * HD + dv] = acc[g];
      if (tid == 0) m_s[g] = m_run[g];
    }
  }
  __syncthreads();
  if (tid < G) {
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) l += red_s[tid * WARPS + w];
    l_s[tid] = l;
  }
  if (FUSED) current_scores<HD>(q_s, kn_s, G, a.scale, cur_s);
  __syncthreads();

  const size_t row0 = (size_t)b * a.NH + h * G;
  for (int i = tid; i < G * HD; i += THREADS) {
    const int g = i / HD, d = i % HD;
    float o = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) o += o_s[(r * MAXG + g) * HD + d];
    if (n == 1)
      store_out<T, TC, FUSED, HD>(a, row0 + g, d, m_s[g], l_s[g], o, FUSED ? cur_s[g] : 0.f,
                                  vn_s);
    else
      a.o_part[((row0 + g) * a.S + s) * HD + d] = o;
  }
  if (n == 1) return;
  if (tid < G) {
    a.m_part[(row0 + tid) * a.S + s] = m_s[tid];
    a.l_part[(row0 + tid) * a.S + s] = l_s[tid];
  }
  __threadfence();  // this split's partial is visible before it is counted
  __syncthreads();
  if (tid == 0) last_s = atomicAdd(a.counters + blockIdx.x, 1) == n - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  merge_store<T, TC, FUSED, HD>(a, b, h, n, smem, cur_s, vn_s);
  if (tid == 0) a.counters[blockIdx.x] = 0;
}

template <typename T, typename TC, bool FUSED, int HD>
int launch(const Params<T, TC>& a, int B, cudaStream_t stream) {
  constexpr int bytes = Smem<TC, HD>::BYTES;
  static int allowed = 48 * 1024;
  if (bytes > allowed) {
    cudaError_t e = cudaFuncSetAttribute(split_kernel<T, TC, FUSED, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed = bytes;
  }
  split_kernel<T, TC, FUSED, HD><<<dim3(B * a.NKV, a.S), THREADS, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TC, bool FUSED>
int by_head_dim(const Params<T, TC>& a, int B, int HD, cudaStream_t st) {
  switch (HD) {
    case 8: return launch<T, TC, FUSED, 8>(a, B, st);
    case 16: return launch<T, TC, FUSED, 16>(a, B, st);
    case 32: return launch<T, TC, FUSED, 32>(a, B, st);
    case 64: return launch<T, TC, FUSED, 64>(a, B, st);
    case 128: return launch<T, TC, FUSED, 128>(a, B, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, typename TC>
int run(const dense_parts::Call& c) {
  if (c.B <= 0) return static_cast<int>(cudaGetLastError());
  const Params<T, TC> a{static_cast<const T*>(c.src), static_cast<const float*>(c.cos_t),
                        static_cast<const float*>(c.sin_t), static_cast<TC*>(c.k),
                        static_cast<TC*>(c.v), static_cast<const int*>(c.lens),
                        static_cast<T*>(c.out), static_cast<T*>(c.k_new),
                        static_cast<float*>(c.o_part), static_cast<float*>(c.m_part),
                        static_cast<float*>(c.l_part), static_cast<int*>(c.counters), c.T_len,
                        c.NH, c.NKV, c.S, c.scale};
  return c.fused ? by_head_dim<T, TC, true>(a, c.B, c.HD, c.stream)
                 : by_head_dim<T, TC, false>(a, c.B, c.HD, c.stream);
}

}  // namespace

namespace dense_parts {  // each (q, cache) type pair's instantiations, in a part of its own

#if IN_PART(0)
int run_bf16_bf16(const Call& c) { return run<__nv_bfloat16, __nv_bfloat16>(c); }
#endif
#if IN_PART(1)
int run_f32_f32(const Call& c) { return run<float, float>(c); }
#endif
#if IN_PART(2)
int run_f32_bf16(const Call& c) { return run<float, __nv_bfloat16>(c); }
#endif
#if IN_PART(3)
int run_bf16_f32(const Call& c) { return run<__nv_bfloat16, float>(c); }
#endif

}  // namespace dense_parts

#if IN_PART(0)
namespace {

// The four (q, cache) type pairs: f32 when q_f32 / cache_f32, else bf16.
int by_types(const dense_parts::Call& c, int q_f32, int cache_f32) {
  if (q_f32) return cache_f32 ? dense_parts::run_f32_f32(c) : dense_parts::run_f32_bf16(c);
  return cache_f32 ? dense_parts::run_bf16_f32(c) : dense_parts::run_bf16_bf16(c);
}

}  // namespace

// The id of the CUDA-graph capture under way on `stream`, or 0 when the
// stream is not capturing: the wrapper keeps one set of arrival counters
// per (capture, stream), zeroed inside that capture.
extern "C" unsigned long long dense_capture_id(void* stream) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  unsigned long long id = 0;
  if (cudaStreamGetCaptureInfo(static_cast<cudaStream_t>(stream), &status, &id) != cudaSuccess ||
      status != cudaStreamCaptureStatusActive)
    return 0;
  return id;
}

// q [B, NH, HD]; k, v [B, T, NKV, HD]; lens [B] int32; out [B, NH, HD].
// q and out are f32 when q_f32, else bf16; the caches f32 when cache_f32,
// else bf16, in any pairing with q's type (each read in its own type). S
// splits per row; with S > 1, o_part [B, NH, S, HD], m_part and l_part
// [B, NH, S] f32 scratch and counters [B * NKV] int32, zero before the
// launch and left zero after it (unused when S == 1), which no launch that
// may run at the same time shares. Needs NH / NKV <= 8, HD in {8, 16, 32,
// 64, 128} (f32: HD >= 8), 16-byte aligned caches and 1 <= S <= MAX_SPLITS
// (checked by the Python wrapper).
extern "C" int dense_decode_attn(const void* q, const void* k, const void* v, const void* lens,
                                 void* out, void* o_part, void* m_part, void* l_part,
                                 void* counters, int B, int T, int NH, int NKV, int HD, int S,
                                 float scale, int q_f32, int cache_f32, void* stream) {
  const dense_parts::Call c{q, nullptr, nullptr, const_cast<void*>(k), const_cast<void*>(v),
                            lens, out, nullptr, o_part, m_part, l_part, counters, B, T, NH, NKV,
                            HD, S, scale, false, static_cast<cudaStream_t>(stream)};
  return by_types(c, q_f32, cache_f32);
}

// qkv [B, NH*HD + 2*NKV*HD] (before RoPE); cos_t, sin_t [B, NKV*HD] f32;
// k, v [B, T, NKV, HD] (row old_lens[b] written, rounded to the caches'
// type); old_lens [B] int32; out [B, NH, HD] and k_new [B, NKV*HD] in
// qkv's type. Scratch, splits and type rules as dense_decode_attn.
extern "C" int fused_decode_attn(const void* qkv, const void* cos_t, const void* sin_t, void* k,
                                 void* v, const void* old_lens, void* out, void* k_new,
                                 void* o_part, void* m_part, void* l_part, void* counters, int B,
                                 int T, int NH, int NKV, int HD, int S, float scale, int q_f32,
                                 int cache_f32, void* stream) {
  const dense_parts::Call c{qkv, cos_t, sin_t, k, v, old_lens, out, k_new, o_part, m_part,
                            l_part, counters, B, T, NH, NKV, HD, S, scale, true,
                            static_cast<cudaStream_t>(stream)};
  return by_types(c, q_f32, cache_f32);
}
#endif  // IN_PART(0)
