// dense_decode_attn: one-query GQA decode attention over the contiguous,
// token-major KV cache [B, T, NKV, HD].
//
// Replaces two TPU kernels of mila_tpu/kernels/dense_attention.py:
//   _dense_kernel (dense_decode_attention): lens[b] valid rows (the current
//       token included, already in the cache);
//   _fused_kernel (fused_decode_attention): RoPE of q and of the new k from
//       the raw fused qkv row with tiled tables (x * cos + swap_halves(x) *
//       sin, cos duplicated over the halves, sin pre-signed [-sin | sin]; q
//       takes the table's first HD columns), attention over the old_lens[b]
//       cached rows plus the current token, and the write of the roped k and
//       the raw v into row old_lens[b] of the caches (skipped when
//       old_lens[b] >= T). The block of (b, h) writes only its own head's
//       slice of row old_lens[b], which no block of the launch reads.
//
// Bound on the H100: the K/V bytes of the live rows (2 operations per byte).
// Design: one block of 128 threads per (row b, KV head h); the G = NH / NKV
// query heads of h share the block, so each K/V element is read once. A
// token's row of head h is HD contiguous values: CPR = HD * sizeof(T) / 16
// neighbouring threads read it as 16-byte words, so one pass covers
// 128 / CPR tokens. Tokens go in chunks of 128 with an online softmax in f32:
//   scores  thread (token, word) dots its 8 (bf16) or 4 (f32) dims with the
//           G queries held in registers; the CPR partial dots meet by shuffles;
//   softmax one warp per head: chunk max, rescale factor, p = exp(s - m), l;
//   values  the same mapping reads V words and accumulates p * v per head in
//           registers; at the end the token groups add up by shuffles within
//           a warp and across warps in shared memory, in turns.
// Rows >= the length are never read. A dense row of length 0 gives zeros
// (as the TPU kernel; the plain reference gives the mean of V there).
// Known weakness: B * NKV blocks (64 at the served shape) fill half of the
// 132 SMs.
#include "common.cuh"

namespace {

constexpr int THREADS = 128, WARPS = THREADS / 32, CH = 128, MAXG = 8, MAXHD = 128;

__device__ __forceinline__ void load16(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* v) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// FUSED == false: src = q [B, NH, HD], lens = rows incl. the current token.
// FUSED == true:  src = qkv [B, NH*HD + 2*KD] before RoPE, lens = old rows;
//                 cos_t/sin_t [B, KD] f32; k_new [B, KD] gets the roped k.
template <typename T, bool FUSED>
__global__ void __launch_bounds__(THREADS)
dense_kernel(const T* __restrict__ src, const float* __restrict__ cos_t,
             const float* __restrict__ sin_t, T* __restrict__ kc, T* __restrict__ vc,
             const int* __restrict__ lens, T* __restrict__ out, T* __restrict__ k_new, int Tlen,
             int NH, int NKV, int HD, float scale) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ float q_s[MAXG][MAXHD];
  __shared__ float s_s[MAXG][CH];
  __shared__ float o_s[MAXG][MAXHD];
  __shared__ float kn_s[MAXHD], vn_s[MAXHD];
  __shared__ float m_s[MAXG], l_s[MAXG], alpha_s[MAXG], pcur_s[MAXG];

  const int b = blockIdx.x / NKV, h = blockIdx.x % NKV;
  const int G = NH / NKV, KD = NKV * HD;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int old = lens[b];
  const int len = min(max(old, 0), Tlen);

  if (!FUSED) {
    for (int i = tid; i < G * HD; i += THREADS) {
      const int g = i / HD, d = i % HD;
      q_s[g][d] = to_f(src[((size_t)b * NH + h * G + g) * HD + d]);
      o_s[g][d] = 0.f;
    }
  } else {
    const T* row = src + (size_t)b * (NH * HD + 2 * KD);
    const float* cb = cos_t + (size_t)b * KD;
    const float* sb = sin_t + (size_t)b * KD;
    const int half = HD / 2;
    for (int i = tid; i < G * HD; i += THREADS) {
      const int g = i / HD, d = i % HD;
      const T* qr = row + (h * G + g) * HD;
      const float r = to_f(qr[d]) * cb[d] + to_f(qr[(d + half) % HD]) * sb[d];
      q_s[g][d] = to_f(from_f<T>(r));  // q in qkv's dtype, as the reference
      o_s[g][d] = 0.f;
    }
    for (int d = tid; d < HD; d += THREADS) {
      const T* kr = row + NH * HD + h * HD;
      const int c = h * HD + d;
      const T kn = from_f<T>(to_f(kr[d]) * cb[c] + to_f(kr[(d + half) % HD]) * sb[c]);
      kn_s[d] = to_f(kn);
      k_new[(size_t)b * KD + c] = kn;
      vn_s[d] = to_f(row[NH * HD + KD + c]);
    }
  }
  if (tid < MAXG) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  const int CPR = HD / VEC, TPB = THREADS / CPR;
  const int tok = tid / CPR, word = tid % CPR;
  float qr[MAXG][VEC], acc[MAXG][VEC];
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      qr[g][j] = g < G ? q_s[g][word * VEC + j] : 0.f;
      acc[g][j] = 0.f;
    }
  const T* kb = kc + (size_t)b * Tlen * KD + h * HD + word * VEC;
  const T* vb = vc + (size_t)b * Tlen * KD + h * HD + word * VEC;

  for (int c0 = 0; c0 < len; c0 += CH) {
    const int n = min(CH, len - c0);
    // Scores: every lane runs CH / TPB passes (the CPR lanes of a token
    // shuffle together, so the loop count must not depend on the token).
    for (int t = tok; t < CH; t += TPB) {
      float kv[VEC];
      const bool live = t < n;
      if (live) {
        load16(kb + (size_t)(c0 + t) * KD, kv);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) kv[j] = 0.f;
      }
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g >= G) break;
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < VEC; ++j) dot = fmaf(qr[g][j], kv[j], dot);
        for (int o = CPR / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
        if (word == 0) s_s[g][t] = live ? dot * scale : -INFINITY;
      }
    }
    __syncthreads();
    // Online softmax, one warp per head.
    for (int g = warp; g < G; g += WARPS) {
      float mx = -INFINITY;
      for (int t = lane; t < CH; t += 32) mx = fmaxf(mx, s_s[g][t]);
      mx = warp_max(mx);
      const float m_new = fmaxf(m_s[g], mx);
      float sum = 0.f;
      for (int t = lane; t < CH; t += 32) {
        const float p = t < n ? expf(s_s[g][t] - m_new) : 0.f;
        s_s[g][t] = p;
        sum += p;
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
    // Values.
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
      const float a = alpha_s[g];
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[g][j] *= a;
    }
    for (int t = tok; t < n; t += TPB) {
      float vv[VEC];
      load16(vb + (size_t)(c0 + t) * KD, vv);
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g >= G) break;
        const float p = s_s[g][t];
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[g][j] = fmaf(p, vv[j], acc[g][j]);
      }
    }
    __syncthreads();  // s_s is rewritten by the next chunk
  }

  // Token groups of a warp add up by shuffles, then warps in turns.
  for (int o = CPR; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[g][j] += __shfl_xor_sync(0xffffffffu, acc[g][j], o);
  }
  for (int turn = 0; turn < WARPS; ++turn) {
    if (warp == turn && lane < CPR) {
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g >= G) break;
#pragma unroll
        for (int j = 0; j < VEC; ++j) o_s[g][word * VEC + j] += acc[g][j];
      }
    }
    __syncthreads();
  }

  if (FUSED) {
    // The current token joins the softmax from registers.
    for (int g = warp; g < G; g += WARPS) {
      float dot = 0.f;
      for (int d = lane; d < HD; d += 32) dot = fmaf(q_s[g][d], kn_s[d], dot);
      dot = warp_sum(dot) * scale;
      if (lane == 0) {
        const float m_fin = fmaxf(m_s[g], dot);
        const float a = expf(m_s[g] - m_fin), p = expf(dot - m_fin);
        l_s[g] = l_s[g] * a + p;
        alpha_s[g] = a;
        pcur_s[g] = p;
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < G * HD; i += THREADS) {
    const int g = i / HD, d = i % HD;
    float o = o_s[g][d];
    if (FUSED) o = o * alpha_s[g] + pcur_s[g] * vn_s[d];
    const float l = l_s[g];
    out[((size_t)b * NH + h * G + g) * HD + d] = from_f<T>(l > 0.f ? o / l : 0.f);
  }
  if (FUSED && old >= 0 && old < Tlen) {
    const size_t r = ((size_t)b * Tlen + old) * KD + h * HD;
    for (int d = tid; d < HD; d += THREADS) {
      kc[r + d] = from_f<T>(kn_s[d]);
      vc[r + d] = from_f<T>(vn_s[d]);
    }
  }
}

template <typename T, bool FUSED>
void launch(const void* src, const void* cos_t, const void* sin_t, void* k, void* v,
            const void* lens, void* out, void* k_new, int B, int Tlen, int NH, int NKV, int HD,
            float scale, cudaStream_t stream) {
  dense_kernel<T, FUSED><<<B * NKV, THREADS, 0, stream>>>(
      static_cast<const T*>(src), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<T*>(k), static_cast<T*>(v),
      static_cast<const int*>(lens), static_cast<T*>(out), static_cast<T*>(k_new), Tlen, NH, NKV,
      HD, scale);
}

}  // namespace

// q [B, NH, HD]; k, v [B, T, NKV, HD]; lens [B] int32; out [B, NH, HD].
// All of q's dtype: f32 when is_f32, else bf16. Needs NH / NKV <= 8 and HD
// in {8, 16, 32, 64, 128} (f32: HD >= 8), 16-byte aligned caches (checked by
// the Python wrapper).
extern "C" int dense_decode_attn(const void* q, const void* k, const void* v, const void* lens,
                                 void* out, int B, int T, int NH, int NKV, int HD, float scale,
                                 int is_f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B > 0) {
    if (is_f32)
      launch<float, false>(q, nullptr, nullptr, const_cast<void*>(k), const_cast<void*>(v), lens,
                           out, nullptr, B, T, NH, NKV, HD, scale, s);
    else
      launch<__nv_bfloat16, false>(q, nullptr, nullptr, const_cast<void*>(k),
                                   const_cast<void*>(v), lens, out, nullptr, B, T, NH, NKV, HD,
                                   scale, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// qkv [B, NH*HD + 2*NKV*HD] (before RoPE); cos_t, sin_t [B, NKV*HD] f32;
// k, v [B, T, NKV, HD] (row old_lens[b] written); old_lens [B] int32;
// out [B, NH, HD]; k_new [B, NKV*HD]. Same dtype rules as dense_decode_attn.
extern "C" int fused_decode_attn(const void* qkv, const void* cos_t, const void* sin_t, void* k,
                                 void* v, const void* old_lens, void* out, void* k_new, int B,
                                 int T, int NH, int NKV, int HD, float scale, int is_f32,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B > 0) {
    if (is_f32)
      launch<float, true>(qkv, cos_t, sin_t, k, v, old_lens, out, k_new, B, T, NH, NKV, HD,
                          scale, s);
    else
      launch<__nv_bfloat16, true>(qkv, cos_t, sin_t, k, v, old_lens, out, k_new, B, T, NH, NKV,
                                  HD, scale, s);
  }
  return static_cast<int>(cudaGetLastError());
}
