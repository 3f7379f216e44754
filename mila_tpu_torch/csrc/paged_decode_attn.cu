// paged_decode_attn: one-query GQA decode attention through a page table.
//
// Replaces the TPU kernel mila_tpu/kernels/paged_attention.py:_paged_kernel
// (entry paged_decode_attention), bf16/f32 pages and int8 pages with f32
// scales [P, NKV, ps], one per (page, head, token). Pages are
// [P, NKV, HD, ps] (token-minor), so the tile of KV head h in page p is a
// contiguous [HD, ps] slab.
//
// Bound on the H100: the K/V bytes of the live tokens (2 operations per
// byte; int8 pages halve them and add 8 bytes of scales per token and
// head). Design: one block of 128 threads per (row b, KV head h); the
// G = NH / NKV query heads of h share the block, so each K/V element is read
// once. The block reads its own page-table entries and walks the row's
// tokens in chunks of 128 up to seq_lens[b]:
//   scores  thread (tg, dg) owns 8 consecutive tokens and HD/8 head dims,
//           reading K[d][t..t+7] as one 16-byte load per dim (16 threads
//           cover a 256-byte row); partial dots meet in shared memory;
//   softmax thread t owns token t: block max / sum per head, online
//           rescaling of the running max m, denominator l and output
//           accumulators (f32);
//   values  thread (d, part) owns one head-dim row d and a run of the chunk's
//           tokens, reading V[d][t..t+7] as 16-byte loads, four in flight.
// Tokens >= seq_lens[b] are masked; a row with length 0 gives zeros.
// int8 pages: the loads carry 8 tokens in 8 bytes; as in the TPU kernel the
// scales never touch the [HD, ps] tiles: k_scale[token] multiplies the
// token's scaled score after the q.k dot, v_scale[token] its probability
// before P.V (the row sum l adds the unscaled probabilities), both in f32.
// Known weakness: B * NKV blocks (64 at the served shape) fill half of the
// 132 SMs.
#include "common.cuh"

namespace {

constexpr int THREADS = 128, CH = 128, MAXG = 8, MAXHD = 128;
constexpr int TG = CH / 8, DG = THREADS / TG;  // 16 token groups x 8 head-dim groups

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const int8_t* p, float* v) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[i] = s8_to_f(r.x, i);
    v[4 + i] = s8_to_f(r.y, i);
  }
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// T: q and out; TP: pages (T, or int8_t with the scale planes ks and vs).
template <typename T, typename TP>
__global__ void __launch_bounds__(THREADS)
paged_kernel(const T* __restrict__ q, const TP* __restrict__ kp, const TP* __restrict__ vp,
             const float* __restrict__ ks, const float* __restrict__ vs,
             const int* __restrict__ table, const int* __restrict__ lens, T* __restrict__ out,
             int NH, int NKV, int HD, int ps, int W, float scale) {
  constexpr bool QUANT = sizeof(TP) == 1;
  __shared__ float q_s[MAXG][MAXHD];
  __shared__ float p_s[MAXG][CH];
  __shared__ float o_s[MAXG][MAXHD];
  __shared__ float s_part[DG][MAXG][CH];  // score partial sums per head-dim group
  __shared__ float red_s[MAXG][THREADS / 32];
  __shared__ float m_s[MAXG], l_s[MAXG], alpha_s[MAXG];

  const int b = blockIdx.x / NKV, h = blockIdx.x % NKV;
  const int G = NH / NKV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = lens[b];
  const int* trow = table + (size_t)b * W;
  const size_t head_stride = (size_t)HD * ps;  // one (page, kv head) slab

  for (int i = tid; i < G * HD; i += THREADS) {
    const int g = i / HD, d = i % HD;
    q_s[g][d] = to_f(q[((size_t)b * NH + h * G + g) * HD + d]);
    o_s[g][d] = 0.f;
  }
  if (tid < G) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  // Scores mapping: thread (tg, dg) owns 8 consecutive tokens and HD / DG
  // head dims, one 16-byte K load per dim.
  const int tg = tid % TG, dg = tid / TG, dpt = HD / DG;
  // Values mapping: R threads per head-dim row d, each over span tokens.
  const int R = THREADS / HD, d = tid % HD, part = tid / HD, span = CH / R;
  float acc[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) acc[g] = 0.f;

  const int nch = (len + CH - 1) / CH;
  for (int c = 0; c < nch; ++c) {
    const int p0 = c * CH + tg * 8;
    float sp[MAXG][8];
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
#pragma unroll
      for (int j = 0; j < 8; ++j) sp[g][j] = 0.f;
    if (p0 < len) {  // the 8 tokens share a page (ps % 8 == 0)
      const TP* kt = kp + ((size_t)trow[p0 / ps] * NKV + h) * head_stride + p0 % ps;
#pragma unroll 4
      for (int i = 0; i < dpt; ++i) {
        const int dd = dg * dpt + i;
        float kv[8];
        load8(kt + (size_t)dd * ps, kv);
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g >= G) break;
          const float qv = q_s[g][dd];
#pragma unroll
          for (int j = 0; j < 8; ++j) sp[g][j] = fmaf(qv, kv[j], sp[g][j]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
#pragma unroll
      for (int j = 0; j < 8; ++j) s_part[dg][g][tg * 8 + j] = sp[g][j];
    }
    __syncthreads();

    // Softmax: thread tid owns token tid of the chunk.
    const int tok = c * CH + tid;
    const bool valid = tok < len;
    float ksc = 1.f, vsc = 1.f;  // the token's scales (int8 pages)
    if (QUANT && valid) {
      const size_t si = ((size_t)trow[tok / ps] * NKV + h) * ps + tok % ps;
      ksc = ks[si];
      vsc = vs[si];
    }
    float s[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
      float v = 0.f;
      for (int k = 0; k < DG; ++k) v += s_part[k][g][tid];
      s[g] = valid ? v * scale * ksc : -INFINITY;
      const float mx = warp_max(s[g]);
      if (lane == 0) red_s[g][warp] = mx;
    }
    __syncthreads();
    if (tid < G) {
      float cm = red_s[tid][0];
      for (int w = 1; w < THREADS / 32; ++w) cm = fmaxf(cm, red_s[tid][w]);
      const float m_new = fmaxf(m_s[tid], cm);
      alpha_s[tid] = expf(m_s[tid] - m_new);
      m_s[tid] = m_new;
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
      const float p = valid ? expf(s[g] - m_s[g]) : 0.f;
      p_s[g][tid] = p * vsc;
      const float sm = warp_sum(p);
      if (lane == 0) red_s[g][warp] = sm;
    }
    __syncthreads();
    if (tid < G) {
      float sm = 0.f;
      for (int w = 0; w < THREADS / 32; ++w) sm += red_s[tid][w];
      l_s[tid] = l_s[tid] * alpha_s[tid] + sm;
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
      if (g < G) acc[g] *= alpha_s[g];
    // Values: batches of 4 loads of 8 tokens, all requested before use.
    for (int t = part * span; t < (part + 1) * span; t += 32) {
      float v[4][8];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int p8 = c * CH + t + 8 * u;
        if (t + 8 * u < (part + 1) * span && p8 < len)
          load8(vp + ((size_t)trow[p8 / ps] * NKV + h) * head_stride + (size_t)d * ps + p8 % ps,
                v[u]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int p8 = c * CH + t + 8 * u;
        if (t + 8 * u >= (part + 1) * span || p8 >= len) break;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (p8 + i >= len) break;
#pragma unroll
          for (int g = 0; g < MAXG; ++g)
            if (g < G) acc[g] = fmaf(p_s[g][t + 8 * u + i], v[u][i], acc[g]);
        }
      }
    }
    __syncthreads();  // p_s, s_part and red_s are rewritten by the next chunk
  }

  // The R partial rows of each head dim add up in turns (plain adds).
  for (int turn = 0; turn < R; ++turn) {
    if (part == turn) {
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
        if (g < G) o_s[g][d] += acc[g];
    }
    __syncthreads();
  }
  for (int i = tid; i < G * HD; i += THREADS) {
    const int g = i / HD, dd = i % HD;
    const float l = l_s[g];
    out[((size_t)b * NH + h * G + g) * HD + dd] = from_f<T>(l > 0.f ? o_s[g][dd] / l : 0.f);
  }
}

template <typename T, typename TP>
void launch(const void* q, const void* kp, const void* vp, const void* ks, const void* vs,
            const void* table, const void* lens, void* out, int B, int NH, int NKV, int HD, int ps,
            int W, float scale, cudaStream_t stream) {
  paged_kernel<T, TP><<<B * NKV, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const TP*>(kp), static_cast<const TP*>(vp),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(table), static_cast<const int*>(lens), static_cast<T*>(out), NH,
      NKV, HD, ps, W, scale);
}

template <typename T>
void dispatch(const void* q, const void* kp, const void* vp, const void* ks, const void* vs,
              const void* table, const void* lens, void* out, int B, int NH, int NKV, int HD,
              int ps, int W, float scale, cudaStream_t s) {
  if (ks)
    launch<T, int8_t>(q, kp, vp, ks, vs, table, lens, out, B, NH, NKV, HD, ps, W, scale, s);
  else
    launch<T, T>(q, kp, vp, ks, vs, table, lens, out, B, NH, NKV, HD, ps, W, scale, s);
}

}  // namespace

// q [B, NH, HD]; k_pages, v_pages [P, NKV, HD, ps]; k_scale, v_scale
// [P, NKV, ps] f32 for int8 pages, else null; table [B, W] int32; lens [B]
// int32; out [B, NH, HD]. q and out are f32 when is_f32, else bf16; pages
// are int8 with scales, else q's type. Needs NH / NKV <= 8, HD in
// {8, 16, 32, 64, 128} and ps % 8 == 0 (checked by the Python wrapper).
extern "C" int paged_decode_attn(const void* q, const void* k_pages, const void* v_pages,
                                 const void* k_scale, const void* v_scale, const void* table,
                                 const void* lens, void* out, int B, int NH, int NKV, int HD,
                                 int ps, int W, float scale, int is_f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B > 0) {
    if (is_f32)
      dispatch<float>(q, k_pages, v_pages, k_scale, v_scale, table, lens, out, B, NH, NKV, HD,
                      ps, W, scale, s);
    else
      dispatch<__nv_bfloat16>(q, k_pages, v_pages, k_scale, v_scale, table, lens, out, B, NH,
                              NKV, HD, ps, W, scale, s);
  }
  return static_cast<int>(cudaGetLastError());
}
