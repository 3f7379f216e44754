// paged_decode_attn: one-query GQA decode attention through a page table,
// split along the sequence (flash-decoding).
//
// Replaces the TPU kernel mila_tpu/kernels/paged_attention.py:_paged_kernel
// (entry paged_decode_attention), bf16/f32 pages under a bf16 or f32 query
// (the TPU kernel takes q in any type and the pages in theirs: an f32 query
// over bf16 pages is GPT-2's serving pair) and int8 pages with f32 scales
// [P, NKV, ps], one per (page, head, token). Pages are
// [P, NKV, HD, ps] (token-minor), so the tile of KV head h in page p is a
// contiguous [HD, ps] slab.
//
// Bound on the H100: the K/V bytes of the live tokens (2 operations per
// byte; int8 pages halve them and add 8 bytes of scales per token and
// head). A block per (row, KV head) walking the whole row leaves most SMs
// idle and waits on one chunk's loads at a time, so the grid is
// (B * NKV, S): split s of row b owns the pages [s W / S, (s + 1) W / S) of
// its table row (S is chosen on the host from B, NKV, W, ps and the SM
// count, never from seq_lens: kernels/paged_attention.py:plan_splits). The
// G = NH / NKV query heads of KV head h share the block, so each K/V element
// is read once. A block of 128 threads:
//   reads its split's page-table entries once into shared memory;
//   walks its tokens in chunks of CH (128; 64 for f32 pages of HD >= 64)
//     through a ring of stages: the next chunks' K and V rows (and int8
//     scales) are in flight through cp.async while the current one computes,
//     as the TPU kernel's start_copy / wait_copy pair does (two stages; three
//     for int8 pages, whose stages are half the size);
//   scores: thread t owns token t of the chunk (two threads per token for
//     CH 64, joined by a shuffle) and all G heads, q from shared memory;
//   online softmax in f32: the chunk max is the one block-wide reduction,
//     each thread keeps its own share of the row sum l; three barriers per
//     chunk (chunk landed, max, probabilities);
//   values: thread (d, part) owns head dim d over a run of the chunk's
//     tokens, reading 8 tokens per shared load.
// A split that starts at or beyond seq_lens[b] writes an empty partial
// (m = -inf, l = 0, o = 0) and exits. With S > 1 each split writes its
// unnormalised f32 partial o [B, NH, S, HD] and m, l [B, NH, S] into scratch
// the wrapper allocates; a second launch merges them per (row, head, dim)
// with the log-sum-exp rescale. With S == 1 the split kernel normalises and
// writes the output itself. So a call issues one CUDA launch when S == 1 and
// two when S > 1. A row of length 0 gives zeros.
// int8 pages: as in the TPU kernel the scales never touch the [HD, ps]
// tiles: k_scale[token] multiplies the token's scaled score after the q.k
// dot, v_scale[token] its probability before P.V (the row sum l adds the
// unscaled probabilities), both in f32.
// Built in two parts (kernels/_build.py: PARTS), one per query type; part 0
// (bf16 q) also holds the C entry point.
#include "common.cuh"
#include "mma.cuh"

namespace paged_parts {  // one call's arguments, and each query type's launches

struct Call {
  const void *q, *kp, *vp, *ks, *vs, *table, *lens;
  void *out, *o_part, *m_part, *l_part;
  int B, NH, NKV, HD, ps, W, S;
  float scale;
  int pages_f32;
  cudaStream_t stream;
};

int run_bf16(const Call& c);
int run_f32(const Call& c);

}  // namespace paged_parts

namespace {

constexpr int THREADS = 128, WARPS = THREADS / 32;

template <typename TP>
__device__ __forceinline__ void copy8(TP* dst, const TP* src) {  // 8 tokens of one head dim
  if constexpr (sizeof(TP) == 1) {
    cp_async8(dst, src);
  } else if constexpr (sizeof(TP) == 2) {
    cp_async16(dst, src);
  } else {
    cp_async16(dst, src);
    cp_async16(dst + 4, src + 4);
  }
}

template <typename TP>
__device__ __forceinline__ void zero8(TP* dst) {
  if constexpr (sizeof(TP) == 1) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(0, 0);
  } else if constexpr (sizeof(TP) == 2) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  } else {
    *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(dst + 4) = make_uint4(0, 0, 0, 0);
  }
}

// 8 consecutive values from shared memory (8-, 16- or 32-byte aligned).
__device__ __forceinline__ void lds8(const int8_t* p, float* v) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[i] = s8_to_f(r.x, i);
    v[4 + i] = s8_to_f(r.y, i);
  }
}

__device__ __forceinline__ void lds8(const __nv_bfloat16* p, float* v) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void lds8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ float ld1(const int8_t* p) { return static_cast<float>(*p); }
__device__ __forceinline__ float ld1(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float ld1(const float* p) { return *p; }

// Shared memory of one block (bytes), laid out as the kernel reads it.
template <typename TP, int MG, int TPT>
struct Smem {
  static constexpr int CH = THREADS / TPT;
  static constexpr bool QUANT = sizeof(TP) == 1;
  static constexpr int NST = QUANT ? 3 : 2;  // chunk stages: int8 pages prefetch two ahead
  static __host__ __device__ int row(int) { return CH * (int)sizeof(TP) + 16; }  // padded K/V row
  static __host__ __device__ int stage(int HD) { return 2 * HD * row(HD) + (QUANT ? 2 * CH * 4 : 0); }
  static __host__ __device__ int floats(int HD) { return 2 * MG * HD + MG * CH + MG * WARPS; }
  static __host__ __device__ int bytes(int HD, int pages) {
    return NST * stage(HD) + 4 * floats(HD) + 4 * pages;
  }
};

// Issues the cp.async copies of chunk [tok_c, tok_c + CH) of KV head h into
// the stage at `base` ([HD] K rows, [HD] V rows of `row` bytes, then the
// int8 scales [2][CH]); groups at or past `stop` are zeroed instead. Thread
// tid copies 8-token group tid % GPR (THREADS is a multiple of GPR) of head
// dims tid / GPR, + THREADS / GPR, ...; the 8 tokens share a page (ps % 8 ==
// 0), looked up once.
template <typename TP, int CH>
__device__ __forceinline__ void load_chunk(unsigned char* base, const TP* __restrict__ kp,
                                           const TP* __restrict__ vp,
                                           const float* __restrict__ ks,
                                           const float* __restrict__ vs, const int* tbl_s,
                                           int tok_c, int stop, int pg0, int ps, int NKV, int h,
                                           int HD, int row) {
  constexpr int GPR = CH / 8;
  const int tid = threadIdx.x, j = tid % GPR, tok = tok_c + 8 * j, rs = row / (int)sizeof(TP);
  TP* Ks = reinterpret_cast<TP*>(base);
  TP* Vs = reinterpret_cast<TP*>(base + HD * row);
  if (tok < stop) {
    const int page = tbl_s[tok / ps - pg0], off = tok % ps;
    const size_t slab = ((size_t)page * NKV + h) * HD * ps + off;
    for (int d = tid / GPR; d < HD; d += THREADS / GPR) {
      copy8(Ks + d * rs + 8 * j, kp + slab + (size_t)d * ps);
      copy8(Vs + d * rs + 8 * j, vp + slab + (size_t)d * ps);
    }
    if (sizeof(TP) == 1 && tid < GPR) {
      float* sc = reinterpret_cast<float*>(base + 2 * HD * row);
      const size_t si = ((size_t)page * NKV + h) * ps + off;
      copy8(sc + 8 * j, ks + si);
      copy8(sc + CH + 8 * j, vs + si);
    }
  } else {
    for (int d = tid / GPR; d < HD; d += THREADS / GPR) {
      zero8(Ks + d * rs + 8 * j);
      zero8(Vs + d * rs + 8 * j);
    }
  }
}

// T: q and out; TP: pages (T, or int8_t with the scale planes ks and vs);
// MG >= G query heads per KV head; TPT threads per token in the scores.
template <typename T, typename TP, int MG, int TPT>
__global__ void __launch_bounds__(THREADS)
paged_split_kernel(const T* __restrict__ q, const TP* __restrict__ kp, const TP* __restrict__ vp,
                   const float* __restrict__ ks, const float* __restrict__ vs,
                   const int* __restrict__ table, const int* __restrict__ lens,
                   T* __restrict__ out, float* __restrict__ o_part, float* __restrict__ m_part,
                   float* __restrict__ l_part, int NH, int NKV, int HD, int ps, int W, int S,
                   float scale) {
  using SM = Smem<TP, MG, TPT>;
  constexpr int CH = SM::CH, NST = SM::NST;
  constexpr bool QUANT = SM::QUANT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ROW = SM::row(HD), STAGE = SM::stage(HD);
  float* q_s = reinterpret_cast<float*>(smem + NST * STAGE);  // [MG][HD]
  float* o_s = q_s + MG * HD;                                // [MG][HD]
  float* p_s = o_s + MG * HD;                                // [MG][CH]
  float* red_s = p_s + MG * CH;                              // [MG][WARPS]
  int* tbl_s = reinterpret_cast<int*>(red_s + MG * WARPS);

  const int b = blockIdx.x / NKV, h = blockIdx.x % NKV, s = blockIdx.y;
  const int G = NH / NKV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pg0 = (int)((long long)s * W / S), pg1 = (int)((long long)(s + 1) * W / S);
  const int len = lens[b];
  // The split's page-table entries, read while the length is in flight.
  for (int i = tid; i < pg1 - pg0; i += THREADS) tbl_s[i] = table[(size_t)b * W + pg0 + i];
  const int t0 = pg0 * ps, stop = min(len, pg1 * ps);
  const size_t row0 = (size_t)b * NH + (size_t)h * G;  // first (b, query head) row

  if (t0 >= stop) {  // an empty split (or a row of length 0)
    for (int i = tid; i < G * HD; i += THREADS) {
      const int g = i / HD, d = i % HD;
      if (S == 1)
        out[(row0 + g) * HD + d] = from_f<T>(0.f);
      else
        o_part[((row0 + g) * S + s) * HD + d] = 0.f;
    }
    if (S > 1 && tid < G) {
      m_part[(row0 + tid) * S + s] = -INFINITY;
      l_part[(row0 + tid) * S + s] = 0.f;
    }
    return;
  }

  for (int i = tid; i < G * HD; i += THREADS) {
    const int g = i / HD, d = i % HD;
    q_s[g * HD + d] = to_f(q[(row0 + g) * HD + d]);
    o_s[g * HD + d] = 0.f;
  }
  __syncthreads();

  // Scores mapping: token t, head dims [dp * HD / TPT, (dp + 1) * HD / TPT).
  const int t = tid / TPT, dp = tid % TPT;
  const int dlo = dp * (HD / TPT), dhi = dlo + HD / TPT;
  // Values mapping: head dim dv over tokens [part * span, (part + 1) * span).
  const int R = THREADS / HD, dv = tid % HD, part = tid / HD, span = CH / R;

  float m_run[MG], l_run[MG], acc[MG];
#pragma unroll
  for (int g = 0; g < MG; ++g) {
    m_run[g] = -INFINITY;
    l_run[g] = 0.f;
    acc[g] = 0.f;
  }

  // A ring of NST chunk stages, NST - 1 chunks in flight: one commit group
  // per chunk (empty past the end), so chunk c has landed once at most
  // NST - 2 newer groups are pending.
  const int nch = (stop - t0 + CH - 1) / CH;
#pragma unroll
  for (int c = 0; c < NST - 1; ++c) {
    if (c < nch)
      load_chunk<TP, CH>(smem + c * STAGE, kp, vp, ks, vs, tbl_s, t0 + c * CH, stop, pg0, ps,
                         NKV, h, HD, ROW);
    cp_async_commit();
  }
  for (int c = 0; c < nch; ++c) {
    cp_async_wait<NST - 2>();
    __syncthreads();  // chunk c landed for every thread; chunk c - 1 fully read
    if (c + NST - 1 < nch)
      load_chunk<TP, CH>(smem + ((c + NST - 1) % NST) * STAGE, kp, vp, ks, vs, tbl_s,
                         t0 + (c + NST - 1) * CH, stop, pg0, ps, NKV, h, HD, ROW);
    cp_async_commit();

    const unsigned char* base = smem + (c % NST) * STAGE;
    const TP* Ks = reinterpret_cast<const TP*>(base);
    const TP* Vs = reinterpret_cast<const TP*>(base + HD * ROW);
    const int rs = ROW / (int)sizeof(TP);
    const int tok_c = t0 + c * CH;

    // Scores.
    float sc[MG];
#pragma unroll
    for (int g = 0; g < MG; ++g) sc[g] = 0.f;
    for (int d = dlo; d < dhi; d += 4) {
      const TP* kc = Ks + d * rs + t;
      const float k0 = ld1(kc), k1 = ld1(kc + rs), k2 = ld1(kc + 2 * rs), k3 = ld1(kc + 3 * rs);
#pragma unroll
      for (int g = 0; g < MG; ++g) {
        if (g < G) {
          const float4 qv = *reinterpret_cast<const float4*>(q_s + g * HD + d);
          sc[g] = fmaf(qv.x, k0, fmaf(qv.y, k1, fmaf(qv.z, k2, fmaf(qv.w, k3, sc[g]))));
        }
      }
    }
    const bool valid = tok_c + t < stop;
    float ksc = 1.f, vsc = 1.f;
    if (QUANT) {
      const float* ks_s = reinterpret_cast<const float*>(base + 2 * HD * ROW);
      ksc = ks_s[t];
      vsc = ks_s[CH + t];
    }
#pragma unroll
    for (int g = 0; g < MG; ++g) {
      if (TPT == 2) sc[g] += __shfl_xor_sync(0xffffffffu, sc[g], 1);
      sc[g] = valid ? sc[g] * scale * ksc : -INFINITY;
      const float mx = warp_max(sc[g]);
      if (lane == 0 && g < G) red_s[g * WARPS + warp] = mx;
    }
    __syncthreads();  // the chunk's per-warp maxima

    // Online softmax: the running max is block-uniform, so every thread
    // rescales its own share of l and its accumulators.
#pragma unroll
    for (int g = 0; g < MG; ++g) {
      if (g < G) {
        float cm = red_s[g * WARPS];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) cm = fmaxf(cm, red_s[g * WARPS + w]);
        const float m_new = fmaxf(m_run[g], cm);
        const float alpha = expf(m_run[g] - m_new);
        m_run[g] = m_new;
        const float p = valid ? expf(sc[g] - m_new) : 0.f;
        if (dp == 0) {
          p_s[g * CH + t] = p * vsc;
          l_run[g] = l_run[g] * alpha + p;
        }
        acc[g] *= alpha;
      }
    }
    __syncthreads();  // the chunk's probabilities

    // Values: 8 tokens per shared load; the group that straddles the end
    // drops the tokens past it (their page slots are never attended).
    for (int j = part * span; j < (part + 1) * span; j += 8) {
      const int left = stop - tok_c - j;
      if (left <= 0) break;
      float v[8];
      lds8(Vs + dv * rs + j, v);
      if (left < 8) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (i >= left) v[i] = 0.f;
      }
#pragma unroll
      for (int g = 0; g < MG; ++g) {
        if (g < G) {
          const float4 pa = *reinterpret_cast<const float4*>(p_s + g * CH + j);
          const float4 pb = *reinterpret_cast<const float4*>(p_s + g * CH + j + 4);
          float a = acc[g];
          a = fmaf(pa.x, v[0], a);
          a = fmaf(pa.y, v[1], a);
          a = fmaf(pa.z, v[2], a);
          a = fmaf(pa.w, v[3], a);
          a = fmaf(pb.x, v[4], a);
          a = fmaf(pb.y, v[5], a);
          a = fmaf(pb.z, v[6], a);
          acc[g] = fmaf(pb.w, v[7], a);
        }
      }
    }
  }

  // The split's row sums and outputs: l over the threads, o over the parts.
#pragma unroll
  for (int g = 0; g < MG; ++g) {
    if (g < G) {
      const float lw = warp_sum(l_run[g]);
      if (lane == 0) red_s[g * WARPS + warp] = lw;
      if (R == 1)
        o_s[g * HD + dv] = acc[g];
      else
        atomicAdd(&o_s[g * HD + dv], acc[g]);
    }
  }
  __syncthreads();
  for (int i = tid; i < G * HD; i += THREADS) {
    const int g = i / HD, d = i % HD;
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) l += red_s[g * WARPS + w];
    if (S == 1)
      out[(row0 + g) * HD + d] = from_f<T>(l > 0.f ? o_s[g * HD + d] / l : 0.f);
    else
      o_part[((row0 + g) * S + s) * HD + d] = o_s[g * HD + d];
  }
  if (S > 1 && tid == 0) {
#pragma unroll
    for (int g = 0; g < MG; ++g) {
      if (g < G) {
        float l = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) l += red_s[g * WARPS + w];
        m_part[(row0 + g) * S + s] = m_run[g];
        l_part[(row0 + g) * S + s] = l;
      }
    }
  }
}

// Merge of the S partials of each (row, query head, head dim): weights
// exp(m_s - max m), empty partials (l = 0) skipped.
template <typename T>
__global__ void __launch_bounds__(256)
combine_kernel(const float* __restrict__ o_part, const float* __restrict__ m_part,
               const float* __restrict__ l_part, T* __restrict__ out, int rows, int S, int HD) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * HD) return;
  const int r = i / HD, d = i % HD;
  const float* mr = m_part + (size_t)r * S;
  const float* lr = l_part + (size_t)r * S;
  float M = -INFINITY;
#pragma unroll 8
  for (int s = 0; s < S; ++s) M = fmaxf(M, mr[s]);
  float L = 0.f, O = 0.f;
  if (M > -INFINITY) {
#pragma unroll 4
    for (int s = 0; s < S; ++s) {
      if (lr[s] > 0.f) {
        const float w = expf(mr[s] - M);
        L = fmaf(lr[s], w, L);
        O = fmaf(o_part[((size_t)r * S + s) * HD + d], w, O);
      }
    }
  }
  out[i] = from_f<T>(L > 0.f ? O / L : 0.f);
}

template <typename T, typename TP, int MG, int TPT>
int launch(const void* q, const void* kp, const void* vp, const void* ks, const void* vs,
           const void* table, const void* lens, void* out, void* o_part, void* m_part,
           void* l_part, int B, int NH, int NKV, int HD, int ps, int W, int S, float scale,
           cudaStream_t stream) {
  using SM = Smem<TP, MG, TPT>;
  const int pages = (W + S - 1) / S;  // the most pages a split owns
  const int bytes = SM::bytes(HD, pages);
  auto kernel = paged_split_kernel<T, TP, MG, TPT>;
  static int allowed = 48 * 1024;
  if (bytes > allowed) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed = bytes;
  }
  kernel<<<dim3(B * NKV, S), THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const TP*>(kp), static_cast<const TP*>(vp),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(table), static_cast<const int*>(lens), static_cast<T*>(out),
      static_cast<float*>(o_part), static_cast<float*>(m_part), static_cast<float*>(l_part), NH,
      NKV, HD, ps, W, S, scale);
  if (S > 1) {
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    const int n = B * NH * HD;
    combine_kernel<T><<<(n + 255) / 256, 256, 0, stream>>>(
        static_cast<const float*>(o_part), static_cast<const float*>(m_part),
        static_cast<const float*>(l_part), static_cast<T*>(out), B * NH, S, HD);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TP, int TPT>
int by_group(int G, const void* q, const void* kp, const void* vp, const void* ks,
             const void* vs, const void* table, const void* lens, void* out, void* o_part,
             void* m_part, void* l_part, int B, int NH, int NKV, int HD, int ps, int W, int S,
             float scale, cudaStream_t st) {
#define PAGED_LAUNCH(MG)                                                                       \
  return launch<T, TP, MG, TPT>(q, kp, vp, ks, vs, table, lens, out, o_part, m_part, l_part, B, \
                                NH, NKV, HD, ps, W, S, scale, st)
  if (G <= 1) PAGED_LAUNCH(1);
  if (G <= 2) PAGED_LAUNCH(2);
  if (G <= 4) PAGED_LAUNCH(4);
  PAGED_LAUNCH(8);
#undef PAGED_LAUNCH
}

template <typename T>
int dispatch(const paged_parts::Call& c) {
  const int G = c.NH / c.NKV;
#define PAGED_BY_GROUP(TP, TPT)                                                               \
  return by_group<T, TP, TPT>(G, c.q, c.kp, c.vp, c.ks, c.vs, c.table, c.lens, c.out, c.o_part, \
                              c.m_part, c.l_part, c.B, c.NH, c.NKV, c.HD, c.ps, c.W, c.S,       \
                              c.scale, c.stream)
  if (c.ks) PAGED_BY_GROUP(int8_t, 1);
  if (c.pages_f32) {  // f32 pages: 64-token chunks keep two stages in shared memory
    if (c.HD >= 64) PAGED_BY_GROUP(float, 2);
    PAGED_BY_GROUP(float, 1);
  }
  PAGED_BY_GROUP(__nv_bfloat16, 1);
#undef PAGED_BY_GROUP
}

}  // namespace

namespace paged_parts {  // each query type's instantiations, in a part of its own

#if IN_PART(0)
int run_bf16(const Call& c) { return dispatch<__nv_bfloat16>(c); }
#endif
#if IN_PART(1)
int run_f32(const Call& c) { return dispatch<float>(c); }
#endif

}  // namespace paged_parts

#if IN_PART(0)
// q [B, NH, HD]; k_pages, v_pages [P, NKV, HD, ps]; k_scale, v_scale
// [P, NKV, ps] f32 for int8 pages, else null; table [B, W] int32; lens [B]
// int32; out [B, NH, HD]. q and out are f32 when q_f32, else bf16; pages
// are int8 with scales, else f32 when pages_f32 and bf16 otherwise, in any
// pairing with q's type (q is read in its type and the pages in theirs,
// both widened to f32; out is written in q's type). S splits per row; with
// S > 1, o_part [B, NH, S, HD], m_part and l_part [B, NH, S] f32 scratch
// (unused when S == 1). Needs NH / NKV <= 8, HD in {8, 16, 32, 64, 128},
// ps % 8 == 0 and 1 <= S <= W (checked by the Python wrapper).
extern "C" int paged_decode_attn(const void* q, const void* k_pages, const void* v_pages,
                                 const void* k_scale, const void* v_scale, const void* table,
                                 const void* lens, void* out, void* o_part, void* m_part,
                                 void* l_part, int B, int NH, int NKV, int HD, int ps, int W, int S,
                                 float scale, int q_f32, int pages_f32, void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  const paged_parts::Call c{q, k_pages, v_pages, k_scale, v_scale, table, lens, out, o_part,
                            m_part, l_part, B, NH, NKV, HD, ps, W, S, scale, pages_f32,
                            static_cast<cudaStream_t>(stream)};
  return q_f32 ? paged_parts::run_f32(c) : paged_parts::run_bf16(c);
}
#endif  // IN_PART(0)
