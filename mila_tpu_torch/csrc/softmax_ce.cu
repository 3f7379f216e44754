// softmax_ce: fused softmax cross-entropy over the last axis, forward (per-row
// loss) and backward (dlogits), for bf16 or f32 logits.
//
// Replaces the TPU kernels mila_tpu/kernels/softmax_ce.py:_ce_fwd_kernel and
// _ce_bwd_kernel (entry fused_softmax_cross_entropy, both directions):
//   fwd: loss = logsumexp(x) - x[t], 0 where t == ignore_index;
//   bwd: dlogits = (softmax(x) - onehot(t)) * g * (t != ignore_index), in
//        the logits' dtype, the softmax recomputed from the logits.
// All arithmetic in f32.
//
// Bound on the H100: bytes (the forward reads each logit once, the
// backward reads it and writes its gradient; a handful of operations per
// element). The TPU wrapper's tiling gate (M % 8, V % 128) is not needed
// here: any M and V run.
// Forward, in one of two variants that kernels/softmax_ce.py:ce_fwd_variant
// chooses from V:
//   row: one block of 256 threads per row. Each thread keeps an online
//     (max, sum of exp) pair over its strided share of the row, 16-byte
//     loads where the row allows them; the pairs combine across the warp by
//     shuffles and across warps in shared memory;
//   short: a warp per row, or 32 / L rows a warp where V <= 16 (L lanes a
//     row, the power of two at or above V), 8 warps a block. Neighbouring
//     lanes read neighbouring elements, so a warp's loads cover its rows'
//     contiguous bytes (a 40-byte row is not 16-byte aligned: no vector
//     loads); each lane's (max, sum of exp) pair and its picked logit
//     combine across the row's lanes by shuffles alone, with no shared
//     memory and no barrier. At V 10 the row variant kept 246 of a block's
//     256 threads idle and a barrier per 10 values.
// Backward: one block of 512 threads per row, in one of three variants of
// one kernel that kernels/softmax_ce.py:ce_bwd_variant chooses from V, the
// dtype and the shared-memory budget:
//   resident: the row (V * 2 bytes of bf16, 100.6 KB at GPT-2's vocab; two
//     blocks fit an SM) is read from device memory once, into shared
//     memory, by 16-byte cp.async. Each thread copies its own 16-byte
//     chunks (c = tid + k * 512) in four commit groups and reads back only
//     those, so its statistics pass runs on each group as it lands, with no
//     barrier. Before, the row was read twice and the second read came from
//     device memory again: 8 blocks of 100 KB rows on each of 132 SMs
//     overflow the 50 MB L2;
//   streamed: a row too large for the budget (f32 at large V), read from
//     device memory for the statistics and again for the gradient;
//   scalar: a row of V * size % 16 != 0 bytes, streamed one element at a time.
// Statistics without a per-element branch: per chunk (8 bf16 or 4 f32
// values) its max, then the chunk's exponentials against the new running
// max and one rescale of the running sum; exponentials by ex2 with log2(e)
// folded in. One reciprocal of the sum a row; the gradient chunk is
// (p - onehot) * g in f32, stored by one 16-byte store.
#include <math.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ void online_add(float& m, float& s, float x) {
  if (x > m) {
    s = s * expf(m - x) + 1.f;
    m = x;
  } else {
    s += expf(x - m);
  }
}

__device__ __forceinline__ void combine(float& m, float& s, float m2, float s2) {
  const float mx = fmaxf(m, m2);
  if (mx == -INFINITY) return;
  s = s * expf(m - mx) + s2 * expf(m2 - mx);
  m = mx;
}

template <typename T>
struct Vec;
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};
template <>
struct Vec<__half> {
  static constexpr int N = 8;
  __device__ static void load(const __half* p, float* out) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    out[0] = u.x, out[1] = u.y, out[2] = u.z, out[3] = u.w;
  }
};

// The row's (max, sum of exp(x - max)) in every thread of the block.
template <typename T>
__device__ void row_stats(const T* row, int V, bool vec, float& m_out, float& s_out) {
  __shared__ float sm[THREADS / 32], ss[THREADS / 32];
  float m = -INFINITY, s = 0.f;
  constexpr int N = Vec<T>::N;
  if (vec) {
    for (int j = threadIdx.x * N; j < V; j += THREADS * N) {
      float x[N];
      Vec<T>::load(row + j, x);
#pragma unroll
      for (int e = 0; e < N; ++e) online_add(m, s, x[e]);
    }
  } else {
    for (int j = threadIdx.x; j < V; j += THREADS) online_add(m, s, to_f(row[j]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
    combine(m, s, m2, s2);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    sm[warp] = m;
    ss[warp] = s;
  }
  __syncthreads();
  m = sm[0];
  s = ss[0];
#pragma unroll
  for (int w = 1; w < THREADS / 32; ++w) combine(m, s, sm[w], ss[w]);
  m_out = m;
  s_out = s;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ce_fwd_kernel(const T* __restrict__ logits, const int* __restrict__ targets,
              float* __restrict__ loss, int V, int ignore_index, bool vec) {
  const int r = blockIdx.x;
  const T* row = logits + (size_t)r * V;
  float m, s;
  row_stats(row, V, vec, m, s);
  if (threadIdx.x == 0) {
    const int t = targets[r];
    const float picked = (t >= 0 && t < V) ? to_f(row[t]) : 0.f;
    loss[r] = t == ignore_index ? 0.f : (logf(s) + m) - picked;
  }
}

constexpr int FWD_ROW = 0, FWD_SHORT = 1;  // kernels/softmax_ce.py:_FWD_VARIANTS

template <typename T, int L>
__global__ void __launch_bounds__(THREADS)
ce_fwd_short_kernel(const T* __restrict__ logits, const int* __restrict__ targets,
                    float* __restrict__ loss, int M, int V, int ignore_index) {
  constexpr int RPW = 32 / L;  // rows a warp
  const int lane = threadIdx.x & 31, c = lane % L;
  const long long r =
      ((long long)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5)) * RPW + lane / L;
  const bool live = r < M;
  const int t = live ? targets[r] : ignore_index;
  float m = -INFINITY, s = 0.f, picked = 0.f;
  if (live) {
    const T* row = logits + r * V;
    for (int j = c; j < V; j += L) {
      const float x = to_f(row[j]);
      online_add(m, s, x);
      if (j == t) picked = x;
    }
  }
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
    combine(m, s, m2, s2);
    picked += __shfl_xor_sync(0xffffffffu, picked, o);
  }
  if (live && c == 0) loss[r] = t == ignore_index ? 0.f : (logf(s) + m) - picked;
}

template <typename T, int L>
void launch_fwd_short(const T* logits, const int* t, float* l, int M, int V, int ignore_index,
                      cudaStream_t s) {
  constexpr int rows = THREADS / 32 * (32 / L);
  ce_fwd_short_kernel<T, L><<<(M + rows - 1) / rows, THREADS, 0, s>>>(logits, t, l, M, V,
                                                                       ignore_index);
}

constexpr int BWD_THREADS = 512;
constexpr int RESIDENT = 0, STREAMED = 1, SCALAR = 2;  // kernels/softmax_ce.py:_BWD_VARIANTS

// Adds n values (f32) to the running (max, sum of 2^((x - max) log2 e)).
template <int N>
__device__ __forceinline__ void chunk_add(float& m, float& s, const float* v) {
  float cm = v[0];
#pragma unroll
  for (int e = 1; e < N; ++e) cm = fmaxf(cm, v[e]);
  const float mn = fmaxf(m, cm);
  if (mn == -INFINITY) return;
  float add = 0.f;
#pragma unroll
  for (int e = 0; e < N; ++e) add += ex2((v[e] - mn) * LOG2E);
  s = s * ex2((m - mn) * LOG2E) + add;
  m = mn;
}

__device__ __forceinline__ void combine2(float& m, float& s, float m2, float s2) {
  const float mx = fmaxf(m, m2);
  if (mx == -INFINITY) return;
  s = s * ex2((m - mx) * LOG2E) + s2 * ex2((m2 - mx) * LOG2E);
  m = mx;
}

// N values of a chunk as f32 (N = 1: one element), and back.
template <typename T, int N>
__device__ __forceinline__ void load_chunk(const T* p, float* v) {
  if constexpr (N == 1)
    v[0] = to_f(*p);
  else
    Vec<T>::load(p, v);
}
template <int N>
__device__ __forceinline__ void store_chunk(float* p, const float* v) {
  if constexpr (N == 1)
    *p = v[0];
  else
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
template <int N>
__device__ __forceinline__ void store_chunk(__nv_bfloat16* p, const float* v) {
  if constexpr (N == 1) {
    *p = __float2bfloat16_rn(v[0]);
  } else {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]), pack2(v[6], v[7]));
  }
}

__device__ __forceinline__ uint32_t pack2_half(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <int N>
__device__ __forceinline__ void store_chunk(__half* p, const float* v) {
  if constexpr (N == 1) {
    *p = __float2half_rn(v[0]);
  } else {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack2_half(v[0], v[1]), pack2_half(v[2], v[3]), pack2_half(v[4], v[5]),
                   pack2_half(v[6], v[7]));
  }
}

__device__ __forceinline__ void wait_groups_after(int q) {  // groups 0..q of 4 have landed
  if (q == 0) cp_async_wait<3>();
  else if (q == 1) cp_async_wait<2>();
  else if (q == 2) cp_async_wait<1>();
  else cp_async_wait<0>();
}

template <typename T, int VAR>
__global__ void __launch_bounds__(BWD_THREADS, 2)
ce_bwd_kernel(const T* __restrict__ logits, const int* __restrict__ targets,
              const float* __restrict__ g, T* __restrict__ dlogits, int V, int ignore_index) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red_m[BWD_THREADS / 32], red_s[BWD_THREADS / 32];
  constexpr int N = VAR == SCALAR ? 1 : Vec<T>::N;
  const int r = blockIdx.x, tid = threadIdx.x;
  const T* row = logits + (size_t)r * V;
  T* out = dlogits + (size_t)r * V;
  const int chunks = V / N;  // V % N == 0 unless SCALAR (N = 1)
  const int kmax = (chunks + BWD_THREADS - 1) / BWD_THREADS, kg = (kmax + 3) / 4;

  float m = -INFINITY, s = 0.f;
  const T* src = row;
  if constexpr (VAR == RESIDENT) {
    T* buf = reinterpret_cast<T*>(smem);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      for (int k = q * kg; k < (q + 1) * kg; ++k) {
        const int c = tid + k * BWD_THREADS;
        if (c < chunks) cp_async16(buf + (size_t)c * N, row + (size_t)c * N);
      }
      cp_async_commit();
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      wait_groups_after(q);  // this thread's own chunks of group q, visible to it
      for (int k = q * kg; k < (q + 1) * kg; ++k) {
        const int c = tid + k * BWD_THREADS;
        if (c < chunks) {
          float v[N];
          load_chunk<T, N>(buf + (size_t)c * N, v);
          chunk_add<N>(m, s, v);
        }
      }
    }
    src = buf;
  } else {
    for (int c = tid; c < chunks; c += BWD_THREADS) {
      float v[N];
      load_chunk<T, N>(row + (size_t)c * N, v);
      chunk_add<N>(m, s, v);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    combine2(m, s, __shfl_xor_sync(0xffffffffu, m, o), __shfl_xor_sync(0xffffffffu, s, o));
  if ((tid & 31) == 0) {
    red_m[tid >> 5] = m;
    red_s[tid >> 5] = s;
  }
  __syncthreads();
  m = red_m[0];
  s = red_s[0];
#pragma unroll
  for (int w = 1; w < BWD_THREADS / 32; ++w) combine2(m, s, red_m[w], red_s[w]);

  const int t = targets[r];
  const float gl = t == ignore_index ? 0.f : g[r];
  const float inv = 1.f / s;
  for (int c = tid; c < chunks; c += BWD_THREADS) {
    float v[N];
    load_chunk<T, N>(src + (size_t)c * N, v);
#pragma unroll
    for (int e = 0; e < N; ++e)
      v[e] = fmaf(ex2((v[e] - m) * LOG2E), inv, c * N + e == t ? -1.f : 0.f) * gl;
    store_chunk<N>(out + (size_t)c * N, v);
  }
}

template <typename T>
bool vec_ok(const void* p, int V) {
  return V % Vec<T>::N == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, int VAR>
int launch_bwd(const void* logits, const int* t, const float* g, void* dlogits, int M, int V,
               int ignore_index, cudaStream_t s) {
  const int smem = VAR == RESIDENT ? V * (int)sizeof(T) : 0;
  auto kern = ce_bwd_kernel<T, VAR>;
  static int allowed = 48 * 1024;
  if (smem > allowed) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed = smem;
  }
  kern<<<M, BWD_THREADS, smem, s>>>(static_cast<const T*>(logits), t, g,
                                    static_cast<T*>(dlogits), V, ignore_index);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd(int variant, const void* logits, const int* t, const float* g, void* dlogits, int M,
        int V, int ignore_index, cudaStream_t s) {
  if (variant == RESIDENT)
    return launch_bwd<T, RESIDENT>(logits, t, g, dlogits, M, V, ignore_index, s);
  if (variant == STREAMED)
    return launch_bwd<T, STREAMED>(logits, t, g, dlogits, M, V, ignore_index, s);
  return launch_bwd<T, SCALAR>(logits, t, g, dlogits, M, V, ignore_index, s);
}

template <typename T>
void launch_fwd(int variant, const void* logits, const int* t, float* l, int M, int V,
                int ignore_index, cudaStream_t s) {
  const T* x = static_cast<const T*>(logits);
  if (variant != FWD_SHORT) {
    ce_fwd_kernel<T><<<M, THREADS, 0, s>>>(x, t, l, V, ignore_index, vec_ok<T>(logits, V));
  } else if (V <= 1) {
    launch_fwd_short<T, 1>(x, t, l, M, V, ignore_index, s);
  } else if (V <= 2) {
    launch_fwd_short<T, 2>(x, t, l, M, V, ignore_index, s);
  } else if (V <= 4) {
    launch_fwd_short<T, 4>(x, t, l, M, V, ignore_index, s);
  } else if (V <= 8) {
    launch_fwd_short<T, 8>(x, t, l, M, V, ignore_index, s);
  } else if (V <= 16) {
    launch_fwd_short<T, 16>(x, t, l, M, V, ignore_index, s);
  } else {
    launch_fwd_short<T, 32>(x, t, l, M, V, ignore_index, s);
  }
}

}  // namespace

// logits [M, V] (dtype: 0 f32, 1 bf16, 2 fp16), contiguous; targets int32
// [M]; loss f32 [M]. variant 0 row, 1 short (kernels/softmax_ce.py's
// ce_fwd_variant).
extern "C" int softmax_ce_fwd(const void* logits, const void* targets, void* loss, int M, int V,
                              int ignore_index, int dtype, int variant, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype < 0 || dtype > 2) return static_cast<int>(cudaErrorInvalidValue);
  if (M > 0) {
    const int* t = static_cast<const int*>(targets);
    float* l = static_cast<float*>(loss);
    if (dtype == 1)
      launch_fwd<__nv_bfloat16>(variant, logits, t, l, M, V, ignore_index, s);
    else if (dtype == 2)
      launch_fwd<__half>(variant, logits, t, l, M, V, ignore_index, s);
    else
      launch_fwd<float>(variant, logits, t, l, M, V, ignore_index, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// g f32 [M] (the loss rows' cotangent); dlogits [M, V] in the logits' dtype.
// variant 0 resident, 1 streamed, 2 scalar (kernels/softmax_ce.py's
// ce_bwd_variant): 0 and 1 need V * size % 16 == 0 and 16-byte aligned
// logits and dlogits; 0 needs V * size bytes of shared memory a block.
extern "C" int softmax_ce_bwd(const void* logits, const void* targets, const void* g,
                              void* dlogits, int M, int V, int ignore_index, int dtype,
                              int variant, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype < 0 || dtype > 2) return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 0) return static_cast<int>(cudaGetLastError());
  const int* t = static_cast<const int*>(targets);
  const float* gg = static_cast<const float*>(g);
  if (dtype == 1) return bwd<__nv_bfloat16>(variant, logits, t, gg, dlogits, M, V, ignore_index, s);
  if (dtype == 2) return bwd<__half>(variant, logits, t, gg, dlogits, M, V, ignore_index, s);
  return bwd<float>(variant, logits, t, gg, dlogits, M, V, ignore_index, s);
}
