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
// element). Design: one block of 256 threads per row. Each thread keeps an
// online (max, sum of exp) pair over its strided share of the row, 16-byte
// loads where the row allows them; the pairs combine across the warp by
// shuffles and across warps in shared memory. The backward rereads the row
// (from L2 at GPT-2's 100 KB rows) to write p - onehot. The TPU wrapper's
// tiling gate (M % 8, V % 128) is not needed here: any M and V run.
#include <math.h>

#include "common.cuh"

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

template <typename T>
__global__ void __launch_bounds__(THREADS)
ce_bwd_kernel(const T* __restrict__ logits, const int* __restrict__ targets,
              const float* __restrict__ g, T* __restrict__ dlogits, int V, int ignore_index,
              bool vec) {
  const int r = blockIdx.x;
  const T* row = logits + (size_t)r * V;
  T* out = dlogits + (size_t)r * V;
  const int t = targets[r];
  float m, s;
  row_stats(row, V, vec, m, s);
  const float gl = t == ignore_index ? 0.f : g[r];
  constexpr int N = Vec<T>::N;
  if (vec) {
    for (int j = threadIdx.x * N; j < V; j += THREADS * N) {
      float x[N];
      Vec<T>::load(row + j, x);
#pragma unroll
      for (int e = 0; e < N; ++e)
        out[j + e] = from_f<T>((expf(x[e] - m) / s - (j + e == t ? 1.f : 0.f)) * gl);
    }
  } else {
    for (int j = threadIdx.x; j < V; j += THREADS)
      out[j] = from_f<T>((expf(to_f(row[j]) - m) / s - (j == t ? 1.f : 0.f)) * gl);
  }
}

template <typename T>
bool vec_ok(const void* p, int V) {
  return V % Vec<T>::N == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// logits [M, V] (bf16: is_bf16 != 0, else f32), contiguous; targets int32 [M];
// loss f32 [M].
extern "C" int softmax_ce_fwd(const void* logits, const void* targets, void* loss, int M, int V,
                              int ignore_index, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M > 0) {
    const int* t = static_cast<const int*>(targets);
    float* l = static_cast<float*>(loss);
    if (is_bf16)
      ce_fwd_kernel<__nv_bfloat16><<<M, THREADS, 0, s>>>(
          static_cast<const __nv_bfloat16*>(logits), t, l, V, ignore_index,
          vec_ok<__nv_bfloat16>(logits, V));
    else
      ce_fwd_kernel<float><<<M, THREADS, 0, s>>>(static_cast<const float*>(logits), t, l, V,
                                                 ignore_index, vec_ok<float>(logits, V));
  }
  return static_cast<int>(cudaGetLastError());
}

// g f32 [M] (the loss rows' cotangent); dlogits [M, V] in the logits' dtype.
extern "C" int softmax_ce_bwd(const void* logits, const void* targets, const void* g,
                              void* dlogits, int M, int V, int ignore_index, int is_bf16,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M > 0) {
    const int* t = static_cast<const int*>(targets);
    const float* gg = static_cast<const float*>(g);
    if (is_bf16)
      ce_bwd_kernel<__nv_bfloat16><<<M, THREADS, 0, s>>>(
          static_cast<const __nv_bfloat16*>(logits), t, gg,
          static_cast<__nv_bfloat16*>(dlogits), V, ignore_index,
          vec_ok<__nv_bfloat16>(logits, V) && vec_ok<__nv_bfloat16>(dlogits, V));
    else
      ce_bwd_kernel<float><<<M, THREADS, 0, s>>>(static_cast<const float*>(logits), t, gg,
                                                 static_cast<float*>(dlogits), V, ignore_index,
                                                 vec_ok<float>(logits, V) &&
                                                     vec_ok<float>(dlogits, V));
  }
  return static_cast<int>(cudaGetLastError());
}
