// fused_adamw: one AdamW update of one flat parameter leaf in one pass.
//
// Replaces the TPU kernel mila_tpu/kernels/fused_adamw.py:_adamw_kernel
// (entry fused_adamw_update). Per element, in f32:
//   g  = g * grad_scale                (the global-norm clip; 1 leaves g)
//   m' = b1 * m + (1 - b1) * g
//   v' = b2 * v + (1 - b2) * g * g
//   w' = w - lr * ((m' / bc1) / (sqrt(v' / bc2) + eps) + wd * w)
// with w the f32 master where there is one, else the parameter itself; the
// parameter is written back as w' rounded to its dtype (nearest even), or,
// for a bf16 parameter with a master, stochastically: (bits(w') + (noise & 0xffff)) &
// 0xffff0000, the TPU kernel's construction, from caller-supplied uint32
// noise (the TPU kernel draws it with jax.random.bits; the caller here draws
// it from a torch.Generator, so a test can feed JAX's bits). An fp16
// parameter is rounded to nearest, master or not: JAX's kernel does so, and
// JAX's AdamW, whose fp16 "stochastic" rounding steps to the neighbouring
// f32 value and casts back, gives the nearest fp16 value too.
//
// Bound on the H100: bytes (about 30 bytes per element read or written
// against ~12 operations): one pass, each thread 4 consecutive elements
// (16-byte loads of the f32 streams). The arithmetic is written with
// __fmul_rn / __fadd_rn / __fdiv_rn / __fsqrt_rn, in the plain version's
// order, so nvcc contracts nothing into an FMA: the kernel's f32 results
// equal the plain PyTorch version's bit for bit, and so does the rounded
// bf16 parameter, given the same noise. bc1 = 1 - b1^t and bc2 are f32
// values the caller computes once per step, as JAX does.
#include "common.cuh"

namespace {

struct Hyper {
  float lr, b1, omb1, b2, omb2, eps, wd, bc1, bc2, gs;
};

__device__ __forceinline__ float load_f(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float load_f(const __half* p, size_t i) { return __half2float(p[i]); }

template <typename P>
__device__ __forceinline__ void store_p(P* p, size_t i, float w, uint32_t noise, bool sr);
template <>
__device__ __forceinline__ void store_p<float>(float* p, size_t i, float w, uint32_t, bool) {
  p[i] = w;
}
template <>
__device__ __forceinline__ void store_p<__nv_bfloat16>(__nv_bfloat16* p, size_t i, float w,
                                                       uint32_t noise, bool sr) {
  if (sr) {
    const uint32_t bits = (__float_as_uint(w) + (noise & 0xffffu)) & 0xffff0000u;
    p[i] = __float2bfloat16_rn(__uint_as_float(bits));  // exact: the low half is 0
  } else {
    p[i] = __float2bfloat16_rn(w);
  }
}
template <>
__device__ __forceinline__ void store_p<__half>(__half* p, size_t i, float w, uint32_t, bool) {
  p[i] = __float2half_rn(w);
}

// One element of the update; returns the new f32 parameter.
__device__ __forceinline__ float adamw_elem(const Hyper& h, float g, float w, float& m,
                                            float& v) {
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.omb2, g), g));
  const float mh = __fdiv_rn(m, h.bc1);
  const float vh = __fdiv_rn(v, h.bc2);
  const float upd = __fadd_rn(__fdiv_rn(mh, __fadd_rn(__fsqrt_rn(vh), h.eps)), __fmul_rn(h.wd, w));
  return __fsub_rn(w, __fmul_rn(h.lr, upd));
}

template <typename P, typename G>
__global__ void __launch_bounds__(256)
adamw_kernel(const P* __restrict__ p, const G* __restrict__ g, const float* __restrict__ m,
             const float* __restrict__ v, const float* __restrict__ master,
             const uint32_t* __restrict__ noise, P* __restrict__ p_out, float* __restrict__ m_out,
             float* __restrict__ v_out, float* __restrict__ master_out, size_t n, Hyper h) {
  const bool sr = noise != nullptr;
  const size_t stride = (size_t)gridDim.x * blockDim.x * 4;
  for (size_t i0 = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4; i0 < n; i0 += stride) {
    if (i0 + 4 <= n) {
      const float4 m4 = *reinterpret_cast<const float4*>(m + i0);
      const float4 v4 = *reinterpret_cast<const float4*>(v + i0);
      float mm[4] = {m4.x, m4.y, m4.z, m4.w}, vv[4] = {v4.x, v4.y, v4.z, v4.w}, ww[4];
      if (master != nullptr) {
        const float4 w4 = *reinterpret_cast<const float4*>(master + i0);
        ww[0] = w4.x, ww[1] = w4.y, ww[2] = w4.z, ww[3] = w4.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) ww[e] = load_f(p, i0 + e);
      }
      uint4 nz = make_uint4(0u, 0u, 0u, 0u);
      if (sr) nz = *reinterpret_cast<const uint4*>(noise + i0);
      const uint32_t nn[4] = {nz.x, nz.y, nz.z, nz.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ww[e] = adamw_elem(h, __fmul_rn(load_f(g, i0 + e), h.gs), ww[e], mm[e], vv[e]);
        store_p(p_out, i0 + e, ww[e], nn[e], sr);
      }
      *reinterpret_cast<float4*>(m_out + i0) = make_float4(mm[0], mm[1], mm[2], mm[3]);
      *reinterpret_cast<float4*>(v_out + i0) = make_float4(vv[0], vv[1], vv[2], vv[3]);
      if (master_out != nullptr)
        *reinterpret_cast<float4*>(master_out + i0) = make_float4(ww[0], ww[1], ww[2], ww[3]);
    } else {
      for (size_t i = i0; i < n; ++i) {
        float mi = m[i], vi = v[i];
        const float w = adamw_elem(h, __fmul_rn(load_f(g, i), h.gs),
                                   master != nullptr ? master[i] : load_f(p, i), mi, vi);
        store_p(p_out, i, w, sr ? noise[i] : 0u, sr);
        m_out[i] = mi;
        v_out[i] = vi;
        if (master_out != nullptr) master_out[i] = w;
      }
    }
  }
}

template <typename P, typename G>
int launch(const void* p, const void* g, const void* m, const void* v, const void* master,
           const void* noise, void* p_out, void* m_out, void* v_out, void* master_out, size_t n,
           const Hyper& h, cudaStream_t stream) {
  const size_t quads = (n + 3) / 4;
  const int blocks = static_cast<int>(quads < (size_t)132 * 16 * 256 ? (quads + 255) / 256
                                                                    : (size_t)132 * 16);
  adamw_kernel<P, G><<<blocks, 256, 0, stream>>>(
      static_cast<const P*>(p), static_cast<const G*>(g), static_cast<const float*>(m),
      static_cast<const float*>(v), static_cast<const float*>(master),
      static_cast<const uint32_t*>(noise), static_cast<P*>(p_out), static_cast<float*>(m_out),
      static_cast<float*>(v_out), static_cast<float*>(master_out), n, h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// p, p_out: n elements of the parameter's dtype (p_dtype: 0 f32, 1 bf16, 2
// fp16); g of p's dtype (g_half != 0, only with a bf16 or fp16 parameter)
// or f32, scaled by grad_scale in f32 first (the global-norm clip); m, v,
// m_out, v_out f32; master and master_out f32 or both null; noise uint32
// or null (null: round to nearest; only a bf16 parameter reads it). Every
// pointer 16-byte aligned and contiguous. The outputs may alias their
// inputs (each element is read before it is written, by the same thread).
extern "C" int fused_adamw(const void* p, const void* g, const void* m, const void* v,
                           const void* master, const void* noise, void* p_out, void* m_out,
                           void* v_out, void* master_out, long long n, int p_dtype, int g_half,
                           float lr, float b1, float omb1, float b2, float omb2, float eps,
                           float wd, float bc1, float bc2, float grad_scale, void* stream) {
  const Hyper h{lr, b1, omb1, b2, omb2, eps, wd, bc1, bc2, grad_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t N = static_cast<size_t>(n);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (p_dtype == 1 && g_half)
    return launch<__nv_bfloat16, __nv_bfloat16>(p, g, m, v, master, noise, p_out, m_out, v_out,
                                                master_out, N, h, s);
  if (p_dtype == 1)
    return launch<__nv_bfloat16, float>(p, g, m, v, master, noise, p_out, m_out, v_out,
                                        master_out, N, h, s);
  if (p_dtype == 2 && g_half)
    return launch<__half, __half>(p, g, m, v, master, nullptr, p_out, m_out, v_out, master_out,
                                  N, h, s);
  if (p_dtype == 2)
    return launch<__half, float>(p, g, m, v, master, nullptr, p_out, m_out, v_out, master_out,
                                 N, h, s);
  if (p_dtype != 0 || g_half) return static_cast<int>(cudaErrorInvalidValue);
  return launch<float, float>(p, g, m, v, master, noise, p_out, m_out, v_out, master_out, N, h,
                              s);
}
