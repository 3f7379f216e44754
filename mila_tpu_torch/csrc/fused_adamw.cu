// fused_adamw: AdamW over every parameter leaf of a step in one launch per
// (param dtype, grad dtype) group, and the global-norm clip's factor in one
// launch over every gradient leaf.
//
// Replaces the TPU kernel mila_tpu/kernels/fused_adamw.py:_adamw_kernel
// (entry fused_adamw_update; optim.AdamW.step reaches the same per-leaf
// function, mila_tpu/optim/adamw.py:upd). Per element, in f32:
//   g  = g * grad_scale                (the global-norm clip; 1 leaves g)
//   m' = b1 * m + (1 - b1) * g
//   v' = b2 * v + (1 - b2) * g * g
//   w' = w - lr * ((m' / bc1) / (sqrt(v' / bc2) + eps) + wd * w)
// with w the f32 master where there is one, else the parameter itself; the
// parameter is written back as w' rounded to its dtype (nearest even), or,
// for a bf16 parameter with a master, stochastically: (bits(w') + (noise &
// 0xffff)) & 0xffff0000, the TPU kernel's construction. An fp16 parameter
// is rounded to nearest, master or not, as JAX's kernel and JAX's AdamW
// give it (ROADMAP §C.3).
//
// The noise is JAX's own: element i of a leaf draws (x0 ^ x1) & 0xffff with
// (x0, x1) = Threefry-2x32-20(leaf_key, (i >> 32, i)), which is
// jax.random.bits(leaf_key, shape, uint32).ravel()[i] with
// jax_threefry_partitionable; the leaf's key is Threefry(step_key, (0, id)),
// which is split(step_key, n)[id] (AdamW.step: id the leaf's index in JAX's
// tree order) and fold_in(step_key, id) (fused_adamw_update's seed). The
// TPU kernel took its bits from the core's PRNG inside the kernel; drawing
// them here removes a 4-byte noise stream from the update and keeps the
// port's rounding bit-equal to JAX's. A caller may still pass its own bits
// per leaf (the tests feed JAX's).
//
// Bound on the H100: bytes. The update reads g, m, v and the master (2 + 4
// + 4 + 4 bytes an element in bf16) and writes p, m, v and the master (2 +
// 4 + 4 + 4), and the norm reads g once more: 30 bytes against about 12 f32
// operations and, where it rounds stochastically, some 75 integer ones of
// the draw. Design: a table of leaves in the kernel parameters (CUDA 12.1+
// takes 32,764 bytes of them on sm_90; __grid_constant__ keeps the table in
// parameter space), one block per chunk of one leaf (the block finds its
// leaf by a binary search over the leaves' first chunks), so a 2048-element
// leaf and a 262.7M-element one share one launch and every block has the
// same work but a leaf's last. A chunk is 32768 elements, or as few as 2048
// (each thread's 8 once) where a step has too few elements to fill the card
// eight blocks an SM deep: a small model's blocks then do not walk 16
// dependent iterations each; each thread takes 8 elements at
// a time in 16-byte loads and stores, and issues its 8 draws after the loads
// (independent of them, they run while the loads are in flight). The output
// streams are flat buffers of the group; each leaf starts at a multiple of
// 8 elements. No host value is read back and nothing is allocated, so a
// step can be captured in a CUDA graph.
//
// The arithmetic is written with __fmul_rn / __fadd_rn / __fdiv_rn /
// __fsqrt_rn, in the plain version's order, so nvcc contracts nothing into
// an FMA: the kernel's f32 results equal the plain PyTorch version's bit for
// bit, and so does the rounded parameter. bc1 = 1 - b1^t and bc2 are f32
// values the caller computes once per step, as JAX does.
//
// The norm: one launch over every gradient leaf (any mix of f32, bf16 and
// fp16), a fixed grid, each block a partial sum of g^2 in f32 over a fixed
// set of chunks; the last block to finish (an integer ticket, no float
// atomics) adds the partials in a fixed order and writes
// min(1, clip / (sqrt(s) + 1e-6)) and sqrt(s) as device f32 values, which
// the update reads. Two calls on the same gradients are bit-equal.
#include <cstring>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;  // elements a thread takes at a time
constexpr int NORM_BLOCKS = 132 * 4;

struct Hyper {
  float lr, b1, omb1, b2, omb2, eps, wd, bc1, bc2;
};

// One leaf of an update launch (72 bytes; kernels/fused_adamw.py: LEAF).
struct Leaf {
  const void* p;          // the param (read only where there is no master)
  const void* g;          // the gradient, of the param's dtype or f32
  const float* m;
  const float* v;
  const float* w;         // the f32 master, or null
  const uint32_t* noise;  // the caller's bits, or null: drawn here
  long long n;
  long long out;          // the leaf's first element in the group's outputs
  int chunk0;             // the leaf's first chunk
  uint32_t id;            // its counter under the step key
};
static_assert(sizeof(Leaf) == 72, "Leaf must match kernels/fused_adamw.py");

template <int L>
struct Leaves {
  Leaf leaf[L];
};

struct Step {
  void* p_out;
  float* m_out;
  float* v_out;
  float* w_out;          // null where the group has no master
  const float* scale;    // the clip factor on the device, or null: gs
  const uint32_t* key;   // the step key on the device (2 words), or null: k0, k1
  float gs;
  uint32_t k0, k1;
  int nleaves;
  int chunk;             // elements a block takes (a multiple of THREADS * VEC)
  Hyper h;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

// Threefry-2x32 with 20 rounds (Salmon et al. 2011; JAX's threefry_2x32).
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1, uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
#define MILA_TF_ROUND(r) \
  x0 += x1;              \
  x1 = rotl(x1, r);      \
  x1 ^= x0;
#define MILA_TF_EVEN MILA_TF_ROUND(13) MILA_TF_ROUND(15) MILA_TF_ROUND(26) MILA_TF_ROUND(6)
#define MILA_TF_ODD MILA_TF_ROUND(17) MILA_TF_ROUND(29) MILA_TF_ROUND(16) MILA_TF_ROUND(24)
  MILA_TF_EVEN x0 += k1; x1 += k2 + 1u;
  MILA_TF_ODD  x0 += k2; x1 += k0 + 2u;
  MILA_TF_EVEN x0 += k0; x1 += k1 + 3u;
  MILA_TF_ODD  x0 += k1; x1 += k2 + 4u;
  MILA_TF_EVEN x0 += k2; x1 += k0 + 5u;
#undef MILA_TF_EVEN
#undef MILA_TF_ODD
#undef MILA_TF_ROUND
}

// The 16 bits of noise of element i under a leaf key.
__device__ __forceinline__ uint32_t draw16(uint32_t lk0, uint32_t lk1, unsigned long long i) {
  uint32_t x0 = static_cast<uint32_t>(i >> 32), x1 = static_cast<uint32_t>(i);
  threefry(lk0, lk1, x0, x1);
  return (x0 ^ x1) & 0xffffu;
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

// 8 consecutive values of a stream as f32, by 16-byte loads.
__device__ __forceinline__ void load8(const float* p, float* x) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w, x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* x) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x, x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const __half* p, float* x) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(h[i]);
    x[2 * i] = f.x, x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float* x) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ uint32_t bits2(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t bits2(__half2 v) { return *reinterpret_cast<uint32_t*>(&v); }

// The rounded parameter: f32 as it is; bf16 and fp16 to nearest, or bf16
// stochastically from the element's 16 noise bits.
__device__ __forceinline__ float sr_bf16(float w, uint32_t noise) {
  // exact as bf16: the low half is 0
  return __uint_as_float((__float_as_uint(w) + noise) & 0xffff0000u);
}
__device__ __forceinline__ void store_p8(float* p, const float* w, const uint32_t*, bool) {
  store8(p, w);
}
__device__ __forceinline__ void store_p8(__nv_bfloat16* p, const float* w, const uint32_t* nz,
                                         bool sr) {
  uint32_t u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float a = sr ? sr_bf16(w[2 * i], nz[2 * i]) : w[2 * i];
    const float b = sr ? sr_bf16(w[2 * i + 1], nz[2 * i + 1]) : w[2 * i + 1];
    u[i] = bits2(__floats2bfloat162_rn(a, b));
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
}
__device__ __forceinline__ void store_p8(__half* p, const float* w, const uint32_t*, bool) {
  uint32_t u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) u[i] = bits2(__floats2half2_rn(w[2 * i], w[2 * i + 1]));
  *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
}
__device__ __forceinline__ void store_p1(float* p, float w, uint32_t, bool) { *p = w; }
__device__ __forceinline__ void store_p1(__nv_bfloat16* p, float w, uint32_t nz, bool sr) {
  *p = __float2bfloat16_rn(sr ? sr_bf16(w, nz) : w);
}
__device__ __forceinline__ void store_p1(__half* p, float w, uint32_t, bool) {
  *p = __float2half_rn(w);
}

// The leaf whose chunks hold chunk c: the last with chunk0 <= c (an empty
// leaf shares its chunk0 with the next and is skipped).
template <typename Table>
__device__ __forceinline__ int find_leaf(const Table& t, int nleaves, int c) {
  int lo = 0, hi = nleaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.leaf[mid].chunk0 <= c) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

template <typename P, typename G, int L>
__global__ void __launch_bounds__(THREADS)
adamw_step_kernel(const __grid_constant__ Step st, const __grid_constant__ Leaves<L> tab) {
  const Leaf& lf = tab.leaf[find_leaf(tab, st.nleaves, blockIdx.x)];
  const long long start = (long long)(blockIdx.x - lf.chunk0) * st.chunk;
  const long long end = min(lf.n, start + st.chunk);
  const float gs = st.scale != nullptr ? *st.scale : st.gs;
  const bool sr = std::is_same<P, __nv_bfloat16>::value && lf.w != nullptr;
  const bool draw = sr && lf.noise == nullptr;
  uint32_t lk0 = 0, lk1 = 0;
  if (draw) {
    const uint32_t k0 = st.key != nullptr ? st.key[0] : st.k0;
    const uint32_t k1 = st.key != nullptr ? st.key[1] : st.k1;
    lk0 = 0u, lk1 = lf.id;
    threefry(k0, k1, lk0, lk1);
  }
  const P* p = static_cast<const P*>(lf.p);
  const G* g = static_cast<const G*>(lf.g);
  P* po = static_cast<P*>(st.p_out) + lf.out;
  float* mo = st.m_out + lf.out;
  float* vo = st.v_out + lf.out;
  float* wo = st.w_out != nullptr ? st.w_out + lf.out : nullptr;

  for (long long i0 = start + threadIdx.x * VEC; i0 < end; i0 += THREADS * VEC) {
    if (i0 + VEC <= end) {
      float gg[VEC], mm[VEC], vv[VEC], ww[VEC];
      uint32_t nz[VEC] = {};
      load8(g + i0, gg);
      load8(lf.m + i0, mm);
      load8(lf.v + i0, vv);
      if (lf.w != nullptr) load8(lf.w + i0, ww);
      else load8(p + i0, ww);
      if (draw) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) nz[e] = draw16(lk0, lk1, i0 + e);
      } else if (sr) {
        const uint4 a = *reinterpret_cast<const uint4*>(lf.noise + i0);
        const uint4 b = *reinterpret_cast<const uint4*>(lf.noise + i0 + 4);
        nz[0] = a.x, nz[1] = a.y, nz[2] = a.z, nz[3] = a.w;
        nz[4] = b.x, nz[5] = b.y, nz[6] = b.z, nz[7] = b.w;
#pragma unroll
        for (int e = 0; e < VEC; ++e) nz[e] &= 0xffffu;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) ww[e] = adamw_elem(st.h, __fmul_rn(gg[e], gs), ww[e], mm[e], vv[e]);
      store_p8(po + i0, ww, nz, sr);
      store8(mo + i0, mm);
      store8(vo + i0, vv);
      if (wo != nullptr) store8(wo + i0, ww);
    } else {
      for (long long i = i0; i < end; ++i) {
        float mi = lf.m[i], vi = lf.v[i];
        const float w = adamw_elem(st.h, __fmul_rn(to_f(g[i]), gs),
                                   lf.w != nullptr ? lf.w[i] : to_f(p[i]), mi, vi);
        uint32_t nzi = 0;
        if (draw) nzi = draw16(lk0, lk1, i);
        else if (sr) nzi = lf.noise[i] & 0xffffu;
        store_p1(po + i, w, nzi, sr);
        mo[i] = mi;
        vo[i] = vi;
        if (wo != nullptr) wo[i] = w;
      }
    }
  }
}

// The table travels by value in the kernel's parameters, so a launch
// copies as many bytes as its capacity: three capacities (a one-leaf or
// small model's step, a mid-sized tree, up to 448 leaves).
template <typename P, typename G, int L>
void launch_step_at(const void* table, int nleaves, int nchunks, const Step& st,
                    cudaStream_t s) {
  Leaves<L> t;
  memcpy(t.leaf, table, sizeof(Leaf) * nleaves);
  adamw_step_kernel<P, G, L><<<nchunks, THREADS, 0, s>>>(st, t);
}

template <typename P, typename G>
int launch_step(const void* table, int nleaves, int nchunks, const Step& st, cudaStream_t s) {
  if (nleaves <= 8) launch_step_at<P, G, 8>(table, nleaves, nchunks, st, s);
  else if (nleaves <= 64) launch_step_at<P, G, 64>(table, nleaves, nchunks, st, s);
  else launch_step_at<P, G, 448>(table, nleaves, nchunks, st, s);
  return static_cast<int>(cudaGetLastError());
}

// One gradient leaf of the norm (24 bytes; kernels/fused_adamw.py: NORM_LEAF).
struct NormLeaf {
  const void* g;
  long long n;
  int chunk0;
  int dtype;  // 0 f32, 1 bf16, 2 fp16
};
static_assert(sizeof(NormLeaf) == 24, "NormLeaf must match kernels/fused_adamw.py");

template <int L>
struct NormLeaves {
  NormLeaf leaf[L];
};

template <typename T>
__device__ __forceinline__ float sumsq_chunk(const T* g, long long start, long long end) {
  float acc = 0.f;
  for (long long i0 = start + threadIdx.x * VEC; i0 < end; i0 += THREADS * VEC) {
    if (i0 + VEC <= end) {
      float x[VEC];
      load8(g + i0, x);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc = fmaf(x[e], x[e], acc);
    } else {
      for (long long i = i0; i < end; ++i) {
        const float x = to_f(g[i]);
        acc = fmaf(x, x, acc);
      }
    }
  }
  return acc;
}

// The block's sum of v over its threads, in a fixed order, in every thread.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float part[THREADS / 32];
  __syncthreads();  // part[] may still be read from an earlier call
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) s += part[w];
  return s;
}

template <int L>
__global__ void __launch_bounds__(THREADS)
clip_norm_kernel(const __grid_constant__ NormLeaves<L> tab, int nleaves, int nchunks, int chunk,
                 float clip, float* __restrict__ partial, unsigned int* __restrict__ done,
                 float* __restrict__ out) {
  float acc = 0.f;
  for (int c = blockIdx.x; c < nchunks; c += gridDim.x) {
    const NormLeaf& lf = tab.leaf[find_leaf(tab, nleaves, c)];
    const long long start = (long long)(c - lf.chunk0) * chunk;
    const long long end = min(lf.n, start + chunk);
    if (lf.dtype == 1)
      acc += sumsq_chunk(static_cast<const __nv_bfloat16*>(lf.g), start, end);
    else if (lf.dtype == 2)
      acc += sumsq_chunk(static_cast<const __half*>(lf.g), start, end);
    else
      acc += sumsq_chunk(static_cast<const float*>(lf.g), start, end);
  }
  const float blk = block_sum(acc);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = blk;
    __threadfence();
    last = atomicAdd(done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float s = 0.f;
  for (int b = threadIdx.x; b < gridDim.x; b += THREADS) s += __ldcg(partial + b);
  s = block_sum(s);
  if (threadIdx.x == 0) {
    const float norm = __fsqrt_rn(s);
    out[0] = fminf(1.f, __fdiv_rn(clip, __fadd_rn(norm, 1e-6f)));
    out[1] = norm;
    *done = 0u;  // ready for the next launch on this counter
  }
}

}  // namespace

// One AdamW update of nleaves leaves of one (param, grad) dtype pair:
// table holds nleaves Leaf records (at most 448), whose chunks of chunk
// elements (a multiple of 2048) number nchunks in all; p_dtype 0 f32, 1 bf16, 2 fp16; g_half != 0: the
// gradients are of the param's dtype, else f32. p_out (the param's dtype),
// m_out, v_out and w_out (f32; null without masters) are the group's flat
// outputs. scale: the clip factor as a device f32, or null: gs. key: the
// step key's two words on the device, or null: k0, k1. Every pointer in the
// table and every output leaf 16-byte aligned; the outputs may not alias
// the inputs.
extern "C" int fused_adamw_step(const void* table, int nleaves, int nchunks, int chunk,
                                int p_dtype, int g_half, void* p_out, void* m_out, void* v_out, void* w_out,
                                const void* scale, float gs, const void* key, unsigned int k0,
                                unsigned int k1, float lr, float b1, float omb1, float b2,
                                float omb2, float eps, float wd, float bc1, float bc2,
                                void* stream) {
  if (nleaves <= 0 || nchunks <= 0) return static_cast<int>(cudaGetLastError());
  if (nleaves > 448 || chunk <= 0 || chunk % (THREADS * VEC))
    return static_cast<int>(cudaErrorInvalidValue);
  const Step st{p_out, static_cast<float*>(m_out), static_cast<float*>(v_out),
                static_cast<float*>(w_out), static_cast<const float*>(scale),
                static_cast<const uint32_t*>(key), gs, k0, k1, nleaves, chunk,
                Hyper{lr, b1, omb1, b2, omb2, eps, wd, bc1, bc2}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p_dtype == 1 && g_half) return launch_step<__nv_bfloat16, __nv_bfloat16>(table, nleaves, nchunks, st, s);
  if (p_dtype == 1) return launch_step<__nv_bfloat16, float>(table, nleaves, nchunks, st, s);
  if (p_dtype == 2 && g_half) return launch_step<__half, __half>(table, nleaves, nchunks, st, s);
  if (p_dtype == 2) return launch_step<__half, float>(table, nleaves, nchunks, st, s);
  if (p_dtype != 0 || g_half) return static_cast<int>(cudaErrorInvalidValue);
  return launch_step<float, float>(table, nleaves, nchunks, st, s);
}

// The blocks of a clip_norm launch over nchunks chunks (the size of its
// partials buffer).
extern "C" int clip_norm_blocks(int nchunks) {
  return nchunks < NORM_BLOCKS ? nchunks : NORM_BLOCKS;
}

// The global norm of nleaves gradient leaves (table: NormLeaf records, at
// most 1024, nchunks chunks of chunk elements in all) and the clip factor min(1, clip /
// (norm + 1e-6)): out[0] the factor, out[1] the norm (f32, on the device).
// partial: clip_norm_blocks(nchunks) floats of scratch; done: a device
// counter that is 0 before the launch and is 0 again after it (one per
// stream). Every gradient pointer 16-byte aligned.
extern "C" int clip_norm(const void* table, int nleaves, int nchunks, int chunk, float clip,
                         void* partial, void* done, void* out, void* stream) {
  if (nleaves <= 0 || nchunks <= 0 || nleaves > 1024 || chunk <= 0 || chunk % (THREADS * VEC))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = clip_norm_blocks(nchunks);
  float* pp = static_cast<float*>(partial);
  unsigned int* dd = static_cast<unsigned int*>(done);
  float* oo = static_cast<float*>(out);
  if (nleaves <= 8) {
    NormLeaves<8> t;
    memcpy(t.leaf, table, sizeof(NormLeaf) * nleaves);
    clip_norm_kernel<8><<<blocks, THREADS, 0, s>>>(t, nleaves, nchunks, chunk, clip, pp, dd, oo);
  } else if (nleaves <= 64) {
    NormLeaves<64> t;
    memcpy(t.leaf, table, sizeof(NormLeaf) * nleaves);
    clip_norm_kernel<64><<<blocks, THREADS, 0, s>>>(t, nleaves, nchunks, chunk, clip, pp, dd, oo);
  } else {
    NormLeaves<1024> t;
    memcpy(t.leaf, table, sizeof(NormLeaf) * nleaves);
    clip_norm_kernel<1024><<<blocks, THREADS, 0, s>>>(t, nleaves, nchunks, chunk, clip, pp, dd, oo);
  }
  return static_cast<int>(cudaGetLastError());
}
