// qmm_int8: weight-only int8 dequant GEMM with bias and GELU/SiLU epilogue.
//
// Replaces the TPU kernel mila_tpu/kernels/quant_matmul.py:_qmm_kernel
// (entry quant_linear -> _quant_matmul_2d): y = sum over K-blocks of
// (bf16(x) @ bf16(q))_f32 * scale[k // block_size, n], + bias, activation,
// stored in x's dtype (bf16 or f32).
//
// Bound on the H100: tensor-core operations at prefill shapes (M up to 1024,
// K 2048/8192, N up to 16384: hundreds of operations per weight byte).
// Design: 128x128 output tile per block, K in steps of 32; 8 warps as 2 (m)
// x 4 (n), each warp 64x32 outputs as 4x4 mma.sync m16n8k16 bf16 tiles with
// f32 accumulators. The int8 tile is converted to bf16 once while it is
// stored to shared memory (exact), transposed so that each thread's B
// fragment is one 32-bit load. The next K step's global loads are issued
// into registers before the current step's products. Per-channel scales
// (block_size == K) multiply the final sum; block scales flush a partial
// accumulator at each block boundary, as the TPU kernel scales each K tile.
// Ragged M and N edges are masked; K % 32 == 0, N % 8 == 0 and
// block_size % 16 == 0 are checked by the Python wrapper.
#include "common.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 32, THREADS = 256;
constexpr int AS = BK + 8;  // bf16 per A row in shared memory (80 bytes)
constexpr int BS = BK + 4;  // bf16 per B row (one row per output column)

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float activate(float v, int act) {
  if (act == 1) {  // GELU, tanh approximation
    return 0.5f * v * (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
  }
  if (act == 2) return v / (1.f + expf(-v));  // SiLU
  return v;
}

template <typename TO>
__device__ __forceinline__ void store2(TO* p, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename TO, bool BLOCKWISE>
__global__ void __launch_bounds__(THREADS)
qmm_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
           const float* __restrict__ scale, const float* __restrict__ bias,
           TO* __restrict__ out, int M, int N, int K, int bs, int act) {
  __shared__ __align__(16) __nv_bfloat16 As[BM * AS];
  __shared__ __align__(16) __nv_bfloat16 Bs[BN * BS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps
  const int g = lane >> 2, tig = lane & 3;
  const int bm = blockIdx.y * BM, bn = blockIdx.x * BN;

  // Global -> register staging: A is 2 x 16 bytes per thread, B is two
  // 8-byte rows (k, k+1) x 8 columns per thread.
  const int a_row0 = tid >> 2, a_col = (tid & 3) * 8;  // rows a_row0, a_row0 + 64
  const int b_kp = tid & 15, b_ng = tid >> 4;          // k pair, 8-column group
  uint4 ra[2];
  uint2 rb[2];

  auto load_tile = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = bm + a_row0 + i * 64;
      ra[i] = make_uint4(0, 0, 0, 0);
      if (m < M) ra[i] = *reinterpret_cast<const uint4*>(x + (size_t)m * K + k0 + a_col);
    }
    const int n = bn + b_ng * 8;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rb[i] = make_uint2(0, 0);
      if (n < N) rb[i] = *reinterpret_cast<const uint2*>(q + (size_t)(k0 + 2 * b_kp + i) * N + n);
    }
  };
  auto store_tile = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<uint4*>(&As[(a_row0 + i * 64) * AS + a_col]) = ra[i];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t w0 = j < 4 ? rb[0].x : rb[0].y, w1 = j < 4 ? rb[1].x : rb[1].y;
      const float lo = s8_to_f(w0, j & 3), hi = s8_to_f(w1, j & 3);
      *reinterpret_cast<uint32_t*>(&Bs[(b_ng * 8 + j) * BS + 2 * b_kp]) = pack2(lo, hi);
    }
  };

  float acc[4][4][4];
  float part[4][4][4];  // per-scale-block partial sums (BLOCKWISE only)
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[i][j][r] = 0.f;
        if (BLOCKWISE) part[i][j][r] = 0.f;
      }

  const int ntiles = K / BK;
  load_tile(0);
  store_tile();
  __syncthreads();
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BK;
    if (t + 1 < ntiles) load_tile(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const __nv_bfloat16* base = &As[(wm * 64 + mi * 16 + g) * AS + kk + tig * 2];
        af[mi][0] = *reinterpret_cast<const uint32_t*>(base);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(base + 8 * AS);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(base + 8);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(base + 8 * AS + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const __nv_bfloat16* base = &Bs[(wn * 32 + ni * 8 + g) * BS + kk + tig * 2];
        bf[ni][0] = *reinterpret_cast<const uint32_t*>(base);
        bf[ni][1] = *reinterpret_cast<const uint32_t*>(base + 8);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(BLOCKWISE ? part[mi][ni] : acc[mi][ni], af[mi], bf[ni]);
      if (BLOCKWISE && (k0 + kk + 16) % bs == 0) {
        // End of a scale block: fold the block's partial sums in, scaled.
        const float* srow = scale + (size_t)((k0 + kk) / bs) * N;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int n = bn + wn * 32 + ni * 8 + tig * 2;
          const float s0 = n < N ? srow[n] : 0.f, s1 = n < N ? srow[n + 1] : 0.f;
#pragma unroll
          for (int mi = 0; mi < 4; ++mi) {
            acc[mi][ni][0] += part[mi][ni][0] * s0;
            acc[mi][ni][1] += part[mi][ni][1] * s1;
            acc[mi][ni][2] += part[mi][ni][2] * s0;
            acc[mi][ni][3] += part[mi][ni][3] * s1;
#pragma unroll
            for (int r = 0; r < 4; ++r) part[mi][ni][r] = 0.f;
          }
        }
      }
    }
    __syncthreads();
    if (t + 1 < ntiles) {
      store_tile();
      __syncthreads();
    }
  }

#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int n = bn + wn * 32 + ni * 8 + tig * 2;
    if (n >= N) continue;
    const float s0 = BLOCKWISE ? 1.f : scale[n], s1 = BLOCKWISE ? 1.f : scale[n + 1];
    const float b0 = bias ? bias[n] : 0.f, b1 = bias ? bias[n + 1] : 0.f;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int m = bm + wm * 64 + mi * 16 + g;
      if (m < M)
        store2<TO>(out + (size_t)m * N + n, activate(acc[mi][ni][0] * s0 + b0, act),
                   activate(acc[mi][ni][1] * s1 + b1, act));
      if (m + 8 < M)
        store2<TO>(out + (size_t)(m + 8) * N + n, activate(acc[mi][ni][2] * s0 + b0, act),
                   activate(acc[mi][ni][3] * s1 + b1, act));
    }
  }
}

template <typename TO>
void launch(const void* x, const void* q, const void* scale, const void* bias, void* out,
            int M, int N, int K, int bs, int act, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  auto xb = static_cast<const __nv_bfloat16*>(x);
  auto qb = static_cast<const int8_t*>(q);
  auto sc = static_cast<const float*>(scale);
  auto bi = static_cast<const float*>(bias);
  auto o = static_cast<TO*>(out);
  if (bs == K)
    qmm_kernel<TO, false><<<grid, THREADS, 0, stream>>>(xb, qb, sc, bi, o, M, N, K, bs, act);
  else
    qmm_kernel<TO, true><<<grid, THREADS, 0, stream>>>(xb, qb, sc, bi, o, M, N, K, bs, act);
}

}  // namespace

// x [M, K] bf16; q [K, N] int8; scale [K / block_size, N] f32; bias [N] f32
// or null; out [M, N] f32 when out_f32 else bf16. act: 0 none, 1 GELU(tanh),
// 2 SiLU.
extern "C" int qmm_int8(const void* x, const void* q, const void* scale, const void* bias,
                        void* out, int M, int N, int K, int block_size, int act, int out_f32,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_f32)
    launch<float>(x, q, scale, bias, out, M, N, K, block_size, act, s);
  else
    launch<__nv_bfloat16>(x, q, scale, bias, out, M, N, K, block_size, act, s);
  return static_cast<int>(cudaGetLastError());
}
