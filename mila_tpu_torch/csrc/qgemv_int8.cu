// qgemv_int8: decode-shape (M <= 32 rows) int8 weight stream with an
// optional RMSNorm prologue and a store / +residual / SwiGLU epilogue.
//
// Replaces three TPU kernels of mila_tpu/kernels/decode_fused.py:
//   _rms_qmm_kernel        (rms_quant_linear)         prologue rms, epilogue store
//   _qmm_res_kernel        (quant_linear_residual)    no prologue, epilogue +res
//   _rms_qmm_swiglu_kernel (rms_quant_linear_swiglu)  prologue rms, epilogue swiglu
//
// Bound on the H100: the K x N int8 weight bytes (2*M operations per byte,
// M <= 32). Design: a block of 8 warps owns 128 output columns (each lane 4
// adjacent columns, one coalesced 32-bit weight word per K row; the SwiGLU
// variant also streams the up column n + I) and one K slice of kc rows
// (kc % 32 == 0), warps interleaved over the rows in batches of 4 words per
// lane. The slice of x is staged in shared memory as f32 rows [kc][MT]
// after the prologue: the TPU kernel keeps the whole [M, K] x resident,
// which does not fit here. For RMSNorm each block first reduces
// rstd = rsqrt(mean(x^2) + eps) over the whole row (x is a few KB and sits
// in L2), then stages bf16(x * rstd * gamma); the first weight words are
// already in flight meanwhile, and each batch of words is requested one
// batch ahead. Warps add their partials into shared memory in turn; the sum
// is scaled by the slice's scale row.
// With one slice the block applies the epilogue; otherwise it writes f32
// partials and qgemv_finish sums the slices and applies it.
#include "common.cuh"

namespace {

constexpr int COLS = 128, THREADS = 256, WARPS = THREADS / 32, UNROLL = 4;

// Sum of squares of the 16 bytes at p (8 bf16 or 4 f32 values).
__device__ __forceinline__ float sumsq16(const __nv_bfloat16* p) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    s = fmaf(f.x, f.x, fmaf(f.y, f.y, s));
  }
  return s;
}
__device__ __forceinline__ float sumsq16(const float* p) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  return f.x * f.x + f.y * f.y + f.z * f.z + f.w * f.w;
}

// UNROLL weight words of rows row0 + u * WARPS (and the up words N columns
// to the right for SwiGLU).
template <bool SWIGLU>
__device__ __forceinline__ void load_words(const int8_t* p, int ldq, int N,
                                           uint32_t (&w)[UNROLL], uint32_t (&wu)[UNROLL]) {
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int8_t* r = p + (size_t)u * WARPS * ldq;
    w[u] = __ldg(reinterpret_cast<const unsigned int*>(r));
    if (SWIGLU) wu[u] = __ldg(reinterpret_cast<const unsigned int*>(r + N));
  }
}

template <typename T>
__device__ __forceinline__ float epilogue(int mode, float v, float vu, const T* res, size_t i) {
  if (mode == 1) return v + to_f(res[i]);
  if (mode == 2) return v / (1.f + expf(-v)) * vu;  // silu(g) * u
  return v;
}

template <int MT, typename T, bool SWIGLU>
__global__ void __launch_bounds__(THREADS)
qgemv_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
             const int8_t* __restrict__ q, const float* __restrict__ scale,
             const T* __restrict__ res, T* __restrict__ out, float* __restrict__ ws,
             int M, int N, int K, int ldq, int bs, int mode, int rms, float eps, int kc) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                                  // [kc][MT]
  float* red = xs + (size_t)kc * MT;                 // [MT][COLS]
  float* redu = red + MT * COLS;                     // [MT][COLS] (SwiGLU up)
  __shared__ float rstd[32];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x, ks = blockIdx.y, nks = gridDim.y;
  const int k0 = ks * kc;

  // The first batch of weight words is requested before the prologue, so
  // its latency overlaps the RMSNorm pass and the staging of x.
  const int c = tile * COLS + lane * 4;
  const bool live = c < N;
  const int8_t* qp = q + (size_t)k0 * ldq + c;
  uint32_t w[UNROLL], wu[UNROLL];
  if (live) load_words<SWIGLU>(qp + (size_t)warp * ldq, ldq, N, w, wu);

  if (rms) {
    // One warp per row, 16-byte loads, all of a lane's loads in flight.
    constexpr int VEC = 16 / sizeof(T);
    for (int m = warp; m < M; m += WARPS) {
      const T* row = x + (size_t)m * K;
      float ss = 0.f;
#pragma unroll 8
      for (int k = lane * VEC; k < K; k += 32 * VEC) ss += sumsq16(row + k);
      ss = warp_sum(ss);
      if (lane == 0) rstd[m] = rsqrtf(ss / K + eps);
    }
    __syncthreads();
  }
  for (int i = tid; i < kc * MT; i += THREADS) {
    const int m = i / kc, kk = i % kc;
    float v = 0.f;
    if (m < M) {
      v = to_f(x[(size_t)m * K + k0 + kk]);
      if (rms) v = v * rstd[m] * gamma[k0 + kk];
      v = round_bf16(v);
    }
    xs[kk * MT + m] = v;
  }
  for (int i = tid; i < MT * COLS * (SWIGLU ? 2 : 1); i += THREADS) red[i] = 0.f;
  __syncthreads();

  float acc[MT][4], accu[SWIGLU ? MT : 1][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[m][j] = 0.f;
      if (SWIGLU) accu[m][j] = 0.f;
    }
  if (live) {
    for (int kk = warp; kk < kc; kk += WARPS * UNROLL) {
      uint32_t cw[UNROLL], cwu[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        cw[u] = w[u];
        if (SWIGLU) cwu[u] = wu[u];
      }
      // Software pipeline: the next batch is in flight during this one.
      if (kk + WARPS * UNROLL < kc)
        load_words<SWIGLU>(qp + (size_t)(kk + WARPS * UNROLL) * ldq, ldq, N, w, wu);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const float* xr = xs + (kk + u * WARPS) * MT;
        float wf[4], wuf[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wf[j] = s8_to_f(cw[u], j);
          if (SWIGLU) wuf[j] = s8_to_f(cwu[u], j);
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float xv = xr[m];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[m][j] = fmaf(xv, wf[j], acc[m][j]);
            if (SWIGLU) accu[m][j] = fmaf(xv, wuf[j], accu[m][j]);
          }
        }
      }
    }
  }
  // Sum the warps' partials in shared memory, one warp at a time (plain
  // adds: each lane owns its 4 columns, so there is no conflict to resolve).
  for (int turn = 0; turn < WARPS; ++turn) {
    if (warp == turn && live) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m >= M) break;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          red[m * COLS + lane * 4 + j] += acc[m][j];
          if (SWIGLU) redu[m * COLS + lane * 4 + j] += accu[m][j];
        }
      }
    }
    __syncthreads();
  }

  const float* srow = scale + (size_t)(k0 / bs) * ldq;
  for (int i = tid; i < M * COLS; i += THREADS) {
    const int m = i / COLS, n = tile * COLS + i % COLS;
    if (n >= N) continue;
    const float v = red[i] * srow[n];
    const float vu = SWIGLU ? redu[i] * srow[N + n] : 0.f;
    if (nks == 1) {
      out[(size_t)m * N + n] = from_f<T>(epilogue<T>(mode, v, vu, res, (size_t)m * N + n));
    } else {
      float* wrow = ws + ((size_t)ks * M + m) * ldq;
      wrow[n] = v;
      if (SWIGLU) wrow[N + n] = vu;
    }
  }
}

template <typename T>
__global__ void qgemv_finish(const float* __restrict__ ws, const T* __restrict__ res,
                             T* __restrict__ out, int M, int N, int ldq, int nks, int mode) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * N) return;
  const int m = i / N, n = i % N;
  float v = 0.f, vu = 0.f;
  for (int s = 0; s < nks; ++s) {
    const float* wrow = ws + ((size_t)s * M + m) * ldq;
    v += wrow[n];
    if (mode == 2) vu += wrow[N + n];
  }
  out[i] = from_f<T>(epilogue<T>(mode, v, vu, res, i));
}

template <int MT, typename T, bool SWIGLU>
void launch(const void* x, const void* gamma, const void* q, const void* scale, const void* res,
            void* out, void* ws, int M, int N, int K, int ldq, int bs, int mode, int rms,
            float eps, int ksplit, cudaStream_t stream) {
  const int kc = K / ksplit;
  const size_t smem = sizeof(float) * ((size_t)kc * MT + (size_t)MT * COLS * (SWIGLU ? 2 : 1));
  auto kern = qgemv_kernel<MT, T, SWIGLU>;
  // Dynamic plus static shared memory above 48 KB needs the opt-in; raise
  // this instantiation's limit on each device to the largest size given.
  static size_t allowed[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64 || smem > allowed[dev]) {
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (dev < 64) allowed[dev] = smem;
  }
  dim3 grid((N + COLS - 1) / COLS, ksplit);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma), static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), static_cast<const T*>(res), static_cast<T*>(out),
      static_cast<float*>(ws), M, N, K, ldq, bs, mode, rms, eps, kc);
  if (ksplit > 1) {
    const int total = M * N;
    qgemv_finish<T><<<(total + 255) / 256, 256, 0, stream>>>(
        static_cast<const float*>(ws), static_cast<const T*>(res), static_cast<T*>(out), M, N,
        ldq, ksplit, mode);
  }
}

template <typename T>
void dispatch(int mt, bool swiglu, const void* x, const void* gamma, const void* q,
              const void* scale, const void* res, void* out, void* ws, int M, int N, int K,
              int ldq, int bs, int mode, int rms, float eps, int ksplit, cudaStream_t s) {
  if (mt == 8) {
    if (swiglu)
      launch<8, T, true>(x, gamma, q, scale, res, out, ws, M, N, K, ldq, bs, mode, rms, eps, ksplit, s);
    else
      launch<8, T, false>(x, gamma, q, scale, res, out, ws, M, N, K, ldq, bs, mode, rms, eps, ksplit, s);
  } else {
    if (swiglu)
      launch<32, T, true>(x, gamma, q, scale, res, out, ws, M, N, K, ldq, bs, mode, rms, eps, ksplit, s);
    else
      launch<32, T, false>(x, gamma, q, scale, res, out, ws, M, N, K, ldq, bs, mode, rms, eps, ksplit, s);
  }
}

}  // namespace

// x [M, K]; gamma [K] f32 or null (rms = 0); q [K, ldq] int8; scale
// [K / block_size, ldq] f32; res [M, N] or null; out [M, N]; ws
// [ksplit, M, ldq] f32 or null when ksplit == 1. N is the output width:
// ldq for store/residual, ldq / 2 for SwiGLU (gate columns [0, N), up
// columns [N, 2N)). mode: 0 store, 1 +residual, 2 SwiGLU. m_tile 8 (M <= 8)
// or 32. x, res and out are f32 when is_f32 else bf16.
extern "C" int qgemv_int8(const void* x, const void* gamma, const void* q, const void* scale,
                          const void* res, void* out, void* ws, int M, int N, int K, int ldq,
                          int block_size, int mode, int rms, float eps, int ksplit, int m_tile,
                          int is_f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool swiglu = mode == 2;
  if (is_f32)
    dispatch<float>(m_tile, swiglu, x, gamma, q, scale, res, out, ws, M, N, K, ldq, block_size,
                    mode, rms, eps, ksplit, s);
  else
    dispatch<__nv_bfloat16>(m_tile, swiglu, x, gamma, q, scale, res, out, ws, M, N, K, ldq,
                            block_size, mode, rms, eps, ksplit, s);
  return static_cast<int>(cudaGetLastError());
}
