// qgemv_int4: decode-shape (M <= 32 rows) matmul against packed int4 weights.
//
// Replaces the TPU kernel mila_tpu/kernels/quant_matmul.py:_qmm4_kernel
// (entry quant_linear -> _quant_linear_int4 -> _quant_matmul4_2d): y =
// x @ dequant(Wp), Wp [K/2, N] int8 with two signed nibbles per byte in the
// split-halves layout (byte row r holds value row r in its low nibble and
// row r + K/2 in its high nibble), scales [K / block_size, N] f32, output
// in x's dtype.
//
// Bound on the H100: the K/2 x N weight bytes (4 * M operations per byte, M
// <= 32). Design: K2's (csrc/qgemv_int8.cu) without its prologues. A block
// of 8 warps owns COLS output columns (each lane CPL adjacent columns, one
// coalesced CPL-byte weight word per packed row: CPL = 4 for M <= 8, 2 for
// M <= 32 to keep the accumulators in registers) and a slice of kc packed
// rows; the first weight words are requested before x is staged, and each
// batch of words one batch ahead. Both halves of x's slice are staged in
// shared memory as bf16-rounded f32 rows. Each thread decodes a word's
// nibbles by sign-extending shifts (the TPU kernel's (b << 28) >> 28 and
// (b << 24) >> 28) and keeps separate low- and high-half f32 sums: the
// halves read different scale rows (k0 / bs and (K/2 + k0) / bs) where the
// scales are blocked. Warps add their sums in shared memory in turns; each
// half's sum is multiplied by its scale row, as the TPU kernel scales each
// tile's partial products. With one slice the block stores the output;
// otherwise it writes f32 partials that qgemv4_finish sums in slice order.
#include "common.cuh"

namespace {

constexpr int THREADS = 256, WARPS = THREADS / 32, UNROLL = 4;

template <int CPL>
__device__ __forceinline__ uint32_t load_word(const int8_t* p) {
  if (CPL == 4) return __ldg(reinterpret_cast<const unsigned int*>(p));
  return __ldg(reinterpret_cast<const unsigned short*>(p));
}

// Sign-extended low and high nibble of byte j of w, as f32.
__device__ __forceinline__ float nib_lo(uint32_t w, int j) {
  return static_cast<float>(static_cast<int>(w << (28 - 8 * j)) >> 28);
}
__device__ __forceinline__ float nib_hi(uint32_t w, int j) {
  return static_cast<float>(static_cast<int>(w << (24 - 8 * j)) >> 28);
}

template <int CPL>
__device__ __forceinline__ void load_batch(const int8_t* p, int N, uint32_t (&w)[UNROLL]) {
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) w[u] = load_word<CPL>(p + (size_t)u * WARPS * N);
}

template <int MT, int CPL, typename T>
__global__ void __launch_bounds__(THREADS)
qgemv4_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
              const float* __restrict__ scale, T* __restrict__ out, float* __restrict__ ws, int M,
              int N, int K, int bs, int kc) {
  constexpr int COLS = 32 * CPL;
  extern __shared__ __align__(16) float smem[];
  float* xlo = smem;                  // [kc][MT] x columns k0 .. k0 + kc
  float* xhi = xlo + (size_t)kc * MT; // [kc][MT] x columns K/2 + k0 ..
  float* red = xhi + (size_t)kc * MT; // [2][MT][COLS] low- and high-half sums

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x, ks = blockIdx.y, nks = gridDim.y;
  const int half = K / 2, k0 = ks * kc;
  const int c = tile * COLS + lane * CPL;
  const bool live = c < N;
  const int8_t* qp = q + (size_t)k0 * N + c;
  uint32_t w[UNROLL];
  if (live) load_batch<CPL>(qp + (size_t)warp * N, N, w);

  for (int i = tid; i < kc * MT; i += THREADS) {
    const int m = i / kc, kk = i % kc;
    float lo = 0.f, hi = 0.f;
    if (m < M) {
      lo = round_bf16(to_f(x[(size_t)m * K + k0 + kk]));
      hi = round_bf16(to_f(x[(size_t)m * K + half + k0 + kk]));
    }
    xlo[kk * MT + m] = lo;
    xhi[kk * MT + m] = hi;
  }
  for (int i = tid; i < 2 * MT * COLS; i += THREADS) red[i] = 0.f;
  __syncthreads();

  float al[MT][CPL], ah[MT][CPL];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < CPL; ++j) al[m][j] = ah[m][j] = 0.f;
  if (live) {
    for (int kk = warp; kk < kc; kk += WARPS * UNROLL) {
      uint32_t cw[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) cw[u] = w[u];
      if (kk + WARPS * UNROLL < kc) load_batch<CPL>(qp + (size_t)(kk + WARPS * UNROLL) * N, N, w);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int row = kk + u * WARPS;
        float wl[CPL], wh[CPL];
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          wl[j] = nib_lo(cw[u], j);
          wh[j] = nib_hi(cw[u], j);
        }
        const float* xl = xlo + row * MT;
        const float* xh = xhi + row * MT;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float a = xl[m], bh = xh[m];
#pragma unroll
          for (int j = 0; j < CPL; ++j) {
            al[m][j] = fmaf(a, wl[j], al[m][j]);
            ah[m][j] = fmaf(bh, wh[j], ah[m][j]);
          }
        }
      }
    }
  }
  for (int turn = 0; turn < WARPS; ++turn) {
    if (warp == turn && live) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m >= M) break;
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          red[m * COLS + lane * CPL + j] += al[m][j];
          red[(MT + m) * COLS + lane * CPL + j] += ah[m][j];
        }
      }
    }
    __syncthreads();
  }

  const float* slo = scale + (size_t)(k0 / bs) * N;
  const float* shi = scale + (size_t)((half + k0) / bs) * N;
  for (int i = tid; i < M * COLS; i += THREADS) {
    const int m = i / COLS, n = tile * COLS + i % COLS;
    if (n >= N) continue;
    const float v = red[m * COLS + i % COLS] * slo[n] + red[(MT + m) * COLS + i % COLS] * shi[n];
    if (nks == 1)
      out[(size_t)m * N + n] = from_f<T>(v);
    else
      ws[((size_t)ks * M + m) * N + n] = v;
  }
}

template <typename T>
__global__ void qgemv4_finish(const float* __restrict__ ws, T* __restrict__ out, int M, int N,
                              int nks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * N) return;
  float v = 0.f;
  for (int s = 0; s < nks; ++s) v += ws[(size_t)s * M * N + i];
  out[i] = from_f<T>(v);
}

template <int MT, int CPL, typename T>
void launch(const void* x, const void* q, const void* scale, void* out, void* ws, int M, int N,
            int K, int bs, int ksplit, cudaStream_t stream) {
  constexpr int COLS = 32 * CPL;
  const int kc = K / 2 / ksplit;
  const size_t smem = sizeof(float) * (2 * (size_t)kc * MT + 2 * (size_t)MT * COLS);
  auto kern = qgemv4_kernel<MT, CPL, T>;
  // Above 48 KB of dynamic shared memory needs the opt-in; raise this
  // instantiation's limit on each device to the largest size given.
  static size_t allowed[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64 || smem > allowed[dev]) {
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (dev < 64) allowed[dev] = smem;
  }
  dim3 grid((N + COLS - 1) / COLS, ksplit);
  kern<<<grid, THREADS, smem, stream>>>(static_cast<const T*>(x), static_cast<const int8_t*>(q),
                                        static_cast<const float*>(scale), static_cast<T*>(out),
                                        static_cast<float*>(ws), M, N, K, bs, kc);
  if (ksplit > 1) {
    const int total = M * N;
    qgemv4_finish<T><<<(total + 255) / 256, 256, 0, stream>>>(
        static_cast<const float*>(ws), static_cast<T*>(out), M, N, ksplit);
  }
}

template <typename T>
void dispatch(int m_tile, const void* x, const void* q, const void* scale, void* out, void* ws,
              int M, int N, int K, int bs, int ksplit, cudaStream_t s) {
  if (m_tile == 8)
    launch<8, 4, T>(x, q, scale, out, ws, M, N, K, bs, ksplit, s);
  else
    launch<32, 2, T>(x, q, scale, out, ws, M, N, K, bs, ksplit, s);
}

}  // namespace

// x [M, K]; q [K / 2, N] int8 (packed int4, split halves); scale
// [K / block_size, N] f32; out [M, N]; ws [ksplit, M, N] f32 or null when
// ksplit == 1. m_tile 8 (M <= 8, 4 columns per lane, N % 4 == 0) or 32 (M
// <= 32, 2 columns per lane, N % 2 == 0). Each slice of kc = K / 2 / ksplit
// packed rows must lie inside one scale block for both halves (kc divides
// K / 2 and block_size) and kc % 32 == 0; x and out are f32 when is_f32,
// else bf16 (checked by the Python wrapper).
extern "C" int qgemv_int4(const void* x, const void* q, const void* scale, void* out, void* ws,
                          int M, int N, int K, int block_size, int ksplit, int m_tile, int is_f32,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_f32)
    dispatch<float>(m_tile, x, q, scale, out, ws, M, N, K, block_size, ksplit, s);
  else
    dispatch<__nv_bfloat16>(m_tile, x, q, scale, out, ws, M, N, K, block_size, ksplit, s);
  return static_cast<int>(cudaGetLastError());
}
