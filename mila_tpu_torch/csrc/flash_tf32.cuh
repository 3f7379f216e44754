// The f32 flash-attention family on TMA and tf32 warpgroup MMA
// (flash_tf32_fwd.cu at every D, flash_tf32_bwd.cu at D 64 and 128): the
// backward's prep pass that writes each operand once as the products read
// it (the forward's, K and V only, is flash_tf32_fwd.cu's prep_cols_kernel,
// in the same layouts), and the helpers both share.
//
// tf32 wgmma takes no transpose bit (both operands K-major), and reads
// whatever f32 bits sit in shared memory without rounding them. So the prep
// pass rounds every operand to tf32 (cvt.rna, as the mma.sync family's
// fragments are) and, for the products that contract over a tensor's rows
// (P V, dQ = dS K, dK = dS^T Q, dV = P^T dO), writes that tensor transposed,
// each group of 8 rows ordered 0 2 4 6 1 3 5 7: the A fragment of tf32 wgmma
// holds k columns t and t + 4 of a lane, the S / dP accumulator columns 2 t
// and 2 t + 1, so P or dS pass from an accumulator to the next product's A
// fragment in the lane that holds them when B's k order is that one
// (pack_a). Tiles are TMA boxes of 32 f32 columns (128 bytes a row, 128-byte
// swizzle) into panels of rows x 128 bytes (slice).
#pragma once

#include "common.cuh"
#include "sm90.cuh"

// Internal linkage: each source built (and each part) keeps its own copy.
namespace {
namespace ftf32 {

constexpr int TQ_ALIGN = 64;    // the Q side's rows are padded to this
constexpr int PREP_ROWS = 32;   // rows a prep block
constexpr int PREP_THREADS = 256;

__device__ __forceinline__ float tf32f(float x) { return __uint_as_float(tf32(x)); }

// The row held at position p of the transposed copies: in each group of 8,
// positions 0-3 hold rows 0 2 4 6 and positions 4-7 rows 1 3 5 7 (the top).
__device__ __forceinline__ int row_at(int p) {
  const int r = p & 7;
  return (p & ~7) | (r < 4 ? 2 * r : 2 * (r - 4) + 1);
}

// ---- prep --------------------------------------------------------------------

// PREP_ROWS rows [t0, t0 + 32) of one (batch, head) of a [B, T, H, D] pair
// (a, c): a rounded to tf32 into ar, c into hi (ch) and lo (cl), [rows of
// Tpad][D] per (batch, head); a and c's hi transposed into at and ct ([D][Tpad]
// per (batch, head), each group of 8 rows in row_at's order). Any output but
// at may be null. QSIDE (a = q, c = do): also lse2 and D per row from l, m
// and o. Rows at or past T are zero.
template <int D, bool QSIDE>
__global__ void __launch_bounds__(PREP_THREADS)
prep_kernel(const float* __restrict__ a, const float* __restrict__ c,
            const float* __restrict__ o, const float* __restrict__ l,
            const float* __restrict__ m, float* __restrict__ ar, float* __restrict__ ch,
            float* __restrict__ cl, float* __restrict__ at, float* __restrict__ ct,
            float* __restrict__ lse2, float* __restrict__ delta, int T, int Tpad, int H) {
  constexpr int RS = D + 1, C4 = D / 4;
  extern __shared__ float tile[];  // a and c's hi, rounded: [2][PREP_ROWS][RS]
  float* ta = tile;
  float* tc = tile + PREP_ROWS * RS;
  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * PREP_ROWS, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  for (int i = tid; i < PREP_ROWS * C4; i += PREP_THREADS) {
    const int r = i / C4, col = 4 * (i % C4), t = t0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
    if (t < T) {
      const size_t src = (((size_t)b * T + t) * H + h) * D + col;
      x = *reinterpret_cast<const float4*>(a + src);
      y = *reinterpret_cast<const float4*>(c + src);
    }
    const float4 xr = make_float4(tf32f(x.x), tf32f(x.y), tf32f(x.z), tf32f(x.w));
    const float4 yh = make_float4(tf32f(y.x), tf32f(y.y), tf32f(y.z), tf32f(y.w));
    const float4 yl = make_float4(tf32f(y.x - yh.x), tf32f(y.y - yh.y), tf32f(y.z - yh.z),
                                  tf32f(y.w - yh.w));
    const size_t dst = (bh * Tpad + t) * D + col;
    if (ar != nullptr) *reinterpret_cast<float4*>(ar + dst) = xr;
    if (ch != nullptr) *reinterpret_cast<float4*>(ch + dst) = yh;
    if (cl != nullptr) *reinterpret_cast<float4*>(cl + dst) = yl;
    float* pa = ta + r * RS + col;
    float* pc = tc + r * RS + col;
    pa[0] = xr.x, pa[1] = xr.y, pa[2] = xr.z, pa[3] = xr.w;
    pc[0] = yh.x, pc[1] = yh.y, pc[2] = yh.z, pc[3] = yh.w;
  }
  if constexpr (QSIDE) {
    // D = sum_d o do in f32, 8 lanes a row; lse2 from the forward's l, m.
    const int r = tid >> 3, part = tid & 7, t = t0 + r;
    float acc = 0.f;
    if (t < T) {
      const size_t src = (((size_t)b * T + t) * H + h) * D;
      for (int col = 4 * part; col < D; col += 32) {
        const float4 u = *reinterpret_cast<const float4*>(o + src + col);
        const float4 w = *reinterpret_cast<const float4*>(c + src + col);
        acc = fmaf(u.x, w.x, acc);
        acc = fmaf(u.y, w.y, acc);
        acc = fmaf(u.z, w.z, acc);
        acc = fmaf(u.w, w.w, acc);
      }
    }
#pragma unroll
    for (int s = 4; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
    if (part == 0) {
      const size_t out = bh * Tpad + t;
      if (t < T) {
        const size_t in = bh * T + t;
        const float lv = l[in];
        lse2[out] = fmaf(m[in], LOG2E, log2f(lv == 0.f ? 1.f : lv));
        delta[out] = acc;
      } else {
        lse2[out] = INFINITY;
        delta[out] = 0.f;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < D * PREP_ROWS; i += PREP_THREADS) {
    const int d = i / PREP_ROWS, p = i % PREP_ROWS, r = row_at(p);
    const size_t dst = (bh * D + d) * Tpad + t0 + p;
    at[dst] = ta[r * RS + d];
    if (ct != nullptr) ct[dst] = tc[r * RS + d];
  }
}

constexpr int PANEL_ROW = 128;  // bytes a swizzled row: 32 f32 columns

// k-slice kk (8 columns) of a tile of `rows` rows stored as 32-column
// panels of rows x 128 bytes from `base` (1024-byte aligned).
__device__ __forceinline__ uint64_t slice(const unsigned char* base, int rows, int kk) {
  return wgmma_desc(base + (kk >> 2) * rows * PANEL_ROW + (kk & 3) * 32, 16, 1024);
}

// The A fragments of k-slices kk of an m64nN accumulator rounded to tf32:
// columns 2 t and 2 t + 1 of each 8 are k indices t and t + 4 (row_at).
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (*a)[4], const float* d) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) {
    a[kk][0] = tf32(d[4 * kk]);
    a[kk][1] = tf32(d[4 * kk + 2]);
    a[kk][2] = tf32(d[4 * kk + 1]);
    a[kk][3] = tf32(d[4 * kk + 3]);
  }
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (sm90_smem(p) & 1023)) & 1023);
}

// An f32 [rows][cols] tensor in boxes of box_rows x 32 columns, 128-byte swizzle.
inline bool encode_f32(CUtensorMap* map, const float* p, uint64_t rows, uint64_t cols, uint32_t box_rows) {
  return encode_2d(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, p, rows, cols, box_rows, 32,
                   CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace ftf32
}  // namespace
