// qgemv_int4: decode-shape (M <= 32 rows) matmul against packed int4
// weights, on the tensor cores.
//
// Replaces the TPU kernel mila_tpu/kernels/quant_matmul.py:_qmm4_kernel
// (entry quant_linear -> _quant_linear_int4 -> _quant_matmul4_2d): y =
// x @ dequant(Wp), Wp [K/2, N] int8 with two signed nibbles per byte in the
// split-halves layout (byte row r holds value row r in its low nibble and
// row r + K/2 in its high nibble), scales [K / block_size, N] f32, output
// in x's dtype. As the TPU kernel: x rounded to bf16 times the signed
// nibbles, summed in f32 over windows of `win` packed rows (the JAX gate's
// block_kp, inside one scale block for both halves), each window's low- and
// high-half sums scaled by their own scale rows.
//
// Bound on the H100: the K/2 x N weight bytes (4 * M operations per byte).
// A CUDA-core inner loop (two sign-extending decodes and 2 M FMAs a byte)
// is bound by instruction issue long before the bytes, so the products run
// on mma.sync m16n8k16, with the weight as the 16-row operand (16 output
// columns) and x as the 8-wide one (8 rows of x; M <= 32 takes up to four
// n-tiles): y^T = W^T x^T. The mma's 16 k values are 8 packed rows, each
// byte giving the pair (low nibble: row r, high nibble: row r + K/2), and x
// is staged as the matching bf16 pairs (x[m][r], x[m][K/2 + r]). Where the
// two halves read different scale rows (blocked scales), each half gets its
// own accumulators: the pair's other element of x is masked to 0.
// A byte becomes its bf16 pair in three instructions: prmt moves its low
// nibble to bits 0-3 and its high nibble (from the word shifted by 4) to
// bits 16-19; lop3 flips the nibbles' sign bits and ORs in bf16 128
// (0x4300): 128 + (u ^ 8) in each half; one bf16x2 FMA subtracts 136. The
// values -8..7 are bf16 integers, so the conversion is exact.
// A block of 8 warps owns 256 output columns (a warp 32: two 16-column
// n-tiles, a lane's 4 columns one 32-bit word of a packed row) and a slice
// of kc packed rows. The slice streams through a ring of NST stages of 32
// rows x 256 bytes by 16-byte cp.async, NST - 1 stages (56 KB) in flight;
// the slice of x is staged meanwhile. Each stage is one step of four mma
// k-steps per n-tile. Bound by the stream itself (without the conversions
// and products, 82-94 % of the time remains): 256-byte runs of a packed
// row measured 10 % faster than 128-byte ones at the vocab head. With
// ksplit > 1 slices (at most 8), the slices of a column tile run as one
// thread-block cluster: each block stores its scaled f32 partial of each
// share of the tile's outputs into the shared memory of the block that
// owns the share, and after one cluster barrier each owner adds its share
// over the slices, in slice order (no float atomics, so two calls are
// bit-equal; no partials through device memory): one launch in all. A
// reduction through device memory (partials to scratch, an arrival counter,
// the last block adding) measured 0.9-2.0 us slower at the small
// projections at the same split (PERF.md §6).
#include "common.cuh"
#include "gemv.cuh"

namespace {

constexpr int THREADS = 256, WARPS = THREADS / 32;
constexpr int BN = 32 * WARPS;  // output columns per block
constexpr int SR = 32;          // packed rows per stage
constexpr int NST = 8;          // ring stages
constexpr int MAX_SLICES = 8;   // INT4_MAX_SLICES of kernels/quant_matmul.py: one portable cluster
constexpr int PITCH = BN + 32;  // bytes per staged row: the 4 rows a k-step's lanes read
                                // start 8 banks apart (160 / 4 = 40 = 8 mod 32)

// Byte j of w as the bf16 pair (low nibble, high nibble), signed; w4 = w >> 4.
__device__ __forceinline__ uint32_t nibble_pair(uint32_t w, uint32_t w4, int j) {
  const uint32_t p = prmt(w, w4, 0x4400u + 0x1111u * j);
  uint32_t b;  // mask ? (p ^ c) : c, c = 0x43084308: bf16 128 + (u ^ 8) in each half
  asm("lop3.b32 %0, %1, %2, %3, 0x6A;" : "=r"(b) : "r"(p), "r"(0x000F000Fu), "r"(0x43084308u));
  uint32_t v;  // b * 1 - 136
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(v) : "r"(b), "r"(0x3F803F80u), "r"(0xC308C308u));
  return v;
}

__device__ __forceinline__ float4 load_scale(const float* scale, int row, int N, int c) {
  return __ldg(reinterpret_cast<const float4*>(scale + (size_t)row * N + c));
}

// MT: n-tiles of 8 rows of x (M <= 8 MT); SPLIT: the halves' scale rows differ.
template <int MT, bool SPLIT, typename T>
__global__ void __launch_bounds__(THREADS)
qgemv4_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
              const float* __restrict__ scale, T* __restrict__ out, int M, int N, int K, int bs,
              int kc, int win) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;                                             // [NST][SR][PITCH]
  uint32_t* xs = reinterpret_cast<uint32_t*>(smem + NST * SR * PITCH);    // [8 MT][kc + 4]
  float4* recv = reinterpret_cast<float4*>(xs + 8 * MT * (kc + 4));       // K slices' partials
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int Kp = K / 2, n0 = blockIdx.x * BN, ks = blockIdx.y, nks = gridDim.y, k0 = ks * kc;
  const int nsteps = kc / SR, XP = kc + 4;
  const int8_t* qb = q + (size_t)k0 * N + n0;
  if (nks > 1) cluster_arrive_relaxed();

  auto issue = [&](int step) {
    unsigned char* dst = ring + (step % NST) * SR * PITCH;
    const int8_t* src = qb + (size_t)step * SR * N;
#pragma unroll
    for (int i = tid; i < SR * BN / 16; i += THREADS) {
      const int r = i / (BN / 16), c = i % (BN / 16);
      cp_async16(dst + r * PITCH + 16 * c, src + (size_t)r * N + 16 * c);
    }
  };
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < nsteps) issue(s);
    cp_async_commit();
  }

  // The first window's scale rows, in flight with the ring.
  const int col = 32 * warp + 4 * g;  // the lane's 4 columns in the block's 256
  float4 sl = load_scale(scale, k0 / bs, N, n0 + col), sh = sl;
  if (SPLIT) sh = load_scale(scale, (Kp + k0) / bs, N, n0 + col);

  // x's slice as bf16 pairs (x[m][k0 + r], x[m][K/2 + k0 + r]), rows of x
  // past M zero, 8 rows r a step from 16-byte loads (all of a thread's in
  // flight at once). Row r of a stage's k-step j (r = 8 j + kk) sits at
  // slot 8 (kk % 4) + 4 (kk / 4) + j of the stage's 32: lane t's pairs for
  // the stage's four k-steps are two runs of 4 (rows 8 j + t and 8 j + 4 + t).
#pragma unroll 4
  for (int i = tid; i < MT * kc; i += THREADS) {  // 8 MT rows of x, kc / 8 steps each
    const int m = i / (kc / 8), r = 8 * (i % (kc / 8));
    float lo[8], hi[8];
    if (m < M) {
      load8(x + (size_t)m * K + k0 + r, lo);
      load8(x + (size_t)m * K + Kp + k0 + r, hi);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) lo[e] = hi[e] = 0.f;
    }
    uint32_t* xr = xs + m * XP + (r & ~31) + ((r & 31) >> 3);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) xr[8 * (kk & 3) + 4 * (kk >> 2)] = pack2(lo[kk], hi[kk]);
  }

  float acc[2][MT][4], acc_hi[2][MT][4], tot[2][MT][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][mt][c] = acc_hi[a][mt][c] = tot[a][mt][c] = 0.f;

  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<NST - 2>();
    __syncthreads();  // stage s landed for every thread; stage s - 1 fully read
    if (s + NST - 1 < nsteps) issue(s + NST - 1);
    cp_async_commit();

    const unsigned char* st = ring + (s % NST) * SR * PITCH + col;
    uint4 bx0[MT], bx1[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const uint32_t* xr = xs + (8 * mt + g) * XP + s * SR + 8 * t;
      bx0[mt] = *reinterpret_cast<const uint4*>(xr);
      bx1[mt] = *reinterpret_cast<const uint4*>(xr + 4);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(st + (8 * j + t) * PITCH);
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(st + (8 * j + 4 + t) * PITCH);
      const uint32_t s0 = w0 >> 4, s1 = w1 >> 4;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        // A rows g and g + 8 of n-tile nt: columns 2 nt and 2 nt + 1 of the lane's 4.
        const uint32_t a[4] = {nibble_pair(w0, s0, 2 * nt), nibble_pair(w0, s0, 2 * nt + 1),
                               nibble_pair(w1, s1, 2 * nt), nibble_pair(w1, s1, 2 * nt + 1)};
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const uint32_t b[2] = {comp(bx0[mt], j), comp(bx1[mt], j)};
          if (SPLIT) {
            const uint32_t blo[2] = {b[0] & 0xFFFFu, b[1] & 0xFFFFu};
            const uint32_t bhi[2] = {b[0] & 0xFFFF0000u, b[1] & 0xFFFF0000u};
            mma_bf16(acc[nt][mt], a, blo);
            mma_bf16(acc_hi[nt][mt], a, bhi);
          } else {
            mma_bf16(acc[nt][mt], a, b);
          }
        }
      }
    }

    // A window ends (or the slice): scale its sums by the window's rows.
    const int row = k0 + s * SR;
    if ((row + SR) % win == 0 || s == nsteps - 1) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        // c0, c1: column 2 nt (rows m, m + 1); c2, c3: column 2 nt + 1.
        const float lo0 = nt ? sl.z : sl.x, lo1 = nt ? sl.w : sl.y;
        const float hi0 = nt ? sh.z : sh.x, hi1 = nt ? sh.w : sh.y;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float slo = c < 2 ? lo0 : lo1, shi = c < 2 ? hi0 : hi1;
            tot[nt][mt][c] += SPLIT ? acc[nt][mt][c] * slo + acc_hi[nt][mt][c] * shi
                                    : acc[nt][mt][c] * slo;
            acc[nt][mt][c] = acc_hi[nt][mt][c] = 0.f;
          }
        }
      }
      if (s + 1 < nsteps) {  // the next window's scale rows
        sl = load_scale(scale, (row + SR) / bs, N, n0 + col);
        if (SPLIT) sh = load_scale(scale, (Kp + row + SR) / bs, N, n0 + col);
      }
    }
  }

  // The lane's outputs: rows m = 8 mt + 2 t + e, its 4 columns.
  const size_t nc = (size_t)n0 + col;
  if (nks == 1) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = 8 * mt + 2 * t + e;
        if (m < M)
          store4(out + (size_t)m * N + nc, make_float4(tot[0][mt][e], tot[0][mt][2 + e],
                                                       tot[1][mt][e], tot[1][mt][2 + e]));
      }
    return;
  }
  // K slices: the blocks of a column tile form one cluster, and block r
  // owns the r-th share of the tile's outputs (float4 groups). Each block
  // stores its partial of every group into the owner's receive buffer, at
  // its own slice's row; after one cluster barrier each owner adds its
  // groups over the slices, in slice order, from its own shared memory.
  constexpr int GROUPS = 8 * MT * BN / 4;  // float4 outputs of the tile
  const int per = GROUPS / nks;
  cluster_wait();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = 8 * mt + 2 * t + e, i = (m * BN + col) / 4;
      if (m < M)
        st_cluster(recv + ks * per + i % per, i / per,
                   make_float4(tot[0][mt][e], tot[0][mt][2 + e], tot[1][mt][e],
                               tot[1][mt][2 + e]));
    }
  cluster_sync();
  for (int j = tid; j < per; j += THREADS) {
    const int i = ks * per + j, m = 4 * i / BN, c = 4 * i % BN;
    if (m >= M) continue;
    float4 v = recv[j];
#pragma unroll
    for (int r = 1; r < MAX_SLICES; ++r) {
      if (r < nks) {
        const float4 p = recv[r * per + j];
        v.x += p.x;
        v.y += p.y;
        v.z += p.z;
        v.w += p.w;
      }
    }
    store4(out + (size_t)m * N + n0 + c, v);
  }
}

template <int MT, bool SPLIT, typename T>
int launch(const void* x, const void* q, const void* scale, void* out, int M, int N, int K,
           int bs, int ksplit, int win, cudaStream_t stream) {
  const int kc = K / 2 / ksplit;
  const int smem = NST * SR * PITCH + 8 * MT * (kc + 4) * 4 + (ksplit > 1 ? 8 * MT * BN * 4 : 0);
  auto kern = qgemv4_kernel<MT, SPLIT, T>;
  static int allowed = 48 * 1024;
  if (smem > allowed) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N / BN, ksplit);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = ksplit;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(x),
                                             static_cast<const int8_t*>(q),
                                             static_cast<const float*>(scale),
                                             static_cast<T*>(out), M, N, K, bs, kc, win));
}

template <typename T>
int dispatch(const void* x, const void* q, const void* scale, void* out, int M, int N, int K,
             int bs, int ksplit, int win, cudaStream_t st) {
#define INT4_LAUNCH(MT)                                                                     \
  return bs < K ? launch<MT, true, T>(x, q, scale, out, M, N, K, bs, ksplit, win, st)       \
                : launch<MT, false, T>(x, q, scale, out, M, N, K, bs, ksplit, win, st)
  if (M <= 8) INT4_LAUNCH(1);
  if (M <= 16) INT4_LAUNCH(2);
  INT4_LAUNCH(4);
#undef INT4_LAUNCH
}

}  // namespace

// x [M, K]; q [K / 2, N] int8 (packed int4, split halves); scale
// [K / block_size, N] f32; out [M, N]. ksplit (1, 2, 4 or 8: one cluster)
// slices of kc = K / 2 / ksplit packed rows (kc % 32 == 0). win: packed
// rows per scale window (win % 32 == 0, win divides K / 2 and, where
// block_size < K, block_size). Needs 1 <= M <= 32, N % 128 == 0, 16-byte
// aligned x, q and scale, and x's slice of 8 ceil(M / 8) (kc + 4) 4-byte
// pairs (and, with K slices, a receive buffer of 32 ceil(M / 8) KB) in
// shared memory beside the 72 KB ring; x and out are f32 when
// is_f32, else bf16 (checked by the Python wrapper).
extern "C" int qgemv_int4(const void* x, const void* q, const void* scale, void* out, int M,
                          int N, int K, int block_size, int ksplit, int win, int is_f32,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_f32) return dispatch<float>(x, q, scale, out, M, N, K, block_size, ksplit, win, s);
  return dispatch<__nv_bfloat16>(x, q, scale, out, M, N, K, block_size, ksplit, win, s);
}
