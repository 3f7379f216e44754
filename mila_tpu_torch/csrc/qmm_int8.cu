// qmm_int8: weight-only int8 or fp8 (e4m3fn, e5m2) dequant GEMM with bias
// and GELU/SiLU epilogue, on Hopper's TMA and warpgroup MMA.
//
// Replaces the TPU kernel mila_tpu/kernels/quant_matmul.py:_qmm_kernel
// (entry quant_linear -> _quant_matmul_2d): y = sum over K-blocks of
// (bf16(x) @ bf16(q))_f32 * scale[k // block_size, n], + bias, activation,
// stored in x's dtype (bf16 or f32; x arrives in bf16).
//
// Bound on the H100: tensor-core operations at prefill shapes (M up to
// 4096, K 2048/8192, N up to 16384: hundreds of operations per weight byte).
// What holds it back is the tiles each block streams in from L2: a 128 x 128
// tile moves 24 KB per 2.1 MFLOP of a 64-deep K step, and the load ring
// alone, with no conversion and no wgmma, takes about half of the kernel's
// time (tools/qmm_variants). So per-channel weights take 128 x 256 tiles
// (32 KB per 4.2 MFLOP) wherever that grid still covers most of the card;
// block scales, whose second register tile would not fit beside a 256-wide
// one, and small grids keep 128 x 128.
// A block of three warpgroups, K in steps of 64:
//   warp 8: one thread keeps TMA loads of the x tile [128, 64] bf16 (128-byte
//     swizzle) and the int8 weight tile [64, BN] up to NT stages ahead in a
//     ring, refilling a stage once the consumers release it (empty);
//     tma_full counts the bytes;
//   warpgroups 0-1 (consumers, 64 rows each): issue four m64nBNk16 wgmma on
//     stage ks (A = the x tile, B = its weight tile in bf16, both in shared
//     memory, f32 accumulators in registers) and commit them; while they run,
//     turn the int8 tile of stage ks + 1 into bf16 (exact; 2.5 instructions
//     a value through the 2^23 float trick; fp8 exact too, 2.5 a value by
//     F8Pair of gemv.cuh, one uniform branch a stage on the launch's wfmt,
//     and the QTensor's scales need no fixup), laid out as wgmma's MN-major B
//     operand (sm90.cuh), into the other of two bf16 buffers; release stage
//     ks - 1 once its products have retired. Two named barriers a step keep
//     the bf16 buffers whole between the warpgroups.
// Per-channel scales (block_size == K) multiply the final sum; block scales
// accumulate each block's product in a second register tile, folded in f32
// at the block's end (as the TPU kernel scales each K tile). Ragged M, N
// and K edges read zeros through TMA and are masked at the store. The
// weight goes through TMA when N % 16 == 0 (TMA wants 16-byte row strides);
// other N (N % 8 == 0) load the same int8 stage through cp.async in warps
// 9-11. x needs K % 8 == 0 and a 16-byte-aligned base; K % 32 == 0,
// N % 8 == 0 and block_size % 16 == 0 are checked by the Python wrapper.
// The host encodes the two TMA descriptors per call.
#include "common.cuh"
#include "gemv.cuh"
#include "sm90.cuh"

namespace {

constexpr int BM = 128, BK = 64, NT = 5;  // NT: stages of the TMA ring
constexpr int THREADS = 384;  // warpgroups 0-1 consume, warpgroup 2 loads
constexpr int CONSUMERS = 256;
constexpr int LOADERS = 96;   // warps 9-11, which load the weight when TMA cannot
constexpr int X_BYTES = BM * BK * 2;
constexpr int N_ATOM_BYTES = BK * 128;  // one 64-column atom of a bf16 weight tile

// Shared memory of a kernel instance with BN-wide tiles: the TMA ring, then
// two bf16 weight buffers, the mbarriers and 1024 bytes of alignment slack.
template <int BN>
struct Tile {
  static constexpr int W8_BYTES = BK * BN, WB_BYTES = BK * BN * 2;
  static constexpr int SMEM = NT * (X_BYTES + W8_BYTES) + 2 * WB_BYTES + 2 * NT * 8 + 1024;
};

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

// Four signed bytes -> four bf16 (two words, low bytes first), exactly:
// float(2^23 + (b ^ 0x80)) - (2^23 + 128) == b, and bf16 keeps its top half.
__device__ __forceinline__ uint2 s8x4_to_bf16x4(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.f;
  return make_uint2(__byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632),
                    __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632));
}

struct S8x4 {
  __device__ __forceinline__ uint2 operator()(uint32_t w) const { return s8x4_to_bf16x4(w); }
};

// Four fp8 bytes -> four bf16 (two words, low bytes first), exactly: each
// pair's bytes into the high bytes of its halves, then F8Pair (gemv.cuh).
struct F8x4 {
  F8Pair f;
  __device__ __forceinline__ uint2 operator()(uint32_t w) const {
    return make_uint2(f.bits(prmt(w, w, 0x1100u)), f.bits(prmt(w, w, 0x3322u)));
  }
};

// Consumer c's share of the one-byte tile [BK][BN] (rows of BN bytes) ->
// bf16 in wgmma's MN-major layout (sm90.cuh): 16 bytes (16 n of one k row)
// in, two 16-byte chunks of a 128-byte swizzled atom row out.
template <int BN, typename Cvt4>
__device__ __forceinline__ void convert_tile(const unsigned char* w8s, unsigned char* wbs, int c,
                                             const Cvt4& cvt) {
#pragma unroll
  for (int it = 0; it < BK * BN / 16 / CONSUMERS; ++it) {
    const int i = c + it * CONSUMERS, k = i / (BN / 16), n0 = (i % (BN / 16)) * 16;
    const uint4 r = *reinterpret_cast<const uint4*>(w8s + k * BN + n0);
    const uint2 a = cvt(r.x), b = cvt(r.y);
    const uint2 e = cvt(r.z), f = cvt(r.w);
    const int chunk = (n0 % 64) / 8;  // 16-byte chunk of the 128-byte atom row
    unsigned char* row = wbs + (n0 / 64) * N_ATOM_BYTES + (k / 8) * 1024 + (k % 8) * 128;
    *reinterpret_cast<uint4*>(row + ((chunk ^ (k % 8)) * 16)) = make_uint4(a.x, a.y, b.x, b.y);
    *reinterpret_cast<uint4*>(row + (((chunk + 1) ^ (k % 8)) * 16)) = make_uint4(e.x, e.y, f.x, f.y);
  }
}

// The tile in the launch's weight format (WFMT_*, gemv.cuh).
template <int BN>
__device__ __forceinline__ void convert_stage(const unsigned char* w8s, unsigned char* wbs, int c,
                                              int wfmt) {
  if (wfmt != WFMT_INT8)
    convert_tile<BN>(w8s, wbs, c, F8x4{F8Pair(wfmt)});
  else
    convert_tile<BN>(w8s, wbs, c, S8x4{});
}

template <int BN>
__device__ __forceinline__ void wgmma_bf16(float* d, uint64_t a, uint64_t b, int accumulate) {
  if constexpr (BN == 256)
    wgmma_m64n256k16<__nv_bfloat16, 1>(d, a, b, accumulate);
  else
    wgmma_m64n128k16<__nv_bfloat16, 1>(d, a, b, accumulate);
}

template <typename TO, bool BLOCKWISE, int BN>
__global__ void __launch_bounds__(THREADS, 1)
qmm_kernel(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmw,
           const int8_t* __restrict__ q, const float* __restrict__ scale,
           const float* __restrict__ bias, TO* __restrict__ out, int M, int N, int K, int bs,
           int act, int w_tma, int wfmt) {
  using TL = Tile<BN>;
  static_assert(!BLOCKWISE || BN == 128, "block scales keep a second register tile");
  constexpr int W8_BYTES = TL::W8_BYTES, WB_BYTES = TL::WB_BYTES, NACC = BN / 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (sm90_smem(smem_raw) & 1023)) & 1023);
  unsigned char* xs = smem;                  // [NT][BM][BK] bf16, swizzled
  unsigned char* wb = xs + NT * X_BYTES;     // [2] bf16 weight tiles, MN-major atoms
  unsigned char* w8 = wb + 2 * WB_BYTES;     // [NT][BK][BN] int8
  uint64_t* tma_full = reinterpret_cast<uint64_t*>(w8 + NT * W8_BYTES);
  uint64_t* empty = tma_full + NT;

  const int tid = threadIdx.x;
  const int bm = blockIdx.x * BM, bn = blockIdx.y * BN;
  const int nk = (K + BK - 1) / BK;
  if (tid == 0) {
    for (int s = 0; s < NT; ++s) {
      mbar_init(&tma_full[s], w_tma ? 1 : 1 + LOADERS);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    const int p = tid - CONSUMERS;
    if (p == 0) {  // warp 8, one thread: the TMA ring
      for (int ks = 0; ks < nk; ++ks) {
        const int s = ks % NT;
        if (ks >= NT) mbar_wait(&empty[s], (ks / NT - 1) & 1);
        mbar_expect_tx(&tma_full[s], X_BYTES + (w_tma ? W8_BYTES : 0));
        tma_load_2d(xs + s * X_BYTES, &tmx, &tma_full[s], ks * BK, bm);
        if (w_tma) tma_load_2d(w8 + s * W8_BYTES, &tmw, &tma_full[s], bn, ks * BK);
      }
    } else if (!w_tma && p >= 32) {  // N % 16 != 0: 8-byte cp.async granules, zeros past edges
      for (int ks = 0; ks < nk; ++ks) {
        const int s = ks % NT;
        unsigned char* w8s = w8 + s * W8_BYTES;
        if (ks >= NT) mbar_wait(&empty[s], (ks / NT - 1) & 1);
        for (int i = p - 32; i < BK * BN / 8; i += LOADERS) {
          const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
          const int k = ks * BK + r, n = bn + c;
          void* dst = w8s + r * BN + c;
          if (k < K && n < N)
            asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(sm90_smem(dst)),
                         "l"(q + (size_t)k * N + n));
          else
            *reinterpret_cast<uint2*>(dst) = make_uint2(0, 0);
        }
        asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
        mbar_arrive(&tma_full[s]);
      }
    }
    return;
  }

  // ---- consumer warpgroups: rows [64 wg, 64 wg + 64) of the tile ----
  const int wg = tid >> 7, lane = tid & 31, wq = (tid >> 5) & 3;
  float acc[NACC];
  float part[BLOCKWISE ? NACC : 1];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  mbar_wait(&tma_full[0], 0);
  convert_stage<BN>(w8, wb, tid, wfmt);
  fence_proxy_async();
  named_bar_sync(1, CONSUMERS);  // stage 0's bf16 tile is whole
  for (int ks = 0; ks < nk; ++ks) {
    const int s = ks % NT;
    const uint64_t da = wgmma_desc(xs + s * X_BYTES + wg * 64 * 128, 16, 1024);
    const uint64_t db = wgmma_desc(wb + (ks & 1) * WB_BYTES, N_ATOM_BYTES, 1024);
    if constexpr (BLOCKWISE) {
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < BK / 16; ++i) {
        const int kg = ks * BK + i * 16;
        if (kg >= K) break;
        wgmma_bf16<BN>(part, da + 2 * i, db + 128 * i, kg % bs != 0);
        if ((kg + 16) % bs == 0) {  // end of a scale block: fold it in, scaled
          wgmma_commit();
          wgmma_wait<0>();
          const float* srow = scale + (size_t)(kg / bs) * N;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const int n = bn + 8 * j + 2 * (lane & 3);
            const float s0 = n < N ? srow[n] : 0.f, s1 = n < N ? srow[n + 1] : 0.f;
            acc[4 * j] = fmaf(part[4 * j], s0, acc[4 * j]);
            acc[4 * j + 1] = fmaf(part[4 * j + 1], s1, acc[4 * j + 1]);
            acc[4 * j + 2] = fmaf(part[4 * j + 2], s0, acc[4 * j + 2]);
            acc[4 * j + 3] = fmaf(part[4 * j + 3], s1, acc[4 * j + 3]);
          }
          wgmma_fence();
        }
      }
    } else {
      // Straight-line wgmma on pinned accumulators: no branch or register
      // move between them, so they pipeline. Past K the TMA tiles read zeros.
      wgmma_fence_operand<NACC>(acc);
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < BK / 16; ++i) wgmma_bf16<BN>(acc, da + 2 * i, db + 128 * i, 1);
    }
    wgmma_commit();
    wgmma_wait<1>();  // stage ks - 1's products have retired
    if constexpr (!BLOCKWISE) wgmma_fence_operand<NACC>(acc);
    if (ks > 0) mbar_arrive(&empty[(ks - 1) % NT]);
    if (ks + 1 < nk) {
      named_bar_sync(1, CONSUMERS);  // both warpgroups' step ks - 1 is done with its buffer
      const int s1 = (ks + 1) % NT;
      mbar_wait(&tma_full[s1], ((ks + 1) / NT) & 1);
      convert_stage<BN>(w8 + s1 * W8_BYTES, wb + ((ks + 1) & 1) * WB_BYTES, tid, wfmt);
      fence_proxy_async();
      named_bar_sync(1, CONSUMERS);  // stage ks + 1's bf16 tile is whole
    }
  }
  wgmma_wait<0>();
  wgmma_fence_operand<NACC>(acc);

  const int r0 = bm + wg * 64 + wq * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = bn + 8 * j + 2 * (lane & 3);
    if (n >= N) continue;
    const float s0 = BLOCKWISE ? 1.f : scale[n], s1 = BLOCKWISE ? 1.f : scale[n + 1];
    const float b0 = bias ? bias[n] : 0.f, b1 = bias ? bias[n + 1] : 0.f;
    if (r0 < M)
      store2<TO>(out + (size_t)r0 * N + n, activate(acc[4 * j] * s0 + b0, act),
                 activate(acc[4 * j + 1] * s1 + b1, act));
    if (r0 + 8 < M)
      store2<TO>(out + (size_t)(r0 + 8) * N + n, activate(acc[4 * j + 2] * s0 + b0, act),
                 activate(acc[4 * j + 3] * s1 + b1, act));
  }
}

template <typename TO, bool BLOCKWISE, int BN>
int launch(const void* x, const void* q, const void* scale, const void* bias, void* out, int M,
           int N, int K, int bs, int act, int wfmt, cudaStream_t stream) {
  using TL = Tile<BN>;
  CUtensorMap tmx, tmw;
  const int w_tma = N % 16 == 0;
  if (!encode_2d(&tmx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, K, BM, BK,
                 CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  if (w_tma) {
    if (!encode_2d(&tmw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, q, K, N, BK, BN,
                   CU_TENSOR_MAP_SWIZZLE_NONE))
      return static_cast<int>(cudaErrorInvalidValue);
  } else {
    tmw = tmx;  // unused: the weight goes through cp.async
  }
  auto kernel = qmm_kernel<TO, BLOCKWISE, BN>;
  static bool sized = false;
  if (!sized) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TL::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized = true;
  }
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);  // M tiles fastest: a
  kernel<<<grid, THREADS, TL::SMEM, stream>>>(  // weight tile is read by neighbouring blocks
      tmx, tmw, static_cast<const int8_t*>(q), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<TO*>(out), M, N, K, bs, act, w_tma, wfmt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [M, K] bf16 (16-byte-aligned base); q [K, N] one-byte weights in format
// wfmt (0 int8, 1 fp8 e4m3fn, 2 fp8 e5m2); scale [K / block_size, N] f32,
// the QTensor's own (no fp8 fixup); bias [N] f32 or null; out [M, N] f32 when out_f32 else
// bf16. act: 0 none, 1 GELU(tanh), 2 SiLU. Returns a cudaError_t (1,
// cudaErrorInvalidValue, when a TMA descriptor cannot be encoded).
extern "C" int qmm_int8(const void* x, const void* q, const void* scale, const void* bias,
                        void* out, int M, int N, int K, int block_size, int act, int out_f32,
                        int wfmt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 256-wide tiles halve the x tile reads per weight column, but only pay
  // while their grid still covers most of the card (tools/qmm_variants at
  // M 1024: wgu's 512 and wqkv's 96 such tiles gain, down's and wo's 64 lose).
  int sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const bool wide = block_size == K && 10 * ((M + BM - 1) / BM) * ((N + 255) / 256) >= 7 * sms;
#define QMM_LAUNCH(TO, BLOCKWISE, BN) \
  return launch<TO, BLOCKWISE, BN>(x, q, scale, bias, out, M, N, K, block_size, act, wfmt, s)
  if (out_f32) {
    if (block_size != K) QMM_LAUNCH(float, true, 128);
    if (wide) QMM_LAUNCH(float, false, 256);
    QMM_LAUNCH(float, false, 128);
  }
  if (block_size != K) QMM_LAUNCH(__nv_bfloat16, true, 128);
  if (wide) QMM_LAUNCH(__nv_bfloat16, false, 256);
  QMM_LAUNCH(__nv_bfloat16, false, 128);
#undef QMM_LAUNCH
}
