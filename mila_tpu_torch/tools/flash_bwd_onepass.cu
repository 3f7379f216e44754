// flash_bwd, one pass: a measured variant of csrc/flash_bwd.cu for
// tools/flash_bwd_variants (`--variants onepass`), not a kernel of the
// package. The dK/dV pass also computes each step's dQ partial, dS K_block
// (dS^T written to shared memory in bf16, read back transposed by wgmma),
// and adds it to an f32 dQ accumulator in device memory with atomics; a
// last launch rounds it to bf16. Five products instead of seven, but the
// f32 atomics make dQ's summation order, and so its bits, vary from call
// to call. The accumulator comes from the stream-ordered allocator, inside
// the call. Two consumer warpgroups at both head sizes (the dQ partial's
// registers do not fit three). Right only where Tkv is a multiple of the
// key block (the tool's shapes): a block's keys past Tkv are not loaded,
// and here their dS would reach dQ.
#include "common.cuh"
#include "mma.cuh"
#include "sm90.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int STATS_THREADS = 256;
constexpr int TQ_ALIGN = 64;  // the statistics rows are padded to this

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- stats -------------------------------------------------------------------

// Rows in the model's order (b, t, h), D / 8 lanes a row, each lane 8 of
// its values (16 bytes); the sum over the row's lanes by shuffles.
template <int D>
__global__ void __launch_bounds__(STATS_THREADS)
flash_bwd_stats_kernel(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ l, const float* __restrict__ m,
                       float* __restrict__ lse2, float* __restrict__ delta, int B, int Tq,
                       int Tq64, int NH) {
  constexpr int LPR = D / 8;
  const int part = threadIdx.x % LPR;
  const long long r = (long long)blockIdx.x * (STATS_THREADS / LPR) + threadIdx.x / LPR;
  const long long rows = (long long)B * Tq64 * NH;
  const int h = static_cast<int>(r % NH);
  const int t = static_cast<int>((r / NH) % Tq64);
  const int b = static_cast<int>(r / ((long long)NH * Tq64));
  const bool live = r < rows && t < Tq;
  float acc = 0.f;
  if (live) {
    const size_t off = (((size_t)b * Tq + t) * NH + h) * D + 8 * part;
    const uint4 ov = *reinterpret_cast<const uint4*>(o + off);
    const uint4 dv = *reinterpret_cast<const uint4*>(dout + off);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = __bfloat1622float2(o2[i]), c = __bfloat1622float2(d2[i]);
      acc = fmaf(a.x, c.x, acc);
      acc = fmaf(a.y, c.y, acc);
    }
  }
#pragma unroll
  for (int s = LPR / 2; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (r < rows && part == 0) {
    const size_t out = ((size_t)b * NH + h) * Tq64 + t;
    if (live) {
      const size_t in = ((size_t)b * NH + h) * Tq + t;
      const float lv = l[in];
      lse2[out] = fmaf(m[in], LOG2E, log2f(lv == 0.f ? 1.f : lv));
      delta[out] = acc;
    } else {
      lse2[out] = INFINITY;
      delta[out] = 0.f;
    }
  }
}

// ---- wgmma helpers (both passes) ---------------------------------------------

constexpr int SCHED = 1;
constexpr int PANEL64 = 64 * 128;  // 64 rows of one 64-column panel, bytes

// acc = A B^T for a warpgroup's 64 rows of A (a, K-major) against 64 rows of
// B (b, K-major): D / 16 k-slices, 32 bytes apart in a panel's 128-byte
// rows; a_panel and b_panel the bytes between their 64-column panels.
// Issued and committed as one group.
template <int D>
__device__ __forceinline__ void issue_abt(float* acc, const unsigned char* a, int a_panel,
                                          const unsigned char* b, int b_panel) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int p = kk / 4, off = 32 * (kk % 4);
    wgmma_m64n64k16<__nv_bfloat16, 0>(acc, wgmma_desc(a + p * a_panel + off, 16, 1024),
                                      wgmma_desc(b + p * b_panel + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// acc += bf16(A) B for A's 64 rows x 64 in registers (4 k-slices of 16) and
// B a 64-row tile read MN-major (the k-th slice 2048 k bytes in, LBO the
// bytes between its 64-column panels). Issued and committed as one group.
template <int D>
__device__ __forceinline__ void issue_ab(float* acc, const uint32_t (*a)[4],
                                         const unsigned char* b, int b_panel) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t bd = wgmma_desc(b + 2048 * kk, b_panel, 1024);
    if constexpr (D == 64)
      wgmma_m64n64k16_rs<__nv_bfloat16, 1>(acc, a[kk], bd, 1);
    else
      wgmma_m64n128k16_rs<__nv_bfloat16, 1>(acc, a[kk], bd, 1);
  }
  wgmma_commit();
}

// An accumulator of 64 x 64 packs into the A fragments of the next product
// (d[8 kk .. 8 kk + 7] are the four bf16 pairs of k-slice kk).
__device__ __forceinline__ void pack_a(uint32_t (*a)[4], const float* d) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack2(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
}

// ---- dkv (wgmma) ---------------------------------------------------------------

constexpr int KV_BQ = 64;  // queries per tile of the sweep
constexpr int RED = SCHED + 2;  // named barrier of the end-of-block sum

// NWG consumer warpgroups (3 at D 64, where a warpgroup's dK, dV, S^T and
// dP^T fit in the 168 registers a thread has at 384 threads; 2 at D 128).
// SPLIT: a block of 64 keys, every warpgroup on all of them, taking the
// sweep's steps in turn; else a block of 64 NWG keys, warpgroup wg on keys
// 64 wg .. 64 wg + 63, all on every step (each Q/dO tile loaded once for
// NWG times the keys).
template <int D, bool SPLIT>
struct KvCfg {
  static constexpr int NWG = 2;
  static constexpr int THREADS = 128 * NWG;
  static constexpr int BK = SPLIT ? 64 : 64 * NWG;  // keys per block
  static constexpr int PANELS = D / 64;
  static constexpr int K_PANEL = BK * 128, Q_PANEL = PANEL64;
  static constexpr int K_TILE = PANELS * K_PANEL, Q_TILE = PANELS * Q_PANEL;
  static constexpr int ST = 2 * KV_BQ * 4;  // a tile's lse2 and D, bytes
  static constexpr int NT = D == 64 ? 6 : 4;  // stages of the Q/dO ring (SPLIT: NT / NWG each)
  static constexpr int STEP = SPLIT ? NWG : 1;  // sweep steps between a warpgroup's steps
  static_assert(!SPLIT || NT % NWG == 0, "a warpgroup's steps keep to its own stages");
  static constexpr int DS = NWG * PANEL64;  // each warpgroup's bf16 dS^T, [64 keys][64 queries]
  static constexpr int SMEM = 2 * K_TILE + NT * (2 * Q_TILE + ST) + DS + (2 * NT + 1) * 8 + 1024;
};

// d[32] = A^T (A stored [16 k][64 m], MN-major, desc a) x B (16 x 64, MN-major,
// desc b): the SS wgmma with both transpose bits set.
__device__ __forceinline__ void wgmma_m64n64k16_bf16_tt(float* d, uint64_t a, uint64_t b,
                                                        int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// P^T and dS^T of one tile in place of S^T and dP^T: sc[4 jj + i] is key
// r0 + 8 (i / 2), query q0 + 8 jj + 2 t + i % 2, whose lse2 and D are st[8 jj
// + 2 t + i % 2] and st[KV_BQ + ...] (a lane's columns depend on t only, so
// the reads broadcast). p = 2^(s c - lse2), 0 where masked (the compare only
// on tiles that reach past the warp's last key, wkey + 15); ds = p (dp - D)
// scale.
__device__ __forceinline__ void dst_cols(float* sc, float* dp, int q0, int wkey, int r0, int t,
                                         int kv_offset, int causal, float c, const float* st,
                                         float scale) {
  const bool diag = causal && wkey + 15 > q0 + kv_offset;
#pragma unroll
  for (int jj = 0; jj < KV_BQ / 8; ++jj) {
    const float2 ls = *reinterpret_cast<const float2*>(st + 8 * jj + 2 * t);
    const float2 dl = *reinterpret_cast<const float2*>(st + KV_BQ + 8 * jj + 2 * t);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = 4 * jj + i;
      float p = ex2(fmaf(sc[e], c, -((i & 1) ? ls.y : ls.x)));
      if (diag && r0 + 8 * (i >> 1) > q0 + 8 * jj + 2 * t + (i & 1) + kv_offset) p = 0.f;
      sc[e] = p;
      dp[e] = (p * (dp[e] - ((i & 1) ? dl.y : dl.x))) * scale;
    }
  }
}

template <int D, bool SPLIT>
__global__ void __launch_bounds__(KvCfg<D, SPLIT>::THREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tmq, const __grid_constant__ CUtensorMap tmk,
                     const __grid_constant__ CUtensorMap tmv, const __grid_constant__ CUtensorMap tmo,
                     const float* __restrict__ lse2_in, const float* __restrict__ delta_in,
                     __nv_bfloat16* __restrict__ dk_out, __nv_bfloat16* __restrict__ dv_out,
                     float* __restrict__ dq_acc, int Tq, int Tq64, int Tkv, int NH, int NKV,
                     float sm_scale, int kv_offset, int causal) {
  using C = KvCfg<D, SPLIT>;
  constexpr int NT = C::NT, Q_TILE = C::Q_TILE, STEP = C::STEP, NWG = C::NWG;
  constexpr int NO = D / 2, NS = KV_BQ / 2;  // dK's (and dV's) and S^T's f32 registers
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (sm90_smem(smem_raw) & 1023)) & 1023);
  unsigned char* ks = smem;            // [PANELS][BK][64] bf16, swizzled
  unsigned char* vs = ks + C::K_TILE;  // the same
  unsigned char* qs = vs + C::K_TILE;  // [NT][PANELS][64][64]
  unsigned char* os = qs + NT * Q_TILE;
  unsigned char* dss = os + NT * Q_TILE;  // [NWG][64][64] bf16, swizzled
  float* st = reinterpret_cast<float*>(dss + C::DS);  // [NT][lse2, D][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(st + NT * 2 * KV_BQ);
  uint64_t* empty = full + NT;
  uint64_t* kv_full = empty + NT;

  const int tid = threadIdx.x;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * C::BK;  // the first key blocks see the most q tiles: they go first
  const int G = NH / NKV;
  // The sweep: the q tiles that see key k0 or later, from the tile holding
  // query k0 - kv_offset on (the TPU kernel's skip rule, per 64-row tile),
  // for every query head of the group.
  const int nq = (Tq + KV_BQ - 1) / KV_BQ;
  const int i0 = causal && k0 > kv_offset ? (k0 - kv_offset) / KV_BQ : 0;
  const int per_head = nq > i0 ? nq - i0 : 0;
  const int n_it = per_head * G;

  // One thread fills stage it % NT with sweep step it: the q tile's Q and
  // dO, and its rows' lse2 and D.
  auto load_stage = [&](int it) {
    const int s = it % NT, h = hk * G + it / per_head, q0 = (i0 + it % per_head) * KV_BQ;
    mbar_expect_tx(&full[s], 2 * Q_TILE + C::ST);
#pragma unroll
    for (int p = 0; p < C::PANELS; ++p) {
      tma_load_3d(qs + s * Q_TILE + p * PANEL64, &tmq, &full[s], h * D + 64 * p, q0, b);
      tma_load_3d(os + s * Q_TILE + p * PANEL64, &tmo, &full[s], h * D + 64 * p, q0, b);
    }
    const size_t row = ((size_t)b * NH + h) * Tq64 + q0;
    bulk_load(st + s * 2 * KV_BQ, lse2_in + row, KV_BQ * 4, &full[s]);
    bulk_load(st + s * 2 * KV_BQ + KV_BQ, delta_in + row, KV_BQ * 4, &full[s]);
  };
  if (tid == 0) {
    for (int s = 0; s < NT; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], SPLIT ? 128 : C::THREADS);
    }
    mbar_init(kv_full, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    // K and V in boxes of 64 keys per panel; a box that starts past Tkv (in
    // the last block when Tkv is not a multiple of BK) is not loaded: its
    // keys are never stored.
    const int boxes = min(C::BK, Tkv - k0) / 64;
    mbar_expect_tx(kv_full, 2 * boxes * C::PANELS * PANEL64);
#pragma unroll
    for (int p = 0; p < C::PANELS; ++p)
      for (int x = 0; x < boxes; ++x) {
        const int off = p * C::K_PANEL + x * PANEL64;
        tma_load_3d(ks + off, &tmk, kv_full, hk * D + 64 * p, k0 + 64 * x, b);
        tma_load_3d(vs + off, &tmv, kv_full, hk * D + 64 * p, k0 + 64 * x, b);
      }
    for (int it = 0; it < min(NT, n_it); ++it) load_stage(it);
  }

  // ---- consumer warpgroups ----
  const int wg = tid >> 7, lane = tid & 31, w = (tid >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int kw = SPLIT ? 0 : 64 * wg;  // the warpgroup's first key in the block
  const int wkey = k0 + kw + 16 * w;   // the warp's first key
  const int r0 = wkey + g;             // this thread's keys r0 and r0 + 8
  const float c = sm_scale * LOG2E;
  const unsigned char* kt = ks + kw * 128;
  const unsigned char* vt = vs + kw * 128;

  float dk[NO], dv[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dk[i] = dv[i] = 0.f;
  mbar_wait(kv_full, 0);
  const int first = SPLIT ? wg : 0;
  for (int it = first; it < n_it; it += STEP) {
    const int s = it % NT;
    float sc[NS], dp[NS];
    uint32_t pa[4][4], da[4][4];  // bf16(P^T), bf16(dS^T): the A fragments of dV and dK
    mbar_wait(&full[s], (it / NT) & 1);
    wgmma_fence();
    issue_abt<D>(sc, kt, C::K_PANEL, qs + s * Q_TILE, PANEL64);  // S^T = K Q^T
    issue_abt<D>(dp, vt, C::K_PANEL, os + s * Q_TILE, PANEL64);  // dP^T = V dO^T
    wgmma_wait<0>();
    wgmma_fence_operand<NS>(sc);
    wgmma_fence_operand<NS>(dp);
    dst_cols(sc, dp, (i0 + it % per_head) * KV_BQ, wkey, r0, t, kv_offset, causal, c,
             st + s * 2 * KV_BQ, sm_scale);
    pack_a(pa, sc);
    pack_a(da, dp);
    wgmma_fence_operand<NO>(dv);
    wgmma_fence_operand<NO>(dk);
    wgmma_fence();
    issue_ab<D>(dv, pa, os + s * Q_TILE, PANEL64);  // dV += P^T dO
    issue_ab<D>(dk, da, qs + s * Q_TILE, PANEL64);  // dK += dS^T Q
    // bf16(dS^T) into the warpgroup's swizzled [64 keys][64 queries] tile:
    // da[kk][r] is keys 16 w + g + 8 (r % 2), queries 16 kk + 8 (r / 2) + 2 t, +1.
    unsigned char* dsw = dss + wg * PANEL64;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int kr = 16 * w + g + 8 * (r & 1), chunk = 2 * kk + (r >> 1);
        *reinterpret_cast<uint32_t*>(dsw + kr * 128 + ((chunk ^ (kr & 7)) << 4) + 4 * t) =
            da[kk][r];
      }
    fence_proxy_async();
    named_bar_sync(RED + 1 + wg, 128);
    const int q0 = (i0 + it % per_head) * KV_BQ, h = hk * G + it / per_head;
    // dQ[q0 .. q0 + 63, 64-column panel p] += dS K_block, added to dq_acc.
#pragma unroll
    for (int p = 0; p < C::PANELS; ++p) {
      float dqp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64k16_bf16_tt(dqp, wgmma_desc(dsw + 2048 * kk, PANEL64, 1024),
                                wgmma_desc(kt + p * C::K_PANEL + 2048 * kk, C::K_PANEL, 1024),
                                kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_fence_operand<32>(dqp);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int q = q0 + 16 * w + g + 8 * hr;
        if (q >= Tq) continue;
        float* drow = dq_acc + (((size_t)b * Tq + q) * NH + h) * D + 64 * p;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          atomicAdd(drow + 8 * jj + 2 * t, dqp[4 * jj + 2 * hr]);
          atomicAdd(drow + 8 * jj + 2 * t + 1, dqp[4 * jj + 2 * hr + 1]);
        }
      }
    }
    wgmma_fence_operand<NO>(dv);
    wgmma_fence_operand<NO>(dk);
    // The stage is done with: refill it once all its users are (SPLIT: the
    // warpgroup's own first thread; else the last warpgroup's).
    mbar_arrive(&empty[s]);
    if ((SPLIT ? (tid & 127) == 0 : tid == 128 * (NWG - 1)) && it + NT < n_it) {
      mbar_wait(&empty[s], (it / NT) & 1);
      load_stage(it + NT);
    }
  }

  if constexpr (SPLIT) {
    // dK and dV of the block: warpgroup 0's sums plus those of warpgroups
    // 1 .. NWG - 1, in that order, through the ring's shared memory (Q's
    // and dO's stages) once all are done with it.
    static_assert((NWG - 1) * D * 128 * 4 <= 2 * NT * Q_TILE, "the sums fit the ring");
    float* red = reinterpret_cast<float*>(qs);  // [NWG - 1][2 NO][128]
    const int ltid = tid & 127;
    named_bar_sync(RED, C::THREADS);
    if (wg > 0) {
      float* mine = red + (wg - 1) * 2 * NO * 128;
#pragma unroll
      for (int i = 0; i < NO; ++i) {
        mine[i * 128 + ltid] = dk[i];
        mine[(NO + i) * 128 + ltid] = dv[i];
      }
    }
    named_bar_sync(RED, C::THREADS);
    if (wg > 0) return;
    for (int x = 0; x < NWG - 1; ++x) {
      const float* theirs = red + x * 2 * NO * 128;
#pragma unroll
      for (int i = 0; i < NO; ++i) {
        dk[i] += theirs[i * 128 + ltid];
        dv[i] += theirs[(NO + i) * 128 + ltid];
      }
    }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int key = r0 + 8 * hr;
    if (key >= Tkv) continue;
    const size_t row = (((size_t)b * Tkv + key) * NKV + hk) * D;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      *reinterpret_cast<__nv_bfloat162*>(dk_out + row + 8 * jj + 2 * t) =
          __floats2bfloat162_rn(dk[4 * jj + 2 * hr], dk[4 * jj + 2 * hr + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv_out + row + 8 * jj + 2 * t) =
          __floats2bfloat162_rn(dv[4 * jj + 2 * hr], dv[4 * jj + 2 * hr + 1]);
    }
  }
}

// Opts a kernel into `bytes` of dynamic shared memory, once per device.
template <typename K>
cudaError_t size_smem(K kern, int bytes, bool* sized) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && sized[dev]) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             bytes);
  if (e == cudaSuccess && dev < 64) sized[dev] = true;
  return e;
}

__global__ void dq_round_kernel(const float* __restrict__ acc, __nv_bfloat16* __restrict__ dq,
                                long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) dq[i] = __float2bfloat16_rn(acc[i]);
}

template <int D, bool SPLIT>
cudaError_t launch_dkv(const CUtensorMap& tmq, const CUtensorMap& tmk, const CUtensorMap& tmv,
                       const CUtensorMap& tmo, const float* lse2, const float* delta, void* dk,
                       void* dv, float* dq_acc, int B, int Tq, int Tq64, int Tkv, int NH, int NKV,
                       float sm_scale, int kv_offset, int causal, cudaStream_t stream) {
  using KC = KvCfg<D, SPLIT>;
  static bool sized[64] = {};
  auto kern = flash_bwd_dkv_kernel<D, SPLIT>;
  const cudaError_t e = size_smem(kern, KC::SMEM, sized);
  if (e != cudaSuccess) return e;
  kern<<<dim3(NKV, B, (Tkv + KC::BK - 1) / KC::BK), KC::THREADS, KC::SMEM, stream>>>(
      tmq, tmk, tmv, tmo, lse2, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), dq_acc, Tq, Tq64, Tkv, NH, NKV, sm_scale, kv_offset,
      causal);
  return cudaGetLastError();
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* l, const float* m, float* lse2, float* delta, void* dq, void* dk,
           void* dv, int B, int Tq, int Tkv, int NH, int NKV, float sm_scale, int kv_offset,
           int causal, cudaStream_t stream) {
  const int Tq64 = (Tq + TQ_ALIGN - 1) / TQ_ALIGN * TQ_ALIGN;
  const auto bf = static_cast<const __nv_bfloat16*>(dout);
  {
    const long long rows = (long long)B * Tq64 * NH;
    const int per_block = STATS_THREADS / (D / 8);
    const unsigned blocks = static_cast<unsigned>((rows + per_block - 1) / per_block);
    flash_bwd_stats_kernel<D><<<blocks, STATS_THREADS, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(o), bf, l, m, lse2, delta, B, Tq, Tq64, NH);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }

  CUtensorMap tmq, tmk, tmv, tmo;
  const auto bt = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!encode_3d(&tmq, bt, 2, q, B, Tq, (uint64_t)NH * D, 64, 64, sw) ||
      !encode_3d(&tmo, bt, 2, dout, B, Tq, (uint64_t)NH * D, 64, 64, sw) ||
      !encode_3d(&tmk, bt, 2, k, B, Tkv, (uint64_t)NKV * D, 64, 64, sw) ||
      !encode_3d(&tmv, bt, 2, v, B, Tkv, (uint64_t)NKV * D, 64, 64, sw))
    return static_cast<int>(cudaErrorInvalidValue);
  {
    // Blocks of 64 NWG keys load each Q/dO tile once for all warpgroups;
    // where they would not fill the card twice over (few batch rows and KV
    // heads: the first, heaviest blocks would set the time), 64-key blocks
    // divide the heaviest block's work by NWG instead.
    static int sms[64] = {};
    int dev = 0;
    cudaGetDevice(&dev);
    int n_sm = dev < 64 ? sms[dev] : 0;
    if (n_sm == 0) {
      cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
      if (dev < 64) sms[dev] = n_sm;
    }
    constexpr int BK = KvCfg<D, false>::BK;
    const bool split = (long long)B * NKV * ((Tkv + BK - 1) / BK) < 2LL * n_sm;
    const long long n = (long long)B * Tq * NH * D;
    float* acc = nullptr;
    cudaError_t e = cudaMallocAsync(reinterpret_cast<void**>(&acc), n * 4, stream);
    if (e != cudaSuccess) return static_cast<int>(e);
    cudaMemsetAsync(acc, 0, n * 4, stream);
    e = split ? launch_dkv<D, true>(tmq, tmk, tmv, tmo, lse2, delta, dk, dv, acc, B, Tq, Tq64,
                                    Tkv, NH, NKV, sm_scale, kv_offset, causal, stream)
              : launch_dkv<D, false>(tmq, tmk, tmv, tmo, lse2, delta, dk, dv, acc, B, Tq, Tq64,
                                     Tkv, NH, NKV, sm_scale, kv_offset, causal, stream);
    if (e != cudaSuccess) return static_cast<int>(e);
    dq_round_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(
        acc, static_cast<__nv_bfloat16*>(dq), n);
    e = cudaGetLastError();
    cudaFreeAsync(acc, stream);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o, dout, dq [B, Tq, NH, D]; k, v, dk, dv [B, Tkv, NKV, D], bf16,
// contiguous, with 16-byte-aligned bases (TMA); l, m f32 [B, NH, Tq] (the
// forward's row sum and max); lse2, delta f32 scratch [B, NH, Tq64], Tq64 =
// Tq rounded up to 64. Needs D in {64, 128}, Tkv % 64 == 0, NH % NKV == 0
// and, when causal, kv_offset >= 0 (checked by the Python wrapper). Three
// launches on `stream`: the statistics, dK/dV, dQ. Returns a cudaError_t
// (cudaErrorInvalidValue when a TMA descriptor cannot be encoded or D is not
// 64 or 128).
extern "C" int flash_bwd(const void* q, const void* k, const void* v, const void* o,
                         const void* dout, const void* l, const void* m, void* lse2, void* delta,
                         void* dq, void* dk, void* dv, int B, int Tq, int Tkv, int NH, int NKV,
                         int D, float sm_scale, int kv_offset, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lf = static_cast<const float*>(l);
  const float* mf = static_cast<const float*>(m);
  float* ls = static_cast<float*>(lse2);
  float* ds = static_cast<float*>(delta);
  if (B <= 0 || Tq <= 0 || Tkv <= 0) return static_cast<int>(cudaGetLastError());
  if (D == 64)
    return launch<64>(q, k, v, o, dout, lf, mf, ls, ds, dq, dk, dv, B, Tq, Tkv, NH, NKV, sm_scale,
                      kv_offset, causal, s);
  if (D == 128)
    return launch<128>(q, k, v, o, dout, lf, mf, ls, ds, dq, dk, dv, B, Tq, Tkv, NH, NKV,
                       sm_scale, kv_offset, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
