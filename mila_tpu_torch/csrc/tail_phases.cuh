// The layer tail's phases as device code, shared by layer_tail_int8.cu (one
// layer per launch) and decode_step_int8.cu (every layer of a decode step in
// one launch). Inside one persistent cooperative launch:
//   x1 = (att @ wo) * s + x;  xn = bf16(x1 * rstd(x1) * gamma_mlp)
//   g, u = (xn @ [gate | up]) * s;  h = bf16(silu(g) * u)
//   x_out = (h @ down) * s + x1;  out = x_out in T
//   xq = bf16(x_out * rstd(x_out) * gamma_next);  qkv = (xq @ wqkv_next) * s
//
// This is the arithmetic of the TPU kernels mila_tpu/kernels/layer_stream.py:
// _stream_kernel and layer_fused.py:_tail_kernel: x1 and x_out stay f32 into
// the next RMSNorm, h and the normalised inputs are rounded to bf16, and each
// tile's per-column scale row is applied to its f32 sum.
//
// The weights are pack_layer's stream: [T, H, bn] one-byte tiles in the
// order [wo | g0 u0 g1 u1 ... | down k-major | wqkv_next] with one f32
// scale row [T, 1, bn] per tile; a tail reads tiles [base, base + n_tiles).
// The tiles are int8 (WK = WK_INT8) or fp8 (WK = WK_FP8; e4m3fn or e5m2 by
// Params::wfmt), one instantiation each, which layer_tail_int8.cu and
// decode_step_int8.cu both build, or bf16 (WK = WK_BF16, unit scales: the
// giga pack of an unquantized model, decode_step_int8.cu only). (With one
// runtime branch a stage between the two conversions instead, the int8 tail
// read 5-9 % slower, PERF.md.) A bf16 row is twice the bytes, so its ring
// stages hold half the rows (Kind), and its products take the weights'
// bf16 pairs from shared memory as they are (bf16_stage_products). An fp8
// pack's scale rows carry JAX's decode fixup (2^120 or 2^112); the phases
// convert fp8 to its exact bf16 value (F8Pair, gemv.cuh) and divide the
// fixup out of each scale row.
//
// Design. Every phase needs the whole output of the previous one (RMSNorm
// needs all of x1, down all of h, the next RMSNorm all of x_out); the TPU
// kernel gets that by running its tiles in order on one core. Here all
// blocks stay resident (cooperative launch, grid sized from the occupancy)
// and meet at grid-wide barriers between the phases:
//   1 wo     GEMV units -> f32 partials p_wo[slice][M][H]
//   2 fin1   x1 = x + sum of slices; per-block row sums of squares
//   3 gu     GEMV units with xn staged -> p_gu[slice][M][2I] (gate | up)
//   4 fin_h  h = bf16(silu(g) * u) from the slice sums -> hbuf [M][I]
//   5 down   GEMV units with h staged -> p_down[kchunk*slices + slice][M][H]
//   6 fin2   x_out = x1 + sum; out; row sums of squares
//   7 qkv    GEMV units with xq staged -> p_q[slice][M][Nq]   (not last layer)
//   8 fin3   qkv = sum of slices                               (not last layer)
// A GEMV unit is (tile, group of 128 or 256 weight columns, K slice of kc
// rows); the plan (kernels/layer_fused.py:plan_tail) picks both per phase
// and gives each block at most one unit a phase where the tiles allow. The
// products run on the tensor cores as in K2 (qgemv_int8.cu): mma.sync
// m16n8k16 with the weight as the 16-row operand (y^T = W^T x^T, M <= 8
// one n-tile of x, M <= 32 four), lane (g, t) reading the word of columns
// 4g..4g+3 from rows 2t, 2t+1, 2t+8 and 2t+9 of a k-step and converting it
// exactly to bf16 pairs (s8_pair or F8Pair, gemv.cuh), and the unit's
// slice of x staged once as bf16 pairs in the fragments' order. Every GEMV
// input here is exact in bf16 (att, the normalised inputs, h) and so is
// every int8 or fp8 weight: the products are the TPU kernel's, only the f32
// sums run in another order. A 256-column unit gives each of the 8 warps 32 columns and
// every k-step; a 128-column one gives 4 warps its columns and splits each
// stage's k-steps between two warp sets, whose sums then add in shared
// memory in a fixed order.
// The weights stream through a ring of NST stages of SR rows by 16-byte
// cp.async (cached in L2 only); a block's units in a phase form one stream
// of stages, so a unit's first stages are in flight while the one before it
// ends. A phase requests its first stages before it stages x. On the card
// the L2 loads a block issues behind its own weight requests wait for them:
// requesting the next phase's stages before (or right after) a barrier
// delayed the barrier and the finish pass by more than it saved, and so did
// the rstd pass issued behind the first requests (tools/tail_phases.py,
// PERF.md); a 3-stage ring beat 2, 4 and 5.
// Partials (a slice's sum times the tile's scale row) go to global memory as
// f32 and the next phase adds them in slice order: no atomics, two calls
// are bit-equal. Data written inside the launch is read back with __ldcg
// (L2), never through the non-coherent or L1 paths.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"
#include "gemv.cuh"

namespace cg = cooperative_groups;

namespace tail {

// The tile stream's element kind, a template argument of the phases: one-
// byte int8 or fp8 tiles (the fp8 format is Params::wfmt), or bf16 tiles.
constexpr int WK_INT8 = 0, WK_FP8 = 1, WK_BF16 = 2;

#ifndef TAIL_MIN_BLOCKS
#define TAIL_MIN_BLOCKS 2  // resident blocks per SM the M <= 8 variants are built for
#endif
#ifndef TAIL_NST
#define TAIL_NST 3  // ring stages
#endif
#ifndef TAIL_XS_KB
#define TAIL_XS_KB 33  // x's staged slice, KB
#endif

constexpr int THREADS = 256, WARPS = THREADS / 32;
constexpr int SR = 64, NST = TAIL_NST, KS = SR / 16;  // SR: weight rows a stage; KS: its k-steps
constexpr int PITCH = 256 + 16;  // bytes a staged weight row: rows 2t of a k-step 8 banks apart
constexpr int XPAD = 4;          // words a staged row of x is padded by: conflict-free loads
constexpr int RING_BYTES = NST * SR * PITCH;
constexpr int XS_BYTES = TAIL_XS_KB * 1024;
// Dynamic shared memory of a block: the ring, then x's staged slice (which
// the 128-column units' k-half sums and K8's attention arrays reuse).
constexpr int SMEM_BYTES = RING_BYTES + XS_BYTES;
constexpr int RSTD_LOADS = 16;              // row_rstd's loads a lane
constexpr int MAX_GRID = 32 * RSTD_LOADS;  // blocks whose row sums row_rstd reads: 512

// A weight kind's bytes an element (EB), rows a ring stage (SRS: the same
// bytes a stage for every kind, so the ring fits RING_BYTES), bytes a
// staged row (PITCH: rows 2t of a k-step 8 banks apart) and k-steps a stage.
template <int WK>
struct Kind {
  static constexpr int EB = WK == WK_BF16 ? 2 : 1;
  static constexpr int SRS = SR / EB;
  static constexpr int PITCH = 256 * EB + 16;
  static constexpr int KSS = SRS / 16;
  static_assert(NST * SRS * PITCH <= RING_BYTES, "a kind's ring must fit the int8 ring");
};

// A value written earlier in the same launch, read through L2.
__device__ __forceinline__ float ldcg_f(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ldcg_f(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p))));
}

// Eight consecutive values (16-byte aligned) written earlier in the launch.
__device__ __forceinline__ void ldcg8(const float* p, float (&v)[8]) {
  const float4 a = __ldcg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldcg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void ldcg8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 r = __ldcg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// v = x[0 .. 7] * rstd * gamma[0 .. 7]: x written in the launch, gamma a
// weight (rounded to bf16 when staged).
__device__ __forceinline__ void norm8(const float* x, float rstd, const float* gamma,
                                      float (&v)[8]) {
  ldcg8(x, v);
  const float4 g0 = __ldg(reinterpret_cast<const float4*>(gamma));
  const float4 g1 = __ldg(reinterpret_cast<const float4*>(gamma) + 1);
  const float gm[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = v[e] * rstd * gm[e];
}

// A GEMV phase: tiles [t0, t0 + n) of the stream, in units of `cols` weight
// columns of one tile and one of ks K slices (n == 0: no phase).
struct Phase {
  int t0, n, ks, cols;
};

struct Params {
  const __nv_bfloat16* att;  // [M, H]
  const void* x;             // [M, H] T
  const float* g_mlp;        // [H]
  const float* g_next;       // [H]
  const int8_t* w;           // [Ttot, H, bn]
  const float* s;            // [Ttot, 1, bn]
  void* out;                 // [M, H] T
  void* qkv;                 // [M, Nq] T
  float *p_wo, *x1, *ssq1, *p_gu, *hbuf, *p_down, *xo, *ssq2, *p_q;
  int M, H, I, bn, base, n_qkv, ks_wo, ks_gu, ks_down, ks_q, cols_wo, cols_gu, cols_down, cols_q;
  float eps;
  int wfmt;  // WFMT_* of the tiles (gemv.cuh)
};

// The power of two that the layer-tail packs fold into an fp8 tile's scale
// row (kernels/layer_fused.py:_FP8_SCALE_FIXUP), undone: F8Pair's operands
// are the fp8 values themselves.
__device__ __forceinline__ float pack_scale_unfix(int fmt) {
  return fmt == WFMT_E4M3 ? 0x1p-120f : 0x1p-112f;
}

// A block's stream of weight stages in a phase. Its i-th unit, u =
// blockIdx.x + i * gridDim.x, is (tile u / (ks * groups), column group (u /
// ks) % groups, slice u % ks), nsteps stages of K::SRS rows. Each thread
// copies the same 16 bytes of every row it takes (rows r, r + rstep, ...);
// request() walks the stages in order, into ring slots 0, 1, .., NST - 1, 0,
// .., and divides only when it moves to the next unit.
template <int WK>
struct Stream {
  using K = Kind<WK>;
  const int8_t* w;
  int H, bn, t0, ks, cols, kc, groups, nsteps, mine;
  int r, cb, rstep;          // this thread's row and byte in a stage; rows between its copies
  const int8_t* src;         // this thread's first byte of the next stage to request
  int unit_i, stage_s, slot; // the next stage to request: unit, stage in it, ring slot

  __device__ Stream(const int8_t* w_, int H_, int bn_, const Phase& ph)
      : w(w_), H(H_), bn(bn_), t0(ph.t0), ks(ph.ks), cols(ph.cols), kc(H_ / ph.ks),
        groups(bn_ / ph.cols), nsteps(H_ / ph.ks / K::SRS), unit_i(0), stage_s(0), slot(0) {
    const int units = ph.n * groups * ks, b = blockIdx.x, cpr = cols * K::EB / 16;
    mine = units > b ? (units - 1 - b) / (int)gridDim.x + 1 : 0;
    r = threadIdx.x / cpr;
    cb = 16 * (threadIdx.x % cpr);
    rstep = THREADS / cpr;
    src = mine ? unit_src(0) : nullptr;
  }

  __device__ void unit(int i, int& t, int& grp, int& sl) const {
    const int u = blockIdx.x + i * gridDim.x;
    sl = u % ks;
    grp = (u / ks) % groups;
    t = u / (ks * groups);
  }

  __device__ const int8_t* unit_src(int i) const {
    int t, grp, sl;
    unit(i, t, grp, sl);
    return w + (((size_t)(t0 + t) * H + sl * kc + r) * bn + grp * cols) * K::EB + cb;
  }

  // Request the next stage into its ring slot as one commit group (an
  // empty one past the stream's end).
  __device__ void request(uint32_t ring) {
    if (unit_i < mine) {
      const uint32_t dst = ring + slot * (K::SRS * K::PITCH) + r * K::PITCH + cb;
      const size_t row = (size_t)bn * K::EB;  // bytes a tile row
#pragma unroll
      for (int c = 0; c < K::SRS * K::EB / 16; ++c)
        if (c * rstep < K::SRS)
          cp_async_to<16>(dst + c * rstep * K::PITCH, src + c * rstep * row);
      src += K::SRS * row;
      if (++stage_s == nsteps) {
        stage_s = 0;
        if (++unit_i < mine) src = unit_src(unit_i);
      }
      slot = slot + 1 == NST ? 0 : slot + 1;
    }
    cp_async_commit();
  }
};

// x's slice (rows m < MT, input columns k0 .. k0 + kc) into xs as bf16 pairs
// (x[m][k], x[m][k + 1]), rows past M zero. Word w of a stage (k = 2 w) sits
// at slot 2 KS (w % 4) + 2 (w / 8) + (w / 4) % 2, so lane t's B fragments
// for the stage's KS k-steps are 2 KS consecutive words. A thread loads XB
// chunks of 8 values before it stores them (their L2 round trips overlap).
template <int MT, typename Stage>
__device__ __forceinline__ void stage_x(Stage stage, int M, int k0, int kc, uint32_t* xs,
                                        int XP) {
  constexpr int XB = 4;
  const int cpr = kc / 8, n = MT * cpr;
  for (int c0 = 0; c0 < n; c0 += XB * THREADS) {
    float v[XB][8];
#pragma unroll
    for (int b = 0; b < XB; ++b) {
      const int i = c0 + threadIdx.x + b * THREADS, m = i / cpr;
      if (i < n && m < M) {
        stage(m, k0 + 8 * (i - m * cpr), v[b]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[b][e] = 0.f;
      }
    }
#pragma unroll
    for (int b = 0; b < XB; ++b) {
      const int i = c0 + threadIdx.x + b * THREADS, m = i / cpr, r = 8 * (i - m * cpr);
      if (i < n) {
        uint32_t* xr = xs + m * XP + (r / SR) * (SR / 2) + (r % SR) / 8;
#pragma unroll
        for (int e = 0; e < 4; ++e) xr[2 * KS * e] = pack2(v[b][2 * e], v[b][2 * e + 1]);
      }
    }
  }
}

// The products of a bf16 stage's k-steps [j0, j0 + ksw) (of its KSS; rows
// of PITCH bytes, sp at the lane's first column): lane (g, t) reads the 8
// bytes of its 4 columns from rows 2t, 2t + 1, 2t + 8 and 2t + 9 of the
// k-step and pairs the rows' halves by prmt into the A fragments, the
// layout s8_pair makes from bytes (column 4g + 2n of n-tile n in A row g,
// 4g + 2n + 1 in row g + 8); xw: the lane's x words of the stage (the B
// fragments of k-step j at 2j, 2j + 1; n-tile mt 8 mt XP words on).
template <int PITCH, int KSS, int MTN>
__device__ __forceinline__ void bf16_stage_products(float (&acc)[2][MTN][4],
                                                    const unsigned char* sp, const uint32_t* xw,
                                                    int XP, int t, int j0, int ksw) {
#pragma unroll
  for (int jj = 0; jj < KSS; ++jj) {
    if (jj >= ksw) break;
    const int j = j0 + jj;
    const unsigned char* r = sp + (16 * j + 2 * t) * PITCH;
    const uint2 w0 = *reinterpret_cast<const uint2*>(r);
    const uint2 w1 = *reinterpret_cast<const uint2*>(r + PITCH);
    const uint2 w2 = *reinterpret_cast<const uint2*>(r + 8 * PITCH);
    const uint2 w3 = *reinterpret_cast<const uint2*>(r + 9 * PITCH);
    uint2 bx[MTN];
#pragma unroll
    for (int mt = 0; mt < MTN; ++mt)
      bx[mt] = *reinterpret_cast<const uint2*>(xw + 8 * mt * XP + 2 * j);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const uint32_t a = n ? w0.y : w0.x, b = n ? w1.y : w1.x;
      const uint32_t c = n ? w2.y : w2.x, d = n ? w3.y : w3.x;
      const uint32_t af[4] = {prmt(a, b, 0x5410u), prmt(a, b, 0x7632u), prmt(c, d, 0x5410u),
                              prmt(c, d, 0x7632u)};
#pragma unroll
      for (int mt = 0; mt < MTN; ++mt) {
        const uint32_t bf[2] = {bx[mt].x, bx[mt].y};
        mma_bf16(acc[n][mt], af, bf);
      }
    }
  }
}

// One GEMV phase: this block's units of ph. xoff(t) is the input column at which
// tile t's rows start (down: its K chunk); stage(m, k, v) loads input values
// (m, k .. k + 7) as f32, exact in bf16; dst(t, sl, m, c) is the address of
// slice sl's partial for output column c of tile t (16-byte aligned for c %
// 4 == 0). The first weight stages are requested before x is staged (whose
// L2 loads then overlap them). WK: the tiles' kind (WK_FP8: fp8 in format
// wfmt). Ends without a barrier.
template <int MT, int WK = WK_INT8, typename XOff, typename Stage, typename Dst>
__device__ void gemv_phase(const int8_t* w, const float* s, int H, int bn, int M, const Phase& ph,
                           unsigned char* smem, XOff xoff, Stage stage, Dst dst,
                           int wfmt = WFMT_INT8) {
  constexpr int MTN = MT / 8;  // n-tiles of 8 rows of x
  using K = Kind<WK>;
  Stream<WK> g(w, H, bn, ph);
  const uint32_t ring = smem_addr(smem);
  uint32_t* xs = reinterpret_cast<uint32_t*>(smem + RING_BYTES);
  float4* half = reinterpret_cast<float4*>(xs);  // a 128-column unit's second k-half sums
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, gq = lane >> 2, tq = lane & 3;
  const int cwn = g.cols / 32, cw = warp % cwn, kw = warp / cwn;  // column warp, k-half
  const int ksw = K::KSS * cwn / WARPS, j0 = kw * ksw;  // the warp's k-steps of each stage
  const int XP = g.kc / 2 + XPAD;
  const F8Pair f8(wfmt);
  const float unfix = WK == WK_FP8 ? pack_scale_unfix(wfmt) : 1.f;
  for (int f = 0; f < NST - 1; ++f) g.request(ring);
  int staged = -1;  // input column of the slice in xs
  int slot = 0;     // ring slot of the stage consumed next
  for (int i = 0; i < g.mine; ++i) {
    int t, grp, sl;
    g.unit(i, t, grp, sl);
    const int k0 = xoff(t) + sl * g.kc, col = grp * g.cols + 32 * cw + 4 * gq;
    float4 sc = __ldg(reinterpret_cast<const float4*>(s + (size_t)(g.t0 + t) * bn + col));
    if constexpr (WK == WK_FP8)
      sc = make_float4(sc.x * unfix, sc.y * unfix, sc.z * unfix, sc.w * unfix);
    if (k0 != staged) {
      __syncthreads();  // the unit before is done with xs
      stage_x<MT>(stage, M, k0, g.kc, xs, XP);
      staged = k0;
    }

    float acc[2][MTN][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int mt = 0; mt < MTN; ++mt)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[n][mt][c] = 0.f;
    const unsigned char* wl = smem + (32 * cw + 4 * gq) * K::EB;
    const uint32_t* xl = xs + gq * XP + 2 * KS * tq + 2 * j0;
    for (int st = 0; st < g.nsteps; ++st) {
      cp_async_wait<NST - 2>();
      __syncthreads();  // this stage landed for every thread; the one before fully read
      g.request(ring);
      const unsigned char* sp = wl + slot * (K::SRS * K::PITCH);
      slot = slot + 1 == NST ? 0 : slot + 1;
      if constexpr (WK == WK_BF16) {
        // Two bf16 stages per staged 64-row stage of x: its k-steps 0-1, 2-3.
        bf16_stage_products<K::PITCH, K::KSS, MTN>(
            acc, sp, xs + gq * XP + 2 * KS * tq + (st >> 1) * (SR / 2) + 4 * (st & 1), XP, tq,
            j0, ksw);
      } else {
        uint4 bx[MTN][KS / 2];
#pragma unroll
        for (int mt = 0; mt < MTN; ++mt)
#pragma unroll
          for (int h = 0; h < KS / 2; ++h)
            if (2 * h < ksw)
              bx[mt][h] =
                  *reinterpret_cast<const uint4*>(xl + 8 * mt * XP + st * (SR / 2) + 4 * h);
        if constexpr (WK == WK_FP8)
          stage_products<PITCH, KS, MTN>(acc, sp, bx, tq, j0, ksw, f8);
        else
          stage_products<PITCH, KS, MTN>(acc, sp, bx, tq, j0, ksw, S8Pair{});
      }
    }

    // The lane's sums: rows m = 8 mt + 2 tq + e of x, columns col .. col + 3
    // (c0, c1 of n-tile n: column col + 2n; c2, c3: column col + 2n + 1).
    if (cwn < WARPS) {  // 128 columns: the second k-half hands its sums over
      __syncthreads();  // every warp is done with xs, which `half` reuses
      if (kw == 1) {
#pragma unroll
        for (int mt = 0; mt < MTN; ++mt)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            half[(8 * mt + 2 * tq + e) * 32 + 8 * cw + gq] =
                make_float4(acc[0][mt][e], acc[0][mt][2 + e], acc[1][mt][e], acc[1][mt][2 + e]);
      }
      __syncthreads();
      staged = -1;
    }
    if (kw == 0) {
#pragma unroll
      for (int mt = 0; mt < MTN; ++mt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = 8 * mt + 2 * tq + e;
          if (m >= M) continue;
          float4 v = make_float4(acc[0][mt][e], acc[0][mt][2 + e], acc[1][mt][e],
                                 acc[1][mt][2 + e]);
          if (cwn < WARPS) {
            const float4 o = half[m * 32 + 8 * cw + gq];
            v = make_float4(v.x + o.x, v.y + o.y, v.z + o.z, v.w + o.w);
          }
          *reinterpret_cast<float4*>(dst(t, sl, m, col)) =
              make_float4(v.x * sc.x, v.y * sc.y, v.z * sc.z, v.w * sc.w);
        }
    }
  }
}

// rstd[m] from the per-block row sums of squares of the previous phase, a
// warp a row, a lane's loads all in flight at once.
__device__ __forceinline__ void row_rstd(const float* ssq, int M, int H, float eps,
                                         float* rstd) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int m = warp; m < M; m += WARPS) {
    float part[RSTD_LOADS];
#pragma unroll
    for (int j = 0; j < RSTD_LOADS; ++j) {
      const int blk = lane + 32 * j;
      part[j] = blk < (int)gridDim.x ? __ldcg(ssq + (size_t)m * gridDim.x + blk) : 0.f;
    }
    float v = 0.f;
#pragma unroll
    for (int j = 0; j < RSTD_LOADS; ++j) v += part[j];
    v = warp_sum(v);
    if (lane == 0) rstd[m] = rsqrtf(v / H + eps);
  }
}

// Per-row sums of squares of a block's elements in a fixed order (no float
// atomics, so two calls are bit-equal): lane 0 of each warp adds its warp's
// sum into the warp's own row sq[warp][m] in loop order, and store_ssq adds
// the warps in order.
__device__ __forceinline__ void clear_sq(float (*sq)[32]) {
  for (int i = threadIdx.x; i < WARPS * 32; i += THREADS) sq[i / 32][i % 32] = 0.f;
  __syncthreads();
}

// Store the block's per-row sums of squares, row-major [M][grid] (row_rstd
// then reads each row's sums with whole-warp loads).
__device__ __forceinline__ void store_ssq(const float (*sq)[32], float* ssq, int M) {
  __syncthreads();
  for (int m = threadIdx.x; m < M; m += THREADS) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) v += sq[w][m];
    ssq[(size_t)m * gridDim.x + blockIdx.x] = v;
  }
}

// Tiles whose rows start at input column 0 (every phase but down).
struct NoOffset {
  __device__ int operator()(int) const { return 0; }
};

// Phases 7-8: qkv = (bf16(src * rstd * gamma) @ the tiles of ph) * s, rstd
// from the row sums of squares ssq (stored before the last barrier). src
// [M, H] f32 was written in this launch. Ends without a barrier.
template <int MT, typename T, int WK = WK_INT8>
__device__ void qkv_phases(const int8_t* w, const float* s, const float* src, const float* ssq,
                           const float* gamma, int M, int H, int bn, const Phase& ph,
                           float eps, float* p_q, T* qkv,
                           unsigned char* smem, float* rstd_s, cg::grid_group& grid,
                           int wfmt = WFMT_INT8) {
  const int Nq = ph.n * bn;
  row_rstd(ssq, M, H, eps, rstd_s);
  __syncthreads();
  gemv_phase<MT, WK>(
      w, s, H, bn, M, ph, smem, NoOffset{},
      [&](int m, int k, float(&v)[8]) { norm8(src + (size_t)m * H + k, rstd_s[m], gamma + k, v); },
      [&](int t, int sl, int m, int c) { return p_q + ((size_t)sl * M + m) * Nq + t * bn + c; },
      wfmt);
  grid.sync();
  const int stride = gridDim.x * THREADS;
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < M * Nq; i += stride) {
    float v = 0.f;
#pragma unroll 16
    for (int sl = 0; sl < ph.ks; ++sl) v += __ldcg(p_q + (size_t)sl * M * Nq + i);
    qkv[i] = from_f<T>(v);
  }
}

// Phases 1-8 of one layer; ends without a barrier (after fin3, or after
// fin2 when n_qkv == 0, with the row sums of squares of x_out in ssq2 and
// x_out itself in xo either way). att and x may have been written earlier
// in the same launch.
template <int MT, typename T, int WK = WK_INT8>
__device__ void tail_phases(const Params& p, unsigned char* smem, cg::grid_group& grid) {
  __shared__ float rstd_s[32], sq_w[WARPS][32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int M = p.M, H = p.H, I = p.I, bn = p.bn;
  const int n_cols = H / bn, n_wo = n_cols, n_gu = 2 * I / bn, n_down = (I / H) * n_cols;
  const int t_wo = p.base, t_gu = t_wo + n_wo, t_down = t_gu + n_gu, t_q = t_down + n_down;
  const Phase wo{t_wo, n_wo, p.ks_wo, p.cols_wo}, gu{t_gu, n_gu, p.ks_gu, p.cols_gu},
      down{t_down, n_down, p.ks_down, p.cols_down}, qkv{t_q, p.n_qkv, p.ks_q, p.cols_q};
  const T* x = static_cast<const T*>(p.x);
  const int stride = gridDim.x * THREADS;

  // 1 wo.
  gemv_phase<MT, WK>(
      p.w, p.s, H, bn, M, wo, smem, NoOffset{},
      [&](int m, int k, float(&v)[8]) { ldcg8(p.att + (size_t)m * H + k, v); },
      [&](int t, int sl, int m, int c) {
        return p.p_wo + ((size_t)sl * M + m) * H + t * bn + c;
      },
      p.wfmt);
  grid.sync();

  // 2 fin1: x1 = x + sum of the wo slices; row sums of squares.
  clear_sq(sq_w);
  for (int i = blockIdx.x * THREADS + tid; i < M * H; i += stride) {  // whole warps: H % 32 == 0
    float v = ldcg_f(x + i);
#pragma unroll 16
    for (int sl = 0; sl < p.ks_wo; ++sl) v += __ldcg(p.p_wo + (size_t)sl * M * H + i);
    p.x1[i] = v;
    const float sq = warp_sum(v * v);
    if (lane == 0) sq_w[warp][i / H] += sq;
  }
  store_ssq(sq_w, p.ssq1, M);
  grid.sync();

  // 3 gate | up, input bf16(x1 * rstd * gamma_mlp).
  row_rstd(p.ssq1, M, H, p.eps, rstd_s);
  __syncthreads();
  gemv_phase<MT, WK>(
      p.w, p.s, H, bn, M, gu, smem, NoOffset{},
      [&](int m, int k, float(&v)[8]) {
        norm8(p.x1 + (size_t)m * H + k, rstd_s[m], p.g_mlp + k, v);
      },
      [&](int t, int sl, int m, int c) {
        return p.p_gu + ((size_t)sl * M + m) * 2 * I + (t & 1) * I + (t >> 1) * bn + c;
      },
      p.wfmt);
  grid.sync();

  // 4 fin_h: h = bf16(silu(g) * u).
  for (int i = blockIdx.x * THREADS + tid; i < M * I; i += stride) {
    const int m = i / I, n = i % I;
    float g = 0.f, u = 0.f;
#pragma unroll 4
    for (int sl = 0; sl < p.ks_gu; ++sl) {
      const float* row = p.p_gu + ((size_t)sl * M + m) * 2 * I;
      g += __ldcg(row + n);
      u += __ldcg(row + I + n);
    }
    p.hbuf[i] = round_bf16(g / (1.f + expf(-g)) * u);
  }
  grid.sync();

  // 5 down: tile d covers rows [kchunk * H, +H) of down, columns nc * bn.
  gemv_phase<MT, WK>(
      p.w, p.s, H, bn, M, down, smem, [&](int t) { return (t / n_cols) * H; },
      [&](int m, int k, float(&v)[8]) { ldcg8(p.hbuf + (size_t)m * I + k, v); },
      [&](int t, int sl, int m, int c) {
        return p.p_down + (((size_t)(t / n_cols) * p.ks_down + sl) * M + m) * H +
               (t % n_cols) * bn + c;
      },
      p.wfmt);
  grid.sync();

  // 6 fin2: x_out = x1 + sum of the down partials.
  clear_sq(sq_w);
  const int n_dp = (I / H) * p.ks_down;
  T* out = static_cast<T*>(p.out);
  for (int i = blockIdx.x * THREADS + tid; i < M * H; i += stride) {
    float v = __ldcg(p.x1 + i);
#pragma unroll 16
    for (int sl = 0; sl < n_dp; ++sl) v += __ldcg(p.p_down + (size_t)sl * M * H + i);
    out[i] = from_f<T>(v);
    p.xo[i] = v;
    const float sq = warp_sum(v * v);
    if (lane == 0) sq_w[warp][i / H] += sq;
  }
  store_ssq(sq_w, p.ssq2, M);
  if (p.n_qkv == 0) return;  // the last layer has no next wqkv
  grid.sync();

  // 7-8 the next layer's wqkv, input bf16(x_out * rstd * gamma_next).
  qkv_phases<MT, T, WK>(p.w, p.s, p.xo, p.ssq2, p.g_next, M, H, bn, qkv, p.eps, p.p_q,
                         static_cast<T*>(p.qkv), smem, rstd_s, grid, p.wfmt);
}

// Kernel k opted into SMEM_BYTES of dynamic shared memory on first use.
inline const void* opted(const void* k, bool* done) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64 || !done[dev]) {
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (dev < 64) done[dev] = true;
  }
  return k;
}

inline int blocks_per_sm(const void* k, int* out) {
  *out = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, k, THREADS, SMEM_BYTES);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

}  // namespace tail
