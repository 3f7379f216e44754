// flash_sync_bwd: the causal grouped-query flash-attention backward in f32
// from D 192, from the tf32 forward's row statistics (flash_tf32_fwd.cu: m
// of the scaled scores, l the f32 sum against the running max). The other
// types and head sizes run on TMA + wgmma: flash_bwd.cu (bf16 and fp16 at
// every D), flash_tf32_bwd.cu (f32 at D 64 and 128).
//
// Replaces the TPU kernels mila_tpu/kernels/flash_attention_bwd.py:
// _dkv_kernel (dK, dV) and _dq_kernel (dQ), entry flash_attention_bwd,
// at those head sizes. Per tile, as there:
//   p  = exp(s * scale - m) / l        (l == 0 taken as 1; masked p = 0)
//   dv += T(p)^T do
//   ds = p * (do v^T - D) * scale,     D = rowsum(o * do) in f32
//   dk += T(ds)^T q,  dq += T(ds) k
// with the causal tile skip under kv_offset >= 0 (T(x): x rounded to tf32).
//
// Bound on the H100: tensor-core operations (five products of 2 D
// multiply-adds per visible (query, key) pair and head; the two kernels of
// each call run seven, S and dP in each, and dP three times, on split
// operands summed in f32) against q, k, v, o, do, dq, dk, dv moved once.
// Two kernels a call, dQ (with D) first, then dK/dV (dq_split, dkv_split;
// namespace split below): 8 warps a block, which owns up to 512 columns of
// dQ (or of dK and dV), so S and dP are formed once a tile, on wgmma's tf32
// form; their operands copied by cp.async two jobs ahead and staged once,
// rounded to tf32 and split into hi and lo; dQ, dK and dV on mma.sync
// m16n8k8 .tf32. At D 192 and 256 (one column part) they
// replaced 4-warp mma.sync kernels that ran about twice as long (PERF.md
// §6, row 16).
// Layouts are the model's: q, o, do, dq [B, Tq, NH, D], k, v, dk, dv [B,
// Tkv, NKV, D], contiguous, 16-byte-aligned bases; l, m, delta f32 [B, NH,
// Tq].
//
// Built in two parts (kernels/_build.py: PARTS), one nvcc each: part 1
// instantiates the kernels, part 0 holds the C entry point.
#include "common.cuh"
#include "flash_part.cuh"
#include "mma.cuh"
#include "sm90.cuh"

namespace bwd_parts {  // one call's arguments, and each input type's launches

struct Call {
  void* const* ptrs;
  int B, Tq, Tkv, NH, NKV, D;
  float sm_scale;
  int kv_offset, causal;
  cudaStream_t stream;
};

int run_f32(const Call& c);  // from D 192: the split kernels

}  // namespace bwd_parts

namespace {

template <typename T>
struct Args {
  const T *q, *k, *v, *o, *dout;
  const float *m, *l;
  float* delta;
  T *dq, *dk, *dv;
  int Tq, Tkv, NH, NKV;
  float sm_scale;
  int kv_offset, causal;
};

// ---- f32: S and dP formed once a tile, on wgmma -----------------------------
//
// dq_split_kernel and dkv_split_kernel take f32 at D % 64 == 0 from 192. A
// block owns up to DC output columns (one part up to D 512, two at 1024:
// flash_part.cuh: dcmax_of), so S and dP are formed once per tile and part where the
// column-part kernels above form them once per 64 columns. Two
// warpgroups share a tile. S = Q K^T and dP = dO V^T run on wgmma's tf32
// form over 32-column panels, the queries as M in both kernels (every
// operand K-major as it sits in memory); dS (and P) go through shared
// memory; then the block's columns of dQ (or dK and dV) on mma.sync in the
// 8 warps' registers, DC / 4 each. The work is a sequence of jobs (a panel,
// or a chunk of rows of the part's columns), each job's operands copied by
// cp.async into a ring of 3 slots two jobs ahead. A panel's operands are
// then staged once, rounded to tf32 (cvt.rna) and, for dP's, split into hi
// and lo (lo = tf32(x - hi)), each by the thread that copied it, into
// wgmma's 128-byte-swizzled layout; a chunk's rows stay in f32 and are
// rounded as the fragments are read (by 2 warps, once each). dP sums the
// three products of each k-step into a zeroed tile and adds that in f32.
namespace split {

constexpr int THREADS = 256;                   // two warpgroups
constexpr int PW = 32;                         // columns a panel: a 128-byte row of tf32
constexpr int RING = 3;                        // cp.async slots: jobs in flight
// The column parts built, and a block's output columns at head size D
// (dcmax_of: the forward's rule); a head takes ceil(D / DC) parts.
using fpart::DC_LARGE;
using fpart::DC_SMALL;
using fpart::dcmax_of;

// A [ROWS][W] f32 panel, N float4 a thread: rows r0.. of a tensor seen from
// `src` (its column 0; row stride `stride`), columns below `nc`; rows at or
// past T and columns at or past nc are 0. With `src1`, the panel's second
// half of rows is rows r0.. of src1. copy and stage map threads to float4s
// alike, so a thread stages what it copied.
template <int ROWS, int W>
struct Panel {
  static constexpr int PER_ROW = W / 4, N = ROWS * PER_ROW / THREADS;
  static_assert(ROWS * PER_ROW % THREADS == 0, "a panel is whole float4s a thread");
  // By cp.async into dst ([ROWS][RS] f32); the zeros by this thread's stores.
  __device__ __forceinline__ static void copy(float* dst, int rs, const float* src,
                                              size_t stride, int r0, int T, int nc, int tid,
                                              const float* src1 = nullptr) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int idx = tid + i * THREADS, row = idx / PER_ROW, c = (idx % PER_ROW) * 4;
      int r = row;
      const float* from = src;
      if (src1 != nullptr && r >= ROWS / 2) {
        from = src1;
        r -= ROWS / 2;
      }
      float* d = dst + row * rs + c;
      if (r0 + r < T && c < nc)
        cp_async16(d, from + (size_t)(r0 + r) * stride + c);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  // This thread's copies in raw ([ROWS][W] f32) rounded to tf32 into hi and,
  // with lo, tf32(x - hi) into lo: wgmma's swizzled [ROWS][32] tiles (the
  // 16-byte chunk c of row r at chunk c ^ (r % 8) of a 128-byte row).
  __device__ __forceinline__ static void stage(const float* raw, uint32_t* hi, uint32_t* lo,
                                               int tid) {
    static_assert(W == 32, "swizzled rows are 128 bytes");
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int idx = tid + i * THREADS, r = idx / PER_ROW, c = (idx % PER_ROW) * 4;
      const float4 v = *reinterpret_cast<const float4*>(raw + r * W + c);
      const int at = r * 32 + ((((c >> 2) ^ r) & 7) << 2);
      const uint4 h = make_uint4(tf32(v.x), tf32(v.y), tf32(v.z), tf32(v.w));
      *reinterpret_cast<uint4*>(hi + at) = h;
      if (lo != nullptr)
        *reinterpret_cast<uint4*>(lo + at) =
            make_uint4(tf32(v.x - __uint_as_float(h.x)), tf32(v.y - __uint_as_float(h.y)),
                       tf32(v.z - __uint_as_float(h.z)), tf32(v.w - __uint_as_float(h.w)));
    }
  }
};

// d += A B on mma.sync m16n8k8 .tf32 (operands rounded to tf32 by cvt.rna,
// the sums f32; ROADMAP §C.2). Fragments (g = lane / 4, t = lane % 4): A
// a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4], a3 = A[g+8][t+4]; B b0 =
// B[t][g], b1 = B[t+4][g]; C c0, c1 = C[g][2t, 2t + 1], c2, c3 = C[g +
// 8][2t, 2t + 1].
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The k order inside a step is free (the products are summed), so the
// fragments below read k index t as column 2t and t + 4 as column 2t + 1
// of every tile: a C tile of 8 columns is then one A fragment as it stands
// (c0, c2, c1, c3), and the row loads are 8-byte pairs. A of a staged tf32
// tile, rows r0.. from column k0 (a row stride of 8 (mod 32) words keeps its pair loads free of
// bank conflicts); B of an f32 [k][n] tile, rounded to tf32 as it is read
// (4 (mod 32) words).
__device__ __forceinline__ void frag_a(uint32_t* a, const uint32_t* tile, int rs, int r0, int k0,
                                       int lane) {
  const int g = lane >> 2, t = lane & 3;
  const uint2 u = *reinterpret_cast<const uint2*>(tile + (r0 + g) * rs + k0 + 2 * t);
  const uint2 w = *reinterpret_cast<const uint2*>(tile + (r0 + g + 8) * rs + k0 + 2 * t);
  a[0] = u.x;
  a[1] = w.x;
  a[2] = u.y;
  a[3] = w.y;
}
__device__ __forceinline__ void frag_bt(uint32_t* b, const float* tile, int rs, int k0, int n0,
                                        int lane) {
  const float* p = tile + (k0 + 2 * (lane & 3)) * rs + n0 + (lane >> 2);
  b[0] = tf32(p[0]);
  b[1] = tf32(p[rs]);
}

// k-slice kk (8 columns) of a swizzled [rows][32] tile from row 0 of `p`.
__device__ __forceinline__ uint64_t slice(const uint32_t* p, int kk) {
  return wgmma_desc(p + 8 * kk, 16, 1024);
}

// One panel of S += A_q B_k^T and dP += A_o B_v^T for a warpgroup: A_q, A_o
// its 64 rows of Q and dO, B_k, B_v 32 rows of K and V (hi; dO and V also
// lo). dP's three products (hi hi, hi lo, lo hi) of each k-step sum into a
// zeroed tile on the tensor cores, which is added to dP in f32 every k-step
// (the tensor cores round their own sums toward 0; here the products cost
// no issue slots). A wait a k-step: the tile's 16 registers, not two.
__device__ __forceinline__ void s_dp_panel(float* s, float* dp, const uint32_t* q,
                                           const uint32_t* oh, const uint32_t* ol,
                                           const uint32_t* k, const uint32_t* vh,
                                           const uint32_t* vl) {
#pragma unroll
  for (int kk = 0; kk < PW / 8; ++kk) {
    float acc[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[e] = 0.f;
    wgmma_fence();
    wgmma_m64n32k8_tf32(s, slice(q, kk), slice(k, kk), 1);
    wgmma_m64n32k8_tf32(acc, slice(oh, kk), slice(vh, kk), 1);
    wgmma_m64n32k8_tf32(acc, slice(oh, kk), slice(vl, kk), 1);
    wgmma_m64n32k8_tf32(acc, slice(ol, kk), slice(vh, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_operand<16>(s);
    wgmma_fence_operand<16>(acc);
#pragma unroll
    for (int e = 0; e < 16; ++e) dp[e] += acc[e];
  }
}

// The 1024-byte-aligned start of dynamic shared memory (swizzle atoms).
__device__ __forceinline__ uint32_t* aligned_smem(unsigned char* raw) {
  return reinterpret_cast<uint32_t*>(raw + ((1024 - (smem_addr(raw) & 1023)) & 1023));
}

// dQ: one block per (64 query rows, head and column part, batch row), the
// heaviest q tiles of every head first (the grid's x runs over heads). Per
// key tile of 64: D / 32 panels of Q, dO, K and V (warpgroup w: S and dP of
// all 64 rows against keys 32 w..), T(dS) into shared memory, then chunks
// of KC keys x DC columns of K (warp w: rows 32 (w % 2).., columns DC / 4
// (w / 2)..: dQ += T(dS) K). The rows' D = sum o do from device memory
// (part 0 stores it for the dK/dV kernel).
namespace q {
constexpr int BQ = 64, BKV = 64;  // rows, keys a tile
constexpr int TS = BQ * PW;       // words a [64][32] tile
constexpr int DSR = BKV + 8;      // uint32 a dS row
template <int DC>
struct Smem {
  static constexpr int KC = DC <= DC_SMALL ? 32 : 16;  // keys a chunk: 10 or 8 float4 a thread
  static constexpr int CRS = DC + 4;                   // floats a chunk row
  static constexpr int SLOT = 4 * TS > KC * CRS ? 4 * TS : KC * CRS;  // floats a ring slot
  static constexpr int BYTES = (6 * TS + RING * SLOT + BQ * DSR + 3 * BQ) * 4 + 1024;
};
}  // namespace q

template <int DC>
__global__ void __launch_bounds__(THREADS, 1) dq_split_kernel(Args<float> a, int D) {
  using namespace q;
  using SM = Smem<DC>;
  constexpr int KC = SM::KC, CRS = SM::CRS, SLOT = SM::SLOT, NT = DC / 32;  // NT: n-tiles a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* staged = aligned_smem(smem_raw);                 // Q, dO hi, lo, K, V hi, lo [TS]
  float* ring = reinterpret_cast<float*>(staged + 6 * TS);   // [RING][SLOT]
  uint32_t* dst = reinterpret_cast<uint32_t*>(ring + RING * SLOT);  // T(dS) [BQ][DSR]
  float* mrow = reinterpret_cast<float*>(dst + BQ * DSR);    // m, 1 / l (0 -> 1), D [BQ] each
  float* lrow = mrow + BQ;
  float* drow = lrow + BQ;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wg = warp >> 2, wi = warp & 3;  // S phase: warpgroup wg, its warp wi
  const int rh = warp & 1, cq = warp >> 1;  // dQ phase: rows 32 rh.., columns cq DC / 4..
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest q tiles first, every head's
  const int parts = gridDim.x / a.NH;
  const int h = blockIdx.x / parts, c0 = (blockIdx.x % parts) * DC, nc = min(DC, D - c0);
  const int b = blockIdx.z;
  const int hk = h / (a.NH / a.NKV);
  const int q0 = qt * BQ;
  const size_t qstride = (size_t)a.NH * D, kstride = (size_t)a.NKV * D;
  const size_t qoff = (size_t)b * a.Tq * qstride + (size_t)h * D;
  const size_t koff = (size_t)b * a.Tkv * kstride + (size_t)hk * D;

  int n_kv = a.Tkv / BKV;
  if (a.causal) {
    const int last = q0 + BQ - 1 + a.kv_offset;
    n_kv = last < 0 ? 0 : min(n_kv, last / BKV + 1);
  }
  const int nps = D / PW, jt = nps + BKV / KC, total = n_kv * jt;

  // Job `job`'s operands into its ring slot (one cp.async group a job).
  auto issue = [&](int job) {
    if (job < total) {
      float* sl = ring + (job % RING) * SLOT;
      const int j = job / jt, i = job % jt;
      if (i < nps) {
        const int col = i * PW;
        Panel<BQ, PW>::copy(sl, PW, a.q + qoff + col, qstride, q0, a.Tq, PW, tid);
        Panel<BQ, PW>::copy(sl + TS, PW, a.dout + qoff + col, qstride, q0, a.Tq, PW, tid);
        Panel<BKV, PW>::copy(sl + 2 * TS, PW, a.k + koff + col, kstride, j * BKV, a.Tkv, PW, tid);
        Panel<BKV, PW>::copy(sl + 3 * TS, PW, a.v + koff + col, kstride, j * BKV, a.Tkv, PW, tid);
      } else {
        Panel<KC, DC>::copy(sl, CRS, a.k + koff + c0, kstride, j * BKV + (i - nps) * KC, a.Tkv,
                            nc, tid);
      }
    }
    cp_async_commit();
  };
  issue(0);
  issue(1);

  // The rows' statistics and D = sum o do, 4 threads a row. D is summed in
  // f64 and rounded once: past D 256 its f32 rounding would be most of what
  // dS = P (dP - D) keeps where a query sees one key.
  {
    const int rl = tid >> 2, t4 = tid & 3, row = q0 + rl;
    double acc = 0.0;
    if (row < a.Tq) {
      const float* orow = a.o + qoff + (size_t)row * qstride;
      const float* grow = a.dout + qoff + (size_t)row * qstride;
      for (int c = 4 * t4; c < D; c += 16) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(orow + c));
        const float4 y = __ldg(reinterpret_cast<const float4*>(grow + c));
        acc += (double)x.x * y.x + (double)x.y * y.y + (double)x.z * y.z + (double)x.w * y.w;
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (t4 == 0) {
      float mv = 0.f, lv = 1.f;
      if (row < a.Tq) {
        const size_t s = ((size_t)b * a.NH + h) * a.Tq + row;
        if (c0 == 0) a.delta[s] = (float)acc;
        mv = a.m[s];
        lv = a.l[s] == 0.f ? 1.f : a.l[s];
      }
      mrow[rl] = mv;
      lrow[rl] = 1.f / lv;
      drow[rl] = (float)acc;
    }
  }

  float dq[2][NT][4];
#pragma unroll
  for (int rb = 0; rb < 2; ++rb)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[rb][ni][e] = 0.f;
  // Job `job` begins: its operands are in (a panel staged), and the copies
  // of job + RING - 1 go out into the slot the job before it read.
  auto begin = [&](int job, bool panel) -> const float* {
    const float* sl = ring + (job % RING) * SLOT;
    cp_async_wait<RING - 2>();  // this thread's copies of the job are in
    if (panel) {
      __syncthreads();  // every warp is past the job before: the staged tiles are free
      Panel<BQ, PW>::stage(sl, staged, nullptr, tid);                         // Q
      Panel<BQ, PW>::stage(sl + TS, staged + TS, staged + 2 * TS, tid);       // dO hi, lo
      Panel<BKV, PW>::stage(sl + 2 * TS, staged + 3 * TS, nullptr, tid);      // K
      Panel<BKV, PW>::stage(sl + 3 * TS, staged + 4 * TS, staged + 5 * TS, tid);  // V hi, lo
      fence_proxy_async();  // the staged tiles are wgmma's operands
    }
    __syncthreads();  // the job's operands are in; its slot's last reader is done
    issue(job + RING - 1);
    return sl;
  };

  for (int j = 0, job = 0; j < n_kv; ++j) {
    // S and dP of the tile (their registers live for the panels only).
    float s[16], dp[16];  // the warpgroup's keys (wgmma m64n32's fragment)
#pragma unroll
    for (int e = 0; e < 16; ++e) s[e] = dp[e] = 0.f;
    const int kw = 32 * wg * PW;  // this warpgroup's 32 keys
    for (int i = 0; i < nps; ++i, ++job) {
      begin(job, true);
      s_dp_panel(s, dp, staged, staged + TS, staged + 2 * TS, staged + 3 * TS + kw,
                 staged + 4 * TS + kw, staged + 5 * TS + kw);
    }
    // T(dS) = T(P (dP - D) scale) into shared memory; p = exp(s scale - m) /
    // l, 0 where masked or past Tq. The first chunk's barrier publishes it.
    const int k0 = j * BKV + 32 * wg;
    float mr[2], il[2], dr[2];  // this thread's rows' m, 1 / l, D
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int rl = 16 * wi + g + 8 * hr;
      mr[hr] = mrow[rl];
      il[hr] = lrow[rl];
      dr[hr] = drow[rl];
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int rl = 16 * wi + g + 8 * hr, row = q0 + rl;
        uint32_t v[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 4 * jj + 2 * hr + c, key = k0 + 8 * jj + 2 * t + c;
          float p = 0.f;
          if (row < a.Tq && !(a.causal && key > row + a.kv_offset))
            p = expf(s[e] * a.sm_scale - mr[hr]) * il[hr];
          v[c] = tf32((p * (dp[e] - dr[hr])) * a.sm_scale);
        }
        *reinterpret_cast<uint2*>(dst + rl * DSR + 32 * wg + 8 * jj + 2 * t) =
            make_uint2(v[0], v[1]);
      }
    // dQ += T(dS) K over each chunk's keys, the warp's columns.
    for (int kc = 0; kc < BKV; kc += KC, ++job) {
      const float* sl = begin(job, false);
#pragma unroll
      for (int kk = 0; kk < KC / 8; ++kk) {
        uint32_t da[2][4];
#pragma unroll
        for (int rb = 0; rb < 2; ++rb)
          frag_a(da[rb], dst, DSR, 32 * rh + 16 * rb, kc + 8 * kk, lane);
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) {
          const int col = cq * (DC / 4) + 8 * ni;
          if (col >= nc) break;
          uint32_t bk[2];
          frag_bt(bk, sl, CRS, 8 * kk, col, lane);
#pragma unroll
          for (int rb = 0; rb < 2; ++rb) mma_tf32(dq[rb][ni], da[rb], bk);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int rb = 0; rb < 2; ++rb)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = q0 + 32 * rh + 16 * rb + g + 8 * hr;
      if (row >= a.Tq) continue;
      float* out = a.dq + qoff + (size_t)row * qstride + c0;
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        const int col = cq * (DC / 4) + 8 * ni;
        if (col < nc)
          *reinterpret_cast<float2*>(out + col + 2 * t) =
              make_float2(dq[rb][ni][2 * hr], dq[rb][ni][2 * hr + 1]);
      }
    }
}

// dK/dV: one block per (32 keys, KV head and column part, batch row), the
// first key blocks (the heaviest) of every head first, sweeping the q tiles
// of 128 rows that see its keys for every query head of the group. Per step: D / 32 panels of K, V, Q and dO (warpgroup w: S
// and dP of queries 64 w.. against the 32 keys), T(P^T) and T(dS^T) into
// shared memory, then chunks of QC queries x DC columns of Q and of dO
// (warp w: keys 16 (w % 2).., columns DC / 4 (w / 2)..: dV += T(P^T) dO, dK
// += T(dS^T) Q). dK and dV sum over the group in the block's registers.
namespace kv {
constexpr int KB = 32, BQD = 128;          // keys a block, queries a step
constexpr int KS = KB * PW, QS = BQD * PW;  // words a [KB][32] or [BQD][32] tile
constexpr int PRR = BQD + 8;                // uint32 a P^T / dS^T row
template <int DC>
struct Smem {
  static constexpr int QC = DC <= DC_SMALL ? 16 : 8;  // queries a chunk: 10 or 8 float4 a thread
  static constexpr int CRS = DC + 4;
  static constexpr int SLOT =
      2 * KS + 2 * QS > 2 * QC * CRS ? 2 * KS + 2 * QS : 2 * QC * CRS;  // floats a ring slot
  static constexpr int BYTES =
      (3 * KS + 3 * QS + RING * SLOT + 2 * KB * PRR + 3 * BQD) * 4 + 1024;
};
}  // namespace kv

template <int DC>
__global__ void __launch_bounds__(THREADS, 1) dkv_split_kernel(Args<float> a, int D) {
  using namespace kv;
  using SM = Smem<DC>;
  constexpr int QC = SM::QC, CRS = SM::CRS, SLOT = SM::SLOT, NT = DC / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* staged = aligned_smem(smem_raw);  // K, V hi, lo [KS]; Q, dO hi, lo [QS]
  float* ring = reinterpret_cast<float*>(staged + 3 * KS + 3 * QS);  // [RING][SLOT]
  uint32_t* pt = reinterpret_cast<uint32_t*>(ring + RING * SLOT);    // T(P^T) [KB][PRR]
  uint32_t* dt = pt + KB * PRR;                                      // T(dS^T) [KB][PRR]
  float* st = reinterpret_cast<float*>(dt + KB * PRR);  // m, l, D [BQD] each

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wg = warp >> 2, wi = warp & 3;  // S phase: queries 64 wg + 16 wi..
  const int kb = warp & 1, cq = warp >> 1;  // dK/dV phase: keys 16 kb.., columns cq DC / 4..
  const int parts = gridDim.x / a.NKV;
  const int hk = blockIdx.x / parts, c0 = (blockIdx.x % parts) * DC, nc = min(DC, D - c0);
  const int b = blockIdx.z;
  const int k0 = blockIdx.y * KB;  // the first key blocks, the heaviest, first for every head
  const int G = a.NH / a.NKV;
  const size_t qstride = (size_t)a.NH * D, kstride = (size_t)a.NKV * D;
  const size_t koff = (size_t)b * a.Tkv * kstride + (size_t)hk * D;

  const int nq = (a.Tq + BQD - 1) / BQD;
  int i0 = 0;
  if (a.causal) i0 = k0 - a.kv_offset > 0 ? (k0 - a.kv_offset) / BQD : 0;
  const int per_head = nq > i0 ? nq - i0 : 0;
  const int nps = D / PW, jt = nps + BQD / QC, total = per_head * G * jt;

  // Job `job`'s operands into its ring slot (one cp.async group a job); a
  // step's first panel also brings its rows' m, l and D. A step's
  // statistics land while the step before it sweeps its chunks, after that
  // step's dS.
  auto issue = [&](int job) {
    if (job < total) {
      float* sl = ring + (job % RING) * SLOT;
      const int it = job / jt, i = job % jt;
      const int h = hk * G + it / per_head, q0 = (i0 + it % per_head) * BQD;
      const size_t qoff = (size_t)b * a.Tq * qstride + (size_t)h * D;
      if (i < nps) {
        const int col = i * PW;
        Panel<KB, PW>::copy(sl, PW, a.k + koff + col, kstride, k0, a.Tkv, PW, tid);
        Panel<KB, PW>::copy(sl + KS, PW, a.v + koff + col, kstride, k0, a.Tkv, PW, tid);
        Panel<BQD, PW>::copy(sl + 2 * KS, PW, a.q + qoff + col, qstride, q0, a.Tq, PW, tid);
        Panel<BQD, PW>::copy(sl + 2 * KS + QS, PW, a.dout + qoff + col, qstride, q0, a.Tq, PW,
                             tid);
        if (i == 0 && tid < BQD) {
          const int row = q0 + tid;
          if (row < a.Tq) {
            const size_t s = ((size_t)b * a.NH + h) * a.Tq + row;
            cp_async4(st + tid, a.m + s);
            cp_async4(st + BQD + tid, a.l + s);
            cp_async4(st + 2 * BQD + tid, a.delta + s);
          } else {
            st[tid] = 0.f;
            st[BQD + tid] = 1.f;
            st[2 * BQD + tid] = 0.f;
          }
        }
      } else {
        const int r0 = q0 + (i - nps) * QC;
        Panel<2 * QC, DC>::copy(sl, CRS, a.q + qoff + c0, qstride, r0, a.Tq, nc, tid,
                                a.dout + qoff + c0);  // Q rows, then dO rows
      }
    }
    cp_async_commit();
  };
  issue(0);
  issue(1);

  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int ni = 0; ni < NT; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[ni][e] = dv[ni][e] = 0.f;
  // Job `job` begins: its operands are in (a panel staged), and the copies
  // of job + RING - 1 go out into the slot the job before it read.
  auto begin = [&](int job, bool panel) -> const float* {
    const float* sl = ring + (job % RING) * SLOT;
    cp_async_wait<RING - 2>();  // this thread's copies of the job are in
    if (panel) {
      __syncthreads();  // every warp is past the job before: the staged tiles are free
      Panel<KB, PW>::stage(sl, staged, nullptr, tid);                                  // K
      Panel<KB, PW>::stage(sl + KS, staged + KS, staged + 2 * KS, tid);                // V
      Panel<BQD, PW>::stage(sl + 2 * KS, staged + 3 * KS, nullptr, tid);               // Q
      Panel<BQD, PW>::stage(sl + 2 * KS + QS, staged + 3 * KS + QS, staged + 3 * KS + 2 * QS,
                            tid);                                                     // dO
      fence_proxy_async();  // the staged tiles are wgmma's operands
    }
    __syncthreads();  // the job's operands are in; its slot's last reader is done
    issue(job + RING - 1);
    return sl;
  };

  for (int it = 0, job = 0; it < per_head * G; ++it) {
    // S and dP of the step (their registers live for the panels only).
    float s[16], dp[16];  // the warpgroup's queries (wgmma m64n32's fragment)
#pragma unroll
    for (int e = 0; e < 16; ++e) s[e] = dp[e] = 0.f;
    const int qw = 64 * wg * PW;  // this warpgroup's 64 queries
    for (int i = 0; i < nps; ++i, ++job) {
      begin(job, true);
      s_dp_panel(s, dp, staged + 3 * KS + qw, staged + 3 * KS + QS + qw,
                 staged + 3 * KS + 2 * QS + qw, staged, staged + KS, staged + 2 * KS);
    }
    // T(P^T) and T(dS^T) into shared memory, keys as rows; the first chunk's
    // barrier publishes them.
    const int q0 = (i0 + it % per_head) * BQD;
    float mr[2], il[2], dr[2];  // this thread's queries' m, 1 / l (l == 0 as 1), D
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int ql = 64 * wg + 16 * wi + g + 8 * hr;
      const float lv = st[BQD + ql];
      mr[hr] = st[ql];
      il[hr] = 1.f / (lv == 0.f ? 1.f : lv);
      dr[hr] = st[2 * BQD + ql];
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int ql = 64 * wg + 16 * wi + g + 8 * hr, qrow = q0 + ql;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 4 * jj + 2 * hr + c, kl = 8 * jj + 2 * t + c;
          float p = 0.f;
          if (qrow < a.Tq && !(a.causal && k0 + kl > qrow + a.kv_offset))
            p = expf(s[e] * a.sm_scale - mr[hr]) * il[hr];
          pt[kl * PRR + ql] = tf32(p);
          dt[kl * PRR + ql] = tf32((p * (dp[e] - dr[hr])) * a.sm_scale);
        }
      }
    // dV += T(P^T) dO, dK += T(dS^T) Q over each chunk's queries.
    for (int qc = 0; qc < BQD; qc += QC, ++job) {
      const float* rows = begin(job, false);  // Q, then dO
#pragma unroll
      for (int kk = 0; kk < QC / 8; ++kk) {
        uint32_t pa[4], da[4];
        frag_a(pa, pt, PRR, 16 * kb, qc + 8 * kk, lane);
        frag_a(da, dt, PRR, 16 * kb, qc + 8 * kk, lane);
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) {
          const int col = cq * (DC / 4) + 8 * ni;
          if (col >= nc) break;
          uint32_t bo[2], bq[2];
          frag_bt(bo, rows + QC * CRS, CRS, 8 * kk, col, lane);
          frag_bt(bq, rows, CRS, 8 * kk, col, lane);
          mma_tf32(dv[ni], pa, bo);
          mma_tf32(dk[ni], da, bq);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const size_t row = koff + (size_t)(k0 + 16 * kb + g + 8 * hr) * kstride + c0;
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      const int col = cq * (DC / 4) + 8 * ni;
      if (col < nc) {
        *reinterpret_cast<float2*>(a.dk + row + col + 2 * t) =
            make_float2(dk[ni][2 * hr], dk[ni][2 * hr + 1]);
        *reinterpret_cast<float2*>(a.dv + row + col + 2 * t) =
            make_float2(dv[ni][2 * hr], dv[ni][2 * hr + 1]);
      }
    }
  }
}

template <int DC>
int launch_dc(const Args<float>& a, int B, int D, cudaStream_t stream) {
  auto dq = dq_split_kernel<DC>;
  auto dkv = dkv_split_kernel<DC>;
  constexpr int smem_dq = q::Smem<DC>::BYTES, smem_dkv = kv::Smem<DC>::BYTES;
  static bool sized_dq[64] = {}, sized_dkv[64] = {};
  if (const int e = size_smem(dq, smem_dq, sized_dq)) return e;
  if (const int e = size_smem(dkv, smem_dkv, sized_dkv)) return e;
  const int parts = (D + DC - 1) / DC;
  dq<<<dim3(a.NH * parts, (a.Tq + q::BQ - 1) / q::BQ, B), THREADS, smem_dq, stream>>>(a, D);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  dkv<<<dim3(a.NKV * parts, a.Tkv / kv::KB, B), THREADS, smem_dkv, stream>>>(a, D);
  return static_cast<int>(cudaGetLastError());
}

int launch(const Args<float>& a, int B, int D, cudaStream_t stream) {
  return dcmax_of(D) == DC_LARGE ? launch_dc<DC_LARGE>(a, B, D, stream)
                                 : launch_dc<DC_SMALL>(a, B, D, stream);
}

}  // namespace split

template <typename T>
Args<T> args_of(const bwd_parts::Call& c) {
  Args<T> a;
  a.q = static_cast<const T*>(c.ptrs[0]);
  a.k = static_cast<const T*>(c.ptrs[1]);
  a.v = static_cast<const T*>(c.ptrs[2]);
  a.o = static_cast<const T*>(c.ptrs[3]);
  a.dout = static_cast<const T*>(c.ptrs[4]);
  a.l = static_cast<const float*>(c.ptrs[5]);
  a.m = static_cast<const float*>(c.ptrs[6]);
  a.delta = static_cast<float*>(c.ptrs[7]);
  a.dq = static_cast<T*>(c.ptrs[8]);
  a.dk = static_cast<T*>(c.ptrs[9]);
  a.dv = static_cast<T*>(c.ptrs[10]);
  a.Tq = c.Tq;
  a.Tkv = c.Tkv;
  a.NH = c.NH;
  a.NKV = c.NKV;
  a.sm_scale = c.sm_scale;
  a.kv_offset = c.kv_offset;
  a.causal = c.causal;
  return a;
}

}  // namespace

#if IN_PART(1)
// f32 from D 192 (D 64, 128: flash_tf32_bwd.cu).
int bwd_parts::run_f32(const Call& c) {
  if (c.D >= 192 && c.D % 64 == 0) return split::launch(args_of<float>(c), c.B, c.D, c.stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
#endif

#if IN_PART(0)

// ptrs: q, k, v, o, do, l, m, delta, dq, dk, dv. q, o, do, dq [B, Tq, NH, D],
// k, v, dk, dv [B, Tkv, NKV, D], f32 (dtype 0; the 16-bit types run
// flash_bwd.cu at every D), contiguous, 16-byte-aligned bases; l, m f32 [B,
// NH, Tq] from the tf32 forward; delta f32 [B, NH, Tq] scratch. D any
// multiple of 64 from 192 (else cudaErrorInvalidValue), Tkv % 64 == 0, NH %
// NKV == 0 and, when causal, kv_offset >= 0 (checked by the Python wrapper).
// Two launches (dQ with D, then dK/dV) on `stream`.
extern "C" int flash_sync_bwd(void* const* ptrs, int B, int Tq, int Tkv, int NH, int NKV, int D,
                              int dtype, float sm_scale, int kv_offset, int causal,
                              void* stream) {
  if (B <= 0 || Tq <= 0 || Tkv <= 0) return static_cast<int>(cudaGetLastError());
  const bwd_parts::Call c{ptrs,     B,         Tq,     Tkv, NH, NKV, D,
                          sm_scale, kv_offset, causal, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return bwd_parts::run_f32(c);
  return static_cast<int>(cudaErrorInvalidValue);
}
#endif  // IN_PART(0)
