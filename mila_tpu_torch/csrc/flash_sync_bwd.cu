// flash_sync_bwd: the causal grouped-query flash-attention backward from the
// forward's row statistics, on mma.sync, for what the TMA + wgmma backward
// (flash_bwd.cu, bf16 and fp16 at D 64-256) does not take: f32 at every D
// % 64 == 0, bf16 and fp16 past D 256 (the fragments and the tf32 rounding
// of f32 are in flash_sync.cuh). Its statistics come from the same
// family's forward (flash_sync_fwd.cu).
//
// Replaces the TPU kernels mila_tpu/kernels/flash_attention_bwd.py:
// _dkv_kernel (dK, dV) and _dq_kernel (dQ), entry flash_attention_bwd, at
// those types and head sizes. Per tile, as there:
//   p  = exp(s * scale - m) / l        (l == 0 taken as 1; masked p = 0)
//   dv += T(p)^T do
//   ds = p * (do v^T - D) * scale,     D = rowsum(o * do) in f32
//   dk += T(ds)^T q,  dq += T(ds) k
// with the causal tile skip under kv_offset >= 0 (T(x): x rounded to the
// inputs' type, tf32 for f32). dq is stored in q's type, dk and dv in k's.
//
// Bound on the H100: tensor-core operations (five products of 2 D
// multiply-adds per visible (query, key) pair and head; the two kernels
// here run seven, S and dP in each, at D 192 and 256 the dK/dV blocks two
// more (below), and f32 runs dP three times, flash_sync.cuh) against q, k,
// v, o, do, dq, dk, dv moved once. The simple family: right first, its
// times in PERF.md. Two kernels, 4 warps of 16 rows each:
//   dq (first): one block per (64 query rows, head, batch row), heaviest q
//     tiles first. Q and dO tiles in shared memory; K/V tiles of N keys
//     (Tile<T, D>) streamed by cp.async, double buffered. Before the loop the
//     block forms its rows' D = sum o do from o (device memory) and dO
//     (shared memory) and stores it into the scratch `delta`, which the dK/dV
//     kernel reads after it. S = Q K^T and dP = dO V^T, dS in S's registers,
//     dQ += T(dS) K.
//   dkv: one block per (64 keys, KV head and column part, batch row). K and
//     V stay in shared memory; the block sweeps the q tiles of N rows that
//     see its keys for every query head of the group, Q, dO and the rows' m,
//     l, D streamed by cp.async, double buffered. Each warp computes S^T = K
//     Q^T and dP^T = V dO^T for its 16 keys, so P^T and dS^T are A fragments
//     in place, and dV += T(P^T) dO, dK += T(dS^T) Q. dK and dV sum over the
//     group in one f32 accumulator inside the block (the TPU kernel writes
//     f32 per query head and sums afterwards: f32 order only). At D 192 and
//     256 (f32) a block keeps half the columns of dK and dV (the D / 2
//     registers of both would not fit beside S^T and dP^T): two blocks per
//     key block, each running S^T and dP^T in full.
//   past D 256 (dq_wide, dkv_wide): as dq and dkv, but a block owns a
//     column part of dQ (or of dK and dV) and streams the operands of S and
//     dP in 64-column panels (flash_sync.cuh: Wide); D is formed from o and
//     dO in device memory.
// Layouts are the model's: q, o, do, dq [B, Tq, NH, D], k, v, dk, dv [B,
// Tkv, NKV, D], contiguous, 16-byte-aligned bases; l, m, delta f32 [B, NH,
// Tq].
//
// Built in four parts (kernels/_build.py: PARTS), one nvcc each: parts 1, 2
// and 3 instantiate the f32 (D 64-256 and past 256), bf16 and fp16 (past
// D 256) kernels, part 0 holds the C entry point.
#include <type_traits>

#include "flash_sync.cuh"

namespace bwd_parts {  // one call's arguments, and each input type's launches

struct Call {
  void* const* ptrs;
  int B, Tq, Tkv, NH, NKV, D;
  float sm_scale;
  int kv_offset, causal;
  cudaStream_t stream;
};

int run_f32(const Call& c);
int run_bf16(const Call& c);
int run_f16(const Call& c);

}  // namespace bwd_parts

namespace {

using namespace fsync;

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

// Column parts of dK/dV a key block is split into (see the top).
template <int D>
__host__ __device__ constexpr int parts() {
  return D >= 192 ? 2 : 1;
}

// dS = P (dP - D) scale in place of dP for the warp's 16 query rows (r0,
// r0 + 8) x BKV keys from k0 (the dQ kernels): p = exp(s scale - m) / l,
// 0 where masked or past Tq.
template <typename T, int BKV>
__device__ __forceinline__ void ds_rows(float (*s)[4], float (*dp)[4], const Args<T>& a,
                                        int r0, int k0, int t, const float* mr, const float* lr,
                                        const float* dr) {
#pragma unroll
  for (int ni = 0; ni < BKV / 8; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hr = e >> 1, row = r0 + 8 * hr;
      const int key = k0 + ni * 8 + 2 * t + (e & 1);
      float p = 0.f;
      if (row < a.Tq && !(a.causal && key > row + a.kv_offset))
        p = expf(s[ni][e] * a.sm_scale - mr[hr]) / lr[hr];
      dp[ni][e] = (p * (dp[ni][e] - dr[hr])) * a.sm_scale;
    }
}

// P^T and dS^T in place of S^T and dP^T for the warp's 16 keys (key0, key0
// + 8) x BQD queries from q0 (the dK/dV kernels; the columns are queries,
// whose m, l and D are st[col], st[BQD + col], st[2 BQD + col]).
template <typename T, int BQD>
__device__ __forceinline__ void ds_cols(float (*s)[4], float (*dp)[4], const Args<T>& a, int q0,
                                        int key0, int t, const float* st) {
#pragma unroll
  for (int ni = 0; ni < BQD / 8; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = ni * 8 + 2 * t + (e & 1);
      const int qrow = q0 + col, key = key0 + 8 * (e >> 1);
      float p = 0.f;
      if (qrow < a.Tq && !(a.causal && key > qrow + a.kv_offset)) {
        const float lv = st[BQD + col];
        p = expf(s[ni][e] * a.sm_scale - st[col]) / (lv == 0.f ? 1.f : lv);
      }
      s[ni][e] = p;
      dp[ni][e] = (p * (dp[ni][e] - st[2 * BQD + col])) * a.sm_scale;
    }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) dq_kernel(Args<T> a) {
  using O = Ops<T>;
  constexpr int BKV = Tile<T, D>::N, RS = Tile<T, D>::RS, KS = O::KS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [BQ][RS]
  T* Os = Qs + BQ * RS;                      // dO [BQ][RS]
  T* Ks = Os + BQ * RS;                      // [2][BKV][RS]
  T* Vs = Ks + 2 * BKV * RS;                 // [2][BKV][RS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest q tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.NH / a.NKV);
  const int q0 = qt * BQ;
  const int r0 = q0 + warp * 16 + g;  // this thread's rows r0 and r0 + 8
  const size_t qstride = (size_t)a.NH * D, kstride = (size_t)a.NKV * D;
  const size_t qoff = (size_t)b * a.Tq * qstride + (size_t)h * D;
  const size_t koff = (size_t)b * a.Tkv * kstride + (size_t)hk * D;

  int n_kv = a.Tkv / BKV;
  if (a.causal) {
    const int last = q0 + BQ - 1 + a.kv_offset;
    n_kv = last < 0 ? 0 : min(n_kv, last / BKV + 1);
  }
  auto load_kv = [&](int buf, int j) {
    load_block<T, RS>(Ks + buf * BKV * RS, a.k + koff, kstride, j * BKV, BKV, D, a.Tkv, tid);
    load_block<T, RS>(Vs + buf * BKV * RS, a.v + koff, kstride, j * BKV, BKV, D, a.Tkv, tid);
    cp_async_commit();
  };
  load_block<T, RS>(Qs, a.q + qoff, qstride, q0, BQ, D, a.Tq, tid);
  load_block<T, RS>(Os, a.dout + qoff, qstride, q0, BQ, D, a.Tq, tid);
  cp_async_commit();
  if (n_kv > 0) load_kv(0, 0);
  if (n_kv > 0)
    cp_async_wait<1>();
  else
    cp_async_wait<0>();
  __syncthreads();  // Q and dO are in

  // The rows' D = sum_d o do (f32), 4 lanes a row; stored for the dK/dV kernel.
  float mr[2], lr[2], dr[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r0 + 8 * hr;
    float acc = 0.f;
    if (row < a.Tq) {
      const T* orow = a.o + qoff + (size_t)row * qstride;
      const T* drow = Os + (warp * 16 + g + 8 * hr) * RS;
      for (int d = t; d < D; d += 4) acc += to_f(orow[d]) * to_f(drow[d]);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    dr[hr] = acc;
    mr[hr] = 0.f;
    lr[hr] = 1.f;
    if (row < a.Tq) {
      const size_t s = ((size_t)b * a.NH + h) * a.Tq + row;
      if (t == 0) a.delta[s] = acc;
      mr[hr] = a.m[s];
      lr[hr] = a.l[s] == 0.f ? 1.f : a.l[s];
    }
  }
  float dq[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[i][e] = 0.f;

  for (int j = 0; j < n_kv; ++j) {
    const int buf = j & 1, k0 = j * BKV;
    if (j + 1 < n_kv) {
      load_kv(buf ^ 1, j + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* kt = Ks + buf * BKV * RS;
    const T* vt = Vs + buf * BKV * RS;

    // S = Q K^T and dP = dO V^T for the warp's 16 rows x BKV keys.
    float s[BKV / 8][4], dp[BKV / 8][4];
#pragma unroll
    for (int ni = 0; ni < BKV / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[ni][e] = dp[ni][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / KS; ++kk) {
      uint32_t qa[4], oa[4];
      O::a_rows(qa, Qs, RS, warp * 16, kk * KS, lane);
      O::a_rows(oa, Os, RS, warp * 16, kk * KS, lane);
#pragma unroll
      for (int ni = 0; ni < BKV / 8; ++ni) {
        uint32_t bk[2], bv[2];
        O::b_rows(bk, kt, RS, ni * 8, kk * KS, lane);
        O::b_rows(bv, vt, RS, ni * 8, kk * KS, lane);
        O::mma(s[ni], qa, bk);
        mma_rows<T>(dp[ni], oa, bv, Os, vt, RS, warp * 16, ni * 8, kk * KS, lane);
      }
    }
    ds_rows<T, BKV>(s, dp, a, r0, k0, t, mr, lr, dr);

    // dQ += T(dS) K: K's row-major [key][d] tile is B.
#pragma unroll
    for (int kk = 0; kk < BKV / KS; ++kk) {
      uint32_t da[4];
      O::a_acc(da, &dp[kk * KS / 8]);
#pragma unroll
      for (int di = 0; di < D / 8; ++di) {
        uint32_t bf[2];
        O::b_trans(bf, kt, RS, kk * KS, di * 8, lane);
        O::mma(dq[di], da, bf);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r0 + 8 * hr;
    if (row >= a.Tq) continue;
    T* drow = a.dq + qoff + (size_t)row * qstride;
#pragma unroll
    for (int di = 0; di < D / 8; ++di)
      O::store2(drow + di * 8 + 2 * t, dq[di][2 * hr], dq[di][2 * hr + 1]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) dkv_kernel(Args<T> a) {
  using O = Ops<T>;
  constexpr int BQD = Tile<T, D>::N, RS = Tile<T, D>::RS, KS = O::KS;
  constexpr int KB = 16 * WARPS;         // keys a block
  constexpr int DC = D / parts<D>();     // dK/dV columns a block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);  // [KB][RS]
  T* Vs = Ks + KB * RS;                      // [KB][RS]
  T* Qs = Vs + KB * RS;                      // [2][BQD][RS]
  T* Os = Qs + 2 * BQD * RS;                 // dO [2][BQD][RS]
  float* St = reinterpret_cast<float*>(Os + 2 * BQD * RS);  // [2][m, l, D][BQD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int hk = blockIdx.y / parts<D>(), c0 = (blockIdx.y % parts<D>()) * DC;
  const int b = blockIdx.z;
  const int k0 = blockIdx.x * KB;
  const int G = a.NH / a.NKV;
  const size_t qstride = (size_t)a.NH * D, kstride = (size_t)a.NKV * D;
  const size_t koff = (size_t)b * a.Tkv * kstride + (size_t)hk * D;

  load_block<T, RS>(Ks, a.k + koff, kstride, k0, KB, D, a.Tkv, tid);
  load_block<T, RS>(Vs, a.v + koff, kstride, k0, KB, D, a.Tkv, tid);
  cp_async_commit();

  // The q tiles that see key k0 or later: from the tile holding query
  // k0 - kv_offset on (the TPU kernel's skip rule, per tile of BQD rows).
  const int nq = (a.Tq + BQD - 1) / BQD;
  int i0 = 0;
  if (a.causal) i0 = k0 - a.kv_offset > 0 ? (k0 - a.kv_offset) / BQD : 0;
  const int per_head = nq > i0 ? nq - i0 : 0;
  const int n_it = per_head * G;

  auto load_q = [&](int buf, int it) {
    const int h = hk * G + it / per_head;
    const int q0 = (i0 + it % per_head) * BQD;
    const size_t qoff = (size_t)b * a.Tq * qstride + (size_t)h * D;
    load_block<T, RS>(Qs + buf * BQD * RS, a.q + qoff, qstride, q0, BQD, D, a.Tq, tid);
    load_block<T, RS>(Os + buf * BQD * RS, a.dout + qoff, qstride, q0, BQD, D, a.Tq, tid);
    if (tid < BQD) {
      float* st = St + buf * 3 * BQD;
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
    cp_async_commit();
  };
  if (n_it > 0) load_q(0, 0);

  float dk[DC / 8][4], dv[DC / 8][4];
#pragma unroll
  for (int i = 0; i < DC / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;
  const int key0 = k0 + warp * 16 + g;  // this thread's keys key0 and key0 + 8

  for (int it = 0; it < n_it; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_it) {
      load_q(buf ^ 1, it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = (i0 + it % per_head) * BQD;
    const T* qt = Qs + buf * BQD * RS;
    const T* ot = Os + buf * BQD * RS;
    const float* st = St + buf * 3 * BQD;

    // S^T = K Q^T and dP^T = V dO^T for the warp's 16 keys x BQD queries.
    float s[BQD / 8][4], dp[BQD / 8][4];
#pragma unroll
    for (int ni = 0; ni < BQD / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[ni][e] = dp[ni][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / KS; ++kk) {
      uint32_t ka[4], va[4];
      O::a_rows(ka, Ks, RS, warp * 16, kk * KS, lane);
      O::a_rows(va, Vs, RS, warp * 16, kk * KS, lane);
#pragma unroll
      for (int ni = 0; ni < BQD / 8; ++ni) {
        uint32_t bq[2], bo[2];
        O::b_rows(bq, qt, RS, ni * 8, kk * KS, lane);
        O::b_rows(bo, ot, RS, ni * 8, kk * KS, lane);
        O::mma(s[ni], ka, bq);
        mma_rows<T>(dp[ni], va, bo, Vs, ot, RS, warp * 16, ni * 8, kk * KS, lane);
      }
    }

    ds_cols<T, BQD>(s, dp, a, q0, key0, t, st);  // P^T and dS^T in place

    // dV += T(P^T) dO, dK += T(dS^T) Q over the tile's queries, this
    // block's columns.
#pragma unroll
    for (int kk = 0; kk < BQD / KS; ++kk) {
      uint32_t pa[4], da[4];
      O::a_acc(pa, &s[kk * KS / 8]);
      O::a_acc(da, &dp[kk * KS / 8]);
#pragma unroll
      for (int di = 0; di < DC / 8; ++di) {
        uint32_t bf[2];
        O::b_trans(bf, ot, RS, kk * KS, c0 + di * 8, lane);
        O::mma(dv[di], pa, bf);
        O::b_trans(bf, qt, RS, kk * KS, c0 + di * 8, lane);
        O::mma(dk[di], da, bf);
      }
    }
    __syncthreads();  // the next iteration's load overwrites the other buffer's last reader
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const size_t row = koff + (size_t)(key0 + 8 * hr) * kstride + c0;
#pragma unroll
    for (int di = 0; di < DC / 8; ++di) {
      O::store2(a.dk + row + di * 8 + 2 * t, dk[di][2 * hr], dk[di][2 * hr + 1]);
      O::store2(a.dv + row + di * 8 + 2 * t, dv[di][2 * hr], dv[di][2 * hr + 1]);
    }
  }
}

// ---- past D 256 (flash_sync.cuh: Wide) ---------------------------------------

// dQ: one block per (64 query rows, head and column part, batch row). The
// rows' D = sum o do from device memory (part 0 stores it); per key tile,
// Q's, dO's, K's and V's 64-column panels stream through a double buffer
// for S and dP while the tile's K columns of the part come in beside them;
// then dS and dQ += T(dS) K on the part's columns.
template <typename T>
__global__ void __launch_bounds__(THREADS) dq_wide_kernel(Args<T> a, int D) {
  using O = Ops<T>;
  using W = Wide<T>;
  constexpr int BKV = W::NK, RS = W::RS, CS = W::CS, DC = W::DC, KS = O::KS, PW = W::PW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qp = reinterpret_cast<T*>(smem_raw);  // [2][BQ][RS]
  T* Op = Qp + 2 * BQ * RS;                  // dO [2][BQ][RS]
  T* Kp = Op + 2 * BQ * RS;                  // [2][BKV][RS]
  T* Vp = Kp + 2 * BKV * RS;                 // [2][BKV][RS]
  T* Kc = Vp + 2 * BKV * RS;                 // [BKV][CS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int parts = (D + DC - 1) / DC;
  const int h = blockIdx.y / parts, c0 = (blockIdx.y % parts) * DC, nc = min(DC, D - c0);
  const int b = blockIdx.z;
  const int hk = h / (a.NH / a.NKV);
  const int q0 = qt * BQ;
  const int r0 = q0 + warp * 16 + g;
  const size_t qstride = (size_t)a.NH * D, kstride = (size_t)a.NKV * D;
  const size_t qoff = (size_t)b * a.Tq * qstride + (size_t)h * D;
  const size_t koff = (size_t)b * a.Tkv * kstride + (size_t)hk * D;

  int n_kv = a.Tkv / BKV;
  if (a.causal) {
    const int last = q0 + BQ - 1 + a.kv_offset;
    n_kv = last < 0 ? 0 : min(n_kv, last / BKV + 1);
  }
  const int np = D / PW;
  auto load_panel = [&](int buf, int k0, int p) {
    load_block<T, RS>(Qp + buf * BQ * RS, a.q + qoff + p * PW, qstride, q0, BQ, PW, a.Tq, tid);
    load_block<T, RS>(Op + buf * BQ * RS, a.dout + qoff + p * PW, qstride, q0, BQ, PW, a.Tq,
                      tid);
    load_block<T, RS>(Kp + buf * BKV * RS, a.k + koff + p * PW, kstride, k0, BKV, PW, a.Tkv,
                      tid);
    load_block<T, RS>(Vp + buf * BKV * RS, a.v + koff + p * PW, kstride, k0, BKV, PW, a.Tkv,
                      tid);
    cp_async_commit();
  };

  float mr[2], lr[2], dr[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r0 + 8 * hr;
    float acc = 0.f;
    if (row < a.Tq) {
      const T* orow = a.o + qoff + (size_t)row * qstride;
      const T* drow = a.dout + qoff + (size_t)row * qstride;
      for (int d = t; d < D; d += 4) acc += to_f(orow[d]) * to_f(drow[d]);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    dr[hr] = acc;
    mr[hr] = 0.f;
    lr[hr] = 1.f;
    if (row < a.Tq) {
      const size_t s = ((size_t)b * a.NH + h) * a.Tq + row;
      if (c0 == 0 && t == 0) a.delta[s] = acc;
      mr[hr] = a.m[s];
      lr[hr] = a.l[s] == 0.f ? 1.f : a.l[s];
    }
  }
  float dq[DC / 8][4];
#pragma unroll
  for (int i = 0; i < DC / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[i][e] = 0.f;

  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * BKV;
    load_block<T, CS>(Kc, a.k + koff + c0, kstride, k0, BKV, nc, a.Tkv, tid);
    cp_async_commit();
    load_panel(0, k0, 0);
    float s[BKV / 8][4], dp[BKV / 8][4];
#pragma unroll
    for (int ni = 0; ni < BKV / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[ni][e] = dp[ni][e] = 0.f;
    for (int p = 0; p < np; ++p) {
      if (p + 1 < np) {
        load_panel((p + 1) & 1, k0, p + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const T* qt_ = Qp + (p & 1) * BQ * RS;
      const T* ot = Op + (p & 1) * BQ * RS;
      const T* kt = Kp + (p & 1) * BKV * RS;
      const T* vt = Vp + (p & 1) * BKV * RS;
#pragma unroll
      for (int kk = 0; kk < PW / KS; ++kk) {
        uint32_t qa[4], oa[4];
        O::a_rows(qa, qt_, RS, warp * 16, kk * KS, lane);
        O::a_rows(oa, ot, RS, warp * 16, kk * KS, lane);
#pragma unroll
        for (int ni = 0; ni < BKV / 8; ++ni) {
          uint32_t bk[2], bv[2];
          O::b_rows(bk, kt, RS, ni * 8, kk * KS, lane);
          O::b_rows(bv, vt, RS, ni * 8, kk * KS, lane);
          O::mma(s[ni], qa, bk);
          mma_rows_rn<T>(dp[ni], oa, bv, ot, vt, RS, warp * 16, ni * 8, kk * KS, lane);
        }
      }
      __syncthreads();  // the next panel's load overwrites the other buffer
    }
    ds_rows<T, BKV>(s, dp, a, r0, k0, t, mr, lr, dr);
#pragma unroll
    for (int kk = 0; kk < BKV / KS; ++kk) {
      uint32_t da[4];
      O::a_acc(da, &dp[kk * KS / 8]);
#pragma unroll
      for (int di = 0; di < DC / 8; ++di) {
        if (di * 8 >= nc) break;
        uint32_t bf[2];
        O::b_trans(bf, Kc, CS, kk * KS, di * 8, lane);
        O::mma(dq[di], da, bf);
      }
    }
    __syncthreads();  // the next tile's K load overwrites Kc
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r0 + 8 * hr;
    if (row >= a.Tq) continue;
    T* drow = a.dq + qoff + (size_t)row * qstride + c0;
#pragma unroll
    for (int di = 0; di < DC / 8; ++di)
      if (di * 8 < nc) O::store2(drow + di * 8 + 2 * t, dq[di][2 * hr], dq[di][2 * hr + 1]);
  }
}

// dK/dV: one block per (64 keys, KV head and column part, batch row),
// sweeping the q tiles of NQ rows that see its keys for every query head of
// the group as dkv_kernel does. Per step, K's, V's, Q's and dO's 64-column
// panels stream through a double buffer for S^T and dP^T while the step's Q
// and dO columns of the part and its rows' m, l and D come in beside them;
// then dV += T(P^T) dO and dK += T(dS^T) Q on the part's columns.
template <typename T>
__global__ void __launch_bounds__(THREADS) dkv_wide_kernel(Args<T> a, int D) {
  using O = Ops<T>;
  using W = Wide<T>;
  constexpr int BQD = W::NQ, RS = W::RS, CS = W::CS, DC = W::DC, KS = O::KS, PW = W::PW;
  constexpr int KB = 16 * WARPS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Kp = reinterpret_cast<T*>(smem_raw);  // [2][KB][RS]
  T* Vp = Kp + 2 * KB * RS;                  // [2][KB][RS]
  T* Qp = Vp + 2 * KB * RS;                  // [2][BQD][RS]
  T* Op = Qp + 2 * BQD * RS;                 // dO [2][BQD][RS]
  T* Qc = Op + 2 * BQD * RS;                 // [BQD][CS]
  T* Oc = Qc + BQD * CS;                     // dO [BQD][CS]
  float* St = reinterpret_cast<float*>(Oc + BQD * CS);  // [m, l, D][BQD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int parts = (D + DC - 1) / DC;
  const int hk = blockIdx.y / parts, c0 = (blockIdx.y % parts) * DC, nc = min(DC, D - c0);
  const int b = blockIdx.z;
  const int k0 = blockIdx.x * KB;
  const int G = a.NH / a.NKV;
  const size_t qstride = (size_t)a.NH * D, kstride = (size_t)a.NKV * D;
  const size_t koff = (size_t)b * a.Tkv * kstride + (size_t)hk * D;

  const int nq = (a.Tq + BQD - 1) / BQD;
  int i0 = 0;
  if (a.causal) i0 = k0 - a.kv_offset > 0 ? (k0 - a.kv_offset) / BQD : 0;
  const int per_head = nq > i0 ? nq - i0 : 0;
  const int n_it = per_head * G;
  const int np = D / PW;

  float dk[DC / 8][4], dv[DC / 8][4];
#pragma unroll
  for (int i = 0; i < DC / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;
  const int key0 = k0 + warp * 16 + g;

  for (int it = 0; it < n_it; ++it) {
    const int h = hk * G + it / per_head;
    const int q0 = (i0 + it % per_head) * BQD;
    const size_t qoff = (size_t)b * a.Tq * qstride + (size_t)h * D;
    load_block<T, CS>(Qc, a.q + qoff + c0, qstride, q0, BQD, nc, a.Tq, tid);
    load_block<T, CS>(Oc, a.dout + qoff + c0, qstride, q0, BQD, nc, a.Tq, tid);
    if (tid < BQD) {
      const int row = q0 + tid;
      if (row < a.Tq) {
        const size_t s = ((size_t)b * a.NH + h) * a.Tq + row;
        cp_async4(St + tid, a.m + s);
        cp_async4(St + BQD + tid, a.l + s);
        cp_async4(St + 2 * BQD + tid, a.delta + s);
      } else {
        St[tid] = 0.f;
        St[BQD + tid] = 1.f;
        St[2 * BQD + tid] = 0.f;
      }
    }
    cp_async_commit();
    auto load_panel = [&](int buf, int p) {
      load_block<T, RS>(Kp + buf * KB * RS, a.k + koff + p * PW, kstride, k0, KB, PW, a.Tkv, tid);
      load_block<T, RS>(Vp + buf * KB * RS, a.v + koff + p * PW, kstride, k0, KB, PW, a.Tkv, tid);
      load_block<T, RS>(Qp + buf * BQD * RS, a.q + qoff + p * PW, qstride, q0, BQD, PW, a.Tq,
                        tid);
      load_block<T, RS>(Op + buf * BQD * RS, a.dout + qoff + p * PW, qstride, q0, BQD, PW, a.Tq,
                        tid);
      cp_async_commit();
    };
    load_panel(0, 0);
    float s[BQD / 8][4], dp[BQD / 8][4];
#pragma unroll
    for (int ni = 0; ni < BQD / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[ni][e] = dp[ni][e] = 0.f;
    for (int p = 0; p < np; ++p) {
      if (p + 1 < np) {
        load_panel((p + 1) & 1, p + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const T* kt = Kp + (p & 1) * KB * RS;
      const T* vt = Vp + (p & 1) * KB * RS;
      const T* qt = Qp + (p & 1) * BQD * RS;
      const T* ot = Op + (p & 1) * BQD * RS;
#pragma unroll
      for (int kk = 0; kk < PW / KS; ++kk) {
        uint32_t ka[4], va[4];
        O::a_rows(ka, kt, RS, warp * 16, kk * KS, lane);
        O::a_rows(va, vt, RS, warp * 16, kk * KS, lane);
#pragma unroll
        for (int ni = 0; ni < BQD / 8; ++ni) {
          uint32_t bq[2], bo[2];
          O::b_rows(bq, qt, RS, ni * 8, kk * KS, lane);
          O::b_rows(bo, ot, RS, ni * 8, kk * KS, lane);
          O::mma(s[ni], ka, bq);
          mma_rows_rn<T>(dp[ni], va, bo, vt, ot, RS, warp * 16, ni * 8, kk * KS, lane);
        }
      }
      __syncthreads();  // the next panel's load overwrites the other buffer
    }
    ds_cols<T, BQD>(s, dp, a, q0, key0, t, St);
#pragma unroll
    for (int kk = 0; kk < BQD / KS; ++kk) {
      uint32_t pa[4], da[4];
      O::a_acc(pa, &s[kk * KS / 8]);
      O::a_acc(da, &dp[kk * KS / 8]);
#pragma unroll
      for (int di = 0; di < DC / 8; ++di) {
        if (di * 8 >= nc) break;
        uint32_t bf[2];
        O::b_trans(bf, Oc, CS, kk * KS, di * 8, lane);
        O::mma(dv[di], pa, bf);
        O::b_trans(bf, Qc, CS, kk * KS, di * 8, lane);
        O::mma(dk[di], da, bf);
      }
    }
    __syncthreads();  // the next step's loads overwrite Qc, Oc and St
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const size_t row = koff + (size_t)(key0 + 8 * hr) * kstride + c0;
#pragma unroll
    for (int di = 0; di < DC / 8; ++di)
      if (di * 8 < nc) {
        O::store2(a.dk + row + di * 8 + 2 * t, dk[di][2 * hr], dk[di][2 * hr + 1]);
        O::store2(a.dv + row + di * 8 + 2 * t, dv[di][2 * hr], dv[di][2 * hr + 1]);
      }
  }
}

template <typename T>
int launch_wide(const Args<T>& a, int B, int D, cudaStream_t stream) {
  using W = Wide<T>;
  constexpr int KB = 16 * WARPS, es = (int)sizeof(T);
  constexpr int smem_dq = (2 * (2 * BQ + 2 * W::NK) * W::RS + W::NK * W::CS) * es;
  constexpr int smem_dkv = (2 * (2 * KB + 2 * W::NQ) * W::RS + 2 * W::NQ * W::CS) * es +
                           3 * W::NQ * 4;
  auto dq = dq_wide_kernel<T>;
  auto dkv = dkv_wide_kernel<T>;
  static bool done_dq[64] = {}, done_dkv[64] = {};
  if (const int e = opt_in(dq, smem_dq, done_dq)) return e;
  if (const int e = opt_in(dkv, smem_dkv, done_dkv)) return e;
  const int parts = (D + W::DC - 1) / W::DC;
  dq<<<dim3((a.Tq + BQ - 1) / BQ, a.NH * parts, B), THREADS, smem_dq, stream>>>(a, D);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  dkv<<<dim3(a.Tkv / KB, a.NKV * parts, B), THREADS, smem_dkv, stream>>>(a, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch(const Args<T>& a, int B, cudaStream_t stream) {
  constexpr int N = Tile<T, D>::N, RS = Tile<T, D>::RS, KB = 16 * WARPS;
  constexpr int smem_dq = (2 * BQ + 4 * N) * RS * (int)sizeof(T);
  constexpr int smem_dkv = (2 * KB + 4 * N) * RS * (int)sizeof(T) + 2 * 3 * N * 4;
  auto dq = dq_kernel<T, D>;
  auto dkv = dkv_kernel<T, D>;
  static bool done_dq[64] = {}, done_dkv[64] = {};
  if (const int e = opt_in(dq, smem_dq, done_dq)) return e;
  if (const int e = opt_in(dkv, smem_dkv, done_dkv)) return e;
  dq<<<dim3((a.Tq + BQ - 1) / BQ, a.NH, B), THREADS, smem_dq, stream>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  dkv<<<dim3(a.Tkv / KB, a.NKV * parts<D>(), B), THREADS, smem_dkv, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_d(const bwd_parts::Call& c) {
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
  const int D = c.D, B = c.B;
  if constexpr (std::is_same<T, float>::value) {  // bf16 and fp16: past D 256 only
    if (D == 64) return launch<T, 64>(a, B, c.stream);
    if (D == 128) return launch<T, 128>(a, B, c.stream);
    if (D == 192) return launch<T, 192>(a, B, c.stream);
    if (D == 256) return launch<T, 256>(a, B, c.stream);
  }
  if (D > 256 && D % 64 == 0) return launch_wide<T>(a, B, D, c.stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

#if IN_PART(1)
int bwd_parts::run_f32(const Call& c) { return by_d<float>(c); }
#endif
#if IN_PART(2)
int bwd_parts::run_bf16(const Call& c) { return by_d<__nv_bfloat16>(c); }
#endif
#if IN_PART(3)
int bwd_parts::run_f16(const Call& c) { return by_d<__half>(c); }
#endif

#if IN_PART(0)

// ptrs: q, k, v, o, do, l, m, delta, dq, dk, dv. q, o, do, dq [B, Tq, NH, D],
// k, v, dk, dv [B, Tkv, NKV, D] of one type (dtype: 0 f32, 1 bf16, 2 fp16),
// contiguous, 16-byte-aligned bases; l, m f32 [B, NH, Tq] from
// flash_sync_fwd; delta f32 [B, NH, Tq] scratch. D in {64, 128, 192, 256}
// for f32, or any multiple of 64 past 256 for every type (else
// cudaErrorInvalidValue), Tkv %
// 64 == 0, NH % NKV == 0 and, when causal, kv_offset >= 0 (checked by
// the Python wrapper). Two launches (dQ with D, then dK/dV) on `stream`.
extern "C" int flash_sync_bwd(void* const* ptrs, int B, int Tq, int Tkv, int NH, int NKV, int D,
                              int dtype, float sm_scale, int kv_offset, int causal,
                              void* stream) {
  if (B <= 0 || Tq <= 0 || Tkv <= 0) return static_cast<int>(cudaGetLastError());
  const bwd_parts::Call c{ptrs,     B,         Tq,     Tkv, NH, NKV, D,
                          sm_scale, kv_offset, causal, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return bwd_parts::run_f32(c);
  if (dtype == 1) return bwd_parts::run_bf16(c);
  if (dtype == 2) return bwd_parts::run_f16(c);
  return static_cast<int>(cudaErrorInvalidValue);
}
#endif  // IN_PART(0)
