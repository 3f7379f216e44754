// flash_bwd: the causal grouped-query flash-attention backward, bf16 in and
// out, from the forward's row statistics.
//
// Replaces the TPU kernels mila_tpu/kernels/flash_attention_bwd.py:
// _dkv_kernel (dK, dV) and _dq_kernel (dQ), entry flash_attention_bwd,
// reached from _fa_bwd (flash_attention.py). Per tile, as there:
//   p  = exp(s * scale - m) / l        (l == 0 taken as 1; masked p = 0)
//   dv += bf16(p)^T do
//   ds = p * (do v^T - D) * scale,     D = rowsum(o * do) in f32 (the
//                                      wrapper computes it, as JAX does)
//   dk += bf16(ds)^T q,  dq += bf16(ds) k
// with the causal tile skip under kv_offset >= 0. dq is rounded to q's
// dtype, dk and dv to k's.
//
// Bound on the H100: tensor-core operations (five products of 2 * D
// multiply-adds per visible (query, key) pair and head: S and dP in both
// kernels, dV, dK, dQ) against q, k, v, do, dq, dk, dv read or written
// once. Design: two kernels, both 4 warps of 16 rows each over 64 x 64
// tiles on mma.sync m16n8k16 bf16 with f32 accumulators, the same fragment
// moves as flash_fwd.cu (an accumulator tile becomes an A fragment through
// pack2; a row-major [k][n] tile gives B through ldmatrix.trans).
//   dkv: one block per (64 keys, KV head, batch row). K and V stay in
//        shared memory; the block sweeps the q tiles that see its keys for
//        every query head of the group (h = hk * G .. hk * G + G - 1),
//        streaming Q, dO and the rows' m, l, D through shared memory with
//        cp.async, double-buffered. Each warp computes S^T and dP^T for its
//        16 keys, so P^T and dS^T are A fragments in place. dK and dV sum
//        over the group in one f32 accumulator inside the block (the TPU
//        kernel writes f32 per query head and sums afterwards: the results
//        differ in f32 order only) and are written once, in k's dtype.
//   dq:  one block per (64 query rows, head, batch row), the layout of
//        flash_fwd: Q and dO tiles in shared memory, K/V tiles streamed
//        and double-buffered, the rows' m, l, D in registers.
// Layouts are the model's: q, do, dq [B, Tq, NH, D], k, v, dk, dv [B, Tkv,
// NKV, D], contiguous; m, l, D f32 [B, NH, Tq]. Query rows past Tq in the
// last q tile load as zeros and have p = 0.
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int BQ = 64, BKV = 64, THREADS = 128;

struct Args {
  const __nv_bfloat16 *q, *k, *v, *dout;
  const float *m, *l, *delta;
  __nv_bfloat16 *dq, *dk, *dv;
  int Tq, Tkv, NH, NKV;
  float sm_scale;
  int kv_offset, causal;
};

// Copy rows [r0, r0 + 64) of one head of a [.., T, H, D] tensor into a
// shared tile of 64 rows x RS; rows at or past T are zero-filled.
template <int D>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          size_t stride, int r0, int T, int tid) {
  constexpr int RS = D + 8;
#pragma unroll
  for (int i = tid; i < 64 * D / 8; i += THREADS) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    if (r0 + r < T)
      cp_async16(dst + r * RS + c, src + (size_t)(r0 + r) * stride + c);
    else
      *reinterpret_cast<uint4*>(dst + r * RS + c) = make_uint4(0u, 0u, 0u, 0u);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_kernel(Args a) {
  constexpr int RS = D + 8;
  constexpr int TILE = 64 * RS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BKV][RS]
  __nv_bfloat16* Vs = Ks + TILE;                                    // [BKV][RS]
  __nv_bfloat16* Qs = Vs + TILE;                                    // [2][BQ][RS]
  __nv_bfloat16* Os = Qs + 2 * TILE;                                // dO [2][BQ][RS]
  float* St = reinterpret_cast<float*>(Os + 2 * TILE);             // [2][m, l, D][BQ]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * BKV;
  const int G = a.NH / a.NKV;
  const size_t qstride = (size_t)a.NH * D, kstride = (size_t)a.NKV * D;
  const size_t koff = (size_t)b * a.Tkv * kstride + (size_t)hk * D;

  load_rows<D>(Ks, a.k + koff, kstride, k0, a.Tkv, tid);
  load_rows<D>(Vs, a.v + koff, kstride, k0, a.Tkv, tid);
  cp_async_commit();

  // The q tiles that see key k0 or later: from the tile holding query
  // k0 - kv_offset on (the TPU kernel's skip rule, per 64-row tile).
  const int nq = (a.Tq + BQ - 1) / BQ;
  int i0 = 0;
  if (a.causal) i0 = k0 - a.kv_offset > 0 ? (k0 - a.kv_offset) / BQ : 0;
  const int per_head = nq > i0 ? nq - i0 : 0;
  const int n_it = per_head * G;

  auto load_q = [&](int buf, int it) {
    const int h = hk * G + it / per_head;
    const int q0 = (i0 + it % per_head) * BQ;
    const size_t qoff = (size_t)b * a.Tq * qstride + (size_t)h * D;
    load_rows<D>(Qs + buf * TILE, a.q + qoff, qstride, q0, a.Tq, tid);
    load_rows<D>(Os + buf * TILE, a.dout + qoff, qstride, q0, a.Tq, tid);
    if (tid < BQ) {
      float* st = St + buf * 3 * BQ;
      const int row = q0 + tid;
      if (row < a.Tq) {
        const size_t s = ((size_t)b * a.NH + h) * a.Tq + row;
        cp_async4(st + tid, a.m + s);
        cp_async4(st + BQ + tid, a.l + s);
        cp_async4(st + 2 * BQ + tid, a.delta + s);
      } else {
        st[tid] = 0.f;
        st[BQ + tid] = 1.f;
        st[2 * BQ + tid] = 0.f;
      }
    }
    cp_async_commit();
  };
  if (n_it > 0) load_q(0, 0);

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
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
    const int q0 = (i0 + it % per_head) * BQ;
    const __nv_bfloat16* qt = Qs + buf * TILE;
    const __nv_bfloat16* ot = Os + buf * TILE;
    const float* st = St + buf * 3 * BQ;

    // S^T = K Q^T and dP^T = V dO^T for the warp's 16 keys x 64 queries.
    float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
    for (int ni = 0; ni < BQ / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[ni][e] = dp[ni][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      load_a(ka, Ks, RS, warp * 16, kk * 16, lane);
      load_a(va, Vs, RS, warp * 16, kk * 16, lane);
#pragma unroll
      for (int ni = 0; ni < BQ / 8; ++ni) {
        uint32_t bq[2], bo[2];
        load_b_rows(bq, qt, RS, ni * 8, kk * 16, lane);
        load_b_rows(bo, ot, RS, ni * 8, kk * 16, lane);
        mma_bf16(s[ni], ka, bq);
        mma_bf16(dp[ni], va, bo);
      }
    }

    // P^T and dS^T in place (the columns are queries).
#pragma unroll
    for (int ni = 0; ni < BQ / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = ni * 8 + tig * 2 + (e & 1);
        const int qrow = q0 + col, key = key0 + 8 * (e >> 1);
        float p = 0.f;
        if (qrow < a.Tq && !(a.causal && key > qrow + a.kv_offset)) {
          const float lv = st[BQ + col];
          p = expf(s[ni][e] * a.sm_scale - st[col]) / (lv == 0.f ? 1.f : lv);
        }
        s[ni][e] = p;
        dp[ni][e] = (p * (dp[ni][e] - st[2 * BQ + col])) * a.sm_scale;
      }

    // dV += bf16(P^T) dO, dK += bf16(dS^T) Q over the tile's 64 queries.
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      const uint32_t pa[4] = {pack2(s[2 * kk][0], s[2 * kk][1]), pack2(s[2 * kk][2], s[2 * kk][3]),
                              pack2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const uint32_t da[4] = {pack2(dp[2 * kk][0], dp[2 * kk][1]),
                              pack2(dp[2 * kk][2], dp[2 * kk][3]),
                              pack2(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                              pack2(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
      const __nv_bfloat16* orow = ot + (kk * 16 + (lane & 15)) * RS;
      const __nv_bfloat16* qrow = qt + (kk * 16 + (lane & 15)) * RS;
#pragma unroll
      for (int di = 0; di < D / 8; ++di) {
        uint32_t bf[2];
        ldmatrix_x2_trans(bf, orow + di * 8);
        mma_bf16(dv[di], pa, bf);
        ldmatrix_x2_trans(bf, qrow + di * 8);
        mma_bf16(dk[di], da, bf);
      }
    }
    __syncthreads();  // the next iteration's load overwrites the other buffer's last reader
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const size_t row = koff + (size_t)(key0 + 8 * hr) * kstride;
#pragma unroll
    for (int di = 0; di < D / 8; ++di) {
      *reinterpret_cast<__nv_bfloat162*>(a.dk + row + di * 8 + tig * 2) =
          __floats2bfloat162_rn(dk[di][2 * hr], dk[di][2 * hr + 1]);
      *reinterpret_cast<__nv_bfloat162*>(a.dv + row + di * 8 + tig * 2) =
          __floats2bfloat162_rn(dv[di][2 * hr], dv[di][2 * hr + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(Args a) {
  constexpr int RS = D + 8;
  constexpr int TILE = 64 * RS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BQ][RS]
  __nv_bfloat16* Os = Qs + TILE;                                    // dO [BQ][RS]
  __nv_bfloat16* Ks = Os + TILE;                                    // [2][BKV][RS]
  __nv_bfloat16* Vs = Ks + 2 * TILE;                                // [2][BKV][RS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
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
    load_rows<D>(Ks + buf * TILE, a.k + koff, kstride, j * BKV, a.Tkv, tid);
    load_rows<D>(Vs + buf * TILE, a.v + koff, kstride, j * BKV, a.Tkv, tid);
    cp_async_commit();
  };
  load_rows<D>(Qs, a.q + qoff, qstride, q0, a.Tq, tid);
  load_rows<D>(Os, a.dout + qoff, qstride, q0, a.Tq, tid);
  if (n_kv > 0)
    load_kv(0, 0);  // one group with Q and dO
  else
    cp_async_commit();

  float mr[2], lr[2], dr[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r0 + 8 * hr;
    mr[hr] = 0.f;
    lr[hr] = 1.f;
    dr[hr] = 0.f;
    if (row < a.Tq) {
      const size_t s = ((size_t)b * a.NH + h) * a.Tq + row;
      mr[hr] = a.m[s];
      lr[hr] = a.l[s] == 0.f ? 1.f : a.l[s];
      dr[hr] = a.delta[s];
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
    const __nv_bfloat16* kt = Ks + buf * TILE;
    const __nv_bfloat16* vt = Vs + buf * TILE;

    // S = Q K^T and dP = dO V^T for the warp's 16 rows x 64 keys.
    float s[BKV / 8][4], dp[BKV / 8][4];
#pragma unroll
    for (int ni = 0; ni < BKV / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[ni][e] = dp[ni][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], oa[4];
      load_a(qa, Qs, RS, warp * 16, kk * 16, lane);
      load_a(oa, Os, RS, warp * 16, kk * 16, lane);
#pragma unroll
      for (int ni = 0; ni < BKV / 8; ++ni) {
        uint32_t bk[2], bv[2];
        load_b_rows(bk, kt, RS, ni * 8, kk * 16, lane);
        load_b_rows(bv, vt, RS, ni * 8, kk * 16, lane);
        mma_bf16(s[ni], qa, bk);
        mma_bf16(dp[ni], oa, bv);
      }
    }

#pragma unroll
    for (int ni = 0; ni < BKV / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1, row = r0 + 8 * hr;
        const int key = k0 + ni * 8 + tig * 2 + (e & 1);
        float p = 0.f;
        if (row < a.Tq && !(a.causal && key > row + a.kv_offset))
          p = expf(s[ni][e] * a.sm_scale - mr[hr]) / lr[hr];
        dp[ni][e] = (p * (dp[ni][e] - dr[hr])) * a.sm_scale;
      }

    // dQ += bf16(dS) K: K's row-major [key][d] tile is B through ldmatrix.trans.
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint32_t da[4] = {pack2(dp[2 * kk][0], dp[2 * kk][1]),
                              pack2(dp[2 * kk][2], dp[2 * kk][3]),
                              pack2(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                              pack2(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
      const __nv_bfloat16* krow = kt + (kk * 16 + (lane & 15)) * RS;
#pragma unroll
      for (int di = 0; di < D / 8; ++di) {
        uint32_t bf[2];
        ldmatrix_x2_trans(bf, krow + di * 8);
        mma_bf16(dq[di], da, bf);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r0 + 8 * hr;
    if (row >= a.Tq) continue;
    __nv_bfloat16* drow = a.dq + qoff + (size_t)row * qstride;
#pragma unroll
    for (int di = 0; di < D / 8; ++di)
      *reinterpret_cast<__nv_bfloat162*>(drow + di * 8 + tig * 2) =
          __floats2bfloat162_rn(dq[di][2 * hr], dq[di][2 * hr + 1]);
  }
}

template <int D>
int launch(const Args& a, int B, cudaStream_t stream) {
  const size_t tiles = sizeof(__nv_bfloat16) * 6 * 64 * (D + 8);
  const size_t smem_dkv = tiles + sizeof(float) * 2 * 3 * BQ;
  auto dkv = flash_bwd_dkv_kernel<D>;
  auto dq = flash_bwd_dq_kernel<D>;
  // Above 48 KB of dynamic shared memory a kernel must opt in (per device).
  cudaFuncSetAttribute(dkv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dkv);
  cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)tiles);
  dkv<<<dim3(a.Tkv / BKV, a.NKV, B), THREADS, smem_dkv, stream>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  dq<<<dim3((a.Tq + BQ - 1) / BQ, a.NH, B), THREADS, tiles, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, dout, dq [B, Tq, NH, D]; k, v, dk, dv [B, Tkv, NKV, D], bf16 and
// contiguous; m, l, delta f32 [B, NH, Tq] (delta = rowsum(o * dout)).
// Needs D in {64, 128}, Tkv % 64 == 0, NH % NKV == 0 and, when causal,
// kv_offset >= 0 (checked by the Python wrapper). Two launches (dK/dV, then
// dQ) on `stream`.
extern "C" int flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                         const void* m, const void* l, const void* delta, void* dq, void* dk,
                         void* dv, int B, int Tq, int Tkv, int NH, int NKV, int D, float sm_scale,
                         int kv_offset, int causal, void* stream) {
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.m = static_cast<const float*>(m);
  a.l = static_cast<const float*>(l);
  a.delta = static_cast<const float*>(delta);
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.Tq = Tq;
  a.Tkv = Tkv;
  a.NH = NH;
  a.NKV = NKV;
  a.sm_scale = sm_scale;
  a.kv_offset = kv_offset;
  a.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Tq <= 0 || Tkv <= 0) return static_cast<int>(cudaGetLastError());
  if (D == 64) return launch<64>(a, B, s);
  if (D == 128) return launch<128>(a, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
