// flash_sync_fwd: the causal grouped-query flash-attention forward with its
// row statistics, on mma.sync, past D 256 at every type (the TMA + wgmma
// forwards take D 64-256: flash_fwd.cu bf16 and fp16, flash_tf32_fwd.cu
// f32; the fragments and the tf32 rounding of f32 are in flash_sync.cuh).
//
// Replaces the TPU kernels mila_tpu/kernels/flash_attention.py:_fa_kernel
// and _fa_kernel_t (entry flash_attention -> _flash_attention_forward, with
// and without save_stats) at those head sizes.
//
// Bound on the H100: tensor-core operations at prefill lengths (4 Tq Tkv D
// per head, about half skipped by the causal tiles) against Tq + 2 Tkv rows
// of D values read. This family is the simple one (no TMA, no warpgroup
// MMA, no overlap of the softmax with the products): right first, its times
// in PERF.md.
// Design (fwd_wide_kernel below): one block of 4 warps per (64 query rows,
// head and column part of O, batch row), the q tiles heaviest first; each
// warp owns 16 query rows. Q and K stream through shared memory in
// 64-column panels by cp.async, double buffered, beside each key tile's V
// columns of the part. S = Q K^T and O += P V on mma.sync; the online
// softmax in f32 per row (4 lanes share a row).
//
// The TPU kernel's semantics, as flash_fwd.cu: the causal tile skip with
// kv_offset (a key tile runs when its first key <= the q tile's last row +
// kv_offset); masked scores take the finite -0.7 * f32max (after the
// scaling); p is rounded to V's type (tf32 for f32) before P V while l sums
// the f32 p, both against the running max of the key tiles; 1 / l with l ==
// 0 guarded at the store; query head h reads KV head h / G. l and m (m of
// the scaled scores) are written per row when asked for: the statistics
// flash_sync_bwd.cu reads. Layouts are the model's: q and out [B, Tq, NH,
// D], k and v [B, Tkv, NKV, D], contiguous, 16-byte-aligned bases.
#include "flash_sync.cuh"

namespace {

using namespace fsync;

// The online softmax of one S tile of BKV keys (the warp's 16 rows) in
// place: scale, mask (only tiles that reach past the warp's first row,
// wrow), the new row max over the 4 lanes of a row, p = exp(s - m) left in s,
// l and the NO column tiles of O rescaled by exp(m_old - m).
template <int BKV, int NO>
__device__ __forceinline__ void softmax_tile(float (*s)[4], float (*o)[4], float* m, float* l,
                                             int k0, int wrow, int r0, int t, float sm_scale,
                                             int kv_offset, int causal) {
  const bool diag = causal && k0 + BKV - 1 > wrow + kv_offset;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int ni = 0; ni < BKV / 8; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hr = e >> 1;
      float val = s[ni][e] * sm_scale;
      if (diag && k0 + ni * 8 + 2 * t + (e & 1) > r0 + 8 * hr + kv_offset) val = MASK_VALUE;
      s[ni][e] = val;
      mx[hr] = fmaxf(mx[hr], val);
    }
  float alpha[2], ls[2] = {0.f, 0.f};
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
    mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
    const float m_new = fmaxf(m[hr], mx[hr]);
    alpha[hr] = expf(m[hr] - m_new);
    m[hr] = m_new;
  }
#pragma unroll
  for (int ni = 0; ni < BKV / 8; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = expf(s[ni][e] - m[e >> 1]);
      s[ni][e] = p;
      ls[e >> 1] += p;
    }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    ls[hr] += __shfl_xor_sync(0xffffffffu, ls[hr], 1);
    ls[hr] += __shfl_xor_sync(0xffffffffu, ls[hr], 2);
    l[hr] = alpha[hr] * l[hr] + ls[hr];
  }
#pragma unroll
  for (int di = 0; di < NO; ++di) {
    o[di][0] *= alpha[0];
    o[di][1] *= alpha[0];
    o[di][2] *= alpha[1];
    o[di][3] *= alpha[1];
  }
}

// Past D 256 (flash_sync.cuh: Wide): one block per (64 query rows, head and
// column part, batch row). Per key tile, Q's and K's 64-column panels stream
// through a double buffer for S = Q K^T while the tile's V columns of the
// part come in beside them; then the same softmax and O += P V on the part's
// columns. Every part forms the same S, m and l; part 0 stores l and m.
template <typename T>
__global__ void __launch_bounds__(THREADS)
fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                T* __restrict__ out, float* __restrict__ l_out, float* __restrict__ m_out,
                int Tq, int Tkv, int NH, int NKV, int D, float sm_scale, int kv_offset,
                int causal) {
  using O = Ops<T>;
  using W = Wide<T>;
  constexpr int BKV = W::NK, RS = W::RS, CS = W::CS, DC = W::DC, KS = O::KS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qp = reinterpret_cast<T*>(smem_raw);  // [2][BQ][RS]
  T* Kp = Qp + 2 * BQ * RS;                  // [2][BKV][RS]
  T* Vc = Kp + 2 * BKV * RS;                 // [BKV][CS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int parts = (D + DC - 1) / DC;
  const int h = blockIdx.y / parts, c0 = (blockIdx.y % parts) * DC, nc = min(DC, D - c0);
  const int b = blockIdx.z;
  const int hk = h / (NH / NKV);
  const int q0 = qt * BQ;
  const int wrow = q0 + warp * 16;
  const int r0 = wrow + g;
  const size_t qstride = (size_t)NH * D, kstride = (size_t)NKV * D;
  const T* qb = q + (size_t)b * Tq * qstride + (size_t)h * D;
  const T* kb = k + (size_t)b * Tkv * kstride + (size_t)hk * D;
  const T* vb = v + (size_t)b * Tkv * kstride + (size_t)hk * D;

  int n_kv = Tkv / BKV;
  if (causal) {
    const int last = q0 + BQ - 1 + kv_offset;
    n_kv = last < 0 ? 0 : min(n_kv, last / BKV + 1);
  }
  const int np = D / W::PW;
  auto load_panel = [&](int buf, int k0, int p) {
    load_block<T, RS>(Qp + buf * BQ * RS, qb + p * W::PW, qstride, q0, BQ, W::PW, Tq, tid);
    load_block<T, RS>(Kp + buf * BKV * RS, kb + p * W::PW, kstride, k0, BKV, W::PW, Tkv, tid);
    cp_async_commit();
  };

  float o[DC / 8][4];
#pragma unroll
  for (int i = 0; i < DC / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * BKV;
    load_block<T, CS>(Vc, vb + c0, kstride, k0, BKV, nc, Tkv, tid);
    cp_async_commit();
    load_panel(0, k0, 0);
    float s[BKV / 8][4];
#pragma unroll
    for (int ni = 0; ni < BKV / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[ni][e] = 0.f;
    for (int p = 0; p < np; ++p) {
      if (p + 1 < np) {
        load_panel((p + 1) & 1, k0, p + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const T* qt_ = Qp + (p & 1) * BQ * RS;
      const T* kt = Kp + (p & 1) * BKV * RS;
#pragma unroll
      for (int kk = 0; kk < W::PW / KS; ++kk) {
        uint32_t a[4];
        O::a_rows(a, qt_, RS, warp * 16, kk * KS, lane);
#pragma unroll
        for (int ni = 0; ni < BKV / 8; ++ni) {
          uint32_t bf[2];
          O::b_rows(bf, kt, RS, ni * 8, kk * KS, lane);
          O::mma(s[ni], a, bf);
        }
      }
      __syncthreads();  // the next panel's load overwrites the other buffer
    }
    softmax_tile<BKV, DC / 8>(s, o, m, l, k0, wrow, r0, t, sm_scale, kv_offset, causal);
#pragma unroll
    for (int kk = 0; kk < BKV / KS; ++kk) {
      uint32_t a[4];
      O::a_acc(a, &s[kk * KS / 8]);
#pragma unroll
      for (int di = 0; di < DC / 8; ++di) {
        if (di * 8 >= nc) break;
        uint32_t bf[2];
        O::b_trans(bf, Vc, CS, kk * KS, di * 8, lane);
        O::mma(o[di], a, bf);
      }
    }
    __syncthreads();  // the next tile's V load overwrites Vc
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r0 + 8 * hr;
    if (row >= Tq) continue;
    const float inv = l[hr] == 0.f ? 1.f : 1.f / l[hr];
    if (l_out != nullptr && c0 == 0 && t == 0) {
      const size_t srow = ((size_t)b * NH + h) * Tq + row;
      l_out[srow] = l[hr];
      m_out[srow] = m[hr];
    }
    T* orow = out + (size_t)b * Tq * qstride + (size_t)row * qstride + (size_t)h * D + c0;
#pragma unroll
    for (int di = 0; di < DC / 8; ++di)
      if (di * 8 < nc)
        O::store2(orow + di * 8 + 2 * t, o[di][2 * hr] * inv, o[di][2 * hr + 1] * inv);
  }
}

template <typename T>
int launch_wide(const void* q, const void* k, const void* v, void* out, float* l_out,
                float* m_out, int B, int Tq, int Tkv, int NH, int NKV, int D, float sm_scale,
                int kv_offset, int causal, cudaStream_t stream) {
  using W = Wide<T>;
  constexpr int smem = (2 * (BQ + W::NK) * W::RS + W::NK * W::CS) * (int)sizeof(T);
  auto kern = fwd_wide_kernel<T>;
  static bool sized[64] = {};
  if (const int e = size_smem(kern, smem, sized)) return e;
  dim3 grid((Tq + BQ - 1) / BQ, NH * ((D + W::DC - 1) / W::DC), B);
  kern<<<grid, THREADS, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                        static_cast<const T*>(v), static_cast<T*>(out), l_out,
                                        m_out, Tq, Tkv, NH, NKV, D, sm_scale, kv_offset, causal);
  return static_cast<int>(cudaGetLastError());
}

// bf16 and fp16 take D 64-256 on flash_fwd.cu, f32 on flash_tf32_fwd.cu;
// every type takes D % 64 == 0 past 256 here.
template <typename T>
int by_d(int D, const void* q, const void* k, const void* v, void* out, float* lo, float* mo,
         int B, int Tq, int Tkv, int NH, int NKV, float sm_scale, int kv_offset, int causal,
         cudaStream_t s) {
  if (D > 256 && D % 64 == 0)
    return launch_wide<T>(q, k, v, out, lo, mo, B, Tq, Tkv, NH, NKV, D, sm_scale, kv_offset,
                          causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q [B, Tq, NH, D], k and v [B, Tkv, NKV, D], out [B, Tq, NH, D], of one type
// (dtype: 0 f32, 1 bf16, 2 fp16), contiguous, 16-byte-aligned bases. D any
// multiple of 64 past 256 (else cudaErrorInvalidValue); Tkv % 64 == 0 and
// NH % NKV == 0 (checked by the Python wrapper). causal != 0 masks key j
// for query i unless j <= i + kv_offset.
// l_out and m_out null, or f32 [B, NH, Tq]: each row's softmax sum l and max
// m of the scaled scores. Returns a cudaError_t.
extern "C" int flash_sync_fwd(const void* q, const void* k, const void* v, void* out,
                              void* l_out, void* m_out, int B, int Tq, int Tkv, int NH, int NKV,
                              int D, int dtype, float sm_scale, int kv_offset, int causal,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lo = static_cast<float*>(l_out);
  float* mo = static_cast<float*>(m_out);
  if (B <= 0 || Tq <= 0) return static_cast<int>(cudaGetLastError());
  if (dtype == 0)
    return by_d<float>(D, q, k, v, out, lo, mo, B, Tq, Tkv, NH, NKV, sm_scale, kv_offset,
                       causal, s);
  if (dtype == 1)
    return by_d<__nv_bfloat16>(D, q, k, v, out, lo, mo, B, Tq, Tkv, NH, NKV, sm_scale,
                               kv_offset, causal, s);
  if (dtype == 2)
    return by_d<__half>(D, q, k, v, out, lo, mo, B, Tq, Tkv, NH, NKV, sm_scale, kv_offset,
                        causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
