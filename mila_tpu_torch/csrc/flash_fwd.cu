// flash_fwd: causal grouped-query flash-attention forward, bf16 in and out.
//
// Replaces the TPU kernels mila_tpu/kernels/flash_attention.py:_fa_kernel
// (D >= 128) and _fa_kernel_t (D < 128), entry flash_attention ->
// _flash_attention_forward, with and without save_stats (below). The
// TPU's transposed layout for D < 128 exists
// for its 128-lane matrix unit only; here one kernel serves D 64 and 128.
//
// Bound on the H100: tensor-core operations at prefill lengths (2 * Tq * Tkv
// * D multiply-adds per head, halved by the causal skip, against Tq + 2 Tkv
// rows of D bf16 values read). Design: one block of 4 warps per (q tile of
// 64 rows, head, batch row); each warp owns 16 query rows, its Q fragments
// in registers. K/V tiles of 64 keys stream through shared memory with
// cp.async, double-buffered (tile j + 1 loads while tile j computes). S =
// Q K^T and O += P V run on mma.sync m16n8k16 bf16 with f32 accumulators;
// V's B fragments come from its row-major tile through ldmatrix.trans; P
// goes from the S accumulators to A fragments in registers. The online
// softmax runs in f32 per row (4 lanes share a row). Blocks take the q
// tiles heaviest first (the causal skip leaves the last tiles the most
// keys).
//
// With l_out/m_out (the launch under autograd, _flash_attention_forward(
// save_stats=True)) it also writes each row's final sum l and max m, f32
// [B, NH, Tq], without the TPU's 128-lane padding.
//
// The TPU kernel's semantics: the causal tile skip with kv_offset (a key
// tile runs when its first key <= the tile's last row + kv_offset); masked
// scores are -0.7 * f32max, not -inf; p is rounded to V's dtype (bf16)
// before P V while l sums the f32 p; 1 / l with l == 0 guarded at the
// store; query head h reads KV head h / G (G = NH / NKV, natural order).
// Layouts are the model's: q and out [B, Tq, NH, D], k and v [B, Tkv, NKV,
// D], contiguous. Rows past Tq in the last q tile are computed on zeros and
// never stored.
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int BQ = 64, BKV = 64, THREADS = 128;
constexpr float MASK_VALUE = -0.7f * 3.402823466e38f;

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                 float* __restrict__ l_out, float* __restrict__ m_out, int Tq, int Tkv, int NH,
                 int NKV, float sm_scale, int kv_offset, int causal) {
  constexpr int RS = D + 8;  // bf16 per shared row (16-byte aligned, staggers banks)
  constexpr int TILE = BKV * RS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [2][BKV][RS]
  __nv_bfloat16* Vs = Ks + 2 * TILE;                                // [2][BKV][RS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (NH / NKV);
  const int q0 = qt * BQ;
  const int wrow = q0 + warp * 16;  // the warp's first query row
  const int r0 = wrow + g;          // this thread's rows r0 and r0 + 8
  const size_t qstride = (size_t)NH * D, kstride = (size_t)NKV * D;
  const __nv_bfloat16* qb = q + (size_t)b * Tq * qstride + (size_t)h * D;
  const __nv_bfloat16* kb = k + (size_t)b * Tkv * kstride + (size_t)hk * D;
  const __nv_bfloat16* vb = v + (size_t)b * Tkv * kstride + (size_t)hk * D;

  int n_kv = Tkv / BKV;
  if (causal) {
    const int last = q0 + BQ - 1 + kv_offset;  // the TPU kernel's tile-skip rule
    n_kv = last < 0 ? 0 : min(n_kv, last / BKV + 1);
  }

  auto load_tile = [&](int buf, int j) {
    const int k0 = j * BKV;
    constexpr int CHUNKS = BKV * D / 8;  // 16-byte pieces per tile
#pragma unroll
    for (int i = tid; i < CHUNKS; i += THREADS) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      cp_async16(Ks + buf * TILE + r * RS + c, kb + (size_t)(k0 + r) * kstride + c);
      cp_async16(Vs + buf * TILE + r * RS + c, vb + (size_t)(k0 + r) * kstride + c);
    }
    cp_async_commit();
  };
  if (n_kv > 0) load_tile(0, 0);

  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + tig * 2;
    const bool a = r0 < Tq, bb = r0 + 8 < Tq;
    qf[kk][0] = a ? ld32(qb + (size_t)r0 * qstride + c) : 0u;
    qf[kk][1] = bb ? ld32(qb + (size_t)(r0 + 8) * qstride + c) : 0u;
    qf[kk][2] = a ? ld32(qb + (size_t)r0 * qstride + c + 8) : 0u;
    qf[kk][3] = bb ? ld32(qb + (size_t)(r0 + 8) * qstride + c + 8) : 0u;
  }
  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int j = 0; j < n_kv; ++j) {
    const int buf = j & 1, k0 = j * BKV;
    if (j + 1 < n_kv) {
      load_tile(buf ^ 1, j + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* kt = Ks + buf * TILE;
    const __nv_bfloat16* vt = Vs + buf * TILE;

    // S = Q K^T for the warp's 16 rows x 64 keys.
    float s[BKV / 8][4];
#pragma unroll
    for (int ni = 0; ni < BKV / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[ni][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int ni = 0; ni < BKV / 8; ++ni) {
        const __nv_bfloat16* p = kt + (ni * 8 + g) * RS + kk * 16 + tig * 2;
        const uint32_t bf[2] = {ld32(p), ld32(p + 8)};
        mma_bf16(s[ni], qf[kk], bf);
      }

    // Scale, mask (only tiles that reach past the warp's first row), row max.
    const bool diag = causal && k0 + BKV - 1 > wrow + kv_offset;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int ni = 0; ni < BKV / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1;
        float val = s[ni][e] * sm_scale;
        if (diag && k0 + ni * 8 + tig * 2 + (e & 1) > r0 + 8 * hr + kv_offset) val = MASK_VALUE;
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
    for (int di = 0; di < D / 8; ++di) {
      o[di][0] *= alpha[0];
      o[di][1] *= alpha[0];
      o[di][2] *= alpha[1];
      o[di][3] *= alpha[1];
    }

    // O += bf16(P) V: two S column tiles make one A fragment of 16 keys.
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint32_t a[4] = {pack2(s[2 * kk][0], s[2 * kk][1]), pack2(s[2 * kk][2], s[2 * kk][3]),
                             pack2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* vrow = vt + (kk * 16 + (lane & 15)) * RS;
#pragma unroll
      for (int di = 0; di < D / 8; ++di) {
        uint32_t bf[2];
        ldmatrix_x2_trans(bf, vrow + di * 8);
        mma_bf16(o[di], a, bf);
      }
    }
    __syncthreads();  // the next iteration's load overwrites the other buffer's last reader
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r0 + 8 * hr;
    if (row >= Tq) continue;
    const float inv = l[hr] == 0.f ? 1.f : 1.f / l[hr];
    if (l_out != nullptr && tig == 0) {  // the backward's row statistics
      const size_t srow = ((size_t)b * NH + h) * Tq + row;
      l_out[srow] = l[hr];
      m_out[srow] = m[hr];
    }
    __nv_bfloat16* orow = out + (size_t)b * Tq * qstride + (size_t)row * qstride + (size_t)h * D;
#pragma unroll
    for (int di = 0; di < D / 8; ++di)
      *reinterpret_cast<__nv_bfloat162*>(orow + di * 8 + tig * 2) =
          __floats2bfloat162_rn(o[di][2 * hr] * inv, o[di][2 * hr + 1] * inv);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, float* l_out, float* m_out,
           int B, int Tq, int Tkv, int NH, int NKV, float sm_scale, int kv_offset, int causal,
           cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) * 4 * BKV * (D + 8);
  auto kern = flash_fwd_kernel<D>;
  static bool opted[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64 || !opted[dev]) {
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (dev < 64) opted[dev] = true;
  }
  dim3 grid((Tq + BQ - 1) / BQ, NH, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), l_out, m_out, Tq, Tkv,
      NH, NKV, sm_scale, kv_offset, causal);
  return 0;
}

}  // namespace

// q [B, Tq, NH, D], k and v [B, Tkv, NKV, D], out [B, Tq, NH, D], all bf16
// and contiguous. Needs D in {64, 128}, Tkv % 64 == 0 and NH % NKV == 0
// (checked by the Python wrapper). causal != 0 masks key j for query i
// unless j <= i + kv_offset. l_out and m_out are null (the primal launch)
// or f32 [B, NH, Tq]: each row's softmax sum l and max m (of the scaled
// scores), the statistics flash_bwd recomputes p from.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* out, void* l_out,
                         void* m_out, int B, int Tq, int Tkv, int NH, int NKV, int D,
                         float sm_scale, int kv_offset, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lo = static_cast<float*>(l_out);
  float* mo = static_cast<float*>(m_out);
  if (B > 0 && Tq > 0) {
    if (D == 64)
      launch<64>(q, k, v, out, lo, mo, B, Tq, Tkv, NH, NKV, sm_scale, kv_offset, causal, s);
    else if (D == 128)
      launch<128>(q, k, v, out, lo, mo, B, Tq, Tkv, NH, NKV, sm_scale, kv_offset, causal, s);
    else
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
