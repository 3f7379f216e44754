// layer_tail_int8: one decoder layer's tail as ONE persistent cooperative
// launch over the pack_layer weight stream of int8 or fp8 (e4m3fn, e5m2)
// tiles (the phases, their arithmetic and their design are in
// tail_phases.cuh).
//
// Replaces the TPU kernels mila_tpu/kernels/layer_stream.py:_stream_kernel
// (layer_tail_stream), mila_tpu/kernels/layer_fused.py:_tail_kernel
// (mlp_qkv_fused) and, with no next wqkv and 2048-column tiles,
// mila_tpu/kernels/decode_mlp.py:_mlp_mega_kernel / _mlp_manual_kernel
// (mlp_block_fused), whose arithmetic are the first six phases.
//
// Bound on the H100: the one-byte tiles of the layer (60.8 MB at
// Llama-3.2-1B, 2 * M operations per byte). The products run on mma.sync,
// so the phases are not held by instruction issue (a conversion and M FMAs
// a byte on the CUDA cores were, PERF.md).
#include "tail_phases.cuh"

namespace {

using namespace tail;

template <int MT, typename T, bool FP8>
__global__ void __launch_bounds__(THREADS, MT == 8 ? TAIL_MIN_BLOCKS : 1) tail_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  tail_phases<MT, T, FP8 ? WK_FP8 : WK_INT8>(p, smem, grid);
}

template <int MT, typename T, bool FP8>
const void* kernel_ptr() {
  static bool done[64] = {};
  return opted(reinterpret_cast<const void*>(tail_kernel<MT, T, FP8>), done);
}

template <bool FP8>
const void* pick_fmt(int m_tile, int is_f32) {
  if (m_tile == 8)
    return is_f32 ? kernel_ptr<8, float, FP8>() : kernel_ptr<8, __nv_bfloat16, FP8>();
  return is_f32 ? kernel_ptr<32, float, FP8>() : kernel_ptr<32, __nv_bfloat16, FP8>();
}

const void* pick(int m_tile, int is_f32, int wfmt) {
  return wfmt == WFMT_INT8 ? pick_fmt<false>(m_tile, is_f32) : pick_fmt<true>(m_tile, is_f32);
}

}  // namespace

// Co-resident blocks per SM of the instantiation (m_tile 8 or 32, the
// tiles' format wfmt).
extern "C" int layer_tail_int8_blocks_per_sm(int m_tile, int is_f32, int wfmt, int* out) {
  return tail::blocks_per_sm(pick(m_tile, is_f32, wfmt), out);
}

// att [M, H] bf16; x, out [M, H] (f32 when is_f32, else bf16); gammas [H]
// f32; w [Ttot, H, bn] one-byte tiles in format wfmt (0 int8, 1 fp8 e4m3fn,
// 2 fp8 e5m2), s [Ttot, 1, bn] f32 (an fp8 pack's with JAX's fixup folded
// in), tiles [base, base + n_tiles) used; qkv [M, n_qkv * bn] or null when
// n_qkv == 0. Scratch (f32):
// p_wo [ks_wo, M, H], x1 [M, H], ssq1 [M, grid], p_gu [ks_gu, M, 2I],
// hbuf [M, I], p_down [(I / H) * ks_down, M, H], xo [M, H], ssq2 [M, grid],
// p_q [ks_q, M, n_qkv * bn], each 16-byte aligned. Units of cols_* (128 or
// 256, dividing bn) weight columns and ks_* K slices per phase. grid must
// not exceed tail::blocks_per_sm * SMs, nor tail::MAX_GRID (512: the row
// sums row_rstd reads; a larger grid returns cudaErrorInvalidValue). Needs bn % 128 == 0, H % bn == 0,
// I % H == 0, M <= m_tile, every H / ks a multiple of tail::SR whose staged
// slice fits tail::XS_BYTES, and 16-byte aligned att, gammas, w and s
// (kernels/layer_fused.py:plan_tail and launch_tail).
extern "C" int layer_tail_int8(const void* att, const void* x, const void* g_mlp,
                               const void* g_next, const void* w, const void* s, void* out,
                               void* qkv, void* p_wo, void* x1, void* ssq1, void* p_gu,
                               void* hbuf, void* p_down, void* xo, void* ssq2, void* p_q, int M,
                               int H, int I, int bn, int base, int n_qkv, int ks_wo, int ks_gu,
                               int ks_down, int ks_q, int cols_wo, int cols_gu,
                               int cols_down, int cols_q, float eps, int grid, int m_tile,
                               int is_f32, int wfmt, void* stream) {
  if (grid < 1 || grid > tail::MAX_GRID) return static_cast<int>(cudaErrorInvalidValue);
  tail::Params prm{static_cast<const __nv_bfloat16*>(att), x, static_cast<const float*>(g_mlp),
             static_cast<const float*>(g_next), static_cast<const int8_t*>(w),
             static_cast<const float*>(s), out, qkv, static_cast<float*>(p_wo),
             static_cast<float*>(x1), static_cast<float*>(ssq1), static_cast<float*>(p_gu),
             static_cast<float*>(hbuf), static_cast<float*>(p_down), static_cast<float*>(xo),
             static_cast<float*>(ssq2), static_cast<float*>(p_q), M, H, I, bn, base, n_qkv,
             ks_wo, ks_gu, ks_down, ks_q, cols_wo, cols_gu, cols_down, cols_q, eps, wfmt};
  void* args[] = {&prm};
  const cudaError_t e = cudaLaunchCooperativeKernel(pick(m_tile, is_f32, wfmt), dim3(grid),
                                                    dim3(tail::THREADS), args, tail::SMEM_BYTES,
                                                    static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}
