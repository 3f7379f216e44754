// The mma.sync pieces of flash_sync_bwd.cu, the flash-attention backward
// for what the TMA + wgmma backwards (flash_bwd.cu: bf16 and fp16 at D
// 64-256; flash_tf32_bwd.cu: f32 at D 64 and 128) do not take and the TPU
// kernels' tiling gate admits: the 16-bit backward past D 256 (column parts,
// Wide below) and f32's from D 192 (its split kernels form S and dP on
// wgmma and run dQ, dK and dV on mma.sync m16n8k8 .tf32). Every forward runs
// on TMA + wgmma (flash_fwd.cu, flash_tf32_fwd.cu).
//
// One warp owns 16 rows of a tile and runs its products on mma.sync with
// f32 accumulators: bf16 and fp16 on m16n8k16, f32 on m16n8k8 .tf32 (the
// operands rounded to tf32 by cvt.rna, the sums stay f32; ROADMAP §C.2).
// Tiles sit in shared memory as row-major [row][column] arrays padded by PAD
// elements a row; the 16-bit fragments come from them by 32-bit loads (ld32)
// or ldmatrix.trans (B from a [k][n] tile).
//
// Fragment layouts (g = lane / 4, t = lane % 4; C/D of both shapes: c0, c1 =
// C[g][2t, 2t + 1], c2, c3 = C[g + 8][2t, 2t + 1]):
//   m16n8k16: A a0 = A[g][2t..2t+1], a1 = A[g+8][2t..], a2 = A[g][2t+8..],
//     a3 = A[g+8][2t+8..]; B b0 = B[2t..2t+1][g], b1 = B[2t+8..][g]. Two
//     C tiles of 8 columns make one A fragment of 16 k values.
//   m16n8k8 .tf32: A a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4], a3 =
//     A[g+8][t+4]; B b0 = B[t][g], b1 = B[t+4][g]. The k order inside a
//     step is free (the products are summed), so this family reads k index
//     t as column 2t and t + 4 as column 2t + 1 of every tile: a C tile of
//     8 columns is then one A fragment as it stands (c0, c2, c1, c3), and the
//     row loads are 8-byte pairs.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace fsync {

constexpr int THREADS = 128, WARPS = 4, BQ = 64;  // 16 rows a warp

__device__ __forceinline__ void mma_f16(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The fragment loads, the one mma and the stores of one input type.
template <typename T>
struct Ops;

// bf16 and fp16: m16n8k16.
template <typename T>
struct Ops16 {
  static constexpr int KS = 16;  // k values a step
  static constexpr int PAD = 8;  // elements a shared row is padded by (16 bytes)
  __device__ static void a_rows(uint32_t* a, const T* tile, int rs, int r0, int k0, int lane) {
    const int g = lane >> 2, t = lane & 3;
    const T* p = tile + (r0 + g) * rs + k0 + 2 * t;
    a[0] = *reinterpret_cast<const uint32_t*>(p);
    a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * rs);
    a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
    a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * rs + 8);
  }
  // Column n of B is row n0 + n of the tile, k along that row from k0.
  __device__ static void b_rows(uint32_t* b, const T* tile, int rs, int n0, int k0, int lane) {
    const int g = lane >> 2, t = lane & 3;
    const T* p = tile + (n0 + g) * rs + k0 + 2 * t;
    b[0] = *reinterpret_cast<const uint32_t*>(p);
    b[1] = *reinterpret_cast<const uint32_t*>(p + 8);
  }
  // B = tile[k0 .. k0 + 16][n0 .. n0 + 8] of a row-major [k][n] tile.
  __device__ static void b_trans(uint32_t* b, const T* tile, int rs, int k0, int n0, int lane) {
    ldmatrix_x2_trans(b, tile + (k0 + (lane & 15)) * rs + n0);
  }
};

template <>
struct Ops<__nv_bfloat16> : Ops16<__nv_bfloat16> {
  // The A fragment of k-step [16 kk, 16 kk + 16) from C tiles c[2 kk], c[2 kk + 1].
  __device__ static void a_acc(uint32_t* a, const float (*c)[4]) {
    a[0] = pack2(c[0][0], c[0][1]);
    a[1] = pack2(c[0][2], c[0][3]);
    a[2] = pack2(c[1][0], c[1][1]);
    a[3] = pack2(c[1][2], c[1][3]);
  }
  __device__ static void mma(float* d, const uint32_t* a, const uint32_t* b) { mma_bf16(d, a, b); }
  __device__ static void store2(__nv_bfloat16* p, float x, float y) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
  }
};

template <>
struct Ops<__half> : Ops16<__half> {
  __device__ static void a_acc(uint32_t* a, const float (*c)[4]) {
    a[0] = pack2_f16(c[0][0], c[0][1]);
    a[1] = pack2_f16(c[0][2], c[0][3]);
    a[2] = pack2_f16(c[1][0], c[1][1]);
    a[3] = pack2_f16(c[1][2], c[1][3]);
  }
  __device__ static void mma(float* d, const uint32_t* a, const uint32_t* b) { mma_f16(d, a, b); }
  __device__ static void store2(__half* p, float x, float y) {
    *reinterpret_cast<__half2*>(p) = __floats2half2_rn(x, y);
  }
};

// The 16-bit backward past D 256 (dq_wide, dkv_wide): a block owns DC
// columns of its output (dQ, or dK and dV; the last part of a row D - c0
// of them when D % DC != 0). S and dP sum over all of D, their operands
// streamed through shared memory in 64-column panels, double buffered; the
// block's own columns of V, K, or Q and dO come in as one tile a step. So
// shared memory and registers do not grow with D, and any multiple of 64
// runs, at the cost of S (and dP) formed once per column part.
template <typename T>
struct Wide {
  static_assert(sizeof(T) == 2, "the column-part kernels take bf16 and fp16");
  static constexpr int DC = 128;                        // output columns a block
  static constexpr int PW = 64;                         // columns a panel
  static constexpr int RS = PW + Ops<T>::PAD;           // elements a panel row
  static constexpr int CS = DC + Ops<T>::PAD;           // elements a column-part row
  static constexpr int NK = 64;                         // keys a tile (dQ)
  static constexpr int NQ = 32;                         // query rows a tile (dK/dV)
};

// Rows [r0, r0 + n) and the first w columns (a multiple of 16 bytes) of a
// [.., T, H, D] tensor seen from `src` (row stride `stride` elements; w = D
// for a whole head) into a shared tile of n rows x RS by 16-byte cp.async;
// rows at or past T are zero-filled.
template <typename T, int RS>
__device__ __forceinline__ void load_block(T* dst, const T* src, size_t stride, int r0, int n,
                                           int w, int T_, int tid) {
  constexpr int PER = 16 / (int)sizeof(T);
  const int cpr = w / PER;
  for (int i = tid; i < n * cpr; i += THREADS) {
    const int r = i / cpr, c = (i % cpr) * PER;
    if (r0 + r < T_)
      cp_async16(dst + r * RS + c, src + (size_t)(r0 + r) * stride + c);
    else
      *reinterpret_cast<uint4*>(dst + r * RS + c) = make_uint4(0u, 0u, 0u, 0u);
  }
}

}  // namespace fsync
