// Warp-level tensor-core and async-copy helpers shared by the flash kernels
// (flash_fwd.cu, flash_bwd.cu), the paged and contiguous-cache decode
// attention (paged_decode_attn.cu, dense_decode_attn.cu) and the int4 and
// int8 GEMVs (qgemv_int4.cu, qgemv_int8.cu): bf16 mma.sync m16n8k16 with
// f32 accumulators, bf16 and fp16 pairs packed from f32, cp.async copies
// into shared memory and ldmatrix.trans.
//
// Fragment layout of m16n8k16 (g = lane / 4, t = lane % 4): A (16 x 16,
// row-major) a0 = A[g][2t..2t+1], a1 = A[g+8][2t..], a2 = A[g][2t+8..], a3
// = A[g+8][2t+8..]; B (16 x 8, "col": for column n the k values are
// adjacent) b0 = B[2t..2t+1][g], b1 = B[2t+8..][g]; C/D c0,c1 = C[g][2t..],
// c2,c3 = C[g+8][2t..]. Two adjacent C tiles of 8 columns therefore make one
// A fragment of 16 k values (pack2 of c0,c1 / c2,c3 of each).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two f32 values rounded to bf16 (nearest even) in one 32-bit register.
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two f32 values rounded to fp16 (nearest even) in one 32-bit register.
__device__ __forceinline__ uint32_t pack2_f16(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// pack2 of the element type T (__nv_bfloat16 or __half).
template <typename T>
__device__ __forceinline__ uint32_t pack2_as(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value)
    return pack2_f16(lo, hi);
  else
    return pack2(lo, hi);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Two 8x8 bf16 matrices at rows p (threads 0-7) and p + 8 rows (threads
// 8-15), transposed: the B fragment of m16n8k16 for a row-major [k][n] tile.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The A fragment of rows [row0, row0 + 16) and columns [c0, c0 + 16) of a
// row-major bf16 tile with `rs` elements per row (shared or global memory).
__device__ __forceinline__ void load_a(uint32_t* a, const __nv_bfloat16* tile, int rs, int row0,
                                       int c0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* p = tile + (row0 + g) * rs + c0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * rs);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * rs + 8);
}

// The B fragment whose column n is row (n0 + n) of a row-major tile, k
// running along that row from c0: B = tile[n0 .. n0 + 8][c0 .. c0 + 16]^T.
__device__ __forceinline__ void load_b_rows(uint32_t* b, const __nv_bfloat16* tile, int rs, int n0,
                                            int c0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* p = tile + (n0 + g) * rs + c0 + 2 * t;
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}
