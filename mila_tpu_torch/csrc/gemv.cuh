// Helpers shared by the decode GEMVs on tensor cores (qgemv_int4.cu,
// qgemv_int8.cu and the layer-tail phases of tail_phases.cuh): byte
// permutes, the exact int8 -> bf16 and fp8 -> bf16 pair conversions, the
// products of one staged weight stage, the thread-block-cluster barrier and
// stores into another block's shared memory, and 16-byte loads and stores
// of x and the outputs in bf16 or f32.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "mma.cuh"

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// Byte j of wa and of wb (int8 s) as the bf16 pair (wa's s, wb's s), exact:
// prmt puts the two bytes in the low bytes of the halves; in each half, one
// lop3 makes bf16 128 + (s & 127) (the byte's low 7 bits as the mantissa of
// 128) and one makes -128, or -256 where the sign bit is set; one bf16x2
// FMA adds them: s, an integer that bf16 holds.
__device__ __forceinline__ uint32_t s8_pair(uint32_t wa, uint32_t wb, int j) {
  const uint32_t p = prmt(wa, wb, 0x4400u + 0x1111u * j);
  uint32_t m, c, v;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;" : "=r"(m) : "r"(p), "r"(0x007F007Fu), "r"(0x43004300u));
  asm("lop3.b32 %0, %1, %2, %3, 0x6A;" : "=r"(c) : "r"(p), "r"(0x00800080u), "r"(0xC300C300u));
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(v) : "r"(m), "r"(0x3F803F80u), "r"(c));
  return v;
}

// One-byte weight formats (the C entries' wfmt argument).
constexpr int WFMT_INT8 = 0, WFMT_E4M3 = 1, WFMT_E5M2 = 2;

// The fp8 -> bf16 conversion of a word p whose halves hold one fp8 byte
// each in their high byte (the low bytes are ignored), exact, subnormals
// included. The TPU kernels' decode (mila_tpu/kernels/quant_matmul.py:
// _load_w) puts the 7-bit payload into the exponent and mantissa fields of
// a bf16 (one shift and one mask here: e4m3 >> 4 into bits 4-10, e5m2 >> 3
// into bits 5-11), which is the fp8 value times 2^-120 (e4m3) or 2^-112
// (e5m2): a bf16 subnormal for the fp8 subnormal codes, and a product
// under f32's normal range for small activations. So one bf16x2 FMA
// multiplies it by +-2^120 or +-2^112 at once (the sign bit and the power
// of two in one lop3; the FMA keeps subnormal inputs) and the operand is the
// fp8 value itself, as in the K1 GEMM. No scale fixup is needed after it:
// scales that carry one (the layer-tail packs) are divided by it
// (tail_phases.cuh: pack_scale_unfix).
// Five instructions a pair: prmt (by the caller), shift, and, lop3, FMA.
struct F8Pair {
  uint32_t shift, mask, mult;
  __device__ __forceinline__ explicit F8Pair(int fmt)
      : shift(fmt == WFMT_E4M3 ? 4u : 3u),
        mask(fmt == WFMT_E4M3 ? 0x07F007F0u : 0x0FE00FE0u),
        mult(fmt == WFMT_E4M3 ? 0x7B807B80u : 0x77807780u) {}  // bf16 2^120, 2^112

  __device__ __forceinline__ uint32_t bits(uint32_t p) const {
    const uint32_t m = (p >> shift) & mask;
    uint32_t k, v;
    asm("lop3.b32 %0, %1, %2, %3, 0xEA;" : "=r"(k) : "r"(p), "r"(0x80008000u), "r"(mult));
    asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(v) : "r"(m), "r"(k), "r"(0x80008000u));
    return v;
  }
  // Byte j of wa and of wb as the bf16 pair (wa's value, wb's value).
  __device__ __forceinline__ uint32_t operator()(uint32_t wa, uint32_t wb, int j) const {
    return bits(prmt(wa, wb, 0x4400u + 0x1111u * j));
  }
};

struct S8Pair {
  __device__ __forceinline__ uint32_t operator()(uint32_t wa, uint32_t wb, int j) const {
    return s8_pair(wa, wb, j);
  }
};

__device__ __forceinline__ uint32_t ld_word(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t comp(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// The products of k-steps [j0, j0 + ksw) of one staged weight stage (rows
// of PITCH bytes; sp at the lane's first column) on the tensor cores: lane
// (g, t) reads the 32-bit words of its 4 columns from rows 2t, 2t + 1, 2t + 8
// and 2t + 9 of each 16-row k-step, turns byte j of each pair of rows into
// a bf16 pair with cvt (S8Pair or F8Pair), and multiplies them with x's B
// fragments, bx[mt][jj / 2] (2 KS words of a stage, k-step jj of them).
template <int PITCH, int KS, int MTN, typename Cvt>
__device__ __forceinline__ void stage_products(float (&acc)[2][MTN][4], const unsigned char* sp,
                                               const uint4 (&bx)[MTN][KS / 2], int t, int j0,
                                               int ksw, const Cvt& cvt) {
#pragma unroll
  for (int jj = 0; jj < KS; ++jj) {
    if (jj >= ksw) break;
    const unsigned char* r = sp + (16 * (j0 + jj) + 2 * t) * PITCH;
    const uint32_t w0 = ld_word(r), w1 = ld_word(r + PITCH);
    const uint32_t w2 = ld_word(r + 8 * PITCH), w3 = ld_word(r + 9 * PITCH);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const uint32_t af[4] = {cvt(w0, w1, 2 * n), cvt(w0, w1, 2 * n + 1), cvt(w2, w3, 2 * n),
                              cvt(w2, w3, 2 * n + 1)};
#pragma unroll
      for (int mt = 0; mt < MTN; ++mt) {
        const uint32_t b[2] = {comp(bx[mt][jj / 2], 2 * (jj % 2)),
                               comp(bx[mt][jj / 2], 2 * (jj % 2) + 1)};
        mma_bf16(acc[n][mt], af, b);
      }
    }
  }
}

// A cp.async of BYTES (16: cached in L2 only; 4 or 8: through L1) into the
// shared-memory address dst.
template <int BYTES>
__device__ __forceinline__ void cp_async_to(uint32_t dst, const void* src) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst), "l"(src), "n"(BYTES));
}

// Programmatic dependent launch: let the next kernel of the stream start
// (it waits itself before it reads this one's results), and wait for the
// kernel before this one to finish and flush its writes.
__device__ __forceinline__ void pdl_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void pdl_wait() { asm volatile("griddepcontrol.wait;" ::: "memory"); }

// The cluster's blocks arrive once at the start (barrier phase 1) and wait
// for each other before the first store into another block's shared
// memory: every block of the cluster has started by then.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// v to the float4 at p in the shared memory of the cluster's block `rank`.
__device__ __forceinline__ void st_cluster(float4* p, int rank, float4 v) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(a) : "r"(smem_addr(p)), "r"(rank));
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};"
               :: "r"(a), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w) : "memory");
}

// Eight consecutive values (16- or 32-byte aligned) as f32.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// Four consecutive values (8- or 16-byte aligned) as f32, and back.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack2(v.x, v.y), pack2(v.z, v.w));
}
