// Hopper (sm_90a) helpers for kernels that stage tiles through the Tensor
// Memory Accelerator and multiply them with warpgroup MMAs: mbarriers, 2-D to
// 5-D TMA loads, 1-D bulk copies, the proxy fence, wgmma shared-memory
// descriptors (128- and 64-byte swizzle), the bf16 and fp16 wgmma with f32
// accumulators (m64n32k16, m64n64k16, m64n128k16 and m64n256k16 with both
// operands in shared memory; m64n64k16 and m64n128k16 with A in registers;
// tf32 m64n16k8, m64n32k8 and m64n64k8 with both operands in shared memory,
// m64nNk8 for N 32-256 with A in registers),
// named barriers, and on the host the dynamic shared memory opt-in and the
// encoders of TMA descriptors (reached through the runtime's entry-point
// lookup, so a library needs no -lcuda).
// Used by qmm_int8.cu, flash_fwd.cu, flash_bwd.cu, flash_sync_bwd.cu and
// flash_tf32.cuh.
//
// Layouts the descriptors describe (128-byte swizzle: inside each
// 1024-byte atom of 8 rows of 128 bytes, the 16-byte chunk c of row r sits
// at chunk c ^ (r % 8); atoms are 1024-byte aligned):
//   K-major operand (A = x, [rows][64 bf16] as TMA writes it with
//     CU_TENSOR_MAP_SWIZZLE_128B): SBO = 1024 bytes between 8-row groups,
//     LBO unused (16); the k-th 16-wide slice starts 32 k bytes in.
//   MN-major operand (B = the weight tile, [k][n], 64 n per 128-byte row):
//     atoms of 8 k rows x 64 n; SBO = 1024 bytes between 8-row k groups,
//     LBO = the bytes between 64-column n atoms; the k-th 16-deep slice
//     starts 2048 k bytes in. wgmma reads it with the B-transpose bit set.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

__device__ __forceinline__ uint32_t sm90_smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(sm90_smem(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(sm90_smem(bar)) : "memory");
}

// One arrival that also tells the barrier to expect `bytes` from TMA.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(sm90_smem(bar)),
               "r"(bytes)
               : "memory");
}

// Spin until the barrier's phase with this parity has completed. A wait
// that never completes (a broken pipeline) traps after about 2^28 polls, so
// the launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done, polls = 0;
  do {
    if (++polls == (1u << 28)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(sm90_smem(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA ---------------------------------------------------------------------

// The box at (c0 inner, c1 outer) of a 2-D tensor map into shared memory;
// completion is counted in bytes on `bar`. Out-of-range elements read 0.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(sm90_smem(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(sm90_smem(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// The box at (c0 inner, c1, c2 outer) of a 3-D tensor map, as tma_load_2d.
// Out-of-range elements read 0 within the box's own c2 slice, so a box of
// rows past the end of one batch row never reads the next batch row.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(sm90_smem(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(sm90_smem(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The box at (c0 inner, .., c3 outer) of a 4-D tensor map, as tma_load_2d.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(sm90_smem(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(sm90_smem(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// The box at (c0 inner, .., c4 outer) of a 5-D tensor map, as tma_load_2d.
__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(sm90_smem(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(sm90_smem(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4)
      : "memory");
}

// `bytes` (a multiple of 16) from global `src` into shared `dst`, both
// 16-byte aligned, by the bulk-copy engine; completion counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(sm90_smem(dst)), "l"(static_cast<uint64_t>(__cvta_generic_to_global(src))),
      "r"(bytes), "r"(sm90_smem(bar))
      : "memory");
}

// Orders this thread's generic-proxy shared-memory writes before later
// async-proxy reads (wgmma operands written with st.shared).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- wgmma -------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins an accumulator array in its registers across this point, so the
// compiler moves none of them between the wgmma that read and write them (a
// move would make it serialize the wgmma).
template <int N>
__device__ __forceinline__ void wgmma_fence_operand(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled operand.
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  uint64_t d = (sm90_smem(p) & 0x3FFFFu) >> 4;
  d |= static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFFu) << 16;
  d |= static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFFu) << 32;
  d |= static_cast<uint64_t>(1) << 62;  // 128-byte swizzle
  return d;
}

// The same for a 64-byte-swizzled K-major operand: rows of 64 bytes in atoms
// of 8 rows (512 bytes), SBO the bytes between 8-row groups; a k-slice of 8
// tf32 values starts 32 bytes into the row.
__device__ __forceinline__ uint64_t wgmma_desc_64b(const void* p, uint32_t sbo_bytes) {
  uint64_t d = (sm90_smem(p) & 0x3FFFFu) >> 4;
  d |= static_cast<uint64_t>(1) << 16;  // LBO unused (K-major, swizzled)
  d |= static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFFu) << 32;
  d |= static_cast<uint64_t>(2) << 62;  // 64-byte swizzle
  return d;
}

// Named barrier `id` over `n` threads (a multiple of 32).
__device__ __forceinline__ void named_bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Arrive at named barrier `id` over `n` threads without waiting for it.
__device__ __forceinline__ void named_bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// The wgmma shapes below each come in bf16 and fp16 (the element type T of
// the templates: __nv_bfloat16 or __half). Both read the same fragments,
// descriptors and transpose bits; only the operand type named in the
// instruction differs.

#define SM90_D32 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
  "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
  "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), \
  "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
  "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

#define SM90_D64 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
  "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
  "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), \
  "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
  "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
  "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
  "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), \
  "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), \
  "+f"(d[63])

#define SM90_D128 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
  "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
  "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), \
  "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
  "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
  "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
  "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), \
  "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), \
  "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), \
  "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), \
  "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), \
  "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), \
  "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), \
  "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
  "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), \
  "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), \
  "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), \
  "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])

#define SM90_SS_N32(TY) \
  asm volatile( \
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n" \
      " wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15" \
      "}, %16, %17, p, 1, 1, 0, %19;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), \
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
      : "l"(a), "l"(b), "r"(accumulate), "n"(TRANS_B))

#define SM90_SS_N64(TY) \
  asm volatile( \
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n" \
      " wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
      "%30, %31" \
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n" \
      : SM90_D32 \
      : "l"(a), "l"(b), "r"(accumulate), "n"(TRANS_B))

#define SM90_SS_N128(TY) \
  asm volatile( \
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n" \
      " wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
      "%58, %59, %60, %61, %62, %63" \
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n" \
      : SM90_D64 \
      : "l"(a), "l"(b), "r"(accumulate), "n"(TRANS_B))

#define SM90_SS_N256(TY) \
  asm volatile( \
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n" \
      " wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, " \
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, " \
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, " \
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, " \
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, " \
      "%122, %123, %124, %125, %126, %127" \
      "}, %128, %129, p, 1, 1, 0, %131;\n}\n" \
      : SM90_D128 \
      : "l"(a), "l"(b), "r"(accumulate), "n"(TRANS_B))

#define SM90_RS_N64(TY) \
  asm volatile( \
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n" \
      " wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
      "%30, %31" \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n" \
      : SM90_D32 \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate), "n"(TRANS_B))

#define SM90_RS_N128(TY) \
  asm volatile( \
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n" \
      " wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
      "%58, %59, %60, %61, %62, %63" \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n" \
      : SM90_D64 \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate), "n"(TRANS_B))

template <typename T>
__host__ __device__ constexpr bool sm90_is_f16() {
  return std::is_same<T, __half>::value;
}

// d[64] (+)= A (64 x 16, K-major, desc a) x B (16 x 128, desc b; MN-major when
// TRANS_B) in f32; accumulate = 0 overwrites d. Fragment of d: warp w of the
// warpgroup, lane l: d[4 j + i] is row 16 w + l / 4 + 8 (i / 2), column
// 8 j + 2 (l % 4) + i % 2.
template <typename T, int TRANS_B>
__device__ __forceinline__ void wgmma_m64n128k16(float* d, uint64_t a, uint64_t b,
                                                 int accumulate) {
  if constexpr (sm90_is_f16<T>())
    SM90_SS_N128("f16");
  else
    SM90_SS_N128("bf16");
}

// d[32] (+)= A (64 x 16) x B (16 x 64): as m64n128k16, half as wide.
template <typename T, int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16(float* d, uint64_t a, uint64_t b,
                                                int accumulate) {
  if constexpr (sm90_is_f16<T>())
    SM90_SS_N64("f16");
  else
    SM90_SS_N64("bf16");
}

// d[16] (+)= A (64 x 16) x B (16 x 32): as m64n128k16, a quarter as wide.
template <typename T, int TRANS_B>
__device__ __forceinline__ void wgmma_m64n32k16(float* d, uint64_t a, uint64_t b,
                                                int accumulate) {
  if constexpr (sm90_is_f16<T>())
    SM90_SS_N32("f16");
  else
    SM90_SS_N32("bf16");
}

// d[128] (+)= A (64 x 16) x B (16 x 256): as above, twice as wide; d[4 j + i]
// is column 8 j + 2 (l % 4) + i % 2 for j < 32.
template <typename T, int TRANS_B>
__device__ __forceinline__ void wgmma_m64n256k16(float* d, uint64_t a, uint64_t b,
                                                 int accumulate) {
  if constexpr (sm90_is_f16<T>())
    SM90_SS_N256("f16");
  else
    SM90_SS_N256("bf16");
}

// d (+)= A (64 x 16, in registers) x B (16 x N, desc b; MN-major when
// TRANS_B) in f32, N = 64 or 128. A's fragment is mma.sync m16n8k16's for
// each warp's 16 rows: warp w, lane l, g = l / 4, t = l % 4: a[0] = A[16 w +
// g][2 t .. 2 t + 1], a[1] = A[16 w + g + 8][2 t ..], a[2] = A[16 w + g][2 t +
// 8 ..], a[3] = A[16 w + g + 8][2 t + 8 ..] (pairs of T, low half first). d
// has the SS form's fragment, so d[8 kk .. 8 kk + 7] of one product packs in
// pairs into a[0..3] of k-slice kk of the next. a must hold until the wgmma
// retires.
template <typename T, int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float* d, const uint32_t* a, uint64_t b,
                                                   int accumulate) {
  if constexpr (sm90_is_f16<T>())
    SM90_RS_N64("f16");
  else
    SM90_RS_N64("bf16");
}

template <typename T, int TRANS_B>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float* d, const uint32_t* a, uint64_t b,
                                                    int accumulate) {
  if constexpr (sm90_is_f16<T>())
    SM90_RS_N128("f16");
  else
    SM90_RS_N128("bf16");
}

// d[16] (+)= A (64 x 8 tf32, K-major, desc a) x B (8 x 32 tf32, K-major: 32
// rows of 8 k values, desc b) in f32; accumulate = 0 overwrites d. tf32
// takes no transpose bit: both operands K-major, a k-slice of 8 values 32
// bytes into a 128-byte-swizzled row. d's fragment as wgmma_m64n128k16's.
__device__ __forceinline__ void wgmma_m64n32k8_tf32(float* d, uint64_t a, uint64_t b,
                                                    int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// The accumulator operand lists of the tf32 forms below, as asm text.
#define SM90_REGS32 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define SM90_REGS64 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, " \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, " \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define SM90_REGS96 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, " \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, " \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, " \
  "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, " \
  "%87, %88, %89, %90, %91, %92, %93, %94, %95"
#define SM90_REGS128 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, " \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, " \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, " \
  "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, " \
  "%87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, " \
  "%103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, " \
  "%117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
#define SM90_D96 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
  "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
  "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), \
  "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
  "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
  "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
  "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), \
  "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), \
  "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), \
  "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), \
  "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), \
  "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), \
  "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])

// d (+)= A (64 x 8 tf32, K-major, desc a) x B (8 x N tf32, K-major: N rows
// of 8 k values, desc b) in f32, N = 16, 32 or 64; accumulate = 0 overwrites d.
// d's fragment as wgmma_m64n128k16's (d[4 j + i]: row 16 w + l / 4 + 8 (i /
// 2), column 8 j + 2 (l % 4) + i % 2).
template <int N>
__device__ __forceinline__ void wgmma_tf32(float* d, uint64_t a, uint64_t b, int accumulate) {
  static_assert(N == 16 || N == 32 || N == 64, "tf32 SS wgmma: N 16, 32 or 64");
  if constexpr (N == 16) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %10, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7])
        : "l"(a), "l"(b), "r"(accumulate));
  } else if constexpr (N == 32) {
    wgmma_m64n32k8_tf32(d, a, b, accumulate);
  } else {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {" SM90_REGS32
        "}, %32, %33, p, 1, 1;\n}\n"
        : SM90_D32
        : "l"(a), "l"(b), "r"(accumulate));
  }
}

// d (+)= A (64 x 8 tf32 in registers) x B (8 x N, K-major, desc b), N = 32,
// 64, 128, 192 or 256. A's fragment is mma.sync m16n8k8 .tf32's for each warp's 16 rows
// (warp w, lane l, g = l / 4, t = l % 4): a[0] = A[16 w + g][t], a[1] =
// A[16 w + g + 8][t], a[2] = A[16 w + g][t + 4], a[3] = A[16 w + g + 8][t +
// 4]. An accumulator's columns 2 t and 2 t + 1 of an 8-column group are k
// indices t and t + 4 here: B's k rows ordered to match (flash_tf32_bwd.cu).
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float* d, const uint32_t* a, uint64_t b,
                                              int accumulate) {
  static_assert(N == 32 || N == 64 || N == 128 || N == 192 || N == 256,
                "tf32 RS wgmma: N 32, 64, 128, 192 or 256");
  if constexpr (N == 32) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {" SM90_REGS32
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : SM90_D32
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
  } else if constexpr (N == 128) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {" SM90_REGS64
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : SM90_D64
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
  } else if constexpr (N == 192) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %101, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n192k8.f32.tf32.tf32 {" SM90_REGS96
        "}, {%96, %97, %98, %99}, %100, p, 1, 1;\n}\n"
        : SM90_D96
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
  } else {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %133, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 {" SM90_REGS128
        "}, {%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
        : SM90_D128
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
  }
}

// The TMA element type of T.
template <typename T>
constexpr CUtensorMapDataType tma_type() {
  return sm90_is_f16<T>() ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// ---- host ----------------------------------------------------------------------

// TMA descriptors:

typedef CUresult (*TensorMapEncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                         const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                         const cuuint32_t*, CUtensorMapInterleave,
                                         CUtensorMapSwizzle, CUtensorMapL2promotion,
                                         CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once; null if unavailable.
static inline TensorMapEncodeTiled tensor_map_encoder() {
  static TensorMapEncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                            &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (TensorMapEncodeTiled)p;
  }
  return fn;
}

// A row-major [rows, cols] tensor of `elem` bytes per element, read in
// boxes of [box_rows, box_cols]. Returns false if it cannot be encoded.
static inline bool encode_2d(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* ptr,
                             uint64_t rows, uint64_t cols, uint32_t box_rows, uint32_t box_cols,
                             CUtensorMapSwizzle swizzle) {
  TensorMapEncodeTiled fn = tensor_map_encoder();
  if (!fn) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * static_cast<uint64_t>(elem)};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A row-major [d2][d1][d0] tensor (d0 innermost) of `elem` bytes per
// element, read in boxes of [1][box1][box0]. Returns false if it cannot be
// encoded (among others: a base not 16-byte aligned, or a row stride not a
// multiple of 16 bytes).
static inline bool encode_3d(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* ptr,
                             uint64_t d2, uint64_t d1, uint64_t d0, uint32_t box1, uint32_t box0,
                             CUtensorMapSwizzle swizzle) {
  TensorMapEncodeTiled fn = tensor_map_encoder();
  if (!fn) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * static_cast<uint64_t>(elem),
                                 d0 * d1 * static_cast<uint64_t>(elem)};
  const cuuint32_t box[3] = {box0, box1, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, type, 3, const_cast<void*>(ptr), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A tensor of `rank` (at most 5) dimensions, dims[0] innermost and dense,
// strides[i] the bytes between steps of dims[i + 1], read in boxes of box[]
// elements. Returns false if it cannot be encoded.
static inline bool encode_nd(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
                             int rank, const uint64_t* dims, const uint64_t* strides,
                             const uint32_t* box, CUtensorMapSwizzle swizzle) {
  TensorMapEncodeTiled fn = tensor_map_encoder();
  if (!fn || rank < 1 || rank > 5) return false;
  cuuint64_t d[5], st[4];
  cuuint32_t b[5], e[5];
  for (int i = 0; i < rank; ++i) d[i] = dims[i], b[i] = box[i], e[i] = 1;
  for (int i = 0; i + 1 < rank; ++i) st[i] = strides[i];
  return fn(map, type, rank, const_cast<void*>(ptr), d, st, b, e, CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}
