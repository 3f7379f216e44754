// Shared helpers for the port's CUDA kernels (sm_90a, plain C entry points
// loaded through ctypes). Every entry point launches on the caller's stream,
// allocates nothing and returns cudaGetLastError() right after its launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// A source built in parts (kernels/_build.py: PARTS) is compiled once per
// part with MILA_PART = 0, 1, ...; IN_PART(k) holds what part k compiles.
// Part 0 holds the C entry points. Without MILA_PART every part is in.
#ifdef MILA_PART
#define IN_PART(k) (MILA_PART == (k))
#else
#define IN_PART(k) 1
#endif

#if IN_PART(0)
extern "C" const char* mila_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
#endif

// Opts a kernel into `bytes` of dynamic shared memory (past 48 KB), once per
// device; `sized` is the caller's flag per device.
template <typename K>
cudaError_t size_smem(K kern, int bytes, bool* sized) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && sized[dev]) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             bytes);
  if (e == cudaSuccess && dev < 64) sized[dev] = true;
  return e;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round an f32 value to bf16 and back (the kernels' bf16(x) before a product).
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

constexpr float LOG2E = 1.4426950408889634f;

// 2^x on the special function unit (ex2.approx.ftz: about 2 ulp; 2^-inf is 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// x rounded to tf32 (10 mantissa bits, to nearest, ties away), in f32's bits.
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Byte j of a 32-bit word, as a signed int8 value in f32.
__device__ __forceinline__ float s8_to_f(uint32_t w, int j) {
  return static_cast<float>(static_cast<int8_t>((w >> (8 * j)) & 0xffu));
}
