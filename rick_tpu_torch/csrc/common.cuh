// Shared device helpers of the rick_tpu_torch kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rick {

__device__ __forceinline__ float lrelu(float v, float slope, float scale) {
  return (v >= 0.f ? v : v * slope) * scale;
}

inline bool aligned(const void* p, size_t bytes) { return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0; }
inline bool aligned16(const void* p) { return aligned(p, 16); }

// The bf16 instantiations read bf16 and compute in f32: four bf16 in one
// 8-byte load (the vector of a float4 store), and the widening of each load
// type to f32 (exact).
struct __align__(8) bf16x4 {
  __nv_bfloat162 lo, hi;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float4 to_f32(float4 v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float4 to_f32(bf16x4 v) {
  const float2 a = __bfloat1622float2(v.lo), b = __bfloat1622float2(v.hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

// A scalar read once per thread (demod, bias, noise weight), through the
// read-only cache.
__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// f32 -> bf16 -> f32: where a bf16 chain rounds.
__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// Blocks for a row-major pass: x covers the columns of a row, y the rows
// (looped inside the kernel past the 65535 limit of gridDim.y).
inline dim3 rows_grid(long long rows, long long cols, int threads) {
  long long bx = (cols + threads - 1) / threads;
  if (bx > 1024) bx = 1024;
  long long by = rows < 65535 ? rows : 65535;
  return dim3((unsigned)bx, (unsigned)by, 1);
}

// Threads per block for rows of `cols` elements: a whole number of warps,
// at most 256, so that short rows (4x4 maps) do not leave most lanes idle.
inline int rows_threads(long long cols) {
  long long t = (cols + 31) / 32 * 32;
  return (int)(t < 256 ? t : 256);
}

}  // namespace rick
