// Shared device helpers of the rick_tpu_torch kernels.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rick {

__device__ __forceinline__ float lrelu(float v, float slope, float scale) {
  return (v >= 0.f ? v : v * slope) * scale;
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

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
