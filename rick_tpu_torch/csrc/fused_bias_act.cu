// Fused bias + leaky-ReLU + gain:  y = leaky_relu(x + bias[c], slope) * scale.
//
// Replaces the forward of rick_tpu/ops/pallas_kernels.py::fused_bias_act_pallas
// (the Pallas kernel _fba_fwd_kernel, launched by _fba_call).
//
// Bound: device memory.  Each element is read once and written once (8 bytes)
// for two flops, far below the H100's ~20 flops per byte of f32 balance.  The
// design therefore only has to stream at full bandwidth: one thread per float4
// (16-byte loads and stores, neighbouring threads on neighbouring addresses),
// and no integer division per element.  An N-D input (N >= 3) is walked as
// rows of (n, c) with the bias of the row read once by each thread, on a 2-D
// grid: x over the row's spatial elements, y over rows.  A 2-D input (N, C)
// takes its bias on the last dim, one thread per element; those are the
// style-MLP and head activations, a few thousand elements.

#include "common.cuh"

namespace {

__device__ __forceinline__ float fba(float v, float b, float slope, float scale) {
  return rick::lrelu(v + b, slope, scale);
}

__device__ __forceinline__ float4 fba(float4 v, float b, float slope, float scale) {
  return make_float4(fba(v.x, b, slope, scale), fba(v.y, b, slope, scale),
                     fba(v.z, b, slope, scale), fba(v.w, b, slope, scale));
}

// x viewed as (rows, inner) with rows = N*C; T = float4 when inner % 4 == 0.
template <typename T>
__global__ void fba_rows(const T* __restrict__ x, const float* __restrict__ bias,
                         T* __restrict__ y, int rows, int C, int inner_v, float slope,
                         float scale) {
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const float b = __ldg(bias + row % C);
    const long long base = (long long)row * inner_v;
    for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < inner_v; j += gridDim.x * blockDim.x)
      y[base + j] = fba(x[base + j], b, slope, scale);
  }
}

// 2-D (N, C): bias on the last dim.
__global__ void fba_lastdim(const float* __restrict__ x, const float* __restrict__ bias,
                            float* __restrict__ y, long long n, int C, float slope, float scale) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    y[i] = fba(x[i], __ldg(bias + i % C), slope, scale);
}

}  // namespace

extern "C" int rick_fused_bias_act(const void* x, const void* bias, void* y, long long n, int C,
                                   long long inner, float slope, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  if (inner == 1) {
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    if (blocks > 4096) blocks = 4096;
    fba_lastdim<<<(unsigned)blocks, threads, 0, s>>>(static_cast<const float*>(x), b,
                                                     static_cast<float*>(y), n, C, slope, scale);
  } else {
    const long long rows = n / inner;
    if (inner % 4 == 0 && rick::aligned16(x) && rick::aligned16(y)) {
      const int threads = rick::rows_threads(inner / 4);
      fba_rows<float4><<<rick::rows_grid(rows, inner / 4, threads), threads, 0, s>>>(
          static_cast<const float4*>(x), b, static_cast<float4*>(y), (int)rows, C,
          (int)(inner / 4), slope, scale);
    } else {
      const int threads = rick::rows_threads(inner);
      fba_rows<float><<<rick::rows_grid(rows, inner, threads), threads, 0, s>>>(
          static_cast<const float*>(x), b, static_cast<float*>(y), (int)rows, C, (int)inner,
          slope, scale);
    }
  }
  return (int)cudaGetLastError();
}
