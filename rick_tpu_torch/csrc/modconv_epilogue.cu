// Modulated-conv epilogue:
//   y = leaky_relu(out * demod[b,c] + nw * noise[b|0,0,h,w] + bias[c], slope) * scale
//
// Replaces the forward of rick_tpu/ops/pallas_kernels.py::modconv_epilogue_pallas
// (the Pallas kernel _epi_fwd_kernel, launched by _epi_forward).  It follows
// every non-upsample StyledConv of the generator: demodulation, noise
// injection, bias and activation in one pass over the conv output.
//
// Bound: device memory.  Per element it reads `out` and writes `y` (8 bytes);
// the noise map is one (H, W) plane per image, or one for the whole batch,
// and is re-read from L2 across channels.  The design streams: one thread per
// float4 along a row of (b, c); the row's demod and bias and the noise weight
// (read on the device, so the host never waits for it) are scalars loaded
// once by each thread; a 2-D grid (x over H*W, y over B*C rows) keeps integer
// division out of the per-element path.

#include "common.cuh"

namespace {

__device__ __forceinline__ float epi(float o, float d, float nz, float nw, float b, float slope,
                                     float scale) {
  return rick::lrelu(o * d + nw * nz + b, slope, scale);
}

__device__ __forceinline__ float4 epi(float4 o, float d, float4 nz, float nw, float b, float slope,
                                      float scale) {
  return make_float4(epi(o.x, d, nz.x, nw, b, slope, scale), epi(o.y, d, nz.y, nw, b, slope, scale),
                     epi(o.z, d, nz.z, nw, b, slope, scale), epi(o.w, d, nz.w, nw, b, slope, scale));
}

template <typename T>
__global__ void epi_rows(const T* __restrict__ out, const float* __restrict__ demod,
                         const T* __restrict__ noise, const float* __restrict__ noise_weight,
                         const float* __restrict__ bias, T* __restrict__ y, int rows, int C,
                         int hw_v, int noise_batched, float slope, float scale) {
  const float nw = __ldg(noise_weight);
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const float d = __ldg(demod + row);
    const float b = __ldg(bias + row % C);
    const T* nrow = noise + (long long)(noise_batched ? row / C : 0) * hw_v;
    const long long base = (long long)row * hw_v;
    for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < hw_v; j += gridDim.x * blockDim.x)
      y[base + j] = epi(out[base + j], d, nrow[j], nw, b, slope, scale);
  }
}

}  // namespace

extern "C" int rick_modconv_epilogue(const void* out, const void* demod, const void* noise,
                                     const void* noise_weight, const void* bias, void* y, int B,
                                     int C, long long hw, int noise_batched, float slope,
                                     float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = (long long)B * C;
  const float* d = static_cast<const float*>(demod);
  const float* nw = static_cast<const float*>(noise_weight);
  const float* b = static_cast<const float*>(bias);
  if (hw % 4 == 0 && rick::aligned16(out) && rick::aligned16(noise) && rick::aligned16(y)) {
    const int threads = rick::rows_threads(hw / 4);
    epi_rows<float4><<<rick::rows_grid(rows, hw / 4, threads), threads, 0, s>>>(
        static_cast<const float4*>(out), d, static_cast<const float4*>(noise), nw, b,
        static_cast<float4*>(y), (int)rows, C, (int)(hw / 4), noise_batched, slope, scale);
  } else {
    const int threads = rick::rows_threads(hw);
    epi_rows<float><<<rick::rows_grid(rows, hw, threads), threads, 0, s>>>(
        static_cast<const float*>(out), d, static_cast<const float*>(noise), nw, b,
        static_cast<float*>(y), (int)rows, C, (int)hw, noise_batched, slope, scale);
  }
  return (int)cudaGetLastError();
}
