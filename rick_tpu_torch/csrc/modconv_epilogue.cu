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
//
// rick_modconv_epilogue_bf16 is the instantiation for G's first StyledConv
// under --bf16: out, demod, noise and the noise weight bf16, bias and y f32.
// It computes rick_tpu's plain chain there: out*demod, nw*noise and their
// sum each rounded to bf16 (bf16 arithmetic), then the f32 bias added (JAX
// promotes that sum to f32) and the activation in f32.  Each thread reads
// four bf16 of `out` (8 bytes) and writes a float4: 6 bytes per element.

#include "common.cuh"

namespace {

template <bool kBf16>
__device__ __forceinline__ float epi(float o, float d, float nz, float nw, float b, float slope,
                                     float scale) {
  if constexpr (kBf16) {
    const float v = rick::round_bf16(rick::round_bf16(o * d) + rick::round_bf16(nw * nz));
    return rick::lrelu(v + b, slope, scale);
  } else {
    return rick::lrelu(o * d + nw * nz + b, slope, scale);
  }
}

template <bool kBf16>
__device__ __forceinline__ float4 epi(float4 o, float d, float4 nz, float nw, float b, float slope,
                                      float scale) {
  return make_float4(epi<kBf16>(o.x, d, nz.x, nw, b, slope, scale),
                     epi<kBf16>(o.y, d, nz.y, nw, b, slope, scale),
                     epi<kBf16>(o.z, d, nz.z, nw, b, slope, scale),
                     epi<kBf16>(o.w, d, nz.w, nw, b, slope, scale));
}

// TIn: the load type of out and noise (float, float4, bf16, bf16x4); TS:
// the type of demod and the noise weight; TOut: TIn's f32 width.
template <typename TIn, typename TS, typename TOut>
__global__ void epi_rows(const TIn* __restrict__ out, const TS* __restrict__ demod,
                         const TIn* __restrict__ noise, const TS* __restrict__ noise_weight,
                         const float* __restrict__ bias, TOut* __restrict__ y, int rows, int C,
                         int hw_v, int noise_batched, float slope, float scale) {
  constexpr bool kBf16 = sizeof(TS) == 2;
  const float nw = rick::load_f32(noise_weight);
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const float d = rick::load_f32(demod + row);
    const float b = __ldg(bias + row % C);
    const TIn* nrow = noise + (long long)(noise_batched ? row / C : 0) * hw_v;
    const long long base = (long long)row * hw_v;
    for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < hw_v; j += gridDim.x * blockDim.x)
      y[base + j] = epi<kBf16>(rick::to_f32(out[base + j]), d, rick::to_f32(nrow[j]), nw, b, slope,
                               scale);
  }
}

// TS: the scalar type of out, noise, demod and the noise weight; TV: four
// of them in one load.  y is f32.
template <typename TS, typename TV>
void launch_epi(const void* out, const void* demod, const void* noise, const void* noise_weight,
                const void* bias, void* y, int B, int C, long long hw, int noise_batched, float slope,
                float scale, cudaStream_t s) {
  const long long rows = (long long)B * C;
  const TS* d = static_cast<const TS*>(demod);
  const TS* nw = static_cast<const TS*>(noise_weight);
  const float* b = static_cast<const float*>(bias);
  if (hw % 4 == 0 && rick::aligned(out, sizeof(TV)) && rick::aligned(noise, sizeof(TV)) &&
      rick::aligned16(y)) {
    const int threads = rick::rows_threads(hw / 4);
    epi_rows<TV, TS, float4><<<rick::rows_grid(rows, hw / 4, threads), threads, 0, s>>>(
        static_cast<const TV*>(out), d, static_cast<const TV*>(noise), nw, b,
        static_cast<float4*>(y), (int)rows, C, (int)(hw / 4), noise_batched, slope, scale);
  } else {
    const int threads = rick::rows_threads(hw);
    epi_rows<TS, TS, float><<<rick::rows_grid(rows, hw, threads), threads, 0, s>>>(
        static_cast<const TS*>(out), d, static_cast<const TS*>(noise), nw, b,
        static_cast<float*>(y), (int)rows, C, (int)hw, noise_batched, slope, scale);
  }
}

}  // namespace

extern "C" int rick_modconv_epilogue(const void* out, const void* demod, const void* noise,
                                     const void* noise_weight, const void* bias, void* y, int B,
                                     int C, long long hw, int noise_batched, float slope,
                                     float scale, void* stream) {
  launch_epi<float, float4>(out, demod, noise, noise_weight, bias, y, B, C, hw, noise_batched,
                            slope, scale, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// The bf16 instantiation: out, demod, noise and noise_weight bf16; bias and y f32.
extern "C" int rick_modconv_epilogue_bf16(const void* out, const void* demod, const void* noise,
                                          const void* noise_weight, const void* bias, void* y,
                                          int B, int C, long long hw, int noise_batched,
                                          float slope, float scale, void* stream) {
  launch_epi<__nv_bfloat16, rick::bf16x4>(out, demod, noise, noise_weight, bias, y, B, C, hw,
                                          noise_batched, slope, scale,
                                          static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}
