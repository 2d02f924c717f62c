// Fused bias + leaky-ReLU + gain and its backward.
//
//   K1  rick_fused_bias_act:      y  = leaky_relu(x + bias[c], slope) * scale
//   K2  rick_fused_bias_act_bwd:  gx = where(y >= 0, v, slope * v) * scale,
//                                 v  = g (+ bias[c] when a bias is given)
//
// K1 replaces the forward of rick_tpu/ops/pallas_kernels.py::fused_bias_act_pallas
// (the Pallas kernel _fba_fwd_kernel, launched by _fba_call); K2 its backward
// (_fba_bwd_kernel, launched by _fba_call from _fba_bwd_rule).  K2 reads the
// activation's sign from the saved OUTPUT y (y >= 0 iff x + bias >= 0, since
// scale > 0), so the forward keeps no other residual.  With no bias it is the
// first derivative; with a bias it is the derivative of the backward itself
// (the double backward of R1 and path length): the first derivative is linear
// in g and its bias sum, so differentiating it again applies the same mask
// to ggx + ggb[c].
//
// Bound: device memory.  K1 reads and writes each element once (8 bytes), K2
// reads g and y and writes gx (12 bytes), for two or three flops, far below
// the H100's ~20 flops per byte of f32 balance.  The
// design therefore only has to stream at full bandwidth: one thread per float4
// (16-byte loads and stores, neighbouring threads on neighbouring addresses),
// and no integer division per element.  An N-D input (N >= 3) is walked as
// rows of (n, c) with the bias of the row read once by each thread, on a 2-D
// grid: x over the row's spatial elements, y over rows.  A 2-D input (N, C)
// takes its bias on the last dim, one thread per element; those are the
// style-MLP and head activations, a few thousand elements.
//
// K1 has a second instantiation, rick_fused_bias_act_bf16: x bf16, bias and
// y f32.  It is what rick_tpu computes where a bf16 layer meets its f32
// activation bias (the first conv of D under --bf16): JAX promotes
// x + bias to f32, so the activation and y are f32.  Each thread reads four
// bf16 (8 bytes) and writes a float4: 6 bytes per element.  K2 has no bf16
// form: on that path y and its cotangent are f32.

#include "common.cuh"

namespace {

__device__ __forceinline__ float fba(float v, float b, float slope, float scale) {
  return rick::lrelu(v + b, slope, scale);
}

__device__ __forceinline__ float4 fba(float4 v, float b, float slope, float scale) {
  return make_float4(fba(v.x, b, slope, scale), fba(v.y, b, slope, scale),
                     fba(v.z, b, slope, scale), fba(v.w, b, slope, scale));
}

// x viewed as (rows, inner) with rows = N*C; TIn = float4 (or bf16x4) when
// inner % 4 == 0, TOut its f32 width.
template <typename TIn, typename TOut>
__global__ void fba_rows(const TIn* __restrict__ x, const float* __restrict__ bias,
                         TOut* __restrict__ y, int rows, int C, int inner_v, float slope,
                         float scale) {
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const float b = __ldg(bias + row % C);
    const long long base = (long long)row * inner_v;
    for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < inner_v; j += gridDim.x * blockDim.x)
      y[base + j] = fba(rick::to_f32(x[base + j]), b, slope, scale);
  }
}

// 2-D (N, C): bias on the last dim.
template <typename TIn>
__global__ void fba_lastdim(const TIn* __restrict__ x, const float* __restrict__ bias,
                            float* __restrict__ y, long long n, int C, float slope, float scale) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    y[i] = fba(rick::to_f32(x[i]), __ldg(bias + i % C), slope, scale);
}

// K1 with x read as TS (scalar) or TV (4 elements); y f32.
template <typename TS, typename TV>
void launch_fba(const void* x, const float* b, void* y, long long n, int C, long long inner,
                float slope, float scale, cudaStream_t s) {
  if (inner == 1) {
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    if (blocks > 4096) blocks = 4096;
    fba_lastdim<TS><<<(unsigned)blocks, threads, 0, s>>>(static_cast<const TS*>(x), b,
                                                         static_cast<float*>(y), n, C, slope, scale);
    return;
  }
  const long long rows = n / inner;
  if (inner % 4 == 0 && rick::aligned(x, sizeof(TV)) && rick::aligned16(y)) {
    const int threads = rick::rows_threads(inner / 4);
    fba_rows<TV, float4><<<rick::rows_grid(rows, inner / 4, threads), threads, 0, s>>>(
        static_cast<const TV*>(x), b, static_cast<float4*>(y), (int)rows, C, (int)(inner / 4),
        slope, scale);
  } else {
    const int threads = rick::rows_threads(inner);
    fba_rows<TS, float><<<rick::rows_grid(rows, inner, threads), threads, 0, s>>>(
        static_cast<const TS*>(x), b, static_cast<float*>(y), (int)rows, C, (int)inner, slope,
        scale);
  }
}

// K2: the same row and last-dim layouts as K1; three streams (g, y, out)
// instead of two, so 12 bytes per element.
template <bool kBias>
__device__ __forceinline__ float fba_bwd(float g, float y, float b, float slope, float scale) {
  const float v = kBias ? g + b : g;
  return (y >= 0.f ? v : v * slope) * scale;
}

template <bool kBias>
__device__ __forceinline__ float4 fba_bwd(float4 g, float4 y, float b, float slope, float scale) {
  return make_float4(fba_bwd<kBias>(g.x, y.x, b, slope, scale), fba_bwd<kBias>(g.y, y.y, b, slope, scale),
                     fba_bwd<kBias>(g.z, y.z, b, slope, scale), fba_bwd<kBias>(g.w, y.w, b, slope, scale));
}

template <typename T, bool kBias>
__global__ void fba_bwd_rows(const T* __restrict__ g, const T* __restrict__ y,
                             const float* __restrict__ bias, T* __restrict__ out, int rows, int C,
                             int inner_v, float slope, float scale) {
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const float b = kBias ? __ldg(bias + row % C) : 0.f;
    const long long base = (long long)row * inner_v;
    for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < inner_v; j += gridDim.x * blockDim.x)
      out[base + j] = fba_bwd<kBias>(g[base + j], y[base + j], b, slope, scale);
  }
}

template <bool kBias>
__global__ void fba_bwd_lastdim(const float* __restrict__ g, const float* __restrict__ y,
                                const float* __restrict__ bias, float* __restrict__ out, long long n,
                                int C, float slope, float scale) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = fba_bwd<kBias>(g[i], y[i], kBias ? __ldg(bias + i % C) : 0.f, slope, scale);
}

template <bool kBias>
void launch_fba_bwd(const void* g, const void* y, const float* bias, void* out, long long n, int C,
                    long long inner, float slope, float scale, cudaStream_t s) {
  if (inner == 1) {
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    if (blocks > 4096) blocks = 4096;
    fba_bwd_lastdim<kBias><<<(unsigned)blocks, threads, 0, s>>>(
        static_cast<const float*>(g), static_cast<const float*>(y), bias, static_cast<float*>(out), n,
        C, slope, scale);
    return;
  }
  const long long rows = n / inner;
  if (inner % 4 == 0 && rick::aligned16(g) && rick::aligned16(y) && rick::aligned16(out)) {
    const int threads = rick::rows_threads(inner / 4);
    fba_bwd_rows<float4, kBias><<<rick::rows_grid(rows, inner / 4, threads), threads, 0, s>>>(
        static_cast<const float4*>(g), static_cast<const float4*>(y), bias,
        static_cast<float4*>(out), (int)rows, C, (int)(inner / 4), slope, scale);
  } else {
    const int threads = rick::rows_threads(inner);
    fba_bwd_rows<float, kBias><<<rick::rows_grid(rows, inner, threads), threads, 0, s>>>(
        static_cast<const float*>(g), static_cast<const float*>(y), bias, static_cast<float*>(out),
        (int)rows, C, (int)inner, slope, scale);
  }
}

}  // namespace

extern "C" int rick_fused_bias_act(const void* x, const void* bias, void* y, long long n, int C,
                                   long long inner, float slope, float scale, void* stream) {
  launch_fba<float, float4>(x, static_cast<const float*>(bias), y, n, C, inner, slope, scale,
                            static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// The bf16 instantiation: x bf16; bias and y f32.
extern "C" int rick_fused_bias_act_bf16(const void* x, const void* bias, void* y, long long n,
                                        int C, long long inner, float slope, float scale,
                                        void* stream) {
  launch_fba<__nv_bfloat16, rick::bf16x4>(x, static_cast<const float*>(bias), y, n, C, inner,
                                          slope, scale, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// bias may be null (the first derivative); otherwise (C,) on dim 1, or on the
// last dim when inner == 1.
extern "C" int rick_fused_bias_act_bwd(const void* g, const void* y, const void* bias, void* out,
                                       long long n, int C, long long inner, float slope,
                                       float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  if (b)
    launch_fba_bwd<true>(g, y, b, out, n, C, inner, slope, scale, s);
  else
    launch_fba_bwd<false>(g, y, b, out, n, C, inner, slope, scale, s);
  return (int)cudaGetLastError();
}
