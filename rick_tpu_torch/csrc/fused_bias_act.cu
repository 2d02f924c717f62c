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
// K1-bf16, rick_fused_bias_act_bf16 (kernel fba_bf16_flat): x bf16, bias
// and y f32.  It replaces the same Pallas call (_fba_fwd_kernel via _fba_call)
// where rick_tpu's --bf16 reaches it: a bf16 layer meeting its f32
// activation bias (D's from-RGB conv), where JAX promotes x + bias to f32,
// so the activation and y are f32.  K2 has no bf16 form: on that path y and
// its cotangent are f32.
//
// Bound: device memory, 6 bytes an element (2 read, 4 written).  At D's
// from-RGB shape (2,128,256,256) that is 100.7 MB, 0.030 ms at 3.35 TB/s.
// So the kernel only has to stream, and the design is about keeping enough
// bytes in flight and every transaction whole: x is walked flat; each thread
// loads a bf16x8 (16 bytes) and issues U = 2 such loads (and their bias
// loads) before any store; a block's loads of one round are contiguous (a
// tile of 2 x 256 vectors, 8 KB of x), and each warp trades its outputs by
// shuffles so that both of its float4 stores write 512 contiguous bytes (a
// thread's own two float4 would leave each store instruction writing half
// of every 32-byte sector).  The grid is at most 8 whole waves of the
// blocks the occupancy allows, walked grid-stride; a thread's bias index is
// its vector's channel, kept as (offset, channel) and advanced with adds
// (rick::FlatPos), one division at the thread's start: a vector never
// straddles a row when inner % 8 == 0.  On the H100, a walk over one wave
// of persistent blocks, or a thread's loads strided by the whole grid, ran
// slower than these contiguous tiles, which keep the addresses in flight at
// once close together.  Inputs with fewer vectors than one block of
// 256 on every SM take one vector per thread in blocks of whole warps spread
// over the SMs, where the launch, not the bytes, sets the time.  Other
// layouts take the same kernel with 8-byte loads (inner % 4 == 0 and x
// 8-byte aligned) or single elements (odd inner, a misaligned x, the 2-D
// (N, C) layout as inner = 1).
//
// rick_fused_bias_act_bf16_rows keeps the row-per-block design
// (fba_rows<bf16x4, float4>) that came before it, as the yardstick
// chip_smoke.py holds the flat kernel to (bitwise equal outputs, time); no
// wrapper calls it.

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

// K1-bf16: see the note at the top.  V bf16 per load; y[i] = fba(x[i],
// bias[channel of i]).  U = 1: one vector per thread, no loop (few
// vectors).  U > 1: U loads in flight per thread, the loop running while
// the thread's warp has work, so that every lane reaches the warp's
// shuffles.
template <int V, int U>
__global__ void __launch_bounds__(rick::kFlatThreads)
    fba_bf16_flat(const __nv_bfloat16* __restrict__ x, const float* __restrict__ bias, float* __restrict__ y,
                  long long n, long long inner, int C, rick::FlatPos in_step, rick::FlatPos jump, float slope,
                  float scale) {
  using Vec = rick::BfVec<V>;
  if constexpr (U == 1) {
    const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * V;
    if (i >= n) return;
    const typename Vec::T raw = Vec::load(x, i);
    const float b = __ldg(bias + rick::flat_split(i, inner, C).c);
    float f[V];
    Vec::widen(raw, f);
#pragma unroll
    for (int k = 0; k < V; ++k) f[k] = fba(f[k], b, slope, scale);
    Vec::store(y, i, n, f);
  } else {
    const long long tile = (long long)U * blockDim.x * V, lane_off = (long long)(threadIdx.x & 31) * V;
    long long i = blockIdx.x * tile + (long long)threadIdx.x * V;
    rick::FlatPos p = rick::flat_split(i, inner, C);
    for (; i - lane_off < n; i += gridDim.x * tile) {
      typename Vec::T raw[U];
      float b[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long e = i + (long long)u * blockDim.x * V;
        raw[u] = e < n ? Vec::load(x, e) : typename Vec::T();
        b[u] = e < n ? __ldg(bias + p.c) : 0.f;
        rick::flat_advance(p, in_step, inner, C);
      }
      rick::flat_advance(p, jump, inner, C);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float f[V];
        Vec::widen(raw[u], f);
#pragma unroll
        for (int k = 0; k < V; ++k) f[k] = fba(f[k], b[u], slope, scale);
        Vec::store_warp(y, i + (long long)u * blockDim.x * V, n, f);
      }
    }
  }
}

template <int V>
void launch_fba_bf16_flat(const void* x, const float* b, void* y, long long n, int C, long long inner, float slope,
                          float scale, cudaStream_t s, int* launch) {
  const rick::FlatLaunch l = rick::flat_launch<&fba_bf16_flat<V, rick::kFlatLoads>>(n, V, inner, C);
  const auto kernel = l.loads == 1 ? &fba_bf16_flat<V, 1> : &fba_bf16_flat<V, rick::kFlatLoads>;
  kernel<<<l.blocks, l.threads, 0, s>>>(static_cast<const __nv_bfloat16*>(x), b, static_cast<float*>(y), n, inner, C,
                                       l.in_step, l.jump, slope, scale);
  if (launch) launch[0] = l.blocks, launch[1] = 1, launch[2] = l.threads;
}

void launch_fba_bf16(const void* x, const float* b, void* y, long long n, int C, long long inner, float slope,
                     float scale, cudaStream_t s, int* launch) {
  if (inner % 8 == 0 && rick::aligned16(x) && rick::aligned16(y))
    launch_fba_bf16_flat<8>(x, b, y, n, C, inner, slope, scale, s, launch);
  else if (inner % 4 == 0 && rick::aligned(x, 8) && rick::aligned16(y))
    launch_fba_bf16_flat<4>(x, b, y, n, C, inner, slope, scale, s, launch);
  else
    launch_fba_bf16_flat<1>(x, b, y, n, C, inner, slope, scale, s, launch);
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

// K1-bf16: x bf16; bias and y f32.  `launch`, when not null, receives the
// grid and block of the launch (grid x, grid y, threads).
extern "C" int rick_fused_bias_act_bf16(const void* x, const void* bias, void* y, long long n,
                                        int C, long long inner, float slope, float scale,
                                        void* stream, int* launch) {
  launch_fba_bf16(x, static_cast<const float*>(bias), y, n, C, inner, slope, scale,
                  static_cast<cudaStream_t>(stream), launch);
  return (int)cudaGetLastError();
}

// The row-per-block design of K1-bf16 that the flat kernel replaced, kept as
// its yardstick (see the note at the top).
extern "C" int rick_fused_bias_act_bf16_rows(const void* x, const void* bias, void* y, long long n,
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
