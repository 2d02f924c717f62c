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
// K3-bf16, rick_modconv_epilogue_bf16 (kernel epi_bf16_flat), replaces the
// same Pallas call (_epi_fwd_kernel via _epi_forward) where rick_tpu's --bf16
// reaches it, at G's first StyledConv: out, demod, noise and the noise
// weight bf16, bias and y f32.  It computes rick_tpu's plain chain there:
// out*demod, nw*noise and their sum each rounded to bf16 (bf16 arithmetic;
// the products are __fmul_rn, so no FMA contracts them before the
// rounding), then the f32 bias added (JAX promotes that sum to f32) and the
// activation in f32.
//
// Bound: at its only main-path shape, (B,512,4,4), the launch.  Its 16,384
// elements at batch 2 move 0.1 MB, 3e-5 ms at 3.35 TB/s, far below the
// device time of an empty kernel (tools/roofline.py counts that floor); a
// row-per-block design there runs 1,024 one-warp blocks with 4 of 32 lanes
// live (a row of 16 bf16 is four 8-byte vectors).  So this kernel walks out
// flat: a thread takes a bf16x8 of out and of its noise row, its row's
// demod and bias, and threads cover several (b, c) rows, every lane live.
// With fewer vectors than a block of 256 on every SM (2,048 at batch 2) each
// thread takes one vector, with no loop, in blocks of whole warps spread
// over the SMs (64 blocks of 32 at batch 2, which on the H100 ran faster
// than 8 blocks of 256); the place of its vector, (offset, channel, batch),
// comes from one 32-bit division (rick::flat_split), and the noise is read
// at (b | 0, offset).  What is left above the floor is one load's latency
// and the store.  At streaming shapes
// (4,128,256,256), bound by bytes (6 an element), it streams as K1-bf16
// does: U = 2 vectors in flight per thread, contiguous tiles, stores traded
// by shuffles, at most 8 whole waves walked grid-stride, the place advanced
// with adds.  Other inputs take the same kernel with 8-byte loads (hw % 4
// == 0, 8-byte aligned) or single elements.
//
// rick_modconv_epilogue_bf16_rows keeps the row-per-block design
// (epi_rows<bf16x4, bf16, float4>) that came before it, as the yardstick
// chip_smoke.py holds the flat kernel to (bitwise equal outputs, time); no
// wrapper calls it.

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

// K3-bf16's arithmetic on one vector of V elements of row (b, c).
template <int V>
__device__ __forceinline__ void epi_bf16(float (&o)[V], const float (&nz)[V], float d, float nw, float b, float slope,
                                         float scale) {
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const float v = rick::round_bf16(rick::round_bf16(__fmul_rn(o[k], d)) + rick::round_bf16(__fmul_rn(nw, nz[k])));
    o[k] = rick::lrelu(v + b, slope, scale);
  }
}

// K3-bf16: see the note at the top.  V bf16 per load.  U = 1: one vector
// per thread, no loop (few vectors: G's conv1).  U > 1: U vectors in flight
// per thread, the loop running while the thread's warp has work, so that
// every lane reaches the warp's shuffles.
template <int V, int U>
__global__ void __launch_bounds__(rick::kFlatThreads)
    epi_bf16_flat(const __nv_bfloat16* __restrict__ out, const __nv_bfloat16* __restrict__ demod,
                  const __nv_bfloat16* __restrict__ noise, const __nv_bfloat16* __restrict__ noise_weight,
                  const float* __restrict__ bias, float* __restrict__ y, long long n, long long hw, int C,
                  int noise_batched, rick::FlatPos in_step, rick::FlatPos jump, float slope, float scale) {
  using Vec = rick::BfVec<V>;
  if constexpr (U == 1) {
    const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * V;
    if (i >= n) return;
    const float nw = __bfloat162float(*noise_weight);
    const typename Vec::T o_raw = Vec::load(out, i);
    const rick::FlatPos p = rick::flat_split(i, hw, C);
    const typename Vec::T nz_raw = Vec::load(noise, (noise_batched ? p.b * hw : 0) + p.off);
    const float d = __bfloat162float(demod[p.b * C + p.c]), b = __ldg(bias + p.c);
    float o[V], nz[V];
    Vec::widen(o_raw, o);
    Vec::widen(nz_raw, nz);
    epi_bf16<V>(o, nz, d, nw, b, slope, scale);
    Vec::store(y, i, n, o);
  } else {
    const float nw = __bfloat162float(*noise_weight);
    const long long tile = (long long)U * blockDim.x * V, lane_off = (long long)(threadIdx.x & 31) * V;
    long long i = blockIdx.x * tile + (long long)threadIdx.x * V;
    rick::FlatPos p = rick::flat_split(i, hw, C);
    for (; i - lane_off < n; i += gridDim.x * tile) {
      typename Vec::T o_raw[U], nz_raw[U];
      float d[U], b[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long e = i + (long long)u * blockDim.x * V;
        const bool live = e < n;
        o_raw[u] = live ? Vec::load(out, e) : typename Vec::T();
        nz_raw[u] = live ? Vec::load(noise, (noise_batched ? p.b * hw : 0) + p.off) : typename Vec::T();
        d[u] = live ? __bfloat162float(demod[p.b * C + p.c]) : 0.f;
        b[u] = live ? __ldg(bias + p.c) : 0.f;
        rick::flat_advance(p, in_step, hw, C);
      }
      rick::flat_advance(p, jump, hw, C);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float o[V], nz[V];
        Vec::widen(o_raw[u], o);
        Vec::widen(nz_raw[u], nz);
        epi_bf16<V>(o, nz, d[u], nw, b[u], slope, scale);
        Vec::store_warp(y, i + (long long)u * blockDim.x * V, n, o);
      }
    }
  }
}

template <int V>
void launch_epi_bf16_flat(const void* out, const void* demod, const void* noise, const void* noise_weight,
                          const void* bias, void* y, int B, int C, long long hw, int noise_batched, float slope,
                          float scale, cudaStream_t s, int* launch) {
  using bf16 = __nv_bfloat16;
  const long long n = (long long)B * C * hw;
  const rick::FlatLaunch l = rick::flat_launch<&epi_bf16_flat<V, rick::kFlatLoads>>(n, V, hw, C);
  const auto kernel = l.loads == 1 ? &epi_bf16_flat<V, 1> : &epi_bf16_flat<V, rick::kFlatLoads>;
  kernel<<<l.blocks, l.threads, 0, s>>>(
      static_cast<const bf16*>(out), static_cast<const bf16*>(demod), static_cast<const bf16*>(noise),
      static_cast<const bf16*>(noise_weight), static_cast<const float*>(bias), static_cast<float*>(y), n, hw, C,
      noise_batched, l.in_step, l.jump, slope, scale);
  if (launch) launch[0] = l.blocks, launch[1] = 1, launch[2] = l.threads;
}

void launch_epi_bf16(const void* out, const void* demod, const void* noise, const void* noise_weight,
                     const void* bias, void* y, int B, int C, long long hw, int noise_batched, float slope,
                     float scale, cudaStream_t s, int* launch) {
  if (hw % 8 == 0 && rick::aligned16(out) && rick::aligned16(noise) && rick::aligned16(y))
    launch_epi_bf16_flat<8>(out, demod, noise, noise_weight, bias, y, B, C, hw, noise_batched, slope, scale, s,
                            launch);
  else if (hw % 4 == 0 && rick::aligned(out, 8) && rick::aligned(noise, 8) && rick::aligned16(y))
    launch_epi_bf16_flat<4>(out, demod, noise, noise_weight, bias, y, B, C, hw, noise_batched, slope, scale, s,
                            launch);
  else
    launch_epi_bf16_flat<1>(out, demod, noise, noise_weight, bias, y, B, C, hw, noise_batched, slope, scale, s,
                            launch);
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

// K3-bf16: out, demod, noise and noise_weight bf16; bias and y f32.
// `launch`, when not null, receives the grid and block of the launch (grid
// x, grid y, threads).
extern "C" int rick_modconv_epilogue_bf16(const void* out, const void* demod, const void* noise,
                                          const void* noise_weight, const void* bias, void* y,
                                          int B, int C, long long hw, int noise_batched,
                                          float slope, float scale, void* stream, int* launch) {
  launch_epi_bf16(out, demod, noise, noise_weight, bias, y, B, C, hw, noise_batched, slope, scale,
                  static_cast<cudaStream_t>(stream), launch);
  return (int)cudaGetLastError();
}

// The row-per-block design of K3-bf16 that the flat kernel replaced, kept as
// its yardstick (see the note at the top).
extern "C" int rick_modconv_epilogue_bf16_rows(const void* out, const void* demod, const void* noise,
                                               const void* noise_weight, const void* bias, void* y,
                                               int B, int C, long long hw, int noise_batched,
                                               float slope, float scale, void* stream) {
  launch_epi<__nv_bfloat16, rick::bf16x4>(out, demod, noise, noise_weight, bias, y, B, C, hw,
                                          noise_batched, slope, scale,
                                          static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}
