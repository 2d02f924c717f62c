// Fused upsample StyledConv:
//   y = leaky_relu(blur4(demod * convT_3x3_stride2(xs, w)) + noise + bias, slope) * gain
//
// Replaces rick_tpu/ops/fused_upsample.py::convt_blur_act (the Pallas kernel
// _kernel).  xs (N, Cin, H, W) is the style-scaled input, w the conv weight
// already scaled by 1/sqrt(fan_in), noise (N|1, 1, 2H, 2W) already scaled by
// the noise weight; the output is (N, Cout, 2H, 2W).
//
// What the kernel keeps out of device memory is its whole point: the
// transposed conv's (2H+1)^2 mid activation.  Unfused, it is written by the
// conv, read and written by the demod, read and written by the blur, then read
// again by the noise/bias/activation pass.  Here it lives in shared memory.
//
// Bound: arithmetic.  The transposed conv costs 9*Cin multiply-adds per
// (2x2 output quad, output channel), hundreds of flops per byte of input and
// output; this version runs them in f32 on the CUDA cores (no tensor cores),
// so the f32 FMA issue rate is the limit, and the design keeps the inner loop
// fed from registers with as few shared-memory loads per FMA as it can:
//
//   * one block per (16x16 output tile, 32 output channels, image);
//   * the transposed conv is computed per input-pixel quad: input pixel (i, j)
//     and its neighbours (i-1, j), (i, j-1), (i-1, j-1) give the four mid
//     pixels (2i+a, 2j+b), a, b in {0, 1}, through the 9 taps (4 + 2 + 2 + 1);
//     every thread runs the same instruction stream, with no parity branches;
//   * the 16x16 output tile needs mid rows/cols [2*i0-2, 2*i0+18), i.e. a
//     10x10 block of quads and an 11x11 patch of input per channel;
//   * 160 threads: 20 quad groups (half a quad row, 5 quads) x 8 channel
//     groups (4 channels); a thread holds 5 x 4 x 4 = 80 accumulators.  Per
//     input channel it loads its 2 x 6 input values and one float4 of weights
//     per tap (21 shared loads for 180 FMAs; lanes that share a quad group or
//     a channel group read one broadcast address);
//   * input channels stream through shared memory 16 at a time, double
//     buffered with cp.async: the next chunk's patch and weights (rows
//     [ci][tap][co]) load while this chunk computes;
//   * the mid tile (32 x 20 x 20) then goes to shared memory, and the block
//     blurs it with the separable 4-tap filter (correlation taps = the
//     flipped kernel, per-axis gain 2), scales by demod, adds noise and bias,
//     applies the activation, and writes the (16 x 16) tile.
//
// Mid positions outside [0, 2H] come out as zero by themselves (they only
// touch zero-padded input), so the blur's zero padding needs no special case.
// Cout must be a multiple of 4 (16-byte weight copies).
//
// The kernel body is a template on a stage, so that the same code can be
// timed with its later stages cut out (K5, the counterpart of
// scripts/bench_fused_ablate.py::make_kernel, whose Pallas stages dma /
// matmul / blend / full map to load / conv / blur / full).  Every stage
// writes the whole (N, Cout, 2H, 2W) output, so that two stages' times
// differ by the work of the later one:
//   LOAD: every cp.async stage of the Cin loop is issued and waited on, no
//         FMAs; writes 0;
//   CONV: writes the transposed conv's mid pixel at each output position,
//         conv_transpose2d(xs, w, stride 2)[..., :2H, :2W];
//   BLUR: the 4-tap blur of the mid tile, without demod, noise, bias or
//         activation;
//   FULL: the kernel (K4).
// One entry point, rick_convt_blur_act_stage, launches the stage it is given;
// K4 is its stage FULL.

#include "common.cuh"

namespace {

constexpr int TILE = 16;          // output tile edge
constexpr int QT = TILE / 2 + 2;  // quads per tile edge (10)
constexpr int QG = 5;             // quads per thread (half a quad row)
constexpr int XP = QT + 1;        // input patch edge (11)
constexpr int XPS = XP + 1;       // patch row stride in shared memory
constexpr int MT = 2 * QT;        // mid tile edge (20)
constexpr int CO_T = 32;          // output channels per block
constexpr int CG = 4;             // output channels per thread
constexpr int CK = 16;            // input channels per shared-memory stage
constexpr int N_QG = QT * QT / QG;         // quad groups (20)
constexpr int N_CG = CO_T / CG;            // channel groups (8)
constexpr int THREADS = N_QG * N_CG;       // 160

constexpr int XS_FLOATS = CK * XP * XPS;  // 2112
constexpr int WS_FLOATS = CK * 9 * CO_T;  // 4608
constexpr int STAGE_FLOATS = XS_FLOATS + WS_FLOATS;
constexpr int MID_FLOATS = CO_T * MT * MT;
constexpr int SMEM_FLOATS = 2 * STAGE_FLOATS > MID_FLOATS ? 2 * STAGE_FLOATS : MID_FLOATS;
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);

static_assert(QT % QG == 0, "quad rows split into whole groups");
static_assert(N_CG == 8 && THREADS % 32 == 0, "a warp = 4 quad groups x 8 channel groups");
static_assert(XS_FLOATS % 4 == 0 && STAGE_FLOATS % 4 == 0, "16-byte aligned stages");

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

enum Stage { LOAD = 0, CONV = 1, BLUR = 2, FULL = 3 };

template <int STAGE>
__global__ void __launch_bounds__(THREADS, 3)
convt_blur_act_kernel(const float* __restrict__ xs,     // (N, Cin, H, W)
                      const float* __restrict__ wt,     // (Cin, 9, Cout), tap = ku*3 + kv
                      const float* __restrict__ demod,  // (N, Cout)
                      const float* __restrict__ noise,  // (N|1, 2H, 2W)
                      const float* __restrict__ bias,   // (Cout)
                      float* __restrict__ y,            // (N, Cout, 2H, 2W)
                      int Cin, int Cout, int H, int W, int noise_batched, float k0, float k1,
                      float k2, float k3, int use_act, float slope, float gain) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* mid_s = smem;  // [CO_T][MT][MT], after the conv loop

  const int OH = 2 * H, OW = 2 * W;
  const int tiles_x = (OW + TILE - 1) / TILE;
  const int y0 = (blockIdx.x / tiles_x) * TILE;
  const int x0 = (blockIdx.x % tiles_x) * TILE;
  const int co0 = blockIdx.y * CO_T;
  const int n = blockIdx.z;
  const int tid = threadIdx.x;
  const int cg = tid % N_CG;  // channels co0 + 4*cg .. +3
  const int qg = tid / N_CG;  // quads (qg / 2, 5*(qg % 2) .. +4)

  // quad (qi, qj) <-> input pixel (iq0 + qi, jq0 + qj); patch row r <-> input
  // row iq0 - 1 + r, so quad row qi reads patch rows qi (x[i-1]) and qi+1 (x[i])
  const int iq0 = y0 / 2 - 1, jq0 = x0 / 2 - 1;
  const float* xn = xs + (long long)n * Cin * H * W;

  auto load_stage = [&](int stage, int ci0) {
    float* xs_s = smem + stage * STAGE_FLOATS;
    float* ws_s = xs_s + XS_FLOATS;
    for (int idx = tid; idx < CK * XP * XP; idx += THREADS) {
      const int ck = idx / (XP * XP), r = (idx / XP) % XP, c = idx % XP;
      const int ci = ci0 + ck, gi = iq0 - 1 + r, gj = jq0 - 1 + c;
      const bool ok = ci < Cin && gi >= 0 && gi < H && gj >= 0 && gj < W;
      cp_async4(xs_s + (ck * XP + r) * XPS + c, ok ? xn + ((long long)ci * H + gi) * W + gj : xs, ok);
    }
    for (int idx = tid; idx < WS_FLOATS / 4; idx += THREADS) {
      const int co = (idx % (CO_T / 4)) * 4, t = (idx / (CO_T / 4)) % 9, ck = idx / (CO_T / 4 * 9);
      const int ci = ci0 + ck, gco = co0 + co;
      const bool ok = ci < Cin && gco < Cout;
      cp_async16(ws_s + idx * 4, ok ? wt + ((long long)ci * 9 + t) * Cout + gco : wt, ok);
    }
    cp_async_commit();
  };

  float acc[QG][CG][4];  // [quad][channel][phase 2a + b]
#pragma unroll
  for (int k = 0; k < QG; ++k)
#pragma unroll
    for (int c = 0; c < CG; ++c)
#pragma unroll
      for (int p = 0; p < 4; ++p) acc[k][c][p] = 0.f;

  const int xoff = (qg / 2) * XPS + (qg % 2) * QG;  // patch (row i-1, col j-1) of the first quad
  const int nchunks = (Cin + CK - 1) / CK;
  load_stage(0, 0);
  for (int chunk = 0; chunk < nchunks; ++chunk) {
    if (chunk + 1 < nchunks) {
      load_stage((chunk + 1) & 1, (chunk + 1) * CK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* xs_s = smem + (chunk & 1) * STAGE_FLOATS;
    const float4* ws4 = reinterpret_cast<const float4*>(xs_s + XS_FLOATS) + cg;

    // the load stage of the ablation stops here: its copies are waited on, no FMA runs
#pragma unroll 2
    for (int ck = 0; ck < (STAGE == LOAD ? 0 : CK); ++ck) {
      // xv[R][c]: R = 0 -> input row i-1, 1 -> i; c = 0..5 -> cols j-1 .. j+4
      float xv[2][QG + 1];
      const float* xp = xs_s + ck * XP * XPS + xoff;
#pragma unroll
      for (int c = 0; c <= QG; ++c) {
        xv[0][c] = xp[c];
        xv[1][c] = xp[XPS + c];
      }
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const int ku = t / 3, kv = t % 3;
        const int phase = 2 * (ku & 1) + (kv & 1);  // mid (2i + ku%2, 2j + kv%2)
        const int R = ku == 2 ? 0 : 1;                // tap 2 reads the row above
        const int dc = kv == 2 ? 0 : 1;               // ... and the column left
        const float4 w4 = ws4[(ck * 9 + t) * (CO_T / 4)];
        const float wv[CG] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int k = 0; k < QG; ++k)
#pragma unroll
          for (int c = 0; c < CG; ++c) acc[k][c][phase] += wv[c] * xv[R][k + dc];
      }
    }
    __syncthreads();  // the next chunk's loads overwrite this stage
  }

  // mid tile: local (ml, mc) <-> mid position (y0 - 2 + ml, x0 - 2 + mc)
  if (STAGE != LOAD) {
    const int base = (qg / 2) * 2 * MT + (qg % 2) * QG * 2;
#pragma unroll
    for (int k = 0; k < QG; ++k)
#pragma unroll
      for (int c = 0; c < CG; ++c) {
        float* m = mid_s + (cg * CG + c) * MT * MT + base + 2 * k;
        m[0] = acc[k][c][0];
        m[1] = acc[k][c][1];
        m[MT] = acc[k][c][2];
        m[MT + 1] = acc[k][c][3];
      }
  }
  __syncthreads();

  // blur + epilogue: output (y0 + ly, x0 + lx) reads mid rows/cols +1..+4
  const int co_end = min(CO_T, Cout - co0);
  for (int idx = tid; idx < co_end * TILE * TILE; idx += THREADS) {
    const int cl = idx / (TILE * TILE), ly = (idx / TILE) % TILE, lx = idx % TILE;
    const int oy = y0 + ly, ox = x0 + lx;
    if (oy >= OH || ox >= OW) continue;
    const int co = co0 + cl;
    float* out = y + (((long long)n * Cout + co) * OH + oy) * OW + ox;
    if constexpr (STAGE == LOAD) {
      *out = 0.f;
    } else if constexpr (STAGE == CONV) {
      *out = mid_s[cl * MT * MT + (ly + 2) * MT + (lx + 2)];
    } else {
      const float* m = mid_s + cl * MT * MT + (ly + 1) * MT + (lx + 1);
      float s = 0.f;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float* r = m + t * MT;
        const float kt = t == 0 ? k0 : t == 1 ? k1 : t == 2 ? k2 : k3;
        s += kt * (k0 * r[0] + k1 * r[1] + k2 * r[2] + k3 * r[3]);
      }
      if constexpr (STAGE == BLUR) {
        *out = s;
      } else {
        const float nz = __ldg(noise + ((long long)(noise_batched ? n : 0) * OH + oy) * OW + ox);
        float v = s * __ldg(demod + (long long)n * Cout + co) + nz + __ldg(bias + co);
        if (use_act) v = rick::lrelu(v, slope, gain);
        *out = v;
      }
    }
  }
}

template <int STAGE>
int launch(const void* xs, const void* wt, const void* demod, const void* noise, const void* bias,
           void* y, int N, int Cin, int Cout, int H, int W, int noise_batched, float k0, float k1,
           float k2, float k3, int use_act, float slope, float gain, void* stream) {
  if (Cout % 4 != 0) return (int)cudaErrorInvalidValue;
  // above 48 KB of dynamic shared memory only after opting in (per device)
  cudaError_t e = cudaFuncSetAttribute(convt_blur_act_kernel<STAGE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const int tiles = ((2 * H + TILE - 1) / TILE) * ((2 * W + TILE - 1) / TILE);
  const dim3 grid(tiles, (Cout + CO_T - 1) / CO_T, N);
  convt_blur_act_kernel<STAGE><<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xs), static_cast<const float*>(wt),
      static_cast<const float*>(demod), static_cast<const float*>(noise),
      static_cast<const float*>(bias), static_cast<float*>(y), Cin, Cout, H, W, noise_batched,
      k0, k1, k2, k3, use_act, slope, gain);
  return (int)cudaGetLastError();
}

}  // namespace

// The kernel cut after `stage` (0 load, 1 conv, 2 blur, 3 full = K4).
extern "C" int rick_convt_blur_act_stage(const void* xs, const void* wt, const void* demod,
                                         const void* noise, const void* bias, void* y, int N,
                                         int Cin, int Cout, int H, int W, int noise_batched,
                                         float k0, float k1, float k2, float k3, int use_act,
                                         float slope, float gain, int stage, void* stream) {
  switch (stage) {
    case LOAD:
      return launch<LOAD>(xs, wt, demod, noise, bias, y, N, Cin, Cout, H, W, noise_batched, k0, k1,
                          k2, k3, use_act, slope, gain, stream);
    case CONV:
      return launch<CONV>(xs, wt, demod, noise, bias, y, N, Cin, Cout, H, W, noise_batched, k0, k1,
                          k2, k3, use_act, slope, gain, stream);
    case BLUR:
      return launch<BLUR>(xs, wt, demod, noise, bias, y, N, Cin, Cout, H, W, noise_batched, k0, k1,
                          k2, k3, use_act, slope, gain, stream);
    case FULL:
      return launch<FULL>(xs, wt, demod, noise, bias, y, N, Cin, Cout, H, W, noise_batched, k0, k1,
                          k2, k3, use_act, slope, gain, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
