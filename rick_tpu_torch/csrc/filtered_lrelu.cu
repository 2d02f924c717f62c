// StyleGAN3's filtered leaky ReLU in one pass (K7), for generation:
//   y = down_fd( clamp( lrelu( up_fu( pad( x + b ) ), slope ) * gain, +-clamp ) )
// with NVlabs' semantics, as `ops/filtered_lrelu.py::filtered_lrelu_ref`
// computes it: the bias added, the map zero-inserted by `up` (2 or 4),
// padded by (px0, px1, py0, py1) (negative: cropped), filtered by the
// separable 1-D `fu` (6 * up taps, gain up per pass), leaky ReLU'd, scaled
// by `gain` and clamped, then filtered by the separable `fd` (12 taps) and
// decimated by 2.  Every product and sum is an f32 FMA on the CUDA cores.
//
// K7 replaces no Pallas kernel: rick_tpu has no StyleGAN3.  The port ran the
// function as a chain of 1-D `upfirdn2d_general` passes (zero insertion and
// padding as copies, each FIR pass as cuDNN's one-channel grouped conv),
// which moved the 4x-upsampled grid through device memory three to four
// times, at ~15% of the card's bandwidth.  NVlabs fuse the same function for
// their own code (`torch_utils/ops/filtered_lrelu.cu`).
//
// Bound: at the 14 filtered layers of StyleGAN3-T at 256px the operations
// on the CUDA cores (67 TFLOP/s), and at the last one the bytes: per (n, c)
// plane of an H x W input, M_h x M_w intermediate grid and H_o x W_o output,
//   2 * (H M_w + M_h M_w) * 6          the up passes, polyphase: 6 taps a phase
//   + 2 * (M_h W_o + H_o W_o) * 12     the down passes at the kept positions
//   + 4 * M_h M_w                      the activation, gain and clamp
// operations, against the input read once and the output written once.  The
// design keeps the intermediate grid in registers and the FMA pipes busy:
//
//   * one block of 128 threads computes an output tile of one (n, c) plane:
//     at most 48 columns (a plane's width split evenly) by 48, 32 or 16 rows;
//   * three passes through shared memory.  x up: the input tile's rows -> A
//     (the rows upsampled along x).  The fused y pass: down each column of A
//     a thread computes 16 output rows from the 2 * 16 + 10 intermediate
//     samples they read (y up, the leaky ReLU, the gain, the clamp), which
//     never leave its registers -> B.  x down at the kept columns only: B's
//     rows -> the output tile.  The 4x grid is never stored, so a block moves
//     ~1.5 words of shared memory per intermediate sample against ~15 FMAs,
//     and the FMA pipes, not shared memory, set the pace;
//   * every pass starts each segment at phase 0 of the polyphase filter (the
//     fused pass at a phase fixed per launch, a template parameter), so every
//     tap index is a constant: no multiply by an inserted zero; the taps sit
//     in registers;
//   * a warp's 32 lanes take 32 lines.  The fused pass reads and writes one
//     float a lane, neighbouring columns; the row passes read and write
//     float4s, one row a lane, the rows 4 mod 8 floats apart, so that no
//     access meets a bank conflict (B's columns are stored shifted so that
//     each x-down segment starts on a float4);
//   * the input tile is loaded with its halo once, by asynchronous copies
//     (cp.async: all of a thread's in flight at once), coalesced, zeros
//     outside the map, then the bias; the output tile is written once,
//     coalesced.
//     The fused pass recomputes 10 intermediate rows for every 32 it keeps
//     (1.31x its up work); a block holds 38 KB (up 4) or 50 KB (up 2), so
//     five or four blocks share an SM.
//
// Device kernel name: flrelu_kernel (none of the names the benchmark's
// rooflines match: modconv_act_kernel, convt_blur_act_kernel, fba_, epi_).

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int RO = 16;  // output rows a thread computes down a column of the fused y pass
constexpr int RD = 4;   // outputs a thread computes along a row of the x-down pass
constexpr int P = 6;    // taps of one phase of the up filter
constexpr int KD = 12;  // taps of the down filter
constexpr int DOWN = 2;
constexpr int DIN = DOWN * RD + KD - 2;  // inputs of an x-down segment
constexpr int TILE = 48;                 // the largest output tile side

__host__ __device__ constexpr int rup(int a, int b) { return (a + b - 1) / b * b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
// at least n, and 4 mod 8: the pitch of a buffer whose rows the lanes of a
// warp read or write as float4s, one row a lane, without a bank conflict
__host__ __device__ constexpr int pitch4(int n) { return rup(n, 4) % 8 == 4 ? rup(n, 4) : rup(n, 4) + 4; }

// The tile geometry of an up factor U: the x-up pass's segment (RX = 4 U
// outputs from 10 inputs, which start on a float4); the most intermediate
// columns a tile needs (NEED_X: T's phase-0 start, 2 a kept sample, the
// down filter's halo) and the x-up pass computes (LEN_X); the most input
// rows and columns (Q_Y, Q_X); the pitches; and the shared memory: A at 0,
// the input tile and then B after A, the output tile at 0.
template <int U>
struct Geo {
  static constexpr int RX = 4 * U;
  static constexpr int XIN = RX / U + P;
  static constexpr int NEED_X = U - 1 + DOWN * TILE + KD - 2;
  static constexpr int LEN_X = rup(NEED_X, RX);
  static constexpr int Q_X = LEN_X / U + P, Q_Y = (DOWN * TILE + U - 1 + KD - 3) / U + P + 1;
  static constexpr int PIN = pitch4(Q_X), PA = pitch4(LEN_X), PB = pitch4(NEED_X + 3), PC = pitch4(TILE);
  static constexpr int A_FLOATS = Q_Y * PA;
  static constexpr int SMEM_BYTES = 4 * (A_FLOATS + imax(Q_Y * PIN, TILE * PB));
  static_assert(TILE % RO == 0 && TILE % RD == 0 && (DOWN * RO) % U == 0, "segments start at phase 0");
  static_assert(TILE * PC <= A_FLOATS, "the output tile fits under A");
};

// One axis of a launch: every tile's but its origin.
struct Axis {
  int in;     // input samples
  int out;    // output samples
  int pad0;   // padding before the up pass (negative: a crop)
  int tile;   // output tile length: x a multiple of RD, y of RO (even, so that e is the same for every tile)
  int e;      // the tile's first intermediate sample, from the phase-0 start of the tile's intermediate grid
  int need;   // x: intermediate samples the x-down pass reads, e + 2 tile + KD - 2
  int len;    // x: intermediate samples the x-up pass computes, need rounded up to its segment
  int q;      // input samples loaded
  int shift;  // x: B's columns are stored `shift` on, so that each x-down segment starts on a float4
  int tiles;
};

struct Params {
  const float* x;
  const float* b;  // or null
  const float* fu;
  const float* fd;
  float* y;
  int C;
  Axis ax, ay;
  float gain, slope, clamp;
};

// N consecutive floats from src, 16-byte aligned, as float4s (and a float2
// and a float for the rest).
template <int N>
__device__ __forceinline__ void load_row(const float* src, float (&v)[N]) {
#pragma unroll
  for (int k = 0; k + 4 <= N; k += 4) {
    const float4 q = *reinterpret_cast<const float4*>(src + k);
    v[k] = q.x, v[k + 1] = q.y, v[k + 2] = q.z, v[k + 3] = q.w;
  }
  if constexpr (N % 4 >= 2) {
    const float2 q = *reinterpret_cast<const float2*>(src + N / 4 * 4);
    v[N / 4 * 4] = q.x, v[N / 4 * 4 + 1] = q.y;
  }
  if constexpr (N % 2) v[N - 1] = src[N - 1];
}

template <int N>
__device__ __forceinline__ void store_row(float* dst, const float (&v)[N]) {
  static_assert(N % 4 == 0, "whole float4s");
#pragma unroll
  for (int k = 0; k < N; k += 4) *reinterpret_cast<float4*>(dst + k) = make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
}

// The up pass's sample at row (or column) r from its phase-0 start: phase
// r % U of the polyphase filter, whose taps f[U P - 1 - a0 - U m],
// a0 = (U - r % U) % U, weigh inputs r / U + (r % U > 0) + m.
template <int U>
__device__ __forceinline__ float up_tap_sum(const float* in, const float (&f)[U * P], int r) {
  const int ph = r % U, a0 = (U - ph) % U, q0 = r / U + (ph > 0);
  float acc = 0.f;
#pragma unroll
  for (int m = 0; m < P; ++m) acc = fmaf(in[q0 + m], f[U * P - 1 - a0 - U * m], acc);
  return acc;
}

// Four bytes from global to shared memory without a register, or four
// zeros where `in_map` is false; `copy_async_wait` waits for all of the
// thread's copies.
__device__ __forceinline__ void copy_async4(float* dst, const float* src, bool in_map) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(in_map ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void copy_async_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// The items tid, tid + THREADS, ... of a pass over `lines` x segments, the
// line fastest (a warp's lanes on neighbouring lines), without a division
// per item.
struct Walk {
  int line, seg;
  const int lines, dl, ds;
  __device__ explicit Walk(int n)
      : line(threadIdx.x % n), seg(threadIdx.x / n), lines(n), dl(THREADS % n), ds(THREADS / n) {}
  __device__ void next() {
    line += dl, seg += ds;
    if (line >= lines) line -= lines, ++seg;
  }
};

// U: the up factor; C: the phase of the intermediate row under each
// segment's first output (the same in every tile and segment of a launch,
// (-py0) mod U), so that every tap of the fused y pass is a constant.
template <int U, int C>
__global__ void __launch_bounds__(THREADS, 4) flrelu_kernel(const Params p) {
  using G = Geo<U>;
  extern __shared__ __align__(16) float smem[];
  float* s_a = smem;                 // x-upsampled rows (ay.q x ax.len), pitch PA
  float* s_in = smem + G::A_FLOATS;  // input tile (ay.q x ax.q), pitch PIN
  float* s_b = smem + G::A_FLOATS;   // y-down rows (ay.tile x ax.need, `shift` on), pitch PB: the input is dead
  float* s_c = smem;                 // output tile (ay.tile x ax.tile), pitch PC: A is dead
  const Axis ax = p.ax, ay = p.ay;
  const int c = blockIdx.y, n = blockIdx.z;
  const int ox0 = (blockIdx.x % ax.tiles) * ax.tile, oy0 = (blockIdx.x / ax.tiles) * ay.tile;
  // the input sample under the intermediate grid's first (phase-0) sample: exact division
  const int qx0 = (DOWN * ox0 - ax.e - ax.pad0) / U, qy0 = (DOWN * oy0 - ay.e - ay.pad0) / U;
  const int rows = min(ay.tile, ay.out - oy0), cols = min(ax.tile, ax.out - ox0);

  // the input tile with its halo, zeros outside the map, by asynchronous
  // copies (all of a thread's in flight at once, so that their latency is
  // paid once); then the bias, on the elements in the map, each by the
  // thread that copied it
  {
    const float* xp = p.x + ((long long)n * p.C + c) * ay.in * ax.in;
    for (Walk w(ax.q); w.seg < ay.q; w.next()) {
      const int gy = qy0 + w.seg, gx = qx0 + w.line;
      const bool in_map = gy >= 0 && gy < ay.in && gx >= 0 && gx < ax.in;
      copy_async4(s_in + w.seg * G::PIN + w.line, in_map ? xp + gy * ax.in + gx : xp, in_map);
    }
    copy_async_wait();
    if (p.b) {
      const float bias = __ldg(p.b + c);
      for (Walk w(ax.q); w.seg < ay.q; w.next()) {
        const int gy = qy0 + w.seg, gx = qx0 + w.line;
        if (gy >= 0 && gy < ay.in && gx >= 0 && gx < ax.in) s_in[w.seg * G::PIN + w.line] += bias;
      }
    }
  }
  float f[U * P];
#pragma unroll
  for (int k = 0; k < U * P; ++k) f[k] = __ldg(p.fu + k) * (float)U;  // the up pass's gain, exact
  float g[KD];
#pragma unroll
  for (int k = 0; k < KD; ++k) g[k] = __ldg(p.fd + k);
  __syncthreads();

  // x up: each input row -> ax.len intermediate columns, RX a segment
  for (Walk w(ay.q); w.seg < ax.len / G::RX; w.next()) {
    float in[G::XIN], out[G::RX];
    load_row(s_in + w.line * G::PIN + w.seg * (G::RX / U), in);
#pragma unroll
    for (int j = 0; j < G::RX; ++j) out[j] = up_tap_sum<U>(in, f, j);
    store_row(s_a + w.line * G::PA + w.seg * G::RX, out);
  }
  __syncthreads();

  // y up, the activation, the clamp and y down, fused down each column of A
  // the x-down pass reads: a segment's RO outputs from its 2 RO + KD - 2
  // intermediate rows, which live in registers only
  {
    constexpr int LAST = C + DOWN * RO + KD - 3;  // the segment's last intermediate row, from phase 0
    constexpr int NIN = LAST / U + (LAST % U > 0) + P;
    for (Walk w(DOWN * ax.tile + KD - 2); w.seg < ay.tile / RO; w.next()) {
      const int col = ax.e + w.line;
      float in[NIN], acc[RO];
      const float* src = s_a + w.seg * (DOWN * RO / U) * G::PA + col;
#pragma unroll
      for (int k = 0; k < NIN; ++k) in[k] = src[k * G::PA];
#pragma unroll
      for (int o = 0; o < RO; ++o) acc[o] = 0.f;
#pragma unroll
      for (int i = 0; i < DOWN * RO + KD - 2; ++i) {
        const float v = rick::lrelu(up_tap_sum<U>(in, f, C + i), p.slope, p.gain);
        const float a = fminf(fmaxf(v, -p.clamp), p.clamp);
#pragma unroll
        for (int o = 0; o < RO; ++o) {
          const int k = i - DOWN * o;
          if (k >= 0 && k < KD) acc[o] = fmaf(a, g[KD - 1 - k], acc[o]);
        }
      }
      float* dst = s_b + w.seg * RO * G::PB + col + ax.shift;
#pragma unroll
      for (int o = 0; o < RO; ++o) dst[o * G::PB] = acc[o];
    }
  }
  __syncthreads();

  // x down at the kept columns: each of the tile's rows of B -> the output tile
  for (Walk w(rows); w.seg < ax.tile / RD; w.next()) {
    float in[DIN], out[RD];
    load_row(s_b + w.line * G::PB + ax.e + ax.shift + w.seg * DOWN * RD, in);
#pragma unroll
    for (int o = 0; o < RD; ++o) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < KD; ++k) acc = fmaf(in[DOWN * o + k], g[KD - 1 - k], acc);
      out[o] = acc;
    }
    store_row(s_c + w.line * G::PC + w.seg * RD, out);
  }
  __syncthreads();

  // the output tile, written once: a warp's lanes on neighbouring columns
  float* yp = p.y + ((long long)n * p.C + c) * ay.out * ax.out + (long long)oy0 * ax.out + ox0;
  for (Walk w(cols); w.seg < rows; w.next()) yp[w.seg * ax.out + w.line] = s_c[w.seg * G::PC + w.line];
}

// The x axis's tiles: the output split evenly into tiles of at most TILE,
// a multiple of RD; e, the tile's first intermediate sample from its
// phase-0 start; the intermediate and input lengths.
Axis plan_x(int in, int out, int pad0, int up) {
  Axis a;
  a.in = in, a.out = out, a.pad0 = pad0;
  const int n = (out + TILE - 1) / TILE;
  a.tile = rup((out + n - 1) / n, RD);
  a.tiles = (out + a.tile - 1) / a.tile;
  a.e = ((-pad0) % up + up) % up;  // (2 o0 - pad0) mod up, o0 even
  a.need = a.e + DOWN * a.tile + KD - 2;
  a.len = rup(a.need, 4 * up);
  a.q = a.len / up + P;
  a.shift = (4 - a.e % 4) % 4;
  return a;
}

// The y axis's tiles: 48, 32 or 16 rows, whichever computes the fewest rows
// (the larger on a tie), since the fused pass computes whole segments of RO.
Axis plan_y(int in, int out, int pad0, int up) {
  Axis a;
  a.in = in, a.out = out, a.pad0 = pad0;
  a.tile = TILE, a.tiles = (out + TILE - 1) / TILE;
  for (int t = TILE - RO; t > 0; t -= RO)
    if ((out + t - 1) / t * t < a.tiles * a.tile) a.tile = t, a.tiles = (out + t - 1) / t;
  a.e = ((-pad0) % up + up) % up;
  a.q = (DOWN * a.tile + a.e + KD - 3) / up + P + 1;
  a.need = a.len = a.shift = 0;
  return a;
}

template <int U, int C>
int launch(const Params& p, int N, cudaStream_t stream) {
  using G = Geo<U>;
  // above 48 KB of dynamic shared memory only after opting in (per device)
  const cudaError_t e =
      cudaFuncSetAttribute(flrelu_kernel<U, C>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const unsigned tiles = (unsigned)(p.ax.tiles * p.ay.tiles);
  flrelu_kernel<U, C><<<dim3(tiles, (unsigned)p.C, (unsigned)N), THREADS, G::SMEM_BYTES, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// x (N, C, H_in, W_in); b (C,) or null; fu (taps_up,), fd (taps_down,); y
// (N, C, H_out, W_out).  Takes up 2 or 4 with 6 * up taps, down 2 with 12
// taps, and the output lengths the chain gives:
//   W_out = (W_in * up + px0 + px1 - taps_up + 1 - taps_down) / down + 1
// (H_out the same with py0, py1); anything else returns
// cudaErrorInvalidValue before any launch.  clamp: +inf for none.
extern "C" int rick_filtered_lrelu(const void* x, const void* b, const void* fu, const void* fd, void* y, int N,
                                   int C, int H_in, int W_in, int H_out, int W_out, int up, int down, int taps_up,
                                   int taps_down, int px0, int px1, int py0, int py1, float gain, float slope,
                                   float clamp, void* stream) {
  if ((up != 2 && up != 4) || down != DOWN || taps_up != P * up || taps_down != KD) return (int)cudaErrorInvalidValue;
  const int mw = W_in * up + px0 + px1 - taps_up + 1, mh = H_in * up + py0 + py1 - taps_up + 1;
  if (N <= 0 || C <= 0 || H_in <= 0 || W_in <= 0 || mw < KD || mh < KD || W_out != (mw - KD) / DOWN + 1 ||
      H_out != (mh - KD) / DOWN + 1)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = static_cast<const float*>(x), p.b = static_cast<const float*>(b);
  p.fu = static_cast<const float*>(fu), p.fd = static_cast<const float*>(fd), p.y = static_cast<float*>(y);
  p.C = C, p.gain = gain, p.slope = slope, p.clamp = clamp;
  p.ax = plan_x(W_in, W_out, px0, up);
  p.ay = plan_y(H_in, H_out, py0, up);
  if ((long long)p.ax.tiles * p.ay.tiles > 0x7fffffffLL || C > 65535 || N > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (up * 4 + p.ay.e) {
    case 8: return launch<2, 0>(p, N, s);
    case 9: return launch<2, 1>(p, N, s);
    case 16: return launch<4, 0>(p, N, s);
    case 17: return launch<4, 1>(p, N, s);
    case 18: return launch<4, 2>(p, N, s);
    default: return launch<4, 3>(p, N, s);
  }
}
