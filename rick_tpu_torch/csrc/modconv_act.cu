// Modulated 3x3 conv (stride 1, padding 1) with its epilogue, for generation:
//   y[b,o,p] = lrelu(demod[b,o] * sum_{i,tap} (x[b,i,p+tap] * s[b,i]) * w[o,i,tap]
//                    + nw * noise[b|0,p] + bias[o], slope) * gain
//
// K6 replaces no Pallas kernel.  rick_tpu leaves the plain StyledConv's conv
// to XLA (rick_tpu/nn/blocks.py, ModulatedConv2d: x * style, then the conv)
// and runs its epilogue as a Pallas kernel (rick_tpu/ops/pallas_kernels.py,
// _epi_fwd_kernel, which K3 ports).  The port ran the same chain as three
// passes: x * s, cuDNN's f32 conv (on the CUDA cores: 67 TFLOP/s), K3.  K6
// computes the whole chain in one kernel, forward only, f32 in and out.
//
// Bound: the conv's 2 * 9 * Cin operations per output, thousands per byte
// moved.  They run on the tensor cores as an implicit GEMM in 3xTF32 (f32
// accuracy), so the bound is 3x the conv's operations at the dense TF32 rate
// (495 TFLOP/s).  The design keeps the tensor cores fed:
//
//   * GEMM: M = output pixels (a tile of TH x TW pixels of NB images: the
//     small maps take several images to a tile, since s and demod are per
//     image of a row), N = 128 output channels, K = Cin x 9 taps.  A tap's
//     A is the input patch of the tile shifted by the tap, a view of one
//     (TH + 2) x (TW + 2) patch per channel in shared memory;
//   * wgmma m64n128k8 TF32, A from registers, B from shared memory.  N = 128
//     lets each A fragment, loaded, scaled by s and split once, feed three
//     products of 64 x 128 x 8.  Each warp loads its 16 rows' fragment of a
//     view itself (a gather of shifted patch rows, which no descriptor
//     expresses); the patch's channel stride is 8 mod 32 words, so those
//     loads meet no bank conflict.  B is K-major without swizzle: the wrapper
//     lays the weights out as [co block][4 channels][tap][hi, lo][co][4]
//     (ops/modconv_act.py::_kernel_weights), so one stage's B is one
//     contiguous block that a bulk copy lands as the core matrices a
//     descriptor names;
//   * f32 accuracy (3xTF32): x * s is rounded once in f32, as the unfused
//     chain rounds it, then split as hi = tf32(v), lo = tf32(v - hi); the
//     weights are split once per call by the wrapper.  The accumulator takes
//     lo*hi + hi*lo + hi*hi; the dropped lo*lo is < 2^-22 of a product.
//     The tensor cores round each addition into their accumulator toward
//     zero, an error that grows with the number of additions (3 x 9 x Cin/8)
//     and always has the same sign: over Cin = 512 it reached 3.9e-5 of the
//     output's largest value.  So each stage's products start from a zeroed
//     accumulator, which is added to an f32 sum in registers (rounded to
//     nearest) once the stage is done: 27 additions toward zero, on a stage's
//     share of the sum;
//   * the Cin loop streams 8 input channels a stage (one k8 step of each of
//     the 9 taps) through two shared-memory stages: thread 0 issues the
//     patch (a TMA 4-D box of x, zeros outside the image and the batch,
//     which is the conv's zero padding) and the stage's weights (a bulk
//     copy), an mbarrier counts their bytes, and the stage after next is
//     issued once every warp is done with a stage, so copies run under the
//     products;
//   * inside a stage each warpgroup keeps one group of products in flight:
//     it commits a tap's products, then loads and splits the next tap's
//     fragment into the other of two register buffers while they run
//     (wgmma.wait_group 1 before it overwrites the buffer the tap before
//     read);
//   * 2 warpgroups of one m64 tile each: 128 pixels a block, 8 x 16 from
//     16 x 16 maps on, 2 images of 8 x 8 or 8 images of 4 x 4 below, so
//     that the small maps still give blocks to every SM.  (A block of 256
//     pixels reads each stage's weights for twice the products, but its
//     accumulator and sum would take 256 registers a thread);
//   * the epilogue runs on the sums: demod, nw * noise, bias, the
//     activation, and each output written once, 8 consecutive pixels of a
//     channel (32 bytes) per 8 lanes.
//
// Device kernel name: modconv_act_kernel (neither K3's epi_rows nor K4's
// convt_blur_act_kernel, which the benchmark's rooflines match by name).

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int CO_T = 128;             // output channels per block (the wgmma's N)
constexpr int NT = CO_T / 8;          // n8 tiles of an accumulator
constexpr int CK = 8;                 // input channels per shared-memory stage: one k8 step
constexpr int KQ = 9 * 2 * CO_T * 4;  // weights of 4 input channels: [tap][hi, lo][co][4 channels]
constexpr int W_FLOATS = CK / 4 * KQ;  // one stage's weights
constexpr int B_LBO = KQ * 4;          // bytes from a core matrix to the next along K (4 channels on)
constexpr int B_SBO = 8 * 16;          // bytes from a core matrix to the next along N (8 channels on)
constexpr int THREADS = 256;           // two warpgroups

static_assert(B_LBO % 16 == 0 && B_LBO < (1 << 18), "a descriptor's 14-bit offset in 16-byte units");

// A block's tile: TH x TW output pixels of NB images, one m64 tile per
// warpgroup.  The patch holds input rows y0 - 1 + r, r < PR, and columns
// x0 - 4 + c, c < RS (from 4 columns left of the tile, so that the patch's
// first column is a 16-byte copy whatever the tile's); RS and PR are chosen
// for a channel stride of 8 or 24 mod 32 words.
template <int TH_, int TW_, int NB_, int RS_, int PR_>
struct Geo {
  static constexpr int TH = TH_, TW = TW_, NB = NB_, RS = RS_, PR = PR_;
  static constexpr int CS = PR * RS;   // patch channel stride
  static constexpr int IS = CK * CS;   // patch image stride
  static constexpr int XS_FLOATS = NB * IS;
  static constexpr int STAGE_FLOATS = XS_FLOATS + W_FLOATS;
  static constexpr size_t SMEM_BYTES = 2 * STAGE_FLOATS * sizeof(float) + 2 * sizeof(uint64_t);  // + 2 mbarriers
  static_assert(NB * TH * TW == 2 * 64, "a tile is the two warpgroups' rows");
  static_assert(RS % 4 == 0 && RS >= TW + 5 && PR >= TH + 2, "the patch holds the tile and its halo");
  static_assert(CS % 32 == 8 || CS % 32 == 24, "A fragment loads on distinct banks");
  static_assert(TW >= 8 || (TW == 4 && RS % 32 == 12), "8 lanes' rows on distinct banks");
  static_assert(XS_FLOATS % 32 == 0, "128-byte aligned copy destinations");
  static_assert(SMEM_BYTES <= 232448, "a block has at most 227 KB of shared memory");
};

using Geo4 = Geo<4, 4, 8, 12, 6>;     // 4 x 4 maps, 8 images a tile
using Geo8 = Geo<8, 8, 2, 20, 10>;    // 8 x 8 maps, 2 images a tile
using Geo16 = Geo<8, 16, 1, 24, 11>;  // larger maps, 8 x 16 tiles

// wgmma shared-memory descriptor of a K-major B (8 k x 128 n TF32) without
// swizzle: core matrices of 8 rows x 16 bytes, B_LBO apart along K, B_SBO
// along N
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(B_LBO >> 4) << 16) | ((uint64_t)(B_SBO >> 4) << 32);
}

// d (64 x 128, the warpgroup's) = a (64 x 8, this warp's 16 rows) * B (desc)
// + (accumulate ? d : 0)
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t desc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, "
      "%23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// The split fragment of this lane in view (ky, kx): rows g and g + 8 of the
// warp's 16 (a_off), channels t4 and t4 + 4, each x times its image's s
template <class G>
__device__ __forceinline__ void load_fragment(const float* xv, const int (&a_off)[2], const float (&sv)[2][2],
                                              uint32_t (&ah)[4], uint32_t (&al)[4]) {
  split(xv[a_off[0]] * sv[0][0], ah[0], al[0]);
  split(xv[a_off[1]] * sv[1][0], ah[1], al[1]);
  split(xv[a_off[0] + 4 * G::CS] * sv[0][1], ah[2], al[2]);
  split(xv[a_off[1] + 4 * G::CS] * sv[1][1], ah[3], al[3]);
}

template <class G>
__global__ void __launch_bounds__(THREADS, 1)
modconv_act_kernel(const __grid_constant__ CUtensorMap xmap,  // x (N, Cin, H, W)
                   const float* __restrict__ wt,            // (co blocks, Cin/4 padded to even, 9, 2, CO_T, 4)
                   const float* __restrict__ s,             // (N, Cin)
                   const float* __restrict__ demod,         // (N, Cout)
                   const float* __restrict__ noise,         // (N|1, H, W)
                   const float* __restrict__ noise_weight,  // (1,)
                   const float* __restrict__ bias,          // (Cout,)
                   float* __restrict__ y,                   // (N, Cout, H, W)
                   int N, int Cin, int Cout, int H, int W, int noise_batched, float slope, float gain) {
  constexpr int TH = G::TH, TW = G::TW, RS = G::RS;
  extern __shared__ __align__(128) float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  // blocks: output-channel block fastest, so the blocks of one pixel tile
  // run together and read its patch from L2
  const int co_blocks = (Cout + CO_T - 1) / CO_T;
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const int cb = blockIdx.x % co_blocks;
  const int tile = blockIdx.x / co_blocks;
  const int x0 = (tile % tiles_x) * TW;
  const int y0 = (tile / tiles_x % tiles_y) * TH;
  const int n0 = tile / (tiles_x * tiles_y) * G::NB;
  const int co0 = cb * CO_T;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;  // a fragment's row group and column
  const int wg = warp >> 2, wq = warp & 3;  // warpgroup, and the warp's 16 rows of its m64 tile

  const int nchunks = (Cin + CK - 1) / CK;
  const float* wblock = wt + (long long)cb * nchunks * W_FLOATS;

  // Each stage (patch, then weights) arrives by TMA and a bulk copy, counted
  // on the stage's mbarrier; thread 0 issues the copies.
  const uint32_t bar0 = smem_u32(smem + 2 * G::STAGE_FLOATS);
  constexpr uint32_t X_BYTES = G::XS_FLOATS * sizeof(float), W_BYTES = W_FLOATS * sizeof(float);
  auto issue = [&](int stage, int chunk) {  // thread 0
    const uint32_t dst = smem_u32(smem + stage * G::STAGE_FLOATS), bar = bar0 + 8 * stage;
    mbar_expect_tx(bar, X_BYTES + W_BYTES);
    tma_load_4d(dst, &xmap, bar, x0 - 4, y0 - 1, chunk * CK, n0);
    bulk_load(dst + X_BYTES, wblock + (long long)chunk * W_FLOATS, W_BYTES, bar);
  };

  // this lane's rows (g and g + 8 of the warp's 16 in its warpgroup's m64
  // tile): the pixel (image b, row i, column j of the tile) and its patch
  // offset in view (0, 0), channel t4
  int a_off[2], img[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = wg * 64 + wq * 16 + g + 8 * h;
    const int b = m / (TH * TW), r = m % (TH * TW);
    img[h] = n0 + b;
    a_off[h] = b * G::IS + t4 * G::CS + (r / TW) * RS + r % TW + 3;
  }

  float acc[64], sum[64];  // the stage's products; their sum over the stages
#pragma unroll
  for (int c = 0; c < 64; ++c) acc[c] = sum[c] = 0.f;

  if (tid == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar0 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int c = 0; c < 2 && c < nchunks; ++c) issue(c, c);

  for (int chunk = 0; chunk < nchunks; ++chunk) {
    // s of each row's image at channels t4 and t4 + 4 of the chunk (zero
    // past the batch or Cin, where the patch is zero too)
    float sv[2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int ci = chunk * CK + t4 + 4 * k, b = img[h];
        sv[h][k] = (b < N && ci < Cin) ? __ldg(s + (long long)b * Cin + ci) : 0.f;
      }
    mbar_wait(bar0 + 8 * (chunk & 1), (chunk >> 1) & 1);
    const float* xs_s = smem + (chunk & 1) * G::STAGE_FLOATS;
    const uint32_t ws_sa = smem_u32(xs_s + G::XS_FLOATS);

    uint32_t ah[2][4], al[2][4];
    load_fragment<G>(xs_s, a_off, sv, ah[0], al[0]);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int buf = tap & 1;
      fence_operands(acc);
      wgmma_fence();
      const uint32_t bh = ws_sa + tap * 2 * CO_T * 16;  // [quad 0][tap][hi][co][4]
      const uint64_t dh = b_desc(bh), dl = b_desc(bh + CO_T * 16);
      wgmma_tf32(acc, al[buf], dh, tap > 0);  // the stage's first product starts from zero
      wgmma_tf32(acc, ah[buf], dl, 1);
      wgmma_tf32(acc, ah[buf], dh, 1);
      wgmma_commit();
      if (tap < 8) {
        wgmma_wait<1>();  // the tap before, which read the other buffer, is done
        fence_operands(acc);
        const int nt = tap + 1;
        load_fragment<G>(xs_s + (nt / 3) * RS + nt % 3, a_off, sv, ah[buf ^ 1], al[buf ^ 1]);
      }
    }
    wgmma_wait<0>();
    fence_operands(acc);
#pragma unroll
    for (int c = 0; c < 64; ++c) sum[c] += acc[c];
    __syncthreads();  // every warp is done with this stage: the chunk after next may overwrite it
    if (tid == 0 && chunk + 2 < nchunks) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(chunk & 1, chunk + 2);
    }
  }

  // the epilogue on the sums: sum[4 ni + 2 h + c] is row g + 8h of the
  // warp's 16, channel co0 + 8 ni + 2 t4 + c
  const float nw = __ldg(noise_weight);
  const long long hw = (long long)H * W;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = wg * 64 + wq * 16 + g + 8 * h;
    const int r = m % (TH * TW), b = img[h];
    const int oy = y0 + r / TW, ox = x0 + r % TW;
    if (b >= N || oy >= H || ox >= W) continue;
    const long long p = (long long)oy * W + ox;
    const float nz = nw * __ldg(noise + (noise_batched ? b : 0) * hw + p);
    float* out = y + (long long)b * Cout * hw + p;
    const float* dm = demod + (long long)b * Cout;
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int co = co0 + ni * 8 + 2 * t4 + c;
        if (co >= Cout) continue;
        const float v = sum[4 * ni + 2 * h + c] * __ldg(dm + co) + nz + __ldg(bias + co);
        out[co * hw] = rick::lrelu(v, slope, gain);
      }
  }
}

template <class G>
int launch(const void* x, const void* wt, const void* s, const void* demod, const void* noise,
           const void* noise_weight, const void* bias, void* y, int N, int Cin, int Cout, int H, int W,
           int noise_batched, float slope, float gain, void* stream) {
  // above 48 KB of dynamic shared memory only after opting in (per device)
  cudaError_t e = cudaFuncSetAttribute(modconv_act_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)G::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  // x (N, Cin, H, W), rows of a multiple of 16 bytes, in boxes of (NB, CK, PR, RS)
  CUtensorMap xmap;
  const cuuint64_t pitch = 4ull * ((W + 3) / 4 * 4);
  const cuuint64_t xdims[4] = {(cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)Cin, (cuuint64_t)N};
  const cuuint64_t xstrides[3] = {pitch, pitch * H, pitch * H * Cin};
  const cuuint32_t xbox[4] = {G::RS, G::PR, CK, G::NB};
  if (!rick::aligned16(x) || !rick::aligned16(wt) || !tensor_map(&xmap, x, 4, xdims, xstrides, xbox))
    return (int)cudaErrorInvalidValue;
  const long long tiles =
      (long long)((W + G::TW - 1) / G::TW) * ((H + G::TH - 1) / G::TH) * ((N + G::NB - 1) / G::NB);
  const long long blocks = tiles * ((Cout + CO_T - 1) / CO_T);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  modconv_act_kernel<G><<<(unsigned)blocks, THREADS, G::SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      xmap, static_cast<const float*>(wt), static_cast<const float*>(s), static_cast<const float*>(demod),
      static_cast<const float*>(noise), static_cast<const float*>(noise_weight), static_cast<const float*>(bias),
      static_cast<float*>(y), N, Cin, Cout, H, W, noise_batched, slope, gain);
  return (int)cudaGetLastError();
}

}  // namespace

// x is (N, Cin, H, W) with rows (W + 3) / 4 * 4 floats apart, 16-byte
// aligned; wt is (ceil(Cout / 128), 2 * ceil(Cin / 8), 9, 2, 128, 4):
// [cb][q][ky * 3 + kx][h][o][k] is the TF32 hi (h = 0) or lo (h = 1) part of
// w[128 cb + o, 4 q + k, ky, kx], zero past Cout and Cin; s (N, Cin), demod
// (N, Cout), noise (N|1, H, W), noise_weight (1,), bias (Cout,); y
// (N, Cout, H, W).  The tile fits the map: 4 x 4 (8 images), 8 x 8 (2
// images), or 8 x 16 from edges above 8.
extern "C" int rick_modconv_act(const void* x, const void* wt, const void* s, const void* demod, const void* noise,
                                const void* noise_weight, const void* bias, void* y, int N, int Cin, int Cout,
                                int H, int W, int noise_batched, float slope, float gain, void* stream) {
  const int edge = H > W ? H : W;
  if (edge <= 4)
    return launch<Geo4>(x, wt, s, demod, noise, noise_weight, bias, y, N, Cin, Cout, H, W, noise_batched, slope,
                        gain, stream);
  if (edge <= 8)
    return launch<Geo8>(x, wt, s, demod, noise, noise_weight, bias, y, N, Cin, Cout, H, W, noise_batched, slope,
                        gain, stream);
  return launch<Geo16>(x, wt, s, demod, noise, noise_weight, bias, y, N, Cin, Cout, H, W, noise_batched, slope,
                       gain, stream);
}
