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
// Bound: the transposed conv's 2*Cin*9 operations per (2x2 output quad,
// output channel), hundreds per byte of input and output.  They run on the
// tensor cores as an implicit GEMM in 3xTF32, so the bound is 3x the conv's
// operations at the dense TF32 rate (495 TFLOP/s); the blur and epilogue
// (a few % of the time) run on the CUDA cores.  The design:
//
//   * GEMM: M = the input-pixel quads of the tile (input pixel (i, j) gives
//     the 2x2 mid quad (2i+a, 2j+b)), N = 32 output channels, K = Cin.  Each
//     of the 9 taps (ku, kv) is one product into the accumulator of phase
//     (ku & 1, kv & 1), on the input patch shifted by (ku == 2, kv == 2):
//     four shifted views of one patch in shared memory, no zero products;
//   * wgmma m64n32k8 TF32, A from registers, B from shared memory.  A view
//     is a gather of patch rows (one per quad, shifted), which no
//     shared-memory descriptor expresses, so each warp loads its 16 rows'
//     A fragment itself: the patch is [channel][row][col] with a channel
//     stride of 8 mod 32 words, so those loads meet no bank conflict.  B is
//     K-major without swizzle: the wrapper lays the weights out as
//     [4 channels][tap][hi, lo][co][4] (ops/fused_upsample.py::
//     _kernel_weights), so a TMA copy lands them as the core matrices a
//     descriptor names, and the products run asynchronously while the
//     other warpgroup loads its next view;
//   * f32 accuracy (3xTF32): each operand is split as hi = tf32(v), lo =
//     tf32(v - hi), rounded to nearest; the weights once per call by the
//     wrapper, the activations as their fragments load.  The accumulator
//     takes lo*hi + hi*lo + hi*hi; the dropped lo*lo is < 2^-22 of a product;
//   * a 32x32 output tile: 18x18 quads for 16x16 worth of output (1.27x halo
//     recompute; 384 GEMM rows with the m64 padding) in 2 warpgroups of 3
//     m64 tiles x 4 phases (192 accumulators a thread).  Outputs of edge 8
//     or 16 (the 4x4 and 8x8 inputs) take a tile of that edge, chosen from
//     H: 1 or 2 warpgroups of 1 m64 tile;
//   * the Cin loop streams 16 input channels a stage through two
//     shared-memory stages, by TMA: thread 0 issues the patch (a 4-D box of
//     xs, zeros out of bounds) and the weights, an mbarrier counts their
//     bytes, and the stage after next is issued as soon as every warp is
//     done with a stage, so copies run under the products;
//   * the mid tile (32 x (T+4)^2) then goes to shared memory in place of the
//     stages, and the block blurs it with the separable 4-tap filter
//     (correlation taps = the flipped kernel, per-axis gain 2): each thread
//     walks one output column of one channel, keeping the last four row
//     sums in registers; then demod, noise, bias, the activation, and the
//     write of the T x T tile.
//
// Mid positions outside [0, 2H] come out as zero by themselves (they only
// touch zero-padded input), so the blur's zero padding needs no special case.
//
// The kernel body is a template on a stage, so that the same code can be
// timed with its later stages cut out (K5, the counterpart of
// scripts/bench_fused_ablate.py::make_kernel, whose Pallas stages dma /
// matmul / blend / full map to load / conv / blur / full).  Every stage
// writes the whole (N, Cout, 2H, 2W) output, so that two stages' times
// differ by the work of the later one:
//   LOAD: every stage of the Cin loop is copied and waited on, no products;
//         writes 0;
//   CONV: writes the transposed conv's mid pixel at each output position,
//         conv_transpose2d(xs, w, stride 2)[..., :2H, :2W];
//   BLUR: the 4-tap blur of the mid tile, without demod, noise, bias or
//         activation;
//   FULL: the kernel (K4).
// One entry point, rick_convt_blur_act_stage, launches the stage it is given;
// K4 is its stage FULL.

#include <cuda.h>

#include "common.cuh"

namespace {

constexpr int CO_T = 32;          // output channels per block
constexpr int CK = 16;            // input channels per shared-memory stage
constexpr int NT = CO_T / 8;      // n8 tiles of an accumulator
constexpr int KQ = 9 * 2 * CO_T * 4;  // weights of 4 input channels: [tap][hi, lo][co][4 channels]
constexpr int B_LBO = KQ * 4;          // bytes from a core matrix to the next along K (4 channels on)
constexpr int B_SBO = 8 * 16;          // bytes from a core matrix to the next along N (8 channels on)
constexpr int RS = 24;            // patch row: input columns x0/2 - 4 .. + 23

// The geometry of a T x T output tile.
template <int T>
struct Tile {
  static constexpr int QT = T / 2 + 2;                // quads per tile edge
  static constexpr int XP = QT + 1;                   // input patch edge
  static constexpr int CS = XP * RS;                  // patch channel stride
  static constexpr int MT = T + 4;                    // mid tile edge
  static constexpr int MCS = MT * MT + 4;             // mid channel stride (mid stores off one bank)
  static constexpr int QUADS = QT * QT;
  static constexpr int MW = T == 32 ? 3 : 1;          // m64 tiles per warpgroup
  static constexpr int WGS = (QUADS + 64 * MW - 1) / (64 * MW);
  static constexpr int THREADS = 128 * WGS;
  static constexpr int XS_FLOATS = CK * CS;
  static constexpr int STAGE_FLOATS = XS_FLOATS + CK / 4 * KQ;
  static constexpr int MID_FLOATS = CO_T * MCS;
  static constexpr int SMEM_FLOATS = 2 * STAGE_FLOATS > MID_FLOATS ? 2 * STAGE_FLOATS : MID_FLOATS;
  static constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float) + 2 * sizeof(uint64_t);  // + 2 mbarriers
  static_assert(RS >= XP + 2, "the patch row holds the quads' columns");
  static_assert(CS % 32 == 8 || CS % 32 == 24, "A fragment loads on distinct banks");
  static_assert(XS_FLOATS % 32 == 0 && STAGE_FLOATS % 32 == 0, "128-byte aligned copy destinations");
  static_assert(SMEM_BYTES <= 232448, "a block has at most 227 KB of shared memory");
};

static_assert(CK % 8 == 0, "whole k8 steps");
static_assert(B_LBO % 16 == 0 && B_LBO < (1 << 18), "a descriptor's 14-bit offset in 16-byte units");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

// until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// TMA: a box of the tensor `map` at the given coordinates (innermost first;
// out-of-bounds elements come as zeros) into shared memory, counted on `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], "
      "[%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major B (8 k x 32 n TF32) without
// swizzle: core matrices of 8 rows x 16 bytes, B_LBO apart along K, B_SBO
// along N
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(B_LBO >> 4) << 16) | ((uint64_t)(B_SBO >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 32, the warpgroup's) += a (64 x 8, this warp's 16 rows) * B (desc)
__device__ __forceinline__ void wgmma_tf32(float (&d)[16], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// v = hi + lo for the tensor cores' TF32 (3xTF32): hi = v rounded to TF32
// (to nearest, ties away: cvt.rna's rounding, in integer operations), lo =
// v - hi (exact) plus half a TF32 ulp, so that the tensor core, which reads
// the top 19 bits of an operand, takes lo rounded the same way
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi)) + 0x1000u;
}

enum Stage { LOAD = 0, CONV = 1, BLUR = 2, FULL = 3 };

template <int STAGE, int T>
__global__ void __launch_bounds__(Tile<T>::THREADS, 1)
convt_blur_act_kernel(const __grid_constant__ CUtensorMap xmap,  // xs (N, Cin, H, W)
                      const __grid_constant__ CUtensorMap wmap,  // wt (Cin/4, 9, 2, Cout, 4)
                      const float* __restrict__ demod,  // (N, Cout)
                      const float* __restrict__ noise,  // (N|1, 2H, 2W)
                      const float* __restrict__ bias,   // (Cout)
                      float* __restrict__ y,            // (N, Cout, 2H, 2W)
                      int Cin, int Cout, int H, int W, int noise_batched, float k0, float k1,
                      float k2, float k3, int use_act, float slope, float gain) {
  using L = Tile<T>;
  constexpr int QT = L::QT, XP = L::XP, CS = L::CS, MT = L::MT, MW = L::MW;
  extern __shared__ __align__(128) float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* mid_s = smem;  // [CO_T][MT][MT] (channel stride MCS), after the Cin loop

  const int OH = 2 * H, OW = 2 * W;
  const int tiles_x = (OW + T - 1) / T;
  const int y0 = (blockIdx.x / tiles_x) * T;
  const int x0 = (blockIdx.x % tiles_x) * T;
  const int co0 = blockIdx.y * CO_T;
  const int n = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;  // a fragment's row group and column
  const int wg = warp >> 2, wq = warp & 3;  // warpgroup, and the warp's 16 rows in each of its m64 tiles

  // quad (qi, qj) <-> input pixel (iq0 + qi, jq0 + qj).  The patch holds
  // input rows iq0 - 1 + r, r < XP, and input columns x0/2 - 4 + c, c < RS
  // (from a multiple of 4, for 16-byte copies): quad (qi, qj) reads x[i, j]
  // at (qi + 1, qj + 3), one row up for the taps ku == 2, one column left for
  // kv == 2
  const int iq0 = y0 / 2 - 1, jp0 = x0 / 2 - 4;

  // Each stage (patch, then weights) arrives by TMA, counted on the stage's
  // mbarrier; thread 0 issues the copies.
  const uint32_t bar0 = smem_u32(smem + L::SMEM_FLOATS);
  constexpr uint32_t X_BYTES = L::XS_FLOATS * sizeof(float), W_BYTES = CK / 4 * KQ * sizeof(float);
  auto issue = [&](int stage, int ci0) {  // thread 0
    const uint32_t dst = smem_u32(smem + stage * L::STAGE_FLOATS), bar = bar0 + 8 * stage;
    mbar_expect_tx(bar, X_BYTES + W_BYTES);
    tma_load_4d(dst, &xmap, bar, jp0, iq0 - 1, ci0, n);
    tma_load_4d(dst + X_BYTES, &wmap, bar, 4 * co0, 0, 0, ci0 / 4);
  };

  // this lane's A elements in the warp's 16 rows of each of its warpgroup's
  // m64 tiles: rows g and g + 8 (quads; rows past the tile's quads read quad
  // (0, 0) and are never stored), columns t4 and t4 + 4 (input channels),
  // in view (0, 0)
  int a_off[MW][2];
#pragma unroll
  for (int mi = 0; mi < MW; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = (wg * MW + mi) * 64 + wq * 16 + g + 8 * h;
      const int q = m < L::QUADS ? m : 0;
      a_off[mi][h] = t4 * CS + (q / QT + 1) * RS + q % QT + 3;
    }

  float acc[4][MW][16];  // [phase 2a + b][m64 tile][4 n8 + fragment]
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int mi = 0; mi < MW; ++mi)
#pragma unroll
      for (int c = 0; c < 16; ++c) acc[p][mi][c] = 0.f;

  const int nchunks = (Cin + CK - 1) / CK;
  if (tid == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar0 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int c = 0; c < 2 && c < nchunks; ++c) issue(c, c * CK);
  for (int chunk = 0; chunk < nchunks; ++chunk) {
    mbar_wait(bar0 + 8 * (chunk & 1), (chunk >> 1) & 1);
    // the load stage of the ablation stops here: its copies are waited on, no product runs
    if constexpr (STAGE != LOAD) {
      const float* xs_s = smem + (chunk & 1) * L::STAGE_FLOATS;
      const uint32_t ws_sa = smem_u32(xs_s + L::XS_FLOATS);
#pragma unroll 1
      for (int k8 = 0; k8 < CK; k8 += 8) {
#pragma unroll
        for (int view = 0; view < 4; ++view) {
          const int dr = view >> 1, dc = view & 1;  // shifted up (ku == 2), left (kv == 2)
          const float* xv = xs_s + k8 * CS - dr * RS - dc;
          uint32_t ah[MW][4], al[MW][4];
#pragma unroll
          for (int mi = 0; mi < MW; ++mi) {
            split(xv[a_off[mi][0]], ah[mi][0], al[mi][0]);
            split(xv[a_off[mi][1]], ah[mi][1], al[mi][1]);
            split(xv[a_off[mi][0] + 4 * CS], ah[mi][2], al[mi][2]);
            split(xv[a_off[mi][1] + 4 * CS], ah[mi][3], al[mi][3]);
          }
#pragma unroll
          for (int p = 0; p < 4; ++p)
#pragma unroll
            for (int mi = 0; mi < MW; ++mi) fence_operands(acc[p][mi]);
          wgmma_fence();
#pragma unroll
          for (int ku = dr ? 2 : 0; ku < (dr ? 3 : 2); ++ku)
#pragma unroll
            for (int kv = dc ? 2 : 0; kv < (dc ? 3 : 2); ++kv) {
              const int tap = ku * 3 + kv, phase = 2 * (ku & 1) + (kv & 1);
              const uint32_t bh = ws_sa + ((k8 / 4 * 9 + tap) * 2) * CO_T * 16;
              const uint64_t dh = b_desc(bh), dl = b_desc(bh + CO_T * 16);
#pragma unroll
              for (int mi = 0; mi < MW; ++mi) {
                wgmma_tf32(acc[phase][mi], al[mi], dh);
                wgmma_tf32(acc[phase][mi], ah[mi], dl);
                wgmma_tf32(acc[phase][mi], ah[mi], dh);
              }
            }
          wgmma_commit();
          wgmma_wait_all();  // the next view overwrites ah and al
#pragma unroll
          for (int p = 0; p < 4; ++p)
#pragma unroll
            for (int mi = 0; mi < MW; ++mi) fence_operands(acc[p][mi]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage: the chunk after next may overwrite it
    if (tid == 0 && chunk + 2 < nchunks) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(chunk & 1, (chunk + 2) * CK);
    }
  }

  // mid tile: local (ml, mc) <-> mid position (y0 - 2 + ml, x0 - 2 + mc);
  // quad (qi, qj) holds local (2qi + a, 2qj + b) in phase 2a + b
  if constexpr (STAGE != LOAD) {
#pragma unroll
    for (int mi = 0; mi < MW; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = (wg * MW + mi) * 64 + wq * 16 + g + 8 * h;
        if (m >= L::QUADS) continue;
        float* mq = mid_s + 2 * (m / QT) * MT + 2 * (m % QT);
#pragma unroll
        for (int ni = 0; ni < NT; ++ni)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float* mp = mq + (ni * 8 + 2 * t4 + c) * L::MCS;
            mp[0] = acc[0][mi][4 * ni + 2 * h + c];
            mp[1] = acc[1][mi][4 * ni + 2 * h + c];
            mp[MT] = acc[2][mi][4 * ni + 2 * h + c];
            mp[MT + 1] = acc[3][mi][4 * ni + 2 * h + c];
          }
      }
  }
  __syncthreads();

  // blur + epilogue: one thread per (channel, output column); output row
  // y0 + ly reads mid rows ly+1 .. ly+4, columns lx+1 .. lx+4 (local)
  const int co_end = min(CO_T, Cout - co0);
  const int ly_end = min(T, OH - y0);
  for (int idx = tid; idx < co_end * T; idx += L::THREADS) {
    const int cl = idx / T, lx = idx % T, ox = x0 + lx;
    if (ox >= OW) continue;
    const int co = co0 + cl;
    float* out = y + (((long long)n * Cout + co) * OH + y0) * OW + ox;
    if constexpr (STAGE == LOAD) {
      for (int ly = 0; ly < ly_end; ++ly) out[(long long)ly * OW] = 0.f;
    } else if constexpr (STAGE == CONV) {
      const float* m = mid_s + cl * L::MCS + 2 * MT + lx + 2;
      for (int ly = 0; ly < ly_end; ++ly) out[(long long)ly * OW] = m[ly * MT];
    } else {
      const float* m = mid_s + cl * L::MCS + lx + 1;
      auto row = [&](int ml) {
        const float* r = m + ml * MT;
        return k0 * r[0] + k1 * r[1] + k2 * r[2] + k3 * r[3];
      };
      float h0 = row(1), h1 = row(2), h2 = row(3);
      float dm = 0.f, bs = 0.f;
      const float* nz = noise + ((long long)(noise_batched ? n : 0) * OH + y0) * OW + ox;
      if constexpr (STAGE == FULL) {
        dm = __ldg(demod + (long long)n * Cout + co);
        bs = __ldg(bias + co);
      }
      for (int ly = 0; ly < ly_end; ++ly) {
        const float h3 = row(ly + 4);
        const float s = k0 * h0 + k1 * h1 + k2 * h2 + k3 * h3;
        h0 = h1;
        h1 = h2;
        h2 = h3;
        if constexpr (STAGE == BLUR) {
          out[(long long)ly * OW] = s;
        } else {
          float v = s * dm + __ldg(nz + (long long)ly * OW) + bs;
          if (use_act) v = rick::lrelu(v, slope, gain);
          out[(long long)ly * OW] = v;
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, without linking it
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tiled f32 tensor map: `rank` dims and boxes, innermost first; strides
// in bytes of dims 1..rank-1; zeros out of bounds
bool tensor_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims, const cuuint64_t* strides,
                const cuuint32_t* box) {
  const EncodeTiled encode = encode_tiled();
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  return encode != nullptr &&
         encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank, const_cast<void*>(base), dims, strides, box, ones,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int STAGE, int T>
int launch_tile(const void* xs, const void* wt, const void* demod, const void* noise, const void* bias,
                void* y, int N, int Cin, int Cout, int H, int W, int noise_batched, float k0, float k1,
                float k2, float k3, int use_act, float slope, float gain, void* stream) {
  using L = Tile<T>;
  // above 48 KB of dynamic shared memory only after opting in (per device)
  cudaError_t e = cudaFuncSetAttribute(convt_blur_act_kernel<STAGE, T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  // xs (N, Cin, H, W), rows of a multiple of 16 bytes, in boxes of (1, CK,
  // XP, RS); wt (ceil(Cin/4), 9, 2, Cout * 4) in boxes of (CK/4, 9, 2, CO_T * 4)
  CUtensorMap xmap, wmap;
  const cuuint64_t pitch = 4ull * ((W + 3) / 4 * 4);
  const cuuint64_t xdims[4] = {(cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)Cin, (cuuint64_t)N};
  const cuuint64_t xstrides[3] = {pitch, pitch * H, pitch * H * Cin};
  const cuuint32_t xbox[4] = {RS, L::XP, CK, 1};
  const cuuint64_t wdims[4] = {4ull * Cout, 2, 9, (cuuint64_t)(Cin + 3) / 4};
  const cuuint64_t wstrides[3] = {16ull * Cout, 32ull * Cout, 288ull * Cout};
  const cuuint32_t wbox[4] = {4 * CO_T, 2, 9, CK / 4};
  if (!rick::aligned16(xs) || !rick::aligned16(wt) || !tensor_map(&xmap, xs, 4, xdims, xstrides, xbox) ||
      !tensor_map(&wmap, wt, 4, wdims, wstrides, wbox))
    return (int)cudaErrorInvalidValue;
  const int tiles = ((2 * H + T - 1) / T) * ((2 * W + T - 1) / T);
  const dim3 grid(tiles, (Cout + CO_T - 1) / CO_T, N);
  convt_blur_act_kernel<STAGE, T><<<grid, L::THREADS, L::SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      xmap, wmap, static_cast<const float*>(demod), static_cast<const float*>(noise),
      static_cast<const float*>(bias), static_cast<float*>(y), Cin, Cout, H, W, noise_batched, k0, k1, k2, k3,
      use_act, slope, gain);
  return (int)cudaGetLastError();
}

// The tile that fits the output: 8 or 16 for the 4x4 and 8x8 inputs of the
// generator's first upsample layers, 32 from 16x16 inputs on.
template <int STAGE>
int launch(const void* xs, const void* wt, const void* demod, const void* noise, const void* bias,
           void* y, int N, int Cin, int Cout, int H, int W, int noise_batched, float k0, float k1,
           float k2, float k3, int use_act, float slope, float gain, void* stream) {
  if (Cout % 4 != 0) return (int)cudaErrorInvalidValue;
  const int edge = 2 * (H > W ? H : W);
  if (edge <= 8)
    return launch_tile<STAGE, 8>(xs, wt, demod, noise, bias, y, N, Cin, Cout, H, W, noise_batched, k0,
                                 k1, k2, k3, use_act, slope, gain, stream);
  if (edge <= 16)
    return launch_tile<STAGE, 16>(xs, wt, demod, noise, bias, y, N, Cin, Cout, H, W, noise_batched, k0,
                                  k1, k2, k3, use_act, slope, gain, stream);
  return launch_tile<STAGE, 32>(xs, wt, demod, noise, bias, y, N, Cin, Cout, H, W, noise_batched, k0,
                                k1, k2, k3, use_act, slope, gain, stream);
}

}  // namespace

// The kernel cut after `stage` (0 load, 1 conv, 2 blur, 3 full = K4).  xs
// is (N, Cin, H, W) with rows (W + 3) / 4 * 4 floats apart, 16-byte
// aligned; wt is (ceil(Cin / 4), 9, 2, Cout, 4): [q][ku * 3 + kv][h][co][k]
// is the TF32 hi (h = 0) or lo (h = 1) part of w[co, 4 q + k, ku, kv].
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
