// Shared device helpers of the rick_tpu_torch kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rick {

__device__ __forceinline__ float lrelu(float v, float slope, float scale) {
  return (v >= 0.f ? v : v * slope) * scale;
}

inline bool aligned(const void* p, size_t bytes) { return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0; }
inline bool aligned16(const void* p) { return aligned(p, 16); }

// The bf16 instantiations read bf16 and compute in f32: four bf16 in one
// 8-byte load (the vector of a float4 store), and the widening of each load
// type to f32 (exact).
struct __align__(8) bf16x4 {
  __nv_bfloat162 lo, hi;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float4 to_f32(float4 v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float4 to_f32(bf16x4 v) {
  const float2 a = __bfloat1622float2(v.lo), b = __bfloat1622float2(v.hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

// Sixteen bytes of bf16: the load of the flat bf16 kernels (two float4
// stores of f32 each).
struct __align__(16) bf16x8 {
  __nv_bfloat162 p[4];
};

// V bf16 read in one load from element i of p (i a multiple of V, p aligned
// to V * 2 bytes) and widened to f32; V f32 stored at element e of y (y
// aligned to 16 bytes for V >= 4) unless e >= n: `store` by the thread
// itself, `store_warp` by every lane of a warp together, the warp's vectors
// being its lanes' in order.  For V = 8 a lane's eight f32 are two float4
// 32 bytes apart from its neighbour's, so `store_warp` trades them by
// shuffles first: each of the warp's two float4 stores then writes 512
// contiguous bytes.
template <int V>
struct BfVec;

template <>
struct BfVec<8> {
  using T = bf16x8;
  static __device__ __forceinline__ T load(const __nv_bfloat16* p, long long i) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p + i));
    return *reinterpret_cast<const bf16x8*>(&u);
  }
  static __device__ __forceinline__ void widen(T v, float (&f)[8]) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 a = __bfloat1622float2(v.p[k]);
      f[2 * k] = a.x;
      f[2 * k + 1] = a.y;
    }
  }
  static __device__ __forceinline__ void store(float* y, long long e, long long n, const float (&f)[8]) {
    if (e >= n) return;
    float4* q = reinterpret_cast<float4*>(y + e);
    q[0] = make_float4(f[0], f[1], f[2], f[3]);
    q[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
  static __device__ __forceinline__ void store_warp(float* y, long long e, long long n, const float (&f)[8]) {
    const int lane = threadIdx.x & 31;
    const long long warp_base = e - 8 * lane;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      // float4 (lane + 32k) of the warp's 256 f32 is half (lane & 1) of
      // lane (lane / 2 + 16k)'s eight
      const int src = (lane >> 1) + 16 * k;
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float lo = __shfl_sync(0xffffffffu, f[j], src), hi = __shfl_sync(0xffffffffu, f[4 + j], src);
        o[j] = (lane & 1) ? hi : lo;
      }
      const long long at = warp_base + 4 * (lane + 32 * k);
      if (at < n) *reinterpret_cast<float4*>(y + at) = make_float4(o[0], o[1], o[2], o[3]);
    }
  }
};

template <>
struct BfVec<4> {
  using T = bf16x4;
  static __device__ __forceinline__ T load(const __nv_bfloat16* p, long long i) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p + i));
    return *reinterpret_cast<const bf16x4*>(&u);
  }
  static __device__ __forceinline__ void widen(T v, float (&f)[4]) {
    const float2 a = __bfloat1622float2(v.lo), b = __bfloat1622float2(v.hi);
    f[0] = a.x, f[1] = a.y, f[2] = b.x, f[3] = b.y;
  }
  static __device__ __forceinline__ void store(float* y, long long e, long long n, const float (&f)[4]) {
    if (e < n) *reinterpret_cast<float4*>(y + e) = make_float4(f[0], f[1], f[2], f[3]);
  }
  static __device__ __forceinline__ void store_warp(float* y, long long e, long long n, const float (&f)[4]) {
    store(y, e, n, f);
  }
};

template <>
struct BfVec<1> {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ T load(const __nv_bfloat16* p, long long i) { return p[i]; }
  static __device__ __forceinline__ void widen(T v, float (&f)[1]) { f[0] = __bfloat162float(v); }
  static __device__ __forceinline__ void store(float* y, long long e, long long n, const float (&f)[1]) {
    if (e < n) y[e] = f[0];
  }
  static __device__ __forceinline__ void store_warp(float* y, long long e, long long n, const float (&f)[1]) {
    store(y, e, n, f);
  }
};

// A place in a flat walk over rows of `inner` elements, the rows ordered
// (b, c) with C channels: the offset in the row, the channel and the batch
// index.  A step of a fixed number of elements, split the same way on the
// host, advances it with adds and two compares, so that no division runs per
// element; `flat_split` divides once, for a thread's first place, in 32 bits
// where the index fits (a 64-bit division is a long software sequence, which
// a launch-bound kernel pays in full).
struct FlatPos {
  long long off;
  int c;
  long long b;
};

__host__ __device__ inline FlatPos flat_split(long long i, long long inner, int C) {
  if (((i | inner) >> 31) == 0) {
    const unsigned i32 = (unsigned)i, inner32 = (unsigned)inner, row = i32 / inner32;
    return FlatPos{(long long)(i32 - row * inner32), (int)(row % (unsigned)C), (long long)(row / (unsigned)C)};
  }
  const long long row = i / inner;
  return FlatPos{i - row * inner, (int)(row % C), row / C};
}

__device__ __forceinline__ void flat_advance(FlatPos& p, const FlatPos& step, long long inner, int C) {
  p.off += step.off;
  const int carry = p.off >= inner;
  if (carry) p.off -= inner;
  p.c += step.c + carry;
  if (p.c >= C) {
    p.c -= C;
    p.b += 1;
  }
  p.b += step.b;
}

// The flat bf16 kernels (K1-bf16, K3-bf16).  Streaming: blocks of
// kFlatThreads, each thread loading kFlatLoads vectors before its stores
// (the warp's stores traded by shuffles), a grid of at most kFlatWaves whole
// waves, walked grid-stride.  Few vectors (fewer than a block of
// kFlatThreads on every SM: G's conv1 at 4x4): one vector per thread, stored
// by the thread itself, in blocks of whole warps spread over every SM, since
// there the launch and one load's latency, not the bytes, set the time.
constexpr int kFlatThreads = 256;
constexpr int kFlatLoads = 2;
constexpr int kFlatWaves = 8;

// A flat launch over n elements, V per vector: a block covers a tile of
// `loads` * threads vectors, its threads' loads of one vector contiguous; a
// thread starts at element (block * tile + thread) * V and steps by
// `in_step` between its loads and by `jump` to its next tile.
struct FlatLaunch {
  int blocks, threads, loads;
  FlatPos in_step, jump;
};

// `kernel` is the streaming instantiation, whose occupancy (read once)
// sizes the waves.
template <auto kernel>
inline FlatLaunch flat_launch(long long n, int V, long long inner, int C) {
  static const int per_sm = [] {
    int k = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&k, kernel, kFlatThreads, 0);
    return k > 0 ? k : 1;
  }();
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  sms = sms > 0 ? sms : 1;
  const long long vectors = n / V;
  long long threads = kFlatThreads, loads = kFlatLoads, blocks;
  if (vectors < (long long)sms * kFlatThreads) {
    threads = (vectors + sms - 1) / sms;
    threads = threads < 32 ? 32 : (threads + 31) / 32 * 32;
    loads = 1;
    blocks = (vectors + threads - 1) / threads;
  } else {
    blocks = (n + loads * threads * V - 1) / (loads * threads * V);
    const long long waves = (long long)kFlatWaves * per_sm * sms;
    blocks = blocks < waves ? blocks : waves;
  }
  blocks = blocks > 0 ? blocks : 1;
  const long long tile = loads * threads * V;
  return FlatLaunch{(int)blocks, (int)threads, (int)loads, flat_split(threads * V, inner, C),
                    flat_split((blocks - 1) * tile, inner, C)};
}

// A scalar read once per thread (demod, bias, noise weight), through the
// read-only cache.
__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// f32 -> bf16 -> f32: where a bf16 chain rounds.
__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// Blocks for a row-major pass: x covers the columns of a row, y the rows
// (looped inside the kernel past the 65535 limit of gridDim.y).
inline dim3 rows_grid(long long rows, long long cols, int threads) {
  long long bx = (cols + threads - 1) / threads;
  if (bx > 1024) bx = 1024;
  long long by = rows < 65535 ? rows : 65535;
  return dim3((unsigned)bx, (unsigned)by, 1);
}

// Threads per block for rows of `cols` elements: a whole number of warps,
// at most 256, so that short rows (4x4 maps) do not leave most lanes idle.
inline int rows_threads(long long cols) {
  long long t = (cols + 31) / 32 * 32;
  return (int)(t < 256 ? t : 256);
}

}  // namespace rick
