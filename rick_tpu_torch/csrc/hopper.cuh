// Hopper helpers of the tensor-core kernels (K4 convt_blur_act.cu, K6
// modconv_act.cu): shared-memory addresses, mbarriers, TMA and bulk copies,
// wgmma's fences and waits, the 3xTF32 split, and tiled tensor maps.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// A bulk copy of `bytes` (a multiple of 16; both addresses 16-byte aligned)
// from device memory into shared memory, counted on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
               "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
               : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// until at most N of this warpgroup's committed wgmma groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// v = hi + lo for the tensor cores' TF32 (3xTF32): hi = v rounded to TF32
// (to nearest, ties away: cvt.rna's rounding, in integer operations), lo =
// v - hi (exact) plus half a TF32 ulp, so that the tensor core, which reads
// the top 19 bits of an operand, takes lo rounded the same way
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi)) + 0x1000u;
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

}  // namespace
