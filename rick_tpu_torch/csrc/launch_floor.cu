// The launch floor: an empty kernel, launched with the grid and block of a
// kernel under test on the same stream.  Its device time is the least any
// launch of that shape takes on the card, whatever the kernel does, and
// tools/roofline.py's bound counts it beside the bytes and the operations:
// at a toy shape (K3-bf16 at 4x4) it, and not the bytes, is what bounds the
// kernel.  It replaces no TPU kernel.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int rick_empty_launch(int grid_x, int grid_y, int threads, void* stream) {
  empty_kernel<<<dim3((unsigned)grid_x, (unsigned)grid_y, 1), threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
