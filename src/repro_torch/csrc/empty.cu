// An empty kernel behind the same ctypes binding as the port's kernels:
// chip_smoke.py times one launch of it as the floor under a kernel's time
// at a small shape (the host's enqueue through ctypes and the card's
// launch latency, with no work). It replaces no TPU kernel.
#include <cuda_runtime.h>

namespace {
__global__ void empty_kernel() {}
}  // namespace

extern "C" int ceaz_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
