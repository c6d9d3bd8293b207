// An empty kernel: the least time one launch costs on the card, the floor
// under the smallest kernels of the port (fused_page_write, cow_page_copy,
// embed_gather move a few KB a call). Replaces no TPU kernel and runs on
// no serving path; chip_smoke.py times it as it times those kernels (one
// launch a call, CUDA-graph replays).
#include <cuda_runtime.h>

namespace {
__global__ void empty_kernel() {}
}  // namespace

// one block of 32 threads on the given stream
extern "C" int launch_floor(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
