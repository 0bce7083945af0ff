// An empty kernel: the time of its launch, replayed from a CUDA graph like
// the other kernels' device times, is the floor that any launch pays on the
// card. tools/bench_kernels.py prints it beside bounds of a microsecond or
// two, which no launch can reach.
#include <cuda_runtime.h>

__global__ void noop_kernel() {}

extern "C" int noop_launch(void* stream) {
  noop_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
