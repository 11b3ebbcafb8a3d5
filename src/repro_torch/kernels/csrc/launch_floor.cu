// An empty kernel behind the same plain C interface as the PFCS kernels:
// what a launch through the ctypes binding costs when the kernel does no
// work.  chip_smoke.py times it by CUDA-graph replay beside every kernel
// (launch_floor_ms); the port never calls it.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int pfcs_launch_floor(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pfcs_launch_floor_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
