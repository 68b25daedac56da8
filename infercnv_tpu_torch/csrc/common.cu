// Entry points of the kernel library that launch nothing: the text of an
// error code (each entry returns a cudaError_t as int, and the Python
// wrappers raise with this text), and the shared memory a block may opt in
// to, which the engine reads to choose its routes before any launch.
#include <cuda_runtime.h>

extern "C" const char* ic_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The current device's cudaDevAttrMaxSharedMemoryPerBlockOptin, in *bytes:
// what every row kernel checks its shared memory against.
extern "C" int ic_max_smem_optin(int* bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  return static_cast<int>(e);
}
