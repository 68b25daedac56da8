// Error strings for the C entry points of the kernel library: each entry
// returns a cudaError_t as int, and the Python wrappers raise with this text.
#include <cuda_runtime.h>

extern "C" const char* ic_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
