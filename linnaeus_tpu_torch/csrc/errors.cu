// The text of a cudaError_t returned by the launch functions, for the
// Python wrappers' exceptions.
#include <cuda_runtime.h>

extern "C" const char* lt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
