// Error text for the codes the C entry points return.
#include <cuda_runtime.h>

extern "C" const char* st_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
