// Shared by every kernel library of csrc/: each .cu file includes this
// header once and is built into its own shared library, loaded by
// kernels/build.py with ctypes.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Text for the error code an entry point returned.
extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
