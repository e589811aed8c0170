// Shared by every kernel source of repro_torch. Each source is built on its
// own into a shared library with a plain C interface (loaded with ctypes by
// kernels/_build.py), so each library carries its own copy of this helper.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// Message for an error code that a launcher returned.
extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
