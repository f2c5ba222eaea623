// Shared by every kernel library: each is built on its own with a plain C
// interface, loaded with ctypes, and reports launch failures by returning
// cudaGetLastError() from its entry point.
#pragma once

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstdint>

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
