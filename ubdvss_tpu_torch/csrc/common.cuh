// Shared by every kernel library: the C entry points return a CUDA error
// code, and the Python side names it through error_string.
#pragma once

#include <cuda_runtime.h>

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launch check for the C entry points: the error of the last launch, or of
// anything before it on this thread.
static inline int launch_status() { return static_cast<int>(cudaGetLastError()); }
