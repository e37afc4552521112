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

// The launch of a persistent kernel of ``threads`` threads a block: its
// dynamic shared memory allowed (past 48 KB, once per kernel and device)
// and as many blocks as stay resident on the card, at most one a tile.
template <auto Kernel>
int persistent_grid(int smem, long long n_tiles, int* grid, int threads = 256) {
  static int allowed[64] = {0}, sms[64] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > allowed[dev]) {
    e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    allowed[dev] = smem;
  }
  if (sms[dev] == 0) {
    e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel, threads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long resident = static_cast<long long>(per_sm) * sms[dev];
  *grid = static_cast<int>(n_tiles < resident ? n_tiles : resident);
  return cudaSuccess;
}
