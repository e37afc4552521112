// Threshold + connected-component labelling of detection-logit maps.
//
// Replaces the TPU kernel _ccl_kernel (ubdvss_tpu/ops/pallas/
// ccl_kernel.py:116).  Output contract is the same: every foreground pixel
// (logit > thr) holds the minimum linear index of its 8-connected (or
// 4-connected) component, background holds H*W.
//
// One thread block per image; the whole int32 label map lives in dynamic
// shared memory (64 KB at 128x128), where geometry::ccl_labels_shared
// (geometry.cuh, shared with the fused K12c kernel) runs union-find in three
// passes (initialise, merge by shared-memory atomicMin, flatten), however
// long the components are.
//
// Bound on this card: the input and output are 8 B per pixel (8.4 MB at
// B=64, 128x128, ~2.5 us at 3.35 TB/s).  One block per map puts 64 blocks
// on the 132 SMs at B=64, and the merge's find walks and atomics run at
// shared-memory latency.
#include "common.cuh"
#include "geometry.cuh"

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
ccl_kernel(const float* __restrict__ logits, int* __restrict__ labels, int H,
           int W, float thr, int connectivity) {
  extern __shared__ int lab_s[];
  const int N = H * W;
  const float* lg = logits + static_cast<long long>(blockIdx.x) * N;
  int* out = labels + static_cast<long long>(blockIdx.x) * N;
  geometry::ccl_labels_shared(lg, lab_s, H, W, thr, connectivity == 8);
  for (int p = threadIdx.x; p < N; p += blockDim.x) out[p] = lab_s[p];
}

}  // namespace

// logits (B, H, W) f32 -> labels (B, H, W) int32; H*W*4 bytes of shared
// memory per block (the caller keeps it within the card's 227 KB).
extern "C" int ccl_labels(const void* logits, void* labels, int B, int H,
                          int W, float thr, int connectivity, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(H) * W * sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      ccl_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  ccl_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<int*>(labels), H, W, thr,
      connectivity);
  return launch_status();
}
