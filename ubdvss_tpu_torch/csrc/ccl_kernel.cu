// Threshold + connected-component labelling of detection-logit maps.
//
// Replaces the TPU kernel _ccl_kernel (ubdvss_tpu/ops/pallas/
// ccl_kernel.py:116).  Output contract is the same: every foreground pixel
// (logit > thr) holds the minimum linear index of its 8-connected (or
// 4-connected) component, background holds H*W.
//
// One thread block per image; the whole int32 label map lives in dynamic
// shared memory (64 KB at 128x128).  Each round every foreground pixel
// takes the minimum label of its neighbourhood and then pointer-jumps
// (l = lab[l] while that falls).  Both steps keep the invariant that a
// label is the index of a pixel of the same component and never rises, so
// updating in place while other threads read is safe; rounds repeat until
// a whole round changes nothing (__syncthreads_or), which is exactly the
// fixpoint the TPU kernel reaches: all labels of a component equal, and
// equal to its minimum index.  The TPU kernel's segmented run-min passes
// were a way to cross long runs in few vectorised rounds; pointer jumping
// does that here.
//
// Bound on this card: the input and output are 8 B per pixel (8.4 MB at
// B=64, 128x128, ~2.5 us at 3.35 TB/s); the rounds run in shared memory,
// whose latency and the serial round count bound the kernel in practice.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
ccl_kernel(const float* __restrict__ logits, int* __restrict__ labels, int H,
           int W, float thr, int connectivity) {
  extern __shared__ int lab_s[];
  volatile int* lab = lab_s;
  const int N = H * W;
  const float* lg = logits + static_cast<long long>(blockIdx.x) * N;
  int* out = labels + static_cast<long long>(blockIdx.x) * N;
  for (int p = threadIdx.x; p < N; p += blockDim.x) lab[p] = lg[p] > thr ? p : N;
  __syncthreads();

  const bool eight = connectivity == 8;
  while (true) {
    int changed = 0;
    for (int p = threadIdx.x; p < N; p += blockDim.x) {
      const int l = lab[p];
      if (l == N) continue;
      const int y = p / W;
      const int x = p - y * W;
      int m = l;
      for (int dy = -1; dy <= 1; ++dy) {
        const int yy = y + dy;
        if (yy < 0 || yy >= H) continue;
        for (int dx = -1; dx <= 1; ++dx) {
          if (dy == 0 && dx == 0) continue;
          if (!eight && dy != 0 && dx != 0) continue;
          const int xx = x + dx;
          if (xx < 0 || xx >= W) continue;
          m = min(m, lab[yy * W + xx]);  // background holds N, the identity
        }
      }
      // pointer jumping: m is the index of a foreground pixel
      for (int r = lab[m]; r < m; r = lab[m]) m = r;
      if (m < l) {
        lab[p] = m;
        changed = 1;
      }
    }
    if (!__syncthreads_or(changed)) break;
  }
  for (int p = threadIdx.x; p < N; p += blockDim.x) out[p] = lab[p];
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
