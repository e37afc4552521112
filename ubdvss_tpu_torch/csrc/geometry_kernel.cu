// The whole component geometry of one image in one block: threshold + CCL
// (union-find), then the root count, the K smallest roots, the slot map
// and each slot's per-row x extremes.
//
// Replaces the TPU kernel _geometry_kernel_compat (ubdvss_tpu/ops/pallas/
// postproc_kernel.py:50), which the JAX package runs instead of its CCL and
// slots kernels under UBDVSS_PALLAS_COMPAT=1.  Its outputs are those of
// K2 after K1: the same two phases, geometry::ccl_labels_shared and
// geometry::roots_slots_extremes (geometry.cuh), run back to back with the
// label map kept in shared memory between them, so the labels never go to
// device memory and the second phase reads them from shared memory.  Like
// K1 it reaches the true components, with no round cap.
//
// Shared memory: H*W*4 + (K + 2*K*H)*4 bytes (80 KB at 128x128, K=16;
// 128 KB at K=64); the caller keeps it within the card's 227 KB.
//
// Bound on this card: 8 B per pixel of device memory (logits read, slots
// written) plus the (K, H) extremes; the union-find and the slot search run
// at shared-memory latency, one block per map, as K1.
#include "common.cuh"
#include "geometry.cuh"

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
geometry_kernel(const float* __restrict__ logits, int* __restrict__ rootvals,
                int* __restrict__ slots, int* __restrict__ minx,
                int* __restrict__ maxx, int* __restrict__ nroots, int H, int W,
                int K, float thr, int connectivity) {
  extern __shared__ int sm[];
  const long long b = blockIdx.x;
  const long long N = static_cast<long long>(H) * W;
  const float* lg = logits + b * N;
  geometry::ccl_labels_shared(lg, sm, H, W, thr, connectivity == 8);
  geometry::roots_slots_extremes(
      lg, sm, sm + N, H, W, K, thr, rootvals + b * K, slots + b * N,
      minx + b * K * H, maxx + b * K * H, nroots + b);
}

}  // namespace

// logits (B, H, W) f32 -> rootvals (B, K), slots (B, H, W), minx/maxx
// (B, K, H), nroots (B,), all int32.
extern "C" int geometry_compat(const void* logits, void* rootvals, void* slots,
                               void* minx, void* maxx, void* nroots, int B,
                               int H, int W, int K, float thr, int connectivity,
                               void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || K <= 0) return cudaErrorInvalidValue;
  const size_t smem = (static_cast<size_t>(H) * W + K + 2 * static_cast<size_t>(K) * H) *
                      sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      geometry_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  geometry_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<int*>(rootvals),
      static_cast<int*>(slots), static_cast<int*>(minx), static_cast<int*>(maxx),
      static_cast<int*>(nroots), H, W, K, thr, connectivity);
  return launch_status();
}
