// Component slots from CCL labels: root count, the K smallest roots, the
// per-pixel slot map and each slot's per-row x extremes.
//
// Replaces the TPU kernel _slots_kernel / _roots_slots_extremes
// (ubdvss_tpu/ops/pallas/postproc_kernel.py:130, :182); the outputs are
// identical to it, including its handling of padding slots: when an image
// has fewer than K components, the padding slots hold the root value H*W,
// which the TPU kernel matches against the background label, so background
// pixels take the LAST padding slot (K-1) and every padding slot carries the
// background's per-row extremes.  Callers mask padding slots by rootvals.
//
// One thread block per image, running geometry::roots_slots_extremes
// (geometry.cuh, shared with the fused K12c kernel) on labels read from
// device memory.
//
// Bound on this card: 12 B per pixel of device memory (logits and labels
// read, slots written; 12.6 MB at B=64, 128x128, ~3.8 us at 3.35 TB/s).
#include "common.cuh"
#include "geometry.cuh"

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
slots_kernel(const float* __restrict__ logits, const int* __restrict__ labels,
             int* __restrict__ rootvals, int* __restrict__ slots,
             int* __restrict__ minx, int* __restrict__ maxx,
             int* __restrict__ nroots, int H, int W, int K, float thr) {
  extern __shared__ int sm[];
  const long long b = blockIdx.x;
  const long long N = static_cast<long long>(H) * W;
  geometry::roots_slots_extremes(
      logits + b * N, labels + b * N, sm, H, W, K, thr, rootvals + b * K,
      slots + b * N, minx + b * K * H, maxx + b * K * H, nroots + b);
}

}  // namespace

// logits, labels (B, H, W) -> rootvals (B, K), slots (B, H, W),
// minx/maxx (B, K, H), nroots (B,), all int32.
extern "C" int component_slots(const void* logits, const void* labels,
                               void* rootvals, void* slots, void* minx,
                               void* maxx, void* nroots, int B, int H, int W,
                               int K, float thr, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || K <= 0) return cudaErrorInvalidValue;
  const size_t smem = (static_cast<size_t>(K) + 2 * static_cast<size_t>(K) * H) * sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      slots_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  slots_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const int*>(labels),
      static_cast<int*>(rootvals), static_cast<int*>(slots),
      static_cast<int*>(minx), static_cast<int*>(maxx),
      static_cast<int*>(nroots), H, W, K, thr);
  return launch_status();
}
