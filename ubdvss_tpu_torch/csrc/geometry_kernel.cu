// The whole component geometry of one image in one block: threshold + CCL
// (union-find), then the root count, the K smallest roots, the slot map,
// each slot's per-row x extremes and its stats.
//
// Replaces the TPU kernel _geometry_kernel_compat (ubdvss_tpu/ops/pallas/
// postproc_kernel.py:50), which the JAX package runs instead of its CCL and
// slots kernels under UBDVSS_PALLAS_COMPAT=1.  Its outputs are those of
// K2 after K1: the same two phases, geometry::ccl_labels_shared and
// geometry::slot_roots / slot_pass / slot_finish (geometry.cuh), run back
// to back with the label map kept in shared memory between them, so the
// labels never go to device memory and the second phase reads them from
// shared memory.  Like K1 it reaches the true components, with no round
// cap.  Each warp runs the kSlotCtas virtual warps that K2's cluster runs
// in two blocks, into their own stats partial sets, and the sets are summed
// in K2's order, so the stats equal K2's bit for bit.
//
// Shared memory: H*W*4 + (K + 2*K*H)*4 bytes (80 KB at 128x128, K=16;
// 128 KB at K=64), plus (K, C+1) words per virtual warp of stats partials;
// the caller picks the warps so that it stays within the card's 227 KB.
//
// Bound on this card: 8 B per pixel of device memory (logits read, slots
// written) plus the class logits of the pixels in a slot and the (K, H)
// extremes; the union-find and the slot search run at shared-memory
// latency, one block per map, as K1.
#include "common.cuh"
#include "geometry.cuh"

namespace {

constexpr int kThreads = 1024;

template <int CM>
__global__ void __launch_bounds__(kThreads)
geometry_kernel(const float* __restrict__ det_logits, const float* __restrict__ logits,
                long long sb, long long sy, long long sx, long long sc, int C,
                int* __restrict__ rootvals, int* __restrict__ slots,
                int* __restrict__ minx, int* __restrict__ maxx,
                int* __restrict__ nroots, float* __restrict__ areas,
                float* __restrict__ det_sums, float* __restrict__ cls_sums, int H,
                int W, int K, float thr, int connectivity) {
  extern __shared__ int sm[];
  const long long b = blockIdx.x;
  const long long N = static_cast<long long>(H) * W;
  const float* dl = det_logits + b * N;
  geometry::ccl_labels_shared(dl, sm, H, W, thr, connectivity == 8);
  const geometry::Plane det{dl, W, 1};
  const geometry::Logits lg{logits + b * sb, sy, sx, sc, C};
  // K2's virtual warps, kSlotCtas per warp of this block, in K2's order
  const int nw = blockDim.x >> 5;
  const int nv = geometry::kSlotCtas * nw;
  const geometry::SlotSmem s(sm + N, K, H, C, nv);
  const int total = geometry::slot_roots(det, sm, s, H, W, K, C, nv, thr);
  geometry::slot_pass<CM>(det, lg, sm, s, H, W, K, thr, total, 0, geometry::kSlotCtas, nv,
                          slots + b * N);
  geometry::slot_finish(s, s.part + nw * K * C, s.cnt + nw * K, H, K, C, total, nv,
                        rootvals + b * K, minx + b * K * H, maxx + b * K * H, nroots + b,
                        areas + b * K, det_sums + b * K, cls_sums + b * K * max(C - 1, 1));
}

}  // namespace

// det_logits (B, H, W) f32 contiguous (channel 0 of logits), logits
// (B, H, W, C) f32 at element strides (sb, sy, sx, sc) -> the outputs of
// component_slots (postproc_kernel.cu).  ``threads`` is that of one of
// K2's blocks.
extern "C" int geometry_compat(const void* det_logits, const void* logits, long long sb,
                               long long sy, long long sx, long long sc, int C,
                               void* rootvals, void* slots, void* minx, void* maxx,
                               void* nroots, void* areas, void* det_sums, void* cls_sums,
                               int B, int H, int W, int K, int threads, float thr,
                               int connectivity, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || K <= 0 || C <= 0 || threads <= 0 ||
      threads > kThreads || threads % 32 != 0)
    return cudaErrorInvalidValue;
  const size_t smem = (static_cast<size_t>(H) * W + K + 2 * static_cast<size_t>(K) * H) *
                          sizeof(int) +
                      static_cast<size_t>(geometry::kSlotCtas) * (threads / 32) * K * (C + 1) *
                          sizeof(float);
  return geometry::with_channel_bound(C, [&](auto cm) {
    constexpr int CM = decltype(cm)::value;
    cudaError_t e = cudaFuncSetAttribute(
        geometry_kernel<CM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    geometry_kernel<CM><<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(det_logits), static_cast<const float*>(logits), sb, sy,
        sx, sc, C, static_cast<int*>(rootvals), static_cast<int*>(slots),
        static_cast<int*>(minx), static_cast<int*>(maxx), static_cast<int*>(nroots),
        static_cast<float*>(areas), static_cast<float*>(det_sums),
        static_cast<float*>(cls_sums), H, W, K, thr, connectivity);
    return launch_status();
  });
}
