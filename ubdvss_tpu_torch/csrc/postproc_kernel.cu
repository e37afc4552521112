// Component slots and stats from CCL labels: root count, the K smallest
// roots, the per-pixel slot map, each slot's per-row x extremes, and each
// slot's pixel count, sigmoid sum and class-softmax sums.
//
// Replaces the TPU kernel _slots_kernel / _roots_slots_extremes
// (ubdvss_tpu/ops/pallas/postproc_kernel.py:130, :182); the five geometry
// outputs are identical to it, including its handling of padding slots:
// when an image has fewer than K components, the padding slots hold the
// root value H*W, which the TPU kernel matches against the background
// label, so background pixels take the LAST padding slot (K-1) and every
// padding slot carries the background's per-row extremes.  Callers mask
// padding slots by rootvals.  The stats are what the TPU module leaves to
// XLA, which rebuilds the one-hot of the slot map inside each contraction's
// fusion (postproc_kernel.py:441-467); here the pixel pass that assigns the
// slots sums them, so no one-hot, product or softmax tensor exists.
//
// One cluster of geometry::kSlotCtas (2) blocks per image, so that B=64
// images fill 128 of the 132 SMs: each block ranks the image's roots itself
// (geometry.cuh: slot_roots), runs its half of the pixel pass (slot_pass)
// on labels read from device memory and the logits read where the head
// wrote them — the (B, H, W, C) view over (B, C, H, W) planes, at its
// strides — and then block 0 takes the other block's extremes and stats
// partials from its shared memory (distributed shared memory) and writes
// the outputs (slot_finish).  A block has one warp per stats partial set,
// 32 where K12c's shared memory allows; K12c runs the same virtual warps in
// its cluster of two blocks, so both sum in one order.
//
// Bound on this card: device memory.  Logits plane and labels read, slots
// written (12 B a pixel), plus the C-1 class logits of the pixels in a
// slot: 12.6 MB + up to 67 MB at B=64, 128x128, C=17 (~24 us at 3.35
// TB/s).  This kernel reads the class logits of every pixel, with its
// label, before its slot is known.
#include <cooperative_groups.h>

#include "common.cuh"
#include "geometry.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 1024;

template <int CM>
__global__ void __cluster_dims__(geometry::kSlotCtas, 1, 1) __launch_bounds__(kThreads)
slots_kernel(const float* __restrict__ logits, long long sb, long long sy,
             long long sx, long long sc, int C, const int* __restrict__ labels,
             int* __restrict__ rootvals, int* __restrict__ slots,
             int* __restrict__ minx, int* __restrict__ maxx,
             int* __restrict__ nroots, float* __restrict__ areas,
             float* __restrict__ det_sums, float* __restrict__ cls_sums, int H,
             int W, int K, float thr) {
  extern __shared__ int sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const long long b = blockIdx.x / geometry::kSlotCtas;
  const long long N = static_cast<long long>(H) * W;
  const int nw = blockDim.x >> 5;
  const geometry::Logits lg{logits + b * sb, sy, sx, sc, C};
  const geometry::Plane det{lg.p, sy, sx};
  const geometry::GlobalLabels lab{labels + b * N};
  const geometry::SlotSmem s(sm, K, H, C, nw);
  const int total = geometry::slot_roots(det, lab, s, s.root, 0, static_cast<int>(N), H, W, K,
                                         C, nw, thr);
  geometry::slot_pass<CM>(det, lg, lab, s, H, W, K, thr, total, rank * nw, 1,
                          geometry::kSlotCtas * nw, slots + b * N);
  cluster.sync();
  if (rank == 0) {
    const geometry::SlotSmem o(cluster.map_shared_rank(sm, 1), K, H, C, nw);
    for (int i = threadIdx.x; i < K * H; i += blockDim.x) {
      s.mn[i] = min(s.mn[i], o.mn[i]);
      s.mx[i] = max(s.mx[i], o.mx[i]);
    }
    __syncthreads();
    geometry::slot_finish(s, o.part, o.cnt, H, K, C, total, geometry::kSlotCtas * nw,
                          rootvals + b * K, minx + b * K * H, maxx + b * K * H, nroots + b,
                          areas + b * K, det_sums + b * K,
                          cls_sums + b * K * max(C - 1, 1));
  }
  cluster.sync();  // block 1's shared memory lives until block 0 has read it
}

}  // namespace

// logits (B, H, W, C) f32 at element strides (sb, sy, sx, sc), labels
// (B, H, W) -> rootvals (B, K), slots (B, H, W), minx/maxx (B, K, H),
// nroots (B,), all int32; areas, det_sums (B, K) and cls_sums
// (B, K, max(C-1, 1)) f32.  ``threads`` is 32 x the stats partial sets
// of a block.
extern "C" int component_slots(const void* logits, long long sb, long long sy,
                               long long sx, long long sc, int C,
                               const void* labels, void* rootvals, void* slots,
                               void* minx, void* maxx, void* nroots, void* areas,
                               void* det_sums, void* cls_sums, int B, int H, int W,
                               int K, int threads, float thr, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || K <= 0 || C <= 0 || threads <= 0 ||
      threads > kThreads || threads % 32 != 0)
    return cudaErrorInvalidValue;
  const size_t smem = (static_cast<size_t>(K) + 2 * static_cast<size_t>(K) * H) * sizeof(int) +
                      static_cast<size_t>(threads / 32) * K * (C + 1) * sizeof(float);
  return geometry::with_channel_bound(C, [&](auto cm) {
    constexpr int CM = decltype(cm)::value;
    cudaError_t e = cudaFuncSetAttribute(
        slots_kernel<CM>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    slots_kernel<CM><<<geometry::kSlotCtas * B, threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(logits), sb, sy, sx, sc, C,
        static_cast<const int*>(labels), static_cast<int*>(rootvals),
        static_cast<int*>(slots), static_cast<int*>(minx), static_cast<int*>(maxx),
        static_cast<int*>(nroots), static_cast<float*>(areas),
        static_cast<float*>(det_sums), static_cast<float*>(cls_sums), H, W, K, thr);
    return launch_status();
  });
}
