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
//
// component_slots_tiled serves the maps where that cluster cannot: where
// the (K, H) extremes, or K12c's half label map beside them, exceed one
// block's shared memory (K=64 at a 256² map and beyond; at H=512 the
// extremes alone are 256 KB).  The same outputs, in four launches:
//   1. roots_count: a block a (raster chunk, image) counts the chunk's
//      roots and sets the extremes to their empty values;
//   2. roots_rank: a block a chunk that holds one of the K smallest roots
//      ranks them by a block-wide prefix sum after the counts of the
//      chunks before it, and writes them to rootvals (H*W pads) and the
//      root count to nroots;
//   3. slots_tile: a block a (tile of kTileRows rows x 32 columns a warp,
//      image) runs the pixel pass of the cluster kernel: each warp walks
//      its 32-column strip down the tile, lanes over the columns, writes
//      the slot of each pixel, and sums the stats in registers and warp
//      trees (geometry.cuh StatsAcc) into its own partial set in shared
//      memory; the extremes go to device memory by integer atomicMin/Max,
//      one a slot and row for each warp (lanes ascend in x, so a slot's
//      lowest lane holds its min x and its highest lane its max x); the
//      block then sums its warps' sets in order into the tile's partials;
//   4. slots_finish: each (slot, channel) sum over the image's tiles in
//      order, and the padding slots' copies of the background's extremes.
// The phases' bodies are tiled.cuh's, which the large K12c
// (geometry_kernel.cu) runs in one launch, so the two agree bit for bit.
// No float atomic anywhere, so two launches agree bit for bit; the order
// of the sums differs from the cluster kernel's, so the two agree within
// f32 rounding, not bit for bit.  Bound: the cluster kernel's bytes.
//
// Both read f32 or bf16 logits (``_bf16`` entry points, the bf16 route's
// trunk output: half the logit bytes); on bf16 each class probability is
// rounded to bf16 before the f32 sums, as in the JAX package
// (geometry.cuh StatsAcc), and the partials, their order and the warp
// count are those of f32, so K2 and K12c stay equal bit for bit.
#include <cooperative_groups.h>

#include "common.cuh"
#include "geometry.cuh"
#include "tiled.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 1024;

template <int CM, class T>
__global__ void __cluster_dims__(geometry::kSlotCtas, 1, 1) __launch_bounds__(kThreads)
slots_kernel(const T* __restrict__ logits, long long sb, long long sy,
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
  const geometry::Logits<T> lg{logits + b * sb, sy, sx, sc, C};
  const geometry::Plane<T> det{lg.p, sy, sx};
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

// ---- component_slots_tiled: one kernel a phase of tiled.cuh ----

constexpr int kRankThreads = 256;
constexpr int kPassThreads = 256;  // at most, 8 warps a pass block

// 1. block (chunk, image)
template <class T>
__global__ void __launch_bounds__(kRankThreads)
roots_count_kernel(const T* __restrict__ logits, long long sb, long long sy, long long sx,
                   const int* __restrict__ labels, int* __restrict__ counts,
                   int* __restrict__ minx, int* __restrict__ maxx, int H, int W, int K,
                   int chunk, float thr) {
  const int c = blockIdx.x;
  const long long b = blockIdx.y;
  const int N = H * W;
  const geometry::Plane<T> det{logits + b * sb, sy, sx};
  const geometry::GlobalLabels lab{labels + b * N};
  const int cnt = tiled::roots_count(det, lab, c, H, W, chunk, thr);
  if (threadIdx.x == 0) counts[b * gridDim.x + c] = cnt;
  int* mn = minx + b * K * H;
  int* mx = maxx + b * K * H;
  for (int i = c * blockDim.x + threadIdx.x; i < K * H; i += gridDim.x * blockDim.x) {
    mn[i] = geometry::kBig;
    mx[i] = -1;
  }
}

// 2. block (chunk, image)
template <class T>
__global__ void __launch_bounds__(kRankThreads)
roots_rank_kernel(const T* __restrict__ logits, long long sb, long long sy, long long sx,
                  const int* __restrict__ labels, const int* __restrict__ counts,
                  int* __restrict__ rootvals, int* __restrict__ nroots, int H, int W, int K,
                  int chunk, float thr) {
  const long long b = blockIdx.y;
  const geometry::Plane<T> det{logits + b * sb, sy, sx};
  const geometry::GlobalLabels lab{labels + b * H * W};
  tiled::roots_rank(det, lab, counts + b * gridDim.x, blockIdx.x, gridDim.x, rootvals + b * K,
                    nroots + b, H, W, K, chunk, thr);
}

// 3. block (tile column, tile row, image); dynamic shared memory: K roots,
// then one stats partial set, (K, C) floats and K ints, per warp.
template <int CM, class T>
__global__ void __launch_bounds__(kPassThreads)
slots_tile_kernel(const T* __restrict__ logits, long long sb, long long sy, long long sx,
                  long long sc, int C, const int* __restrict__ labels,
                  const int* __restrict__ rootvals, const int* __restrict__ nroots,
                  int* __restrict__ slots, int* __restrict__ minx, int* __restrict__ maxx,
                  float* __restrict__ tpart, int* __restrict__ tcnt, int H, int W, int K,
                  int tile_rows, float thr) {
  extern __shared__ int sm[];
  const long long b = blockIdx.z;
  const long long N = static_cast<long long>(H) * W;
  const long long tile = (b * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  const geometry::Logits<T> lg{logits + b * sb, sy, sx, sc, C};
  const geometry::GlobalLabels lab{labels + b * N};
  tiled::slots_tile<CM>(lg, lab, rootvals + b * K, nroots[b], slots + b * N, minx + b * K * H,
                        maxx + b * K * H, tpart + tile * K * C, tcnt + tile * K, blockIdx.x,
                        blockIdx.y, blockDim.x >> 5, H, W, K, tile_rows, thr, sm);
}

// 4. block (part of the image's K*(C+1) sums, image)
__global__ void __launch_bounds__(kRankThreads)
slots_finish_kernel(const float* __restrict__ tpart, const int* __restrict__ tcnt,
                    const int* __restrict__ nroots, int* __restrict__ minx,
                    int* __restrict__ maxx, float* __restrict__ areas,
                    float* __restrict__ det_sums, float* __restrict__ cls_sums, int H, int K,
                    int C, int tiles) {
  const long long b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  tiled::slots_finish_sum(tpart + b * tiles * K * C, tcnt + b * tiles * K, areas + b * K,
                          det_sums + b * K, cls_sums + b * K * max(C - 1, 1), i, K, C, tiles);
  // padding slots carry the background's extremes (slot K-1's)
  const int nvalid = min(nroots[b], K);
  for (int j = nvalid * H + i; j < (K - 1) * H; j += gridDim.x * blockDim.x) {
    tiled::slots_pad_extremes(minx + b * K * H, maxx + b * K * H, j, H, K);
  }
}

// logits (B, H, W, C) at element strides (sb, sy, sx, sc), labels
// (B, H, W) -> rootvals (B, K), slots (B, H, W), minx/maxx (B, K, H),
// nroots (B,), all int32; areas, det_sums (B, K) and cls_sums
// (B, K, max(C-1, 1)) f32.  ``threads`` is 32 x the stats partial sets
// of a block.
template <class T>
int slots_cluster(const void* logits, long long sb, long long sy, long long sx, long long sc,
                  int C, const void* labels, void* rootvals, void* slots, void* minx, void* maxx,
                  void* nroots, void* areas, void* det_sums, void* cls_sums, int B, int H, int W,
                  int K, int threads, float thr, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || K <= 0 || C <= 0 || threads <= 0 ||
      threads > kThreads || threads % 32 != 0)
    return cudaErrorInvalidValue;
  const size_t smem = (static_cast<size_t>(K) + 2 * static_cast<size_t>(K) * H) * sizeof(int) +
                      static_cast<size_t>(threads / 32) * K * (C + 1) * sizeof(float);
  return geometry::with_channel_bound(C, [&](auto cm) {
    constexpr int CM = decltype(cm)::value;
    cudaError_t e = cudaFuncSetAttribute(
        slots_kernel<CM, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    slots_kernel<CM, T><<<geometry::kSlotCtas * B, threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(logits), sb, sy, sx, sc, C,
        static_cast<const int*>(labels), static_cast<int*>(rootvals),
        static_cast<int*>(slots), static_cast<int*>(minx), static_cast<int*>(maxx),
        static_cast<int*>(nroots), static_cast<float*>(areas),
        static_cast<float*>(det_sums), static_cast<float*>(cls_sums), H, W, K, thr);
    return launch_status();
  });
}

// The outputs of component_slots for maps of any size (H*W < 2^30, B <=
// 65535), through the four launches above.  Scratch from the caller:
// ``counts`` B * ceil(H*W / chunk) ints, ``tpart`` B * tiles * K * C floats
// and ``tcnt`` B * tiles * K ints, where tiles = ceil(W / threads) *
// ceil(H / tile_rows); ``threads`` is 32 x the warps of a pass block.
template <class T>
int slots_tiled(const void* logits, long long sb, long long sy, long long sx, long long sc,
                int C, const void* labels, void* rootvals, void* slots, void* minx, void* maxx,
                void* nroots, void* areas, void* det_sums, void* cls_sums, void* counts,
                void* tpart, void* tcnt, int B, int H, int W, int K, int threads, int chunk,
                int tile_rows, float thr, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || K <= 0 || C <= 0 || B > 65535 || chunk <= 0 ||
      tile_rows <= 0 || threads <= 0 || threads > kPassThreads || threads % 32 != 0 ||
      static_cast<long long>(H) * W >= (1LL << 30))
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* lg = static_cast<const T*>(logits);
  const auto* lab = static_cast<const int*>(labels);
  auto* roots = static_cast<int*>(rootvals);
  auto* nr = static_cast<int*>(nroots);
  auto* mn = static_cast<int*>(minx);
  auto* mx = static_cast<int*>(maxx);
  const int N = H * W;
  const dim3 chunks((N + chunk - 1) / chunk, B);
  roots_count_kernel<T><<<chunks, kRankThreads, 0, s>>>(
      lg, sb, sy, sx, lab, static_cast<int*>(counts), mn, mx, H, W, K, chunk, thr);
  int e = launch_status();
  if (e != 0) return e;
  roots_rank_kernel<T><<<chunks, kRankThreads, 0, s>>>(
      lg, sb, sy, sx, lab, static_cast<const int*>(counts), roots, nr, H, W, K, chunk, thr);
  e = launch_status();
  if (e != 0) return e;
  const dim3 tiles((W + threads - 1) / threads, (H + tile_rows - 1) / tile_rows, B);
  const size_t smem = static_cast<size_t>(K) * sizeof(int) +
                      static_cast<size_t>(threads / 32) * K * (C + 1) * sizeof(float);
  e = geometry::with_channel_bound(C, [&](auto cm) {
    constexpr int CM = decltype(cm)::value;
    cudaError_t a = cudaFuncSetAttribute(
        slots_tile_kernel<CM, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (a != cudaSuccess) return static_cast<int>(a);
    slots_tile_kernel<CM, T><<<tiles, threads, smem, s>>>(
        lg, sb, sy, sx, sc, C, lab, roots, nr, static_cast<int*>(slots), mn, mx,
        static_cast<float*>(tpart), static_cast<int*>(tcnt), H, W, K, tile_rows, thr);
    return launch_status();
  });
  if (e != 0) return e;
  const dim3 fin((K * (C + 1) + kRankThreads - 1) / kRankThreads, B);
  slots_finish_kernel<<<fin, kRankThreads, 0, s>>>(
      static_cast<const float*>(tpart), static_cast<const int*>(tcnt), nr, mn, mx,
      static_cast<float*>(areas), static_cast<float*>(det_sums), static_cast<float*>(cls_sums),
      H, K, C, static_cast<int>(tiles.x * tiles.y));
  return launch_status();
}

}  // namespace

// logits (B, H, W, C) f32 at element strides (sb, sy, sx, sc), labels
// (B, H, W) -> the outputs of slots_cluster above.
extern "C" int component_slots(const void* logits, long long sb, long long sy, long long sx,
                               long long sc, int C, const void* labels, void* rootvals,
                               void* slots, void* minx, void* maxx, void* nroots, void* areas,
                               void* det_sums, void* cls_sums, int B, int H, int W, int K,
                               int threads, float thr, void* stream) {
  return slots_cluster<float>(logits, sb, sy, sx, sc, C, labels, rootvals, slots, minx, maxx,
                              nroots, areas, det_sums, cls_sums, B, H, W, K, threads, thr,
                              stream);
}

// The same from bf16 logits.
extern "C" int component_slots_bf16(const void* logits, long long sb, long long sy,
                                    long long sx, long long sc, int C, const void* labels,
                                    void* rootvals, void* slots, void* minx, void* maxx,
                                    void* nroots, void* areas, void* det_sums, void* cls_sums,
                                    int B, int H, int W, int K, int threads, float thr,
                                    void* stream) {
  return slots_cluster<__nv_bfloat16>(logits, sb, sy, sx, sc, C, labels, rootvals, slots, minx,
                                      maxx, nroots, areas, det_sums, cls_sums, B, H, W, K,
                                      threads, thr, stream);
}

// The outputs of component_slots for maps of any size, from f32 logits
// (slots_tiled above).
extern "C" int component_slots_tiled(const void* logits, long long sb, long long sy,
                                     long long sx, long long sc, int C, const void* labels,
                                     void* rootvals, void* slots, void* minx, void* maxx,
                                     void* nroots, void* areas, void* det_sums,
                                     void* cls_sums, void* counts, void* tpart, void* tcnt,
                                     int B, int H, int W, int K, int threads, int chunk,
                                     int tile_rows, float thr, void* stream) {
  return slots_tiled<float>(logits, sb, sy, sx, sc, C, labels, rootvals, slots, minx, maxx,
                            nroots, areas, det_sums, cls_sums, counts, tpart, tcnt, B, H, W, K,
                            threads, chunk, tile_rows, thr, stream);
}

// The same from bf16 logits.
extern "C" int component_slots_tiled_bf16(const void* logits, long long sb, long long sy,
                                          long long sx, long long sc, int C, const void* labels,
                                          void* rootvals, void* slots, void* minx, void* maxx,
                                          void* nroots, void* areas, void* det_sums,
                                          void* cls_sums, void* counts, void* tpart, void* tcnt,
                                          int B, int H, int W, int K, int threads, int chunk,
                                          int tile_rows, float thr, void* stream) {
  return slots_tiled<__nv_bfloat16>(logits, sb, sy, sx, sc, C, labels, rootvals, slots, minx,
                                    maxx, nroots, areas, det_sums, cls_sums, counts, tpart, tcnt,
                                    B, H, W, K, threads, chunk, tile_rows, thr, stream);
}
