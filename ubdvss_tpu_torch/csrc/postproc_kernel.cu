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
// One cluster an image, of the blocks its launch plan gives it (geometry.cuh
// SlotPlan; ops/cuda/postproc_kernel.py slot_plan):
//   * 2 where the batch fills the card (B >= 34 at 132 SMs: the main path's
//     and the stream's B=64 fill 128 of the 132 SMs), slots_kernel: each
//     block ranks the image's roots itself (geometry.cuh: slot_roots), runs
//     its half of the pixel pass (slot_pass) and block 0 takes the other
//     block's extremes and stats partials from its shared memory
//     (distributed shared memory) and writes the outputs (slot_finish);
//   * 16, 8 or 4 where every image's blocks of the batch fit the card at
//     once (a detect call's one heatmap, the packed route's four 256²
//     maps), slots_band_kernel: each block ranks the roots of its band of
//     rows with coalesced loads and takes the image's K smallest from the
//     blocks' lists through the cluster (slot_rank, join_roots), runs its
//     share of the pixel pass, and writes a share of the outputs, reading
//     the others' extremes and partials through the cluster (band_finish).
// The pass reads labels from device memory and the logits where the head
// wrote them — the (B, H, W, C) view over (B, C, H, W) planes, at its
// strides.  A block has one virtual warp per stats partial set, 32 where
// K12c's shared memory allows, run by as many warps up to 17 logit channels
// and by 16 or 8 warps in turn past them, whose threads hold more class
// logits and sums (geometry.cuh stats_block).  The sums run over the
// partial sets in the virtual warps' order: one running sum on two blocks,
// a running sum a block then one over the blocks on a wider cluster; K12c
// runs the same plan, so both sum in one order and agree bit for bit.  A
// batch of few images takes more virtual warps an image (16 x 32 against 2
// x 32), so each walks a shorter run of the image (4 steps at 256² against
// 32), and its sums come in another order than the same image's in a batch
// of 34 or more.
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
// extremes alone are 256 KB).  The same outputs, in three launches at the
// geometry of ops/cuda/postproc_kernel.py tiled_plan (tiled.cuh Plan):
//   1. roots: a block a (raster chunk of 2048 pixels or more, image)
//      counts the chunk's roots and lists its first K, ranked by warp
//      ballots in one pass over the chunk's labels;
//   2. pass: a block a (band of tile_rows rows by the full width, image)
//      gathers the image's K smallest roots from the chunks' counts and
//      lists (band 0 writes rootvals and nroots), then runs the pixel
//      pass: each warp walks (row, 256-column segment) units along the
//      row, lanes over consecutive columns, writes the slot of each pixel,
//      takes the band's per-row extremes by shared-memory atomicMin/Max
//      (one a slot and step for each warp: lanes ascend in x, so a slot's
//      lowest lane holds its min x and its highest lane its max x), and
//      sums the stats in registers and warp trees (geometry.cuh StatsAcc,
//      its tiled sums) into the warp's partial set in shared memory; the
//      band then writes its rows of every slot's extremes (the padding
//      slots the background's) and the sum of its warps' sets in order;
//   3. finish: each (slot, channel) sum over the bands in a fixed order
//      (a warp a stride of bands, then the warps in order).
// The phases' bodies are tiled.cuh's, which the large K12c
// (geometry_kernel.cu) runs in one launch, so the two agree bit for bit.
// No float atomic anywhere, so two launches agree bit for bit; the order
// of the sums differs from the cluster kernel's, so the two agree within
// f32 rounding, not bit for bit.  Bound: the cluster kernel's bytes (12 B a
// pixel and the class logits of the pixels in a slot: 48 us at B=8 512²,
// K=64, f32).  The pass is bound instead by each warp's chain of dependent
// steps (load, slot search, match, softmax: about 3 us a 32-pixel step), so
// its blocks run at 64 registers, four an SM, over bands of a few rows
// (PERF.md §6, PR 12).
//
// Both read f32 or bf16 logits (``_bf16`` entry points, the bf16 route's
// trunk output: half the logit bytes); on bf16 each class probability is
// rounded to bf16 before the f32 sums, as in the JAX package
// (geometry.cuh StatsAcc), and the partials, their order and the warp
// count are those of f32, so K2 and K12c stay equal bit for bit.
//
// Any logit channel count: up to geometry.cuh's kOnePassChannels (65)
// the pass keeps a pixel's class logits and its class sums in registers,
// each logit loaded once, in an instance compiled for 1 or 17 channels or
// for the least guarded bound that holds C (kStatsBounds, its class loops
// free of branches on C); past it one pass a chunk of 40 classes (StatsAcc,
// kWideChannels, kChunkClasses), the slots and extremes written by the first and read
// back by the others; the one limit is one warp's partial set, K (C + 1)
// words, in a block's shared memory.
//
// The ``_packed`` entry points read the packed route's phase-major logits
// ((B, H/2, W/2, 4C), channel (2 (y & 1) + (x & 1)) C + c for pixel (y,
// x)) in place, as the TPU module's packed_phases does: every load goes
// through geometry.cuh's pixel_offset with the phase strides, and the
// pass walks the same unpacked (y, x) order, so the outputs equal those of
// the same kernel on the unpacked logits bit for bit.  A warp's 32 lanes
// then read two runs of 16 contiguous cells (one a phase column) where an
// unpacked map gives one run of 32.
#include <cooperative_groups.h>

#include "common.cuh"
#include "geometry.cuh"
#include "tiled.cuh"

namespace {

namespace cg = cooperative_groups;

// Two blocks an image (the plan's least cluster), its cluster fixed at
// compile time.
template <int CM, class T>
__global__ void __cluster_dims__(geometry::kSlotCtas, 1, 1)
__launch_bounds__(geometry::stats_block<CM>())
slots_kernel(const T* __restrict__ logits, long long sb, long long sy,
             long long sx, long long sc, geometry::Phase ph, int C,
             const int* __restrict__ labels,
             int* __restrict__ rootvals, int* __restrict__ slots,
             int* __restrict__ minx, int* __restrict__ maxx,
             int* __restrict__ nroots, float* __restrict__ areas,
             float* __restrict__ det_sums, float* __restrict__ cls_sums, int H,
             int W, int K, int sets, float thr) {
  extern __shared__ int sm[];
  SLOT_STAMP_START;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const long long b = blockIdx.x / geometry::kSlotCtas;
  const long long N = static_cast<long long>(H) * W;
  const geometry::Logits<T> lg{logits + b * sb, sy, sx, sc, C, ph};
  const geometry::Plane<T> det{lg.p, sy, sx, ph};
  const geometry::GlobalLabels lab{labels + b * N};
  const geometry::SlotSmem s(sm, K, H, C, sets);
  const int total = geometry::slot_roots(det, lab, s, s.root, 0, static_cast<int>(N), H, W, K,
                                         C, sets, thr);
  SLOT_STAMP(1);
  geometry::slot_pass<CM>(det, lg, lab, s, H, W, K, thr, total, rank * sets, sets,
                          geometry::kSlotCtas * sets, slots + b * N);
  SLOT_STAMP(2);
  cluster.sync();
  if (rank == 0) {
    const geometry::SlotSmem o(cluster.map_shared_rank(sm, 1), K, H, C, sets);
    for (int i = threadIdx.x; i < K * H; i += blockDim.x) {
      s.mn[i] = min(s.mn[i], o.mn[i]);
      s.mx[i] = max(s.mx[i], o.mx[i]);
    }
    __syncthreads();
    geometry::slot_finish(s, o.part, o.cnt, H, K, C, total, geometry::kSlotCtas * sets,
                          rootvals + b * K, minx + b * K * H, maxx + b * K * H, nroots + b,
                          areas + b * K, det_sums + b * K,
                          cls_sums + b * K * max(C - 1, 1));
  }
  cluster.sync();  // block 1's shared memory lives until block 0 has read it
  SLOT_STAMP(3);
}

// A wider cluster an image, at plan ``pl``: block r ranks the roots of rows
// [r S, (r + 1) S), S = ceil(H / pl.blocks).
template <int CM, class T>
__global__ void __launch_bounds__(geometry::stats_block<CM>())
slots_band_kernel(const T* __restrict__ logits, long long sb, long long sy, long long sx,
                  long long sc, geometry::Phase ph, int C, const int* __restrict__ labels,
                  int* __restrict__ rootvals, int* __restrict__ slots, int* __restrict__ minx,
                  int* __restrict__ maxx, int* __restrict__ nroots, float* __restrict__ areas,
                  float* __restrict__ det_sums, float* __restrict__ cls_sums, int H, int W,
                  int K, geometry::SlotPlan pl, float thr) {
  extern __shared__ int sm[];
  SLOT_STAMP_START;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const long long b = blockIdx.x / pl.blocks;
  const int N = H * W;
  const geometry::Logits<T> lg{logits + b * sb, sy, sx, sc, C, ph};
  const geometry::Plane<T> det{lg.p, sy, sx, ph};
  const geometry::GlobalLabels lab{labels + b * N};
  const geometry::SlotSmem s(sm, K, H, C, pl.sets);
  const int span = geometry::band_rows(H, pl.blocks) * W;
  const int p0 = min(rank * span, N);
  geometry::slot_rank(det, lab, s.ranked, s.ranked + K, p0, min(p0 + span, N), W, K, thr);
  cluster.barrier_arrive();
  geometry::slot_clear(s, H, K, C, pl.sets);
  cluster.barrier_wait();
  const int total = geometry::join_roots(cluster, s, pl.blocks, K, N);
  SLOT_STAMP(1);
  geometry::slot_pass<CM>(det, lg, lab, s, H, W, K, thr, total, rank * pl.sets, pl.sets,
                          pl.blocks * pl.sets, slots + b * N);
  SLOT_STAMP(2);
  geometry::band_finish(cluster, s, rank, pl, H, K, C, total, rootvals + b * K,
                        minx + b * K * H, maxx + b * K * H, nroots + b, areas + b * K,
                        det_sums + b * K, cls_sums + b * K * max(C - 1, 1));
  SLOT_STAMP(3);
}

// ---- component_slots_tiled: one kernel a phase of tiled.cuh ----

// 1. block (chunk, image): the chunk's root count and first roots; eight
// blocks an SM, so that a batch's chunks run in one wave.
template <class T>
__global__ void __launch_bounds__(tiled::kRootsThreads, 8)
roots_kernel(const T* __restrict__ logits, long long sb, long long sy, long long sx,
             geometry::Phase ph, const int* __restrict__ labels, int* __restrict__ counts,
             int* __restrict__ lists, tiled::Plan pl, float thr) {
  __shared__ int scratch[tiled::kRootsScratch];
  const int c = blockIdx.x;
  const long long b = blockIdx.y;
  const int N = pl.H * pl.W;
  const geometry::Plane<T> det{logits + b * sb, sy, sx, ph};
  const geometry::GlobalLabels lab{labels + b * N};
  const long long item = b * pl.nchunks + c;
  tiled::roots_chunk(det, lab, c, N, pl.W, pl.K, pl.chunk, thr, counts + item,
                     lists + item * pl.K, scratch);
}

// 2. block (band, image); dynamic shared memory tiled::pass_smem.  Four
// blocks an SM (64 registers a thread): the pass is bound by each warp's
// chain of dependent steps, so resident warps, not registers, set its pace;
// fewer where a thread holds more classes (geometry.cuh tiled_blocks).
template <int CM, class T>
__global__ void __launch_bounds__(256, geometry::tiled_blocks<CM>())
pass_kernel(const T* __restrict__ logits, long long sb, long long sy, long long sx, long long sc,
            geometry::Phase ph, const int* __restrict__ labels, const int* __restrict__ counts,
            const int* __restrict__ lists, int* __restrict__ rootvals, int* __restrict__ nroots,
            int* __restrict__ slots, int* __restrict__ minx, int* __restrict__ maxx,
            float* __restrict__ tpart, int* __restrict__ tcnt, int* __restrict__ ext,
            tiled::Plan pl, float thr) {
  extern __shared__ int sm[];
  const long long b = blockIdx.y;
  const long long N = static_cast<long long>(pl.H) * pl.W;
  const long long band = b * pl.bands + blockIdx.x;
  const int K = pl.K;
  const geometry::Logits<T> lg{logits + b * sb, sy, sx, sc, pl.C, ph};
  const geometry::GlobalLabels lab{labels + b * N};
  tiled::slots_pass<CM>(lg, lab, counts + b * pl.nchunks, lists + b * pl.nchunks * K,
                        rootvals + b * K, nroots + b, slots + b * N, minx + b * K * pl.H,
                        maxx + b * K * pl.H, tpart + band * K * pl.C, tcnt + band * K,
                        ext + band * 2 * K * pl.tile_rows, blockIdx.x, pl, thr, sm);
}

// 3. block (group of 32 sums, image)
__global__ void __launch_bounds__(tiled::kFinishThreads)
finish_kernel(const float* __restrict__ tpart, const int* __restrict__ tcnt,
              float* __restrict__ areas, float* __restrict__ det_sums,
              float* __restrict__ cls_sums, tiled::Plan pl) {
  __shared__ int scratch[tiled::kFinishScratch];
  const long long b = blockIdx.y;
  const int K = pl.K, C = pl.C;
  tiled::slots_finish(tpart + b * pl.bands * K * C, tcnt + b * pl.bands * K, areas + b * K,
                      det_sums + b * K, cls_sums + b * K * max(C - 1, 1), blockIdx.x, K, C,
                      pl.bands, scratch);
}

// logits (B, H, W, C) at element strides (sb, sy, sx, sc) and phase
// ``ph`` (geometry.cuh Phase), labels (B, H, W) -> rootvals (B, K), slots
// (B, H, W), minx/maxx (B, K, H), nroots (B,), all int32; areas, det_sums
// (B, K) and cls_sums (B, K, max(C-1, 1)) f32.  The plan (geometry.cuh
// SlotPlan): ``threads`` is 32 x the stats partial sets of a block, one a
// virtual warp, ``blocks`` the cluster an image; a block has at most
// geometry::stats_block<CM>() threads, each warp running its share of the
// virtual warps in turn.
template <class T>
int slots_cluster(const void* logits, long long sb, long long sy, long long sx, long long sc,
                  geometry::Phase ph, int C, const void* labels, void* rootvals, void* slots,
                  void* minx, void* maxx, void* nroots, void* areas, void* det_sums,
                  void* cls_sums, int B, int H, int W, int K, int threads, int blocks,
                  float thr, void* stream) {
  const geometry::SlotPlan pl{blocks, threads / 32};
  if (B <= 0 || H <= 0 || W <= 0 || K <= 0 || C <= 0 || threads % 32 != 0 ||
      !geometry::valid_plan(pl) || static_cast<long long>(blocks) * B > 0x7fffffff)
    return cudaErrorInvalidValue;
  // two blocks: no band's ranked roots (K + 1 words)
  const size_t smem =
      (geometry::slot_smem_words(K, H, C, pl.sets) - (pl.blocks == geometry::kSlotCtas) * (K + 1)) *
      sizeof(int);
  return geometry::with_channel_bound(C, [&](auto cm) {
    constexpr int CM = decltype(cm)::value;
    const int block = threads < geometry::stats_block<CM>() ? threads : geometry::stats_block<CM>();
    if (pl.blocks == geometry::kSlotCtas) {
      cudaError_t e = cudaFuncSetAttribute(
          slots_kernel<CM, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
      slots_kernel<CM, T><<<geometry::kSlotCtas * B, block, smem,
                            static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(logits), sb, sy, sx, sc, ph, C,
          static_cast<const int*>(labels), static_cast<int*>(rootvals),
          static_cast<int*>(slots), static_cast<int*>(minx), static_cast<int*>(maxx),
          static_cast<int*>(nroots), static_cast<float*>(areas),
          static_cast<float*>(det_sums), static_cast<float*>(cls_sums), H, W, K, pl.sets, thr);
      return launch_status();
    }
    return geometry::launch_cluster(
        slots_band_kernel<CM, T>, pl, B, block, smem, static_cast<cudaStream_t>(stream),
        static_cast<const T*>(logits), sb, sy, sx, sc, ph, C, static_cast<const int*>(labels),
        static_cast<int*>(rootvals), static_cast<int*>(slots), static_cast<int*>(minx),
        static_cast<int*>(maxx), static_cast<int*>(nroots), static_cast<float*>(areas),
        static_cast<float*>(det_sums), static_cast<float*>(cls_sums), H, W, K, pl, thr);
  });
}

// The clusters of ``blocks`` (4, 8 or 16) blocks of K2 at C channels,
// (H, W) maps, K slots and ``threads`` (32 x the sets of a block) that the
// card runs at once, on f32 or bf16 logits.
int slots_room(int C, int H, int W, int K, int threads, int blocks, int bf16, int* room) {
  const int sets = threads / 32;
  const size_t smem = geometry::slot_smem_words(K, H, C, sets) * sizeof(int);
  return geometry::with_channel_bound(C, [&](auto cm) {
    constexpr int CM = decltype(cm)::value;
    const int block = threads < geometry::stats_block<CM>() ? threads : geometry::stats_block<CM>();
    return bf16 ? geometry::cluster_room(slots_band_kernel<CM, __nv_bfloat16>, blocks, block, smem,
                                         room)
                : geometry::cluster_room(slots_band_kernel<CM, float>, blocks, block, smem, room);
  });
}

// The outputs of component_slots for maps of any size (H*W < 2^30, B <=
// 65535), through the three launches above, at the plan's geometry
// (``plan``: tiled_plan's nplan ints, tiled.cuh Plan).  Scratch from the
// caller: ``counts`` B * nchunks ints, ``lists`` B * nchunks * K ints,
// ``tpart`` B * bands * K * C floats, ``tcnt`` B * bands * K ints and,
// where the plan keeps the extremes out of shared memory, ``ext`` B *
// bands * 2 * K * tile_rows ints.
template <class T>
int slots_tiled(const void* logits, long long sb, long long sy, long long sx, long long sc,
                geometry::Phase ph, const void* labels, void* rootvals, void* slots, void* minx,
                void* maxx, void* nroots, void* areas, void* det_sums, void* cls_sums, void* counts,
                void* lists, void* tpart, void* tcnt, void* ext, const int* plan, int nplan,
                float thr, void* stream) {
  tiled::Plan pl;
  if (!tiled::read_plan(plan, nplan, &pl) || pl.B > 65535) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* lg = static_cast<const T*>(logits);
  const auto* lab = static_cast<const int*>(labels);
  auto* cn = static_cast<int*>(counts);
  auto* li = static_cast<int*>(lists);
  auto* tp = static_cast<float*>(tpart);
  auto* tc = static_cast<int*>(tcnt);
  roots_kernel<T><<<dim3(pl.nchunks, pl.B), tiled::kRootsThreads, 0, s>>>(lg, sb, sy, sx, ph, lab,
                                                                         cn, li, pl, thr);
  int e = launch_status();
  if (e != 0) return e;
  const size_t smem = tiled::pass_smem(pl);
  e = geometry::with_channel_bound(pl.C, [&](auto cm) {
    constexpr int CM = decltype(cm)::value;
    cudaError_t a = cudaFuncSetAttribute(
        pass_kernel<CM, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (a != cudaSuccess) return static_cast<int>(a);
    pass_kernel<CM, T><<<dim3(pl.bands, pl.B), 32 * pl.pass_warps, smem, s>>>(
        lg, sb, sy, sx, sc, ph, lab, cn, li, static_cast<int*>(rootvals),
        static_cast<int*>(nroots),
        static_cast<int*>(slots), static_cast<int*>(minx), static_cast<int*>(maxx), tp, tc,
        static_cast<int*>(ext), pl, thr);
    return launch_status();
  });
  if (e != 0) return e;
  finish_kernel<<<dim3(pl.fin_blocks, pl.B), tiled::kFinishThreads, 0, s>>>(
      tp, tc, static_cast<float*>(areas), static_cast<float*>(det_sums),
      static_cast<float*>(cls_sums), pl);
  return launch_status();
}

}  // namespace

// The channel count the stats are compiled for at C logit channels
// (geometry.cuh with_channel_bound).
extern "C" int stats_channel_bound(int C) {
  return geometry::with_channel_bound(C, [](auto cm) { return decltype(cm)::value; });
}

// The clusters of ``blocks`` blocks of K2 the card runs at once, into
// *room (slots_room above).
extern "C" int component_slots_room(int C, int H, int W, int K, int threads, int blocks, int bf16,
                                    int* room) {
  return slots_room(C, H, W, K, threads, blocks, bf16, room);
}

// geometry.cuh slot_plan: (blocks, sets) into ``out`` for B images,
// ``sets`` virtual warps a block, ``sms`` SMs and the room of clusters of
// 16, 8 and 4 blocks, as ops/cuda/postproc_kernel.py slot_plan gives them.
extern "C" int slot_plan_ints(int B, int sets, int sms, const int* room, int* out) {
  const geometry::SlotPlan pl = geometry::slot_plan(B, sets, sms, room);
  out[0] = pl.blocks;
  out[1] = pl.sets;
  return 0;
}

// logits (B, H, W, C) f32 at element strides (sb, sy, sx, sc), labels
// (B, H, W) -> the outputs of slots_cluster above, at its plan.
extern "C" int component_slots(const void* logits, long long sb, long long sy, long long sx,
                               long long sc, int C, const void* labels, void* rootvals,
                               void* slots, void* minx, void* maxx, void* nroots, void* areas,
                               void* det_sums, void* cls_sums, int B, int H, int W, int K,
                               int threads, int blocks, float thr,
                               void* stream) {
  return slots_cluster<float>(logits, sb, sy, sx, sc, geometry::Phase{}, C, labels, rootvals,
                              slots, minx, maxx, nroots, areas, det_sums, cls_sums, B, H, W, K,
                              threads, blocks, thr, stream);
}

// The same from bf16 logits.
extern "C" int component_slots_bf16(const void* logits, long long sb, long long sy,
                                    long long sx, long long sc, int C, const void* labels,
                                    void* rootvals, void* slots, void* minx, void* maxx,
                                    void* nroots, void* areas, void* det_sums, void* cls_sums,
                                    int B, int H, int W, int K, int threads, int blocks,
                                    float thr, void* stream) {
  return slots_cluster<__nv_bfloat16>(logits, sb, sy, sx, sc, geometry::Phase{}, C, labels,
                                      rootvals, slots, minx, maxx, nroots, areas, det_sums,
                                      cls_sums, B, H, W, K, threads, blocks, thr, stream);
}

// The same from phase-major packed logits (the packed route's (B, H/2,
// W/2, 4C)): (sb, sy, sx) step over images and 2x2 cells, (spy, spx) over
// a cell's phases, sc over channels (geometry.cuh Phase); H, W are the
// unpacked map's.
extern "C" int component_slots_packed(const void* logits, long long sb, long long sy,
                                      long long sx, long long sc, long long spy, long long spx,
                                      int C, const void* labels, void* rootvals, void* slots,
                                      void* minx, void* maxx, void* nroots, void* areas,
                                      void* det_sums, void* cls_sums, int B, int H, int W, int K,
                                      int threads, int blocks, float thr,
                                      void* stream) {
  return slots_cluster<float>(logits, sb, sy, sx, sc, geometry::phase_of(spy, spx), C, labels,
                              rootvals, slots, minx, maxx, nroots, areas, det_sums, cls_sums, B,
                              H, W, K, threads, blocks, thr, stream);
}

extern "C" int component_slots_packed_bf16(const void* logits, long long sb, long long sy,
                                           long long sx, long long sc, long long spy,
                                           long long spx, int C, const void* labels,
                                           void* rootvals, void* slots, void* minx, void* maxx,
                                           void* nroots, void* areas, void* det_sums,
                                           void* cls_sums, int B, int H, int W, int K,
                                           int threads, int blocks, float thr,
                                           void* stream) {
  return slots_cluster<__nv_bfloat16>(logits, sb, sy, sx, sc, geometry::phase_of(spy, spx), C,
                                      labels, rootvals, slots, minx, maxx, nroots, areas,
                                      det_sums, cls_sums, B, H, W, K, threads, blocks,
                                      thr, stream);
}

// The outputs of component_slots for maps of any size, from f32 logits at
// element strides (sb, sy, sx, sc) and the raw labels (slots_tiled above).
extern "C" int component_slots_tiled(const void* logits, long long sb, long long sy,
                                     long long sx, long long sc, const void* labels,
                                     void* rootvals, void* slots, void* minx, void* maxx,
                                     void* nroots, void* areas, void* det_sums,
                                     void* cls_sums, void* counts, void* lists, void* tpart,
                                     void* tcnt, void* ext, const int* plan, int nplan,
                                     float thr, void* stream) {
  return slots_tiled<float>(logits, sb, sy, sx, sc, geometry::Phase{}, labels, rootvals, slots,
                            minx, maxx, nroots, areas, det_sums, cls_sums, counts, lists, tpart,
                            tcnt, ext, plan, nplan, thr, stream);
}

// The same from bf16 logits.
extern "C" int component_slots_tiled_bf16(const void* logits, long long sb, long long sy,
                                          long long sx, long long sc, const void* labels,
                                          void* rootvals, void* slots, void* minx, void* maxx,
                                          void* nroots, void* areas, void* det_sums,
                                          void* cls_sums, void* counts, void* lists,
                                          void* tpart, void* tcnt, void* ext, const int* plan,
                                          int nplan, float thr, void* stream) {
  return slots_tiled<__nv_bfloat16>(logits, sb, sy, sx, sc, geometry::Phase{}, labels, rootvals,
                                    slots, minx, maxx, nroots, areas, det_sums, cls_sums, counts,
                                    lists, tpart, tcnt, ext, plan, nplan, thr, stream);
}

// The same from phase-major packed logits (component_slots_packed's
// strides).
extern "C" int component_slots_tiled_packed(const void* logits, long long sb, long long sy,
                                            long long sx, long long sc, long long spy,
                                            long long spx, const void* labels, void* rootvals,
                                            void* slots, void* minx, void* maxx, void* nroots,
                                            void* areas, void* det_sums, void* cls_sums,
                                            void* counts, void* lists, void* tpart, void* tcnt,
                                            void* ext, const int* plan, int nplan, float thr,
                                            void* stream) {
  return slots_tiled<float>(logits, sb, sy, sx, sc, geometry::phase_of(spy, spx), labels,
                            rootvals, slots, minx, maxx, nroots, areas, det_sums, cls_sums,
                            counts, lists, tpart, tcnt, ext, plan, nplan, thr, stream);
}

extern "C" int component_slots_tiled_packed_bf16(
    const void* logits, long long sb, long long sy, long long sx, long long sc, long long spy,
    long long spx, const void* labels, void* rootvals, void* slots, void* minx, void* maxx,
    void* nroots, void* areas, void* det_sums, void* cls_sums, void* counts, void* lists,
    void* tpart, void* tcnt, void* ext, const int* plan, int nplan, float thr, void* stream) {
  return slots_tiled<__nv_bfloat16>(logits, sb, sy, sx, sc, geometry::phase_of(spy, spx),
                                    labels, rootvals, slots, minx, maxx, nroots, areas, det_sums,
                                    cls_sums, counts, lists, tpart, tcnt, ext, plan, nplan, thr,
                                    stream);
}
