// The whole component geometry of one image in one cluster of blocks:
// threshold + CCL (union-find), then the root count, the K smallest roots,
// the slot map, each slot's per-row x extremes and its stats.
//
// Replaces the TPU kernel _geometry_kernel_compat (ubdvss_tpu/ops/pallas/
// postproc_kernel.py:50), which the JAX package runs instead of its CCL and
// slots kernels under UBDVSS_PALLAS_COMPAT=1.  Its outputs are those of
// K2 after K1, bit for bit: the same phases of geometry.cuh, with the label
// map kept in shared memory, so the labels never go to device memory.
//
// One cluster an image at K2's launch plan (geometry.cuh SlotPlan): G = 2
// blocks where the batch fills the card (the main path's B=64;
// geometry_kernel), else 16, 8 or 4 (geometry_band_kernel):
//   1. block r holds the image's label rows [r S, (r + 1) S), S =
//      ceil(H/G), in its shared memory (a band; the last may be short or
//      empty) and runs the union-find's initialise and merge passes on
//      them;
//   2. each block r > 0 merges the seam rows r S - 1 and r S across the
//      cluster, all G - 1 seams at once: its unions reach the blocks above
//      through distributed shared memory (cluster.map_shared_rank;
//      atomicMin on the peer's words).  A root is always the smaller linear
//      index, so a component links into the band of its first pixel and
//      never the other way;
//   3. each block flattens its rows (a find may walk into any block above);
//   4. each block ranks the roots of its rows; the bands come in raster
//      order, so the image's K smallest are the blocks' lists in block
//      order, which each block reads from the others;
//   5. each block runs K2's virtual warps rank * sets ... of the pixel
//      pass, on labels read from whichever block holds the row, and the
//      outputs are written as K2's are: by block 0 on two blocks, each
//      block a share on a wider cluster.
// The same plan as K2 (the caller's ``threads`` and ``blocks``), the same
// virtual warps and the same order of sums give K2's stats bit for bit.  Like K1 it reaches the true components, with no
// round cap.  The detection logits are read at the head's strides, as K2
// reads them.
//
// Shared memory a block: S*W + 2K + 1 + 2*K*H words (labels of its rows,
// the roots, its own ranked roots and count, the extremes; 49 KB at
// 128x128, K=16, on two blocks), plus (K, C+1) words per virtual warp of
// stats partials; the caller picks the warps so that it stays within the
// card's 227 KB on two blocks, and a wider cluster holds fewer rows a
// block.
//
// Bound on this card: 8 B per pixel of device memory (detection logit
// read, slot written) plus the class logits of the pixels in a slot and
// the (K, H) extremes; the union-find and the slot search run at
// shared-memory latency.
//
// It reads f32 or bf16 logits (``geometry_compat_bf16``), with K2's
// rounding of the class probabilities on bf16 (geometry.cuh StatsAcc), so
// it equals K2 after K1 bit for bit on either type.
//
// geometry_compat_large serves the maps where half the label map and the
// (K, H) extremes exceed one block's shared memory (K=64 past about 200²:
// the 2048² scans' 512² maps, the 4096² scan's 1024² map), where the TPU
// kernel still holds the map in VMEM.  It is one cooperative launch of
// persistent blocks (four an SM, 64 registers) that run the phases of the
// device-memory CCL and the tiled slots (tiled.cuh, the bodies
// ccl_labels_tiled and component_slots_tiled launch one kernel each) at
// the same plan (ops/cuda/postproc_kernel.py tiled_plan), each block
// looping over a phase's work items, with a grid-wide barrier
// (cooperative_groups grid sync) between phases:
//   1. the CCL's tiles (in shared memory);
//   2. the seams between tiles, union-find on device memory;
//   3. the flatten, and each raster chunk's root count and first K roots
//      (a root's label is its own index before and after the flatten, so
//      the two overlap);
//   4. the pixel pass over the bands: each gathers the K smallest roots,
//      writes its rows' slots and extremes and its stats partials;
//   5. each (slot, channel) sum over the bands in order.
// The labels (a device-memory workspace) are canonical, and the chunks,
// bands, warps, partials and finish order are component_slots_tiled's, so
// the eight outputs equal ccl_labels_tiled then component_slots_tiled bit
// for bit, in f32 and bf16: past geometry_compat_fits the compat route's
// detections are the default route's.  The labels are read with plain
// loads (other blocks wrote them earlier in the launch).  Every phase's
// shared-memory scratch is the launch's dynamic shared memory.  Bound: the
// tiled pair's bytes (8 B a pixel of logit read and slot written, the
// class logits of the pixels in a slot, the extremes); the barriers cost a
// few microseconds each.
//
// Both have ``_packed`` entry points for the packed route's phase-major
// logits, read in place at their phase strides (geometry.cuh Phase), equal
// bit for bit to the same kernel on the unpacked logits.
#include <cooperative_groups.h>

#include "common.cuh"
#include "geometry.cuh"
#include "tiled.cuh"

namespace {

namespace cg = cooperative_groups;

// Two blocks an image (the plan's least cluster, fixed at compile time):
// block 0 holds rows [0, S), block 1 [S, H).
template <int CM, class T>
__global__ void __cluster_dims__(geometry::kSlotCtas, 1, 1)
__launch_bounds__(geometry::stats_block<CM>())
geometry_kernel(const T* __restrict__ logits, long long sb, long long sy, long long sx,
                long long sc, geometry::Phase ph, int C, int* __restrict__ rootvals,
                int* __restrict__ slots,
                int* __restrict__ minx, int* __restrict__ maxx, int* __restrict__ nroots,
                float* __restrict__ areas, float* __restrict__ det_sums,
                float* __restrict__ cls_sums, int H, int W, int K, int sets, float thr,
                int connectivity) {
  extern __shared__ int sm[];
  SLOT_STAMP_START;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const long long b = blockIdx.x / geometry::kSlotCtas;
  const int N = H * W;
  const int S = (H + 1) / 2;  // block 0 holds rows [0, S), block 1 [S, H)
  const int split = S * W;
  int* own = sm;
  int* peer = cluster.map_shared_rank(sm, rank ^ 1);
  int* lo = rank == 0 ? own : peer;
  int* hi = rank == 0 ? peer : own;
  const int p0 = rank == 0 ? 0 : split;
  const int p1 = rank == 0 ? split : N;
  const geometry::Logits<T> lg{logits + b * sb, sy, sx, sc, C, ph};
  const geometry::Plane<T> det{lg.p, sy, sx, ph};
  const bool eight = connectivity == 8;

  // 1-3. CCL over the cluster
  const geometry::SplitLabels lab{lo, hi, split};
  geometry::ccl_init(
      lab,
      [&](int p) {
        const int y = p / W;
        return det(y, p - y * W) > thr;
      },
      p0, p1, N);
  __syncthreads();
  geometry::ccl_merge(lab, W, rank == 0 ? 0 : S, p0, p1, N, eight);
  cluster.sync();
  if (rank == 1 && S < H) geometry::ccl_seam(lab, W, S, N, eight);
  cluster.sync();
  geometry::ccl_flatten(lab, p0, p1, N);
  cluster.sync();
  SLOT_STAMP(0);

  // 4. the roots: each block ranks its rows', then joins the two lists
  const geometry::SlotSmem s(sm + split, K, H, C, sets);
  int* ranked = s.ranked;  // K roots of this block's rows, then their count
  const geometry::SplitView view{lo, hi, split};
  const int count = geometry::slot_roots(det, view, s, ranked, p0, p1, H, W, K, C, sets, thr);
  if (threadIdx.x == 0) ranked[K] = count;
  cluster.sync();
  const int* other = cluster.map_shared_rank(ranked, rank ^ 1);
  const int* lo_roots = rank == 0 ? ranked : other;
  const int* hi_roots = rank == 0 ? other : ranked;
  const int c0 = lo_roots[K];
  const int c1 = hi_roots[K];
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    s.root[k] = k < c0 ? lo_roots[k] : (k - c0 < c1 ? hi_roots[k - c0] : N);
  }
  __syncthreads();
  SLOT_STAMP(1);

  // 5. K2's pixel pass and finish
  geometry::slot_pass<CM>(det, lg, view, s, H, W, K, thr, c0 + c1, rank * sets, sets,
                          geometry::kSlotCtas * sets, slots + b * N);
  SLOT_STAMP(2);
  cluster.sync();
  if (rank == 0) {
    const geometry::SlotSmem o(cluster.map_shared_rank(sm, 1) + split, K, H, C, sets);
    for (int i = threadIdx.x; i < K * H; i += blockDim.x) {
      s.mn[i] = min(s.mn[i], o.mn[i]);
      s.mx[i] = max(s.mx[i], o.mx[i]);
    }
    __syncthreads();
    geometry::slot_finish(s, o.part, o.cnt, H, K, C, c0 + c1, geometry::kSlotCtas * sets,
                          rootvals + b * K, minx + b * K * H, maxx + b * K * H, nroots + b,
                          areas + b * K, det_sums + b * K, cls_sums + b * K * max(C - 1, 1));
  }
  cluster.sync();  // block 1's shared memory lives until block 0 has read it
  SLOT_STAMP(3);
}

// A wider cluster an image, at plan ``pl``: block r holds rows
// [r S, (r + 1) S), S = ceil(H / pl.blocks).
template <int CM, class T>
__global__ void __launch_bounds__(geometry::stats_block<CM>())
geometry_band_kernel(const T* __restrict__ logits, long long sb, long long sy, long long sx,
                     long long sc, geometry::Phase ph, int C, int* __restrict__ rootvals,
                     int* __restrict__ slots, int* __restrict__ minx, int* __restrict__ maxx,
                     int* __restrict__ nroots, float* __restrict__ areas,
                     float* __restrict__ det_sums, float* __restrict__ cls_sums, int H, int W,
                     int K, geometry::SlotPlan pl, float thr, int connectivity) {
  extern __shared__ int sm[];
  SLOT_STAMP_START;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const long long b = blockIdx.x / pl.blocks;
  const int N = H * W;
  const int S = geometry::band_rows(H, pl.blocks);
  const int span = S * W;
  const int y0 = min(rank * S, H);
  const int p0 = y0 * W;
  const int p1 = min(p0 + span, N);
  const float inv = 1.f / static_cast<float>(span);
  const geometry::Logits<T> lg{logits + b * sb, sy, sx, sc, C, ph};
  const geometry::Plane<T> det{lg.p, sy, sx, ph};
  const bool eight = connectivity == 8;

  // 1-3. CCL over the cluster
  const geometry::BandLabels lab{sm, p0, span, inv};
  geometry::ccl_init(
      lab,
      [&](int p) {
        const int y = p / W;
        return det(y, p - y * W) > thr;
      },
      p0, p1, N);
  __syncthreads();
  geometry::ccl_merge(lab, W, y0, p0, p1, N, eight);
  cluster.sync();
  if (rank > 0 && y0 < H) geometry::ccl_seam(lab, W, y0, N, eight);
  cluster.sync();
  geometry::ccl_flatten(lab, p0, p1, N);
  cluster.sync();
  SLOT_STAMP(0);

  // 4. the roots: each block ranks its rows', then takes the image's K
  // smallest from the blocks' lists
  const geometry::SlotSmem s(sm + span, K, H, C, pl.sets);
  const geometry::BandView view{sm, p0, span, inv};
  geometry::slot_rank(det, view, s.ranked, s.ranked + K, p0, p1, W, K, thr);
  cluster.barrier_arrive();
  geometry::slot_clear(s, H, K, C, pl.sets);
  cluster.barrier_wait();
  const int total = geometry::join_roots(cluster, s, pl.blocks, K, N);
  SLOT_STAMP(1);

  // 5. K2's pixel pass and finish
  geometry::slot_pass<CM>(det, lg, view, s, H, W, K, thr, total, rank * pl.sets, pl.sets,
                          pl.blocks * pl.sets, slots + b * N);
  SLOT_STAMP(2);
  geometry::band_finish(cluster, s, rank, pl, H, K, C, total, rootvals + b * K,
                        minx + b * K * H, maxx + b * K * H, nroots + b, areas + b * K,
                        det_sums + b * K, cls_sums + b * K * max(C - 1, 1));
  SLOT_STAMP(3);
}

// Shared memory of a K12c block at plan ``pl``: its band's labels, then
// K2's (geometry.cuh SlotSmem).
inline size_t geometry_smem(int H, int W, int K, int C, const geometry::SlotPlan& pl) {
  return (static_cast<size_t>(geometry::band_rows(H, pl.blocks)) * W +
          geometry::slot_smem_words(K, H, C, pl.sets)) * sizeof(int);
}

// logits (B, H, W, C) at element strides (sb, sy, sx, sc) and phase
// ``ph`` (geometry.cuh Phase) -> the outputs of component_slots
// (postproc_kernel.cu), at K2's plan: ``threads`` 32 x the virtual warps
// of a block, run on at most geometry::stats_block<CM>() threads,
// ``blocks`` the cluster an image.
template <class T>
int geometry_launch(const void* logits, long long sb, long long sy, long long sx, long long sc,
                    geometry::Phase ph, int C, void* rootvals, void* slots, void* minx,
                    void* maxx, void* nroots,
                    void* areas, void* det_sums, void* cls_sums, int B, int H, int W, int K,
                    int threads, int blocks, float thr, int connectivity,
                    void* stream) {
  const geometry::SlotPlan pl{blocks, threads / 32};
  if (B <= 0 || H <= 0 || W <= 0 || K <= 0 || C <= 0 || threads % 32 != 0 ||
      !geometry::valid_plan(pl) || static_cast<long long>(blocks) * B > 0x7fffffff ||
      static_cast<long long>(H) * W >= (1 << 24))
    return cudaErrorInvalidValue;
  const size_t smem = geometry_smem(H, W, K, C, pl);
  return geometry::with_channel_bound(C, [&](auto cm) {
    constexpr int CM = decltype(cm)::value;
    const int block = threads < geometry::stats_block<CM>() ? threads : geometry::stats_block<CM>();
    if (pl.blocks == geometry::kSlotCtas) {
      cudaError_t e = cudaFuncSetAttribute(
          geometry_kernel<CM, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
      geometry_kernel<CM, T><<<geometry::kSlotCtas * B, block, smem,
                               static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(logits), sb, sy, sx, sc, ph, C, static_cast<int*>(rootvals),
          static_cast<int*>(slots), static_cast<int*>(minx), static_cast<int*>(maxx),
          static_cast<int*>(nroots), static_cast<float*>(areas),
          static_cast<float*>(det_sums), static_cast<float*>(cls_sums), H, W, K, pl.sets,
          thr, connectivity);
      return launch_status();
    }
    return geometry::launch_cluster(
        geometry_band_kernel<CM, T>, pl, B, block, smem, static_cast<cudaStream_t>(stream),
        static_cast<const T*>(logits), sb, sy, sx, sc, ph, C, static_cast<int*>(rootvals),
        static_cast<int*>(slots), static_cast<int*>(minx), static_cast<int*>(maxx),
        static_cast<int*>(nroots), static_cast<float*>(areas), static_cast<float*>(det_sums),
        static_cast<float*>(cls_sums), H, W, K, pl, thr, connectivity);
  });
}

// The clusters of ``blocks`` (4, 8 or 16) blocks of K12c at C channels,
// (H, W) maps, K slots and ``threads`` that the card runs at once, on f32
// or bf16 logits.
int geometry_room(int C, int H, int W, int K, int threads, int blocks, int bf16, int* room) {
  const size_t smem = geometry_smem(H, W, K, C, geometry::SlotPlan{blocks, threads / 32});
  return geometry::with_channel_bound(C, [&](auto cm) {
    constexpr int CM = decltype(cm)::value;
    const int block = threads < geometry::stats_block<CM>() ? threads : geometry::stats_block<CM>();
    return bf16 ? geometry::cluster_room(geometry_band_kernel<CM, __nv_bfloat16>, blocks, block,
                                         smem, room)
                : geometry::cluster_room(geometry_band_kernel<CM, float>, blocks, block, smem,
                                         room);
  });
}

constexpr int kLargeThreads = 256;  // every phase's block: the tiled pair's at most

// The large maps' K12c: every phase of the tiled pair in one launch, at
// the plan's geometry.  ``labels`` (B, H, W), ``counts`` (B, nchunks),
// ``lists`` (B, nchunks, K), ``tpart`` (B, bands, K, C) and ``tcnt`` (B,
// bands, K) are workspaces.  None of the pointers the launch writes and
// reads again is __restrict__ const, so no load of them takes the
// read-only cache.
template <int CM, class T>
__global__ void __launch_bounds__(kLargeThreads, geometry::tiled_blocks<CM>())
geometry_large_kernel(const T* __restrict__ logits, long long sb, long long sy, long long sx,
                      long long sc, geometry::Phase ph, int* labels, int* rootvals, int* slots,
                      int* minx, int* maxx,
                      int* nroots, float* __restrict__ areas, float* __restrict__ det_sums,
                      float* __restrict__ cls_sums, int* counts, int* lists, float* tpart,
                      int* tcnt, int* ext, tiled::Plan pl, float thr, int connectivity) {
  extern __shared__ int sm[];
  cg::grid_group grid = cg::this_grid();
  const int B = pl.B, H = pl.H, K = pl.K, C = pl.C;
  const long long N = static_cast<long long>(H) * pl.W;
  const bool eight = connectivity == 8;
  const long long gtid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long gstride = static_cast<long long>(gridDim.x) * blockDim.x;
  auto det_of = [&](long long b) { return geometry::Plane<T>{logits + b * sb, sy, sx, ph}; };

  // 1. the CCL's tiles
  const int ctx = (pl.W + pl.tile_w - 1) / pl.tile_w;
  const int ctiles = ctx * ((H + pl.tile_h - 1) / pl.tile_h);
  for (int it = blockIdx.x; it < B * ctiles; it += gridDim.x) {
    const int b = it / ctiles;
    const int t = it - b * ctiles;
    __syncthreads();  // lab_s is the next tile's
    tiled::ccl_tile(det_of(b), labels + b * N, t % ctx, t / ctx, pl, thr, eight, sm);
  }
  grid.sync();

  // 2. the seams
  for (int it = blockIdx.x; it < B * ctiles; it += gridDim.x) {
    const int b = it / ctiles;
    const int t = it - b * ctiles;
    tiled::ccl_seam(labels + b * N, t % ctx, t / ctx, pl, eight);
  }
  grid.sync();

  // 3. the flatten; the chunks' roots (a root's label is its own index
  // before and after the flatten, so the two overlap)
  tiled::ccl_flatten(labels, gtid, gstride, B * N, static_cast<int>(N));
  for (int it = blockIdx.x; it < B * pl.nchunks; it += gridDim.x) {
    const int b = it / pl.nchunks;
    __syncthreads();  // the scratch is the next chunk's
    const tiled::CoherentLabels lab{labels + b * N};
    tiled::roots_chunk(det_of(b), lab, it - b * pl.nchunks, static_cast<int>(N), pl.W, K,
                       pl.chunk, thr, counts + it, lists + static_cast<long long>(it) * K, sm);
  }
  grid.sync();

  // 4. the pixel pass over the bands
  for (int it = blockIdx.x; it < B * pl.bands; it += gridDim.x) {
    const int b = it / pl.bands;
    const geometry::Logits<T> lg{logits + b * sb, sy, sx, sc, C, ph};
    const tiled::CoherentLabels lab{labels + b * N};
    __syncthreads();  // the roots, partials and extremes are the next band's
    tiled::slots_pass<CM>(lg, lab, counts + static_cast<long long>(b) * pl.nchunks,
                          lists + static_cast<long long>(b) * pl.nchunks * K, rootvals + b * K,
                          nroots + b, slots + b * N, minx + static_cast<long long>(b) * K * H,
                          maxx + static_cast<long long>(b) * K * H,
                          tpart + static_cast<long long>(it) * K * C,
                          tcnt + static_cast<long long>(it) * K,
                          ext + static_cast<long long>(it) * 2 * K * pl.tile_rows, it - b * pl.bands,
                          pl, thr, sm);
  }
  grid.sync();

  // 5. the sums over the bands
  for (int it = blockIdx.x; it < B * pl.fin_blocks; it += gridDim.x) {
    const long long b = it / pl.fin_blocks;
    __syncthreads();  // the scratch is the next group's
    tiled::slots_finish(tpart + b * pl.bands * K * C, tcnt + b * pl.bands * K, areas + b * K,
                        det_sums + b * K, cls_sums + b * K * max(C - 1, 1),
                        static_cast<int>(it - b * pl.fin_blocks), K, C, pl.bands, sm);
  }
}

// The large maps' K12c: the outputs of component_slots (postproc_kernel.cu)
// through one cooperative launch of as many blocks as the card holds at
// once (at most one a work item of the largest phase), at the plan's
// geometry (``plan``: tiled_plan's nplan ints, tiled.cuh Plan).
// Workspaces from the caller: ``labels`` B*H*W ints and the scratch of
// component_slots_tiled (``counts``, ``lists``, ``tpart``, ``tcnt``).
template <class T>
int geometry_large_launch(const void* logits, long long sb, long long sy, long long sx,
                          long long sc, geometry::Phase ph, void* rootvals, void* slots,
                          void* minx, void* maxx,
                          void* nroots, void* areas, void* det_sums, void* cls_sums, void* labels,
                          void* counts, void* lists, void* tpart, void* tcnt, void* ext,
                          const int* plan, int nplan, float thr, int connectivity,
                          void* stream) {
  tiled::Plan pl;
  if (!tiled::read_plan(plan, nplan, &pl)) return cudaErrorInvalidValue;
  const size_t smem = tiled::large_smem(pl);
  const long long ctiles = static_cast<long long>((pl.W + pl.tile_w - 1) / pl.tile_w) *
                           ((pl.H + pl.tile_h - 1) / pl.tile_h);
  long long most = ctiles > pl.nchunks ? ctiles : pl.nchunks;
  most = most > pl.bands ? most : pl.bands;
  const long long work = pl.B * most;
  return geometry::with_channel_bound(pl.C, [&](auto cm) {
    constexpr int CM = decltype(cm)::value;
    auto kernel = geometry_large_kernel<CM, T>;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return static_cast<int>(e);
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kLargeThreads,
                                                           smem)) != cudaSuccess)
      return static_cast<int>(e);
    if (per_sm <= 0) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    const long long resident = static_cast<long long>(per_sm) * sms;
    const unsigned grid = static_cast<unsigned>(work < resident ? work : resident);
    const T* lg = static_cast<const T*>(logits);
    int* lab = static_cast<int*>(labels);
    int* roots = static_cast<int*>(rootvals);
    int* sl = static_cast<int*>(slots);
    int* mn = static_cast<int*>(minx);
    int* mx = static_cast<int*>(maxx);
    int* nr = static_cast<int*>(nroots);
    float* ar = static_cast<float*>(areas);
    float* ds = static_cast<float*>(det_sums);
    float* cs = static_cast<float*>(cls_sums);
    int* cn = static_cast<int*>(counts);
    int* li = static_cast<int*>(lists);
    float* tp = static_cast<float*>(tpart);
    int* tc = static_cast<int*>(tcnt);
    int* ex = static_cast<int*>(ext);
    void* args[] = {&lg, &sb, &sy, &sx, &sc, &ph, &lab, &roots, &sl, &mn, &mx, &nr, &ar, &ds,
                    &cs, &cn, &li, &tp, &tc, &ex, &pl, &thr, &connectivity};
    e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                    dim3(kLargeThreads), args, smem,
                                    static_cast<cudaStream_t>(stream));
    if (e != cudaSuccess) return static_cast<int>(e);
    return launch_status();
  });
}

}  // namespace

// The clusters of ``blocks`` blocks of K12c the card runs at once, into
// *room (geometry_room above).
extern "C" int geometry_compat_room(int C, int H, int W, int K, int threads, int blocks, int bf16,
                                    int* room) {
  return geometry_room(C, H, W, K, threads, blocks, bf16, room);
}

// logits (B, H, W, C) f32 at element strides (sb, sy, sx, sc) -> the
// outputs of component_slots (postproc_kernel.cu), at K2's plan.
extern "C" int geometry_compat(const void* logits, long long sb, long long sy, long long sx,
                               long long sc, int C, void* rootvals, void* slots, void* minx,
                               void* maxx, void* nroots, void* areas, void* det_sums,
                               void* cls_sums, int B, int H, int W, int K, int threads,
                               int blocks, float thr, int connectivity,
                               void* stream) {
  return geometry_launch<float>(logits, sb, sy, sx, sc, geometry::Phase{}, C, rootvals, slots,
                                minx, maxx, nroots, areas, det_sums, cls_sums, B, H, W, K,
                                threads, blocks, thr, connectivity, stream);
}

// The same from bf16 logits.
extern "C" int geometry_compat_bf16(const void* logits, long long sb, long long sy,
                                    long long sx, long long sc, int C, void* rootvals,
                                    void* slots, void* minx, void* maxx, void* nroots,
                                    void* areas, void* det_sums, void* cls_sums, int B, int H,
                                    int W, int K, int threads, int blocks, float thr,
                                    int connectivity, void* stream) {
  return geometry_launch<__nv_bfloat16>(logits, sb, sy, sx, sc, geometry::Phase{}, C, rootvals,
                                        slots, minx, maxx, nroots, areas, det_sums, cls_sums, B,
                                        H, W, K, threads, blocks, thr, connectivity,
                                        stream);
}

// The same from phase-major packed logits: (sb, sy, sx) step over images
// and 2x2 cells, (spy, spx) over a cell's phases, sc over channels
// (geometry.cuh Phase); H, W are the unpacked map's.
extern "C" int geometry_compat_packed(const void* logits, long long sb, long long sy,
                                      long long sx, long long sc, long long spy, long long spx,
                                      int C, void* rootvals, void* slots, void* minx, void* maxx,
                                      void* nroots, void* areas, void* det_sums, void* cls_sums,
                                      int B, int H, int W, int K, int threads, int blocks,
                                      float thr, int connectivity, void* stream) {
  return geometry_launch<float>(logits, sb, sy, sx, sc, geometry::phase_of(spy, spx), C,
                                rootvals, slots, minx, maxx, nroots, areas, det_sums, cls_sums, B,
                                H, W, K, threads, blocks, thr, connectivity, stream);
}

extern "C" int geometry_compat_packed_bf16(const void* logits, long long sb, long long sy,
                                           long long sx, long long sc, long long spy,
                                           long long spx, int C, void* rootvals, void* slots,
                                           void* minx, void* maxx, void* nroots, void* areas,
                                           void* det_sums, void* cls_sums, int B, int H, int W,
                                           int K, int threads, int blocks, float thr,
                                           int connectivity, void* stream) {
  return geometry_launch<__nv_bfloat16>(logits, sb, sy, sx, sc, geometry::phase_of(spy, spx), C,
                                        rootvals, slots, minx, maxx, nroots, areas, det_sums,
                                        cls_sums, B, H, W, K, threads, blocks, thr,
                                        connectivity, stream);
}

// The same for maps of any size (H*W < 2^30), in one cooperative launch
// (geometry_large_launch above), equal to ccl_labels_tiled then
// component_slots_tiled at the same plan bit for bit.
extern "C" int geometry_compat_large(const void* logits, long long sb, long long sy,
                                     long long sx, long long sc, void* rootvals, void* slots,
                                     void* minx, void* maxx, void* nroots, void* areas,
                                     void* det_sums, void* cls_sums, void* labels, void* counts,
                                     void* lists, void* tpart, void* tcnt, void* ext,
                                     const int* plan, int nplan, float thr, int connectivity,
                                     void* stream) {
  return geometry_large_launch<float>(logits, sb, sy, sx, sc, geometry::Phase{}, rootvals,
                                      slots, minx, maxx, nroots, areas, det_sums, cls_sums,
                                      labels, counts, lists, tpart, tcnt, ext, plan, nplan, thr,
                                      connectivity, stream);
}

// The same from bf16 logits.
extern "C" int geometry_compat_large_bf16(const void* logits, long long sb, long long sy,
                                          long long sx, long long sc, void* rootvals,
                                          void* slots, void* minx, void* maxx, void* nroots,
                                          void* areas, void* det_sums, void* cls_sums,
                                          void* labels, void* counts, void* lists, void* tpart,
                                          void* tcnt, void* ext, const int* plan, int nplan,
                                          float thr, int connectivity, void* stream) {
  return geometry_large_launch<__nv_bfloat16>(logits, sb, sy, sx, sc, geometry::Phase{},
                                              rootvals, slots, minx, maxx, nroots, areas,
                                              det_sums, cls_sums, labels, counts, lists, tpart,
                                              tcnt, ext, plan, nplan, thr, connectivity, stream);
}

// The same from phase-major packed logits (geometry_compat_packed's
// strides).
extern "C" int geometry_compat_large_packed(
    const void* logits, long long sb, long long sy, long long sx, long long sc, long long spy,
    long long spx, void* rootvals, void* slots, void* minx, void* maxx, void* nroots,
    void* areas, void* det_sums, void* cls_sums, void* labels, void* counts, void* lists,
    void* tpart, void* tcnt, void* ext, const int* plan, int nplan, float thr, int connectivity,
    void* stream) {
  return geometry_large_launch<float>(logits, sb, sy, sx, sc, geometry::phase_of(spy, spx),
                                      rootvals, slots, minx, maxx, nroots, areas, det_sums,
                                      cls_sums, labels, counts, lists, tpart, tcnt, ext, plan,
                                      nplan, thr, connectivity, stream);
}

extern "C" int geometry_compat_large_packed_bf16(
    const void* logits, long long sb, long long sy, long long sx, long long sc, long long spy,
    long long spx, void* rootvals, void* slots, void* minx, void* maxx, void* nroots,
    void* areas, void* det_sums, void* cls_sums, void* labels, void* counts, void* lists,
    void* tpart, void* tcnt, void* ext, const int* plan, int nplan, float thr, int connectivity,
    void* stream) {
  return geometry_large_launch<__nv_bfloat16>(logits, sb, sy, sx, sc,
                                              geometry::phase_of(spy, spx), rootvals, slots,
                                              minx, maxx, nroots, areas, det_sums, cls_sums,
                                              labels, counts, lists, tpart, tcnt, ext, plan,
                                              nplan, thr, connectivity, stream);
}
