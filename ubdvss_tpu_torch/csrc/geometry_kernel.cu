// The whole component geometry of one image in one cluster of two blocks:
// threshold + CCL (union-find), then the root count, the K smallest roots,
// the slot map, each slot's per-row x extremes and its stats.
//
// Replaces the TPU kernel _geometry_kernel_compat (ubdvss_tpu/ops/pallas/
// postproc_kernel.py:50), which the JAX package runs instead of its CCL and
// slots kernels under UBDVSS_PALLAS_COMPAT=1.  Its outputs are those of
// K2 after K1, bit for bit: the same phases of geometry.cuh, with the label
// map kept in shared memory, so the labels never go to device memory.
//
// One cluster of geometry::kSlotCtas (2) blocks per image, as K2, so that
// B=64 images fill 128 of the 132 SMs:
//   1. each block holds half of the image's label rows (block 0 rows
//      [0, S), block 1 rows [S, H), S = ceil(H/2)) in its shared memory and
//      runs the union-find's initialise and merge passes on them;
//   2. block 1 merges the seam rows S-1 and S across the cluster: its
//      unions reach block 0's words through distributed shared memory
//      (cluster.map_shared_rank; atomicMin on the peer's words).  A root is
//      always the smaller linear index, so block 1's components link into
//      block 0's and never the other way;
//   3. each block flattens its rows (a find may walk into block 0);
//   4. each block ranks the roots of its rows; block 0's come first in
//      raster order, so the image's K smallest are block 0's list, then
//      block 1's, which each block reads from the other;
//   5. each block runs K2's virtual warps rank * nw ... of the pixel pass,
//      on labels read from whichever block holds the row, and block 0
//      finishes as K2 does, with block 1's extremes and stats partials.
// The same warp count as K2 (the caller's ``threads``), the same virtual
// warps and the same order of sums give K2's stats bit for bit.  Like K1
// it reaches the true components, with no round cap.  The detection logits
// are read at the head's strides, as K2 reads them.
//
// Shared memory a block: S*W + 2K + 1 + 2*K*H words (labels of its rows,
// the roots, its own ranked roots and count, the extremes; 49 KB at
// 128x128, K=16), plus (K, C+1) words per warp of stats partials; the
// caller picks the warps so that it stays within the card's 227 KB.
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
// persistent blocks that run the phases of the device-memory CCL and the
// tiled slots (tiled.cuh, the bodies ccl_labels_tiled and
// component_slots_tiled launch one kernel each) in order, each block
// looping over a phase's work items, with a grid-wide barrier
// (cooperative_groups grid sync) between phases:
//   1. the CCL's tiles (32x64, in shared memory), and the extremes set to
//      their empty values;
//   2. the seams between tiles, union-find on device memory;
//   3. the flatten, and each raster chunk's root count (a root's label is
//      its own index before and after the flatten, so the two overlap);
//   4. the roots ranked chunk by chunk: rootvals, nroots;
//   5. the pixel pass over the tiled slots' tiles (SLOTS_TILE_ROWS rows by
//      32 * nw columns, the same nw), slots, extremes by integer atomics,
//      each tile's stats partials;
//   6. each (slot, channel) sum over the tiles in order, and the padding
//      slots' copies of the background's extremes.
// The labels (a device-memory workspace) are canonical, and the tiles,
// partials and finish order are component_slots_tiled's, so the eight
// outputs equal ccl_labels_tiled then component_slots_tiled bit for bit, in
// f32 and bf16: past geometry_compat_fits the compat route's detections are
// the default route's.  The labels are read with plain loads (other blocks
// wrote them earlier in the launch).  Bound: the tiled pair's bytes (8 B a
// pixel of logit read and slot written, the class logits of the pixels in
// a slot, the extremes); the barriers cost a few microseconds each.
#include <cooperative_groups.h>

#include "common.cuh"
#include "geometry.cuh"
#include "tiled.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 1024;

template <int CM, class T>
__global__ void __cluster_dims__(geometry::kSlotCtas, 1, 1) __launch_bounds__(kThreads)
geometry_kernel(const T* __restrict__ logits, long long sb, long long sy, long long sx,
                long long sc, int C, int* __restrict__ rootvals, int* __restrict__ slots,
                int* __restrict__ minx, int* __restrict__ maxx, int* __restrict__ nroots,
                float* __restrict__ areas, float* __restrict__ det_sums,
                float* __restrict__ cls_sums, int H, int W, int K, float thr,
                int connectivity) {
  extern __shared__ int sm[];
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
  const geometry::Logits<T> lg{logits + b * sb, sy, sx, sc, C};
  const geometry::Plane<T> det{lg.p, sy, sx};
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

  // 4. the roots: each block ranks its rows', then joins the two lists
  const int nw = blockDim.x >> 5;
  const geometry::SlotSmem s(sm + split, K, H, C, nw);
  int* ranked = s.cnt + nw * K;  // K roots of this block's rows, then their count
  const geometry::SplitView view{lo, hi, split};
  const int count = geometry::slot_roots(det, view, s, ranked, p0, p1, H, W, K, C, nw, thr);
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

  // 5. K2's pixel pass and finish
  geometry::slot_pass<CM>(det, lg, view, s, H, W, K, thr, c0 + c1, rank * nw, 1,
                          geometry::kSlotCtas * nw, slots + b * N);
  cluster.sync();
  if (rank == 0) {
    const geometry::SlotSmem o(cluster.map_shared_rank(sm, 1) + split, K, H, C, nw);
    for (int i = threadIdx.x; i < K * H; i += blockDim.x) {
      s.mn[i] = min(s.mn[i], o.mn[i]);
      s.mx[i] = max(s.mx[i], o.mx[i]);
    }
    __syncthreads();
    geometry::slot_finish(s, o.part, o.cnt, H, K, C, c0 + c1, geometry::kSlotCtas * nw,
                          rootvals + b * K, minx + b * K * H, maxx + b * K * H, nroots + b,
                          areas + b * K, det_sums + b * K, cls_sums + b * K * max(C - 1, 1));
  }
  cluster.sync();  // block 1's shared memory lives until block 0 has read it
}

// logits (B, H, W, C) at element strides (sb, sy, sx, sc) -> the outputs
// of component_slots (postproc_kernel.cu).  ``threads`` is that of one of
// K2's blocks.
template <class T>
int geometry_launch(const void* logits, long long sb, long long sy, long long sx, long long sc,
                    int C, void* rootvals, void* slots, void* minx, void* maxx, void* nroots,
                    void* areas, void* det_sums, void* cls_sums, int B, int H, int W, int K,
                    int threads, float thr, int connectivity, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || K <= 0 || C <= 0 || threads <= 0 ||
      threads > kThreads || threads % 32 != 0)
    return cudaErrorInvalidValue;
  const size_t smem =
      (static_cast<size_t>((H + 1) / 2) * W + 2 * static_cast<size_t>(K) + 1 +
       2 * static_cast<size_t>(K) * H) * sizeof(int) +
      static_cast<size_t>(threads / 32) * K * (C + 1) * sizeof(float);
  return geometry::with_channel_bound(C, [&](auto cm) {
    constexpr int CM = decltype(cm)::value;
    cudaError_t e = cudaFuncSetAttribute(
        geometry_kernel<CM, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    geometry_kernel<CM, T><<<geometry::kSlotCtas * B, threads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(logits), sb, sy, sx, sc, C, static_cast<int*>(rootvals),
        static_cast<int*>(slots), static_cast<int*>(minx), static_cast<int*>(maxx),
        static_cast<int*>(nroots), static_cast<float*>(areas),
        static_cast<float*>(det_sums), static_cast<float*>(cls_sums), H, W, K, thr,
        connectivity);
    return launch_status();
  });
}

constexpr int kLargeThreads = 256;  // component_slots_tiled's pass blocks, at most

// The large maps' K12c: every phase of the tiled pair in one launch.
// ``labels`` (B, H, W), ``counts`` (B, nchunks), ``tpart`` (B, tiles, K, C)
// and ``tcnt`` (B, tiles, K) are workspaces; nw is the pass tiles' warps.
// None of the pointers the launch writes and reads again is __restrict__
// const, so no load of them takes the read-only cache.
template <int CM, class T>
__global__ void __launch_bounds__(kLargeThreads)
geometry_large_kernel(const T* __restrict__ logits, long long sb, long long sy, long long sx,
                      long long sc, int C, int* labels, int* rootvals, int* slots, int* minx,
                      int* maxx, int* nroots, float* __restrict__ areas,
                      float* __restrict__ det_sums, float* __restrict__ cls_sums, int* counts,
                      float* tpart, int* tcnt, int B, int H, int W, int K, int nw, int chunk,
                      int tile_rows, float thr, int connectivity) {
  extern __shared__ int sm[];
  cg::grid_group grid = cg::this_grid();
  const long long N = static_cast<long long>(H) * W;
  const bool eight = connectivity == 8;
  const long long gtid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long gstride = static_cast<long long>(gridDim.x) * blockDim.x;
  auto det_of = [&](long long b) { return geometry::Plane<T>{logits + b * sb, sy, sx}; };

  // 1. the CCL's tiles; the extremes' empty values
  const int ctx = (W + tiled::kTileW - 1) / tiled::kTileW;
  const int cty = (H + tiled::kTileH - 1) / tiled::kTileH;
  const int ctiles = ctx * cty;
  for (int it = blockIdx.x; it < B * ctiles; it += gridDim.x) {
    const int b = it / ctiles;
    const int t = it - b * ctiles;
    __syncthreads();  // lab_s is the next tile's
    tiled::ccl_tile(det_of(b), labels + b * N, t % ctx, t / ctx, H, W, thr, eight, sm);
  }
  for (long long i = gtid; i < static_cast<long long>(B) * K * H; i += gstride) {
    minx[i] = geometry::kBig;
    maxx[i] = -1;
  }
  grid.sync();

  // 2. the seams
  for (int it = blockIdx.x; it < B * ctiles; it += gridDim.x) {
    const int b = it / ctiles;
    const int t = it - b * ctiles;
    tiled::ccl_seam(labels + b * N, t % ctx, t / ctx, H, W, eight);
  }
  grid.sync();

  // 3. the flatten; the chunks' root counts
  tiled::ccl_flatten(labels, gtid, B * N, gstride, static_cast<int>(N));
  const int nchunks = static_cast<int>((N + chunk - 1) / chunk);
  for (int it = blockIdx.x; it < B * nchunks; it += gridDim.x) {
    const int b = it / nchunks;
    const int c = it - b * nchunks;
    const tiled::CoherentLabels lab{labels + b * N};
    const int cnt = tiled::roots_count(det_of(b), lab, c, H, W, chunk, thr);
    if (threadIdx.x == 0) counts[it] = cnt;
  }
  grid.sync();

  // 4. the ranks
  for (int it = blockIdx.x; it < B * nchunks; it += gridDim.x) {
    const int b = it / nchunks;
    const int c = it - b * nchunks;
    const tiled::CoherentLabels lab{labels + b * N};
    __syncthreads();  // the block sums' slots are the next chunk's
    tiled::roots_rank(det_of(b), lab, counts + b * nchunks, c, nchunks, rootvals + b * K,
                      nroots + b, H, W, K, chunk, thr);
  }
  grid.sync();

  // 5. the pixel pass
  const int ptx = (W + 32 * nw - 1) / (32 * nw);
  const int pty = (H + tile_rows - 1) / tile_rows;
  const int ptiles = ptx * pty;
  for (int it = blockIdx.x; it < B * ptiles; it += gridDim.x) {
    const int b = it / ptiles;
    const int t = it - b * ptiles;
    const geometry::Logits<T> lg{logits + b * sb, sy, sx, sc, C};
    const tiled::CoherentLabels lab{labels + b * N};
    __syncthreads();  // the roots and partials are the next tile's
    tiled::slots_tile<CM>(lg, lab, rootvals + b * K, nroots[b], slots + b * N, minx + b * K * H,
                          maxx + b * K * H, tpart + static_cast<long long>(it) * K * C,
                          tcnt + static_cast<long long>(it) * K, t % ptx, t / ptx, nw, H, W, K,
                          tile_rows, thr, sm);
  }
  grid.sync();

  // 6. the sums over the tiles; the padding slots' extremes
  const int items = K * C + K;
  for (long long i = gtid; i < static_cast<long long>(B) * items; i += gstride) {
    const long long b = i / items;
    tiled::slots_finish_sum(tpart + b * ptiles * K * C, tcnt + b * ptiles * K, areas + b * K,
                            det_sums + b * K, cls_sums + b * K * max(C - 1, 1),
                            static_cast<int>(i - b * items), K, C, ptiles);
  }
  const long long pad = static_cast<long long>(K - 1) * H;
  for (long long i = gtid; i < B * pad; i += gstride) {
    const long long b = i / pad;
    const int j = static_cast<int>(i - b * pad);
    if (j >= min(nroots[b], K) * H) tiled::slots_pad_extremes(minx + b * K * H, maxx + b * K * H, j, H, K);
  }
}

// The large maps' K12c: the outputs of component_slots (postproc_kernel.cu)
// through one cooperative launch of as many blocks as the card holds at
// once (at most one a work item of the largest phase).  Workspaces from the
// caller: ``labels`` B*H*W ints, ``counts`` B * ceil(H*W / chunk) ints,
// ``tpart`` B * tiles * K * C floats and ``tcnt`` B * tiles * K ints, where
// tiles = ceil(W / (32 * nw)) * ceil(H / tile_rows).
template <class T>
int geometry_large_launch(const void* logits, long long sb, long long sy, long long sx,
                          long long sc, int C, void* rootvals, void* slots, void* minx,
                          void* maxx, void* nroots, void* areas, void* det_sums, void* cls_sums,
                          void* labels, void* counts, void* tpart, void* tcnt, int B, int H,
                          int W, int K, int nw, int chunk, int tile_rows, float thr,
                          int connectivity, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || K <= 0 || C <= 0 || nw <= 0 || 32 * nw > kLargeThreads ||
      chunk <= 0 || tile_rows <= 0 || static_cast<long long>(H) * W >= (1LL << 30))
    return cudaErrorInvalidValue;
  const size_t pass_smem = (static_cast<size_t>(K) + static_cast<size_t>(nw) * K * (C + 1)) *
                           sizeof(int);
  const size_t tile_smem = static_cast<size_t>(tiled::kTileH) * tiled::kTileW * sizeof(int);
  const size_t smem = pass_smem > tile_smem ? pass_smem : tile_smem;
  const long long N = static_cast<long long>(H) * W;
  const long long ctiles = static_cast<long long>((W + tiled::kTileW - 1) / tiled::kTileW) *
                           ((H + tiled::kTileH - 1) / tiled::kTileH);
  const long long work = B * ((ctiles > (N + chunk - 1) / chunk) ? ctiles : (N + chunk - 1) / chunk);
  return geometry::with_channel_bound(C, [&](auto cm) {
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
    float* tp = static_cast<float*>(tpart);
    int* tc = static_cast<int*>(tcnt);
    void* args[] = {&lg, &sb, &sy, &sx, &sc, &C, &lab, &roots, &sl, &mn, &mx, &nr, &ar, &ds,
                    &cs, &cn, &tp, &tc, &B, &H, &W, &K, &nw, &chunk, &tile_rows, &thr,
                    &connectivity};
    e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                    dim3(kLargeThreads), args, smem,
                                    static_cast<cudaStream_t>(stream));
    if (e != cudaSuccess) return static_cast<int>(e);
    return launch_status();
  });
}

}  // namespace

// logits (B, H, W, C) f32 at element strides (sb, sy, sx, sc) -> the
// outputs of component_slots (postproc_kernel.cu).
extern "C" int geometry_compat(const void* logits, long long sb, long long sy, long long sx,
                               long long sc, int C, void* rootvals, void* slots, void* minx,
                               void* maxx, void* nroots, void* areas, void* det_sums,
                               void* cls_sums, int B, int H, int W, int K, int threads,
                               float thr, int connectivity, void* stream) {
  return geometry_launch<float>(logits, sb, sy, sx, sc, C, rootvals, slots, minx, maxx, nroots,
                                areas, det_sums, cls_sums, B, H, W, K, threads, thr,
                                connectivity, stream);
}

// The same from bf16 logits.
extern "C" int geometry_compat_bf16(const void* logits, long long sb, long long sy,
                                    long long sx, long long sc, int C, void* rootvals,
                                    void* slots, void* minx, void* maxx, void* nroots,
                                    void* areas, void* det_sums, void* cls_sums, int B, int H,
                                    int W, int K, int threads, float thr, int connectivity,
                                    void* stream) {
  return geometry_launch<__nv_bfloat16>(logits, sb, sy, sx, sc, C, rootvals, slots, minx,
                                        maxx, nroots, areas, det_sums, cls_sums, B, H, W, K,
                                        threads, thr, connectivity, stream);
}

// The same for maps of any size (H*W < 2^30), in one cooperative launch
// (geometry_large_launch above), equal to ccl_labels_tiled then
// component_slots_tiled bit for bit.
extern "C" int geometry_compat_large(const void* logits, long long sb, long long sy,
                                     long long sx, long long sc, int C, void* rootvals,
                                     void* slots, void* minx, void* maxx, void* nroots,
                                     void* areas, void* det_sums, void* cls_sums, void* labels,
                                     void* counts, void* tpart, void* tcnt, int B, int H, int W,
                                     int K, int nw, int chunk, int tile_rows, float thr,
                                     int connectivity, void* stream) {
  return geometry_large_launch<float>(logits, sb, sy, sx, sc, C, rootvals, slots, minx, maxx,
                                      nroots, areas, det_sums, cls_sums, labels, counts, tpart,
                                      tcnt, B, H, W, K, nw, chunk, tile_rows, thr, connectivity,
                                      stream);
}

// The same from bf16 logits.
extern "C" int geometry_compat_large_bf16(const void* logits, long long sb, long long sy,
                                          long long sx, long long sc, int C, void* rootvals,
                                          void* slots, void* minx, void* maxx, void* nroots,
                                          void* areas, void* det_sums, void* cls_sums,
                                          void* labels, void* counts, void* tpart, void* tcnt,
                                          int B, int H, int W, int K, int nw, int chunk,
                                          int tile_rows, float thr, int connectivity,
                                          void* stream) {
  return geometry_large_launch<__nv_bfloat16>(logits, sb, sy, sx, sc, C, rootvals, slots, minx,
                                              maxx, nroots, areas, det_sums, cls_sums, labels,
                                              counts, tpart, tcnt, B, H, W, K, nw, chunk,
                                              tile_rows, thr, connectivity, stream);
}
