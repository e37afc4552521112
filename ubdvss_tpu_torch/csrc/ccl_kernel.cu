// Threshold + connected-component labelling of detection-logit maps.
//
// Replaces the TPU kernel _ccl_kernel (ubdvss_tpu/ops/pallas/
// ccl_kernel.py:116).  Output contract is the same: every foreground pixel
// (logit > thr) holds the minimum linear index of its 8-connected (or
// 4-connected) component, background holds H*W.
//
// Two routes, chosen by the wrapper from the map's size:
//
// ccl_labels (one block a map): the whole int32 label map lives in dynamic
// shared memory (64 KB at 128x128), where geometry::ccl_labels_shared
// (geometry.cuh, shared with the fused K12c kernel) runs union-find in three
// passes (initialise, merge by shared-memory atomicMin, flatten), however
// long the components are.  Bound on this card: the input and output are
// 8 B per pixel (8.4 MB at B=64, 128x128, ~2.5 us at 3.35 TB/s).  One block
// per map puts 64 blocks on the 132 SMs at B=64, and the merge's find walks
// and atomics run at shared-memory latency; even so it beats the tiled
// kernel below on the batched 128² and 60x80 maps of the 512² path and the
// QVGA stream (H100, scripts/torch_kernel_ab.py), so the wrapper keeps it
// for every map it can hold.
//
// ccl_labels_tiled (maps larger than one block's shared memory, 232,448 B
// of labels: a 2048² scan's 512² map is 1 MiB, a 4096² scan's 4 MiB).  The
// TPU kernel holds such a map in VMEM; here the labels live in device
// memory and union-find runs in three launches (the block-based
// union-find of Allegretti, Bolelli & Grana, IEEE TPDS 2019), at the
// geometry of ops/cuda/postproc_kernel.py tiled_plan (tiled.cuh Plan):
//   1. tiles: one block a tile (32x64, 512 threads) labels it in shared
//      memory with the same three passes, and writes each pixel the GLOBAL
//      linear index of its tile-component's root.  Within a tile, raster
//      order of (row, column) is the same locally and globally, so that
//      root is the smallest global index of the tile-component;
//   2. seams: one block a tile unites each foreground pixel on the tile's
//      top row and side columns with the neighbours in other tiles that
//      the merge's decision tree would unite it with on the whole map (N
//      alone when N is foreground, else W or NW, and NE), by
//      geometry::union_roots on device memory: atomicMin on roots, so a
//      root is always the smaller index, and a union that finds its root
//      relinked meanwhile retries from there;
//   3. flatten: four pixels a thread (one 16-byte load), each foreground
//      pixel's root found with plain loads and written only where it
//      moved.
// The passes' bodies are tiled.cuh's, which the large K12c
// (geometry_kernel.cu) runs in one launch.  Every union of the decision
// tree on the whole map is made by pass 1 (same tile) or pass 2 (across a
// seam), and links only ever point to smaller indices, so each component's
// root is its minimum linear index.  Bound: 8 B a pixel (the logits read,
// the labels written; 16.8 MB at B=8, 512x512, ~5 us).  What the card
// spends beyond it (PERF.md §6, PR 12): pass 1 is three syncs and the
// union-find's chains of shared-memory atomics a tile, two waves of tiles;
// passes 2 and 3 are chains of dependent device-memory reads.
//
// Each route reads f32 or bf16 logits (``_bf16`` entry points: the bf16
// route's trunk output, 6 B a pixel); a logit is widened to f32 exactly and
// compared with the f32 threshold logit, so the labels are those of the
// f32 copy of the same logits.
#include "common.cuh"
#include "geometry.cuh"
#include "tiled.cuh"

namespace {

constexpr int kThreads = 1024;

template <class T>
__global__ void __launch_bounds__(kThreads)
ccl_kernel(const T* __restrict__ logits, int* __restrict__ labels, int H, int W, float thr,
           int connectivity) {
  extern __shared__ int lab_s[];
  const int N = H * W;
  const T* lg = logits + static_cast<long long>(blockIdx.x) * N;
  int* out = labels + static_cast<long long>(blockIdx.x) * N;
  geometry::ccl_labels_shared(lg, lab_s, H, W, thr, connectivity == 8);
  for (int p = threadIdx.x; p < N; p += blockDim.x) out[p] = lab_s[p];
}

constexpr int kFlattenThreads = 256;

// Pass 1: block (tile x, tile y, image); the tile's labels in dynamic
// shared memory.
template <class T>
__global__ void __launch_bounds__(1024)
ccl_tile_kernel(const T* __restrict__ logits, int* __restrict__ labels, tiled::Plan pl, float thr,
                int connectivity) {
  extern __shared__ int lab_s[];
  const long long N = static_cast<long long>(pl.H) * pl.W;
  const geometry::Plane<T> det{logits + blockIdx.z * N, pl.W, 1};
  tiled::ccl_tile(det, labels + blockIdx.z * N, blockIdx.x, blockIdx.y, pl, thr,
                  connectivity == 8, lab_s);
}

// Pass 2: block (tile x, tile y, image).
__global__ void __launch_bounds__(1024)
ccl_seam_kernel(int* __restrict__ labels, tiled::Plan pl, int connectivity) {
  tiled::ccl_seam(labels + blockIdx.z * static_cast<long long>(pl.H) * pl.W, blockIdx.x,
                  blockIdx.y, pl, connectivity == 8);
}

// Pass 3: a group of four pixels a thread.
__global__ void __launch_bounds__(kFlattenThreads)
ccl_flatten_kernel(int* __restrict__ labels, long long total, int N) {
  tiled::ccl_flatten(labels, static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x,
                     static_cast<long long>(gridDim.x) * blockDim.x, total, N);
}

template <class T>
int labels_one_block(const void* logits, void* labels, int B, int H, int W, float thr,
                     int connectivity, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(H) * W * sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      ccl_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  ccl_kernel<T><<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(logits), static_cast<int*>(labels), H, W, thr, connectivity);
  return launch_status();
}

template <class T>
int labels_tiled(const void* logits, void* labels, const int* plan, int nplan, float thr,
                 int connectivity, void* stream) {
  tiled::Plan pl;
  if (!tiled::read_plan(plan, nplan, &pl) || pl.B > 65535) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto lab = static_cast<int*>(labels);
  const dim3 tiles((pl.W + pl.tile_w - 1) / pl.tile_w, (pl.H + pl.tile_h - 1) / pl.tile_h, pl.B);
  const size_t smem = tiled::ccl_tile_smem(pl);
  cudaError_t a = cudaFuncSetAttribute(ccl_tile_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (a != cudaSuccess) return static_cast<int>(a);
  ccl_tile_kernel<T><<<tiles, pl.ccl_threads, smem, s>>>(static_cast<const T*>(logits), lab, pl,
                                                        thr, connectivity);
  int e = launch_status();
  if (e != 0) return e;
  ccl_seam_kernel<<<tiles, pl.seam_threads, 0, s>>>(lab, pl, connectivity);
  e = launch_status();
  if (e != 0) return e;
  const long long total = static_cast<long long>(pl.B) * pl.H * pl.W;
  const long long groups = (total + 3) / 4;
  const long long blocks = (groups + kFlattenThreads - 1) / kFlattenThreads;
  ccl_flatten_kernel<<<static_cast<unsigned>(blocks < (1 << 20) ? blocks : (1 << 20)),
                       kFlattenThreads, 0, s>>>(lab, total, pl.H * pl.W);
  return launch_status();
}

}  // namespace

// logits (B, H, W) f32 -> labels (B, H, W) int32; H*W*4 bytes of shared
// memory per block (the caller keeps it within the card's 227 KB).
extern "C" int ccl_labels(const void* logits, void* labels, int B, int H, int W, float thr,
                          int connectivity, void* stream) {
  return labels_one_block<float>(logits, labels, B, H, W, thr, connectivity, stream);
}

// The same from bf16 logits.
extern "C" int ccl_labels_bf16(const void* logits, void* labels, int B, int H, int W, float thr,
                               int connectivity, void* stream) {
  return labels_one_block<__nv_bfloat16>(logits, labels, B, H, W, thr, connectivity, stream);
}

// The same contract for maps of any size up to H*W < 2^30 (B <= 65535):
// the labels are built in place in ``labels`` by three launches, whose
// geometry is the plan's (``plan``: tiled_plan's nplan ints, tiled.cuh
// Plan).
extern "C" int ccl_labels_tiled(const void* logits, void* labels, const int* plan, int nplan,
                                float thr, int connectivity, void* stream) {
  return labels_tiled<float>(logits, labels, plan, nplan, thr, connectivity, stream);
}

// The same from bf16 logits.
extern "C" int ccl_labels_tiled_bf16(const void* logits, void* labels, const int* plan,
                                     int nplan, float thr, int connectivity, void* stream) {
  return labels_tiled<__nv_bfloat16>(logits, labels, plan, nplan, thr, connectivity, stream);
}
