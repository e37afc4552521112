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
// union-find of Allegretti, Bolelli & Grana, IEEE TPDS 2019):
//   1. tiles: one block a 32x64 tile labels it in shared memory with the
//      same three passes, and writes each pixel the GLOBAL linear index of
//      its tile-component's root.  Within a tile, raster order of (row,
//      column) is the same locally and globally, so that root is the
//      smallest global index of the tile-component;
//   2. seams: one block a tile unites every foreground pixel on the tile's
//      top row and left and right columns with each foreground neighbour
//      that lies in another tile and comes earlier in raster order (W, N,
//      and under 8-connectivity NW and NE, which reach the diagonal tiles
//      at corners), by geometry::union_roots on device memory: atomicMin on
//      roots, so a root is always the smaller index, and a union that finds
//      its root relinked meanwhile retries from there;
//   3. flatten: every foreground pixel takes find(p).
// The passes' bodies are tiled.cuh's, which the large K12c
// (geometry_kernel.cu) runs in one launch.
// Every pair of neighbouring pixels is joined by pass 1 (same tile) or
// pass 2 (different tiles), and links only ever point to smaller indices,
// so each component's root is its minimum linear index.  Bound: 8 B a
// pixel (the logits read, the labels written; 16.8 MB at B=8, 512x512,
// ~5 us); passes 2 and 3 reread the labels of the seams and the
// foreground.
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

constexpr int kTileThreads = 512;
constexpr int kSeamThreads = 128;
constexpr int kFlattenThreads = 256;

// Pass 1: block (tile x, tile y, image).
template <class T>
__global__ void __launch_bounds__(kTileThreads)
ccl_tile_kernel(const T* __restrict__ logits, int* __restrict__ labels, int H, int W, float thr,
                int connectivity) {
  __shared__ int lab_s[tiled::kTileH * tiled::kTileW];
  const long long N = static_cast<long long>(H) * W;
  const geometry::Plane<T> det{logits + blockIdx.z * N, W, 1};
  tiled::ccl_tile(det, labels + blockIdx.z * N, blockIdx.x, blockIdx.y, H, W, thr,
                  connectivity == 8, lab_s);
}

// Pass 2: block (tile x, tile y, image); the tile's top row, then its left
// and right columns.
__global__ void __launch_bounds__(kSeamThreads)
ccl_seam_kernel(int* __restrict__ labels, int H, int W, int connectivity) {
  tiled::ccl_seam(labels + blockIdx.z * static_cast<long long>(H) * W, blockIdx.x, blockIdx.y, H,
                  W, connectivity == 8);
}

// Pass 3: grid-stride over every pixel of the batch.
__global__ void __launch_bounds__(kFlattenThreads)
ccl_flatten_kernel(int* __restrict__ labels, long long total, int N) {
  tiled::ccl_flatten(labels, static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x, total,
                     static_cast<long long>(gridDim.x) * blockDim.x, N);
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
int labels_tiled(const void* logits, void* labels, int B, int H, int W, float thr,
                 int connectivity, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || B > 65535 ||
      static_cast<long long>(H) * W >= (1LL << 30))
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto lab = static_cast<int*>(labels);
  const dim3 tiles((W + tiled::kTileW - 1) / tiled::kTileW, (H + tiled::kTileH - 1) / tiled::kTileH,
                   B);
  ccl_tile_kernel<T><<<tiles, kTileThreads, 0, s>>>(static_cast<const T*>(logits), lab, H, W,
                                                    thr, connectivity);
  int e = launch_status();
  if (e != 0) return e;
  ccl_seam_kernel<<<tiles, kSeamThreads, 0, s>>>(lab, H, W, connectivity);
  e = launch_status();
  if (e != 0) return e;
  const long long total = static_cast<long long>(B) * H * W;
  const long long blocks = (total + kFlattenThreads - 1) / kFlattenThreads;
  ccl_flatten_kernel<<<static_cast<unsigned>(blocks < 8192 ? blocks : 8192), kFlattenThreads, 0,
                       s>>>(lab, total, H * W);
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
// the labels are built in place in ``labels`` by three launches.
extern "C" int ccl_labels_tiled(const void* logits, void* labels, int B, int H, int W, float thr,
                                int connectivity, void* stream) {
  return labels_tiled<float>(logits, labels, B, H, W, thr, connectivity, stream);
}

// The same from bf16 logits.
extern "C" int ccl_labels_tiled_bf16(const void* logits, void* labels, int B, int H, int W,
                                     float thr, int connectivity, void* stream) {
  return labels_tiled<__nv_bfloat16>(logits, labels, B, H, W, thr, connectivity, stream);
}
