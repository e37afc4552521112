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
// One thread block per image.  Roots (foreground pixels whose label is
// their own index) are ranked in raster order by a block-wide exclusive
// prefix sum (warp shuffles); roots of rank < K are the slots, kept
// ascending in shared memory, and each pixel finds its root's slot by
// binary search there.  Per-row extremes are shared-memory atomicMin/Max
// into (K, H) arrays.
//
// Bound on this card: 12 B per pixel of device memory (logits and labels
// read, slots written; 12.6 MB at B=64, 128x128, ~3.8 us at 3.35 TB/s).
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kBig = 1 << 30;

__global__ void __launch_bounds__(kThreads)
slots_kernel(const float* __restrict__ logits, const int* __restrict__ labels,
             int* __restrict__ rootvals, int* __restrict__ slots,
             int* __restrict__ minx, int* __restrict__ maxx,
             int* __restrict__ nroots, int H, int W, int K, float thr) {
  extern __shared__ int sm[];
  int* s_root = sm;          // K, ascending, H*W pads
  int* s_mn = sm + K;        // (K, H)
  int* s_mx = s_mn + K * H;  // (K, H)
  __shared__ int s_warp[32];
  const int N = H * W;
  const int tid = threadIdx.x;
  const long long b = blockIdx.x;
  const float* lg = logits + b * N;
  const int* lab = labels + b * N;

  for (int i = tid; i < K; i += blockDim.x) s_root[i] = N;
  for (int i = tid; i < K * H; i += blockDim.x) {
    s_mn[i] = kBig;
    s_mx[i] = -1;
  }

  // 1. count roots in a contiguous raster chunk per thread
  const int chunk = (N + blockDim.x - 1) / blockDim.x;
  const int begin = min(tid * chunk, N);
  const int end = min(begin + chunk, N);
  int cnt = 0;
  for (int p = begin; p < end; ++p) cnt += (lg[p] > thr && lab[p] == p);

  // 2. block-wide exclusive prefix sum of the counts
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int incl = cnt;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    int v = lane < nw ? s_warp[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    if (lane < nw) s_warp[lane] = v;  // inclusive warp totals
  }
  __syncthreads();
  const int total = s_warp[(blockDim.x >> 5) - 1];
  int rank = (warp > 0 ? s_warp[warp - 1] : 0) + incl - cnt;
  for (int p = begin; p < end && rank < K; ++p) {
    if (lg[p] > thr && lab[p] == p) s_root[rank++] = p;
  }
  __syncthreads();

  // 3. slot map + per-row extremes
  const int nvalid = min(total, K);
  const int bg_slot = total < K ? K - 1 : K;
  int* out_slots = slots + b * N;
  for (int p = tid; p < N; p += blockDim.x) {
    const int l = lg[p] > thr ? lab[p] : N;
    int slot;
    if (l == N) {
      slot = bg_slot;
    } else {
      int lo = 0, hi = nvalid;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (s_root[mid] < l) lo = mid + 1; else hi = mid;
      }
      slot = (lo < nvalid && s_root[lo] == l) ? lo : K;
    }
    out_slots[p] = slot;
    if (slot < K) {
      const int y = p / W;
      const int x = p - y * W;
      atomicMin(&s_mn[slot * H + y], x);
      atomicMax(&s_mx[slot * H + y], x);
    }
  }
  __syncthreads();

  // 4. write out; padding slots all carry the background's extremes
  for (int i = tid; i < K * H; i += blockDim.x) {
    const int k = i / H;
    const int src = (k >= nvalid && k < K - 1) ? (K - 1) * H + (i - k * H) : i;
    minx[b * K * H + i] = s_mn[src];
    maxx[b * K * H + i] = s_mx[src];
  }
  for (int k = tid; k < K; k += blockDim.x) rootvals[b * K + k] = s_root[k];
  if (tid == 0) nroots[b] = total;
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
