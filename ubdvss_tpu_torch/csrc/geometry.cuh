// The two phases of the component geometry, as block-wide device functions
// shared by ccl_kernel.cu (K1), postproc_kernel.cu (K2) and
// geometry_kernel.cu (K12c, both phases in one block), so that each
// algorithm has one copy.  Every thread of the block calls them.
#pragma once

#include <cuda_runtime.h>

namespace geometry {

constexpr int kBig = 1 << 30;

// Phase 1: threshold + connected-component labelling, in shared memory.
//
// On return every foreground pixel (logit > thr) of the (H, W) map holds
// the minimum linear index of its 8-connected (or 4-connected) component
// and background holds H*W, the contract of the TPU kernel _ccl_kernel
// (ubdvss_tpu/ops/pallas/ccl_kernel.py:116).  Each round every foreground
// pixel takes the minimum label of its neighbourhood and then
// pointer-jumps (l = lab[l] while that falls).  Both steps keep the
// invariant that a label is the index of a pixel of the same component
// and never rises, so updating in place while other threads read is
// safe; rounds repeat until a whole round changes nothing
// (__syncthreads_or, which is also the closing barrier), the fixpoint the
// TPU kernel reaches.  The TPU kernel's segmented run-min passes were a
// way to cross long runs in few vectorised rounds; pointer jumping does
// that here.
__device__ inline void ccl_labels_shared(const float* __restrict__ lg,
                                         volatile int* lab, int H, int W,
                                         float thr, bool eight) {
  const int N = H * W;
  for (int p = threadIdx.x; p < N; p += blockDim.x) lab[p] = lg[p] > thr ? p : N;
  __syncthreads();
  while (true) {
    int changed = 0;
    for (int p = threadIdx.x; p < N; p += blockDim.x) {
      const int l = lab[p];
      if (l == N) continue;
      const int y = p / W;
      const int x = p - y * W;
      int m = l;
      for (int dy = -1; dy <= 1; ++dy) {
        const int yy = y + dy;
        if (yy < 0 || yy >= H) continue;
        for (int dx = -1; dx <= 1; ++dx) {
          if (dy == 0 && dx == 0) continue;
          if (!eight && dy != 0 && dx != 0) continue;
          const int xx = x + dx;
          if (xx < 0 || xx >= W) continue;
          m = min(m, lab[yy * W + xx]);  // background holds N, the identity
        }
      }
      // pointer jumping: m is the index of a foreground pixel
      for (int r = lab[m]; r < m; r = lab[m]) m = r;
      if (m < l) {
        lab[p] = m;
        changed = 1;
      }
    }
    if (!__syncthreads_or(changed)) break;
  }
}

// Phase 2: root count, the K smallest roots, the slot map and each slot's
// per-row x extremes, from the logits and the raw labels (global or shared
// memory, which this phase only reads), as the TPU's _roots_slots_extremes
// (ubdvss_tpu/ops/pallas/postproc_kernel.py:182), including its padding
// slots: when an image has fewer than K components, the padding slots hold
// the root value H*W, which the TPU kernel matches against the background
// label, so background pixels take the LAST padding slot (K-1) and every
// padding slot carries the background's per-row extremes.  Callers mask
// padding slots by rootvals.
//
// Roots (foreground pixels whose label is their own index) are ranked in
// raster order by a block-wide exclusive prefix sum (warp shuffles; the
// block is a whole number of warps); roots of rank < K are the slots, kept
// ascending in shared memory, and each pixel finds its root's slot by
// binary search there.  Per-row extremes are shared-memory atomicMin/Max
// into (K, H) arrays.  ``sm`` holds K + 2*K*H ints.  The outputs are one
// image's: rootvals (K), slots (H, W), minx/maxx (K, H), nroots (1).
__device__ inline void roots_slots_extremes(
    const float* __restrict__ lg, const int* __restrict__ lab, int* sm, int H,
    int W, int K, float thr, int* __restrict__ rootvals, int* __restrict__ slots,
    int* __restrict__ minx, int* __restrict__ maxx, int* __restrict__ nroots) {
  int* s_root = sm;          // K, ascending, H*W pads
  int* s_mn = sm + K;        // (K, H)
  int* s_mx = s_mn + K * H;  // (K, H)
  __shared__ int s_warp[32];
  const int N = H * W;
  const int tid = threadIdx.x;

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
    slots[p] = slot;
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
    minx[i] = s_mn[src];
    maxx[i] = s_mx[src];
  }
  for (int k = tid; k < K; k += blockDim.x) rootvals[k] = s_root[k];
  if (tid == 0) *nroots = total;
}

}  // namespace geometry
