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
// (ubdvss_tpu/ops/pallas/ccl_kernel.py:116).
//
// Block-wide union-find over the label map (Playne & Hawick, IEEE TPDS
// 2018; the block-based variants of Allegretti, Bolelli & Grana, IEEE TPDS
// 2019), three passes with a __syncthreads() after each, whatever the
// components' shapes:
//   1. initialise: lab[p] = p on foreground, H*W on background;
//   2. merge: every foreground pixel unions with its foreground neighbours
//      earlier in raster order, halving the paths its finds walk (a column
//      of N unions would otherwise walk the column again for every pixel);
//   3. flatten: lab[p] = find(p).
// A parent always points to a smaller index of the same component (a union
// links the larger root under the smaller with atomicMin, and retries when
// that root was linked elsewhere meanwhile), so each component's root is
// its minimum linear index and the flattened labels are exactly the TPU
// kernel's, with no round loop and no cap.
//
// The merge takes the scan mask of Wu, Otoo & Suzuki's decision tree for
// 8-connectivity: when N is foreground the pixel unions with N alone (W, NW
// and NE are neighbours of N and reach it through their own unions);
// otherwise with W (or, without W, with NW) and with NE.  4-connectivity
// unions with W and N.
__device__ inline int find_root(volatile int* lab, int p) {
  for (int r = lab[p]; r != p; r = lab[p]) p = r;
  return p;
}

// find_root that also points every other node of the path it walks at its
// grandparent (path halving), so that later walks are shorter.  Safe while
// unions run: it writes only to nodes that are not roots, each time an
// ancestor in the same component, and a link that an atomicMin in
// union_roots makes on a node that is no longer a root may be overwritten
// only because that union then retries from the node's parent.  Not for the
// flatten pass, where another thread may already have written a node's
// final label.
__device__ inline int find_root_halving(volatile int* lab, int p) {
  while (true) {
    const int r = lab[p];
    if (r == p) return p;
    const int g = lab[r];
    if (g != r) lab[p] = g;
    p = g;
  }
}

__device__ inline void union_roots(volatile int* lab, int a, int b) {
  while (true) {
    a = find_root_halving(lab, a);
    b = find_root_halving(lab, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(const_cast<int*>(lab) + b, a);
    if (old == b) return;  // b was a root and now points to a
    b = old;  // b was linked under `old` meanwhile: join old's set and a's
  }
}

__device__ inline void ccl_labels_shared(const float* __restrict__ lg,
                                         volatile int* lab, int H, int W,
                                         float thr, bool eight) {
  const int N = H * W;
  for (int p = threadIdx.x; p < N; p += blockDim.x) lab[p] = lg[p] > thr ? p : N;
  __syncthreads();
  for (int p = threadIdx.x; p < N; p += blockDim.x) {
    if (lab[p] == N) continue;
    const int y = p / W;
    const int x = p - y * W;
    const bool w = x > 0 && lab[p - 1] != N;
    const bool n = y > 0 && lab[p - W] != N;
    if (!eight) {
      if (w) union_roots(lab, p, p - 1);
      if (n) union_roots(lab, p, p - W);
      continue;
    }
    if (n) {
      union_roots(lab, p, p - W);
      continue;
    }
    if (w) {
      union_roots(lab, p, p - 1);
    } else if (y > 0 && x > 0 && lab[p - W - 1] != N) {
      union_roots(lab, p, p - W - 1);
    }
    if (y > 0 && x + 1 < W && lab[p - W + 1] != N) union_roots(lab, p, p - W + 1);
  }
  __syncthreads();
  for (int p = threadIdx.x; p < N; p += blockDim.x) {
    if (lab[p] != N) lab[p] = find_root(lab, p);
  }
  __syncthreads();
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
