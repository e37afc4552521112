// The phases of the device-memory CCL (ccl_labels_tiled) and of the tiled
// slots (component_slots_tiled) as block-wide device functions over one
// work item each (a tile, a raster chunk, a pixel range), shared by
// ccl_kernel.cu and postproc_kernel.cu, which launch one kernel a phase, and
// geometry_kernel.cu's large K12c, which runs them all in one launch with
// grid-wide barriers between them.  One copy of each phase keeps the two
// routes' outputs equal bit for bit: the labels are canonical (each the
// minimum linear index of its component), and the stats are summed in the
// same per-warp, per-tile and over-tiles order.
//
// The label map is read through a view: GlobalLabels (__ldg, for kernels
// that only read it) or CoherentLabels (plain loads, for the one-launch
// kernel, where other blocks wrote it earlier in the same launch and the
// read-only cache could hold a stale line).  Every thread of the block
// calls each function; the caller separates items that reuse shared memory
// with a __syncthreads().
#pragma once

#include "geometry.cuh"

namespace tiled {

using geometry::kBig;
using geometry::kFull;

// The CCL's tiles: kTileH rows by kTileW columns a tile.
constexpr int kTileH = 32;
constexpr int kTileW = 64;

struct CoherentLabels {
  const int* p;
  __device__ int operator[](int i) const { return p[i]; }
};

// Pass 1 of the CCL, tile (tx, ty) of one image: the tile labelled in
// ``lab_s`` (kTileH * kTileW words of shared memory) with geometry.cuh's
// three passes, then each pixel written the GLOBAL linear index of its
// tile-component's root (within a tile, raster order of (row, column) is
// the same locally and globally, so that root is the smallest global index
// of the tile-component).
template <class T>
__device__ inline void ccl_tile(const geometry::Plane<T>& det, int* labels, int tx, int ty,
                                int H, int W, float thr, bool eight, int* lab_s) {
  const int x0 = tx * kTileW;
  const int y0 = ty * kTileH;
  const int tw = min(kTileW, W - x0);
  const int n = tw * min(kTileH, H - y0);
  const int N = H * W;
  const geometry::FlatLabels lab{lab_s};
  geometry::ccl_init(
      lab,
      [&](int q) {
        const int ly = q / tw;
        return det(y0 + ly, x0 + q - ly * tw) > thr;
      },
      0, n, n);
  __syncthreads();
  geometry::ccl_merge(lab, tw, 0, 0, n, n, eight);
  __syncthreads();
  geometry::ccl_flatten(lab, 0, n, n);
  __syncthreads();
  for (int q = threadIdx.x; q < n; q += blockDim.x) {
    const int r = lab_s[q];
    const int ly = q / tw;
    const int ry = r / tw;
    labels[(y0 + ly) * W + x0 + (q - ly * tw)] = r == n ? N : (y0 + ry) * W + x0 + (r - ry * tw);
  }
}

// Pass 2, tile (tx, ty): every foreground pixel on the tile's top row and
// left and right columns united with each foreground neighbour that lies in
// another tile and comes earlier in raster order (W, N, and under
// 8-connectivity NW and NE, which reach the diagonal tiles at corners), by
// geometry::union_roots on device memory.
__device__ inline void ccl_seam(int* labels, int tx, int ty, int H, int W, bool eight) {
  const int x0 = tx * kTileW;
  const int y0 = ty * kTileH;
  const int tw = min(kTileW, W - x0);
  const int th = min(kTileH, H - y0);
  const int N = H * W;
  const geometry::FlatLabels lab{labels};
  for (int i = threadIdx.x; i < tw + 2 * th; i += blockDim.x) {
    const int lx = i < tw ? i : (i < tw + th ? 0 : tw - 1);
    const int ly = i < tw ? 0 : (i < tw + th ? i - tw : i - tw - th);
    const int x = x0 + lx;
    const int y = y0 + ly;
    const int p = y * W + x;
    if (lab(p) == N) continue;
    if (lx == 0 && x > 0 && lab(p - 1) != N) geometry::union_roots(lab, p, p - 1);
    if (y == 0) continue;
    const int q = p - W;
    if (ly == 0 && lab(q) != N) geometry::union_roots(lab, p, q);
    if (!eight) continue;
    if (x > 0 && (lx == 0 || ly == 0) && lab(q - 1) != N) geometry::union_roots(lab, p, q - 1);
    if (x + 1 < W && (lx == tw - 1 || ly == 0) && lab(q + 1) != N)
      geometry::union_roots(lab, p, q + 1);
  }
}

// Pass 3: pixels [i0, total) of the batch's (B, N) labels at stride
// ``step`` take find(p).
__device__ inline void ccl_flatten(int* labels, long long i0, long long total, long long step,
                                   int N) {
  for (long long i = i0; i < total; i += step) {
    const long long b = i / N;
    const int p = static_cast<int>(i - b * N);
    const geometry::FlatLabels lab{labels + b * N};
    if (lab(p) != N) lab(p) = geometry::find_root(lab, p);
  }
}

// The block-wide sum of v, returned to every thread (the block is whole
// warps).
__device__ inline int block_sum(int v) {
  __shared__ int s_part[32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  __syncthreads();  // s_part may still be read by an earlier call
  if ((threadIdx.x & 31) == 0) s_part[threadIdx.x >> 5] = v;
  __syncthreads();
  int t = 0;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) t += s_part[w];
  return t;
}

template <class T, class Lab>
__device__ inline bool is_root(const geometry::Plane<T>& det, const Lab& lab, int p, int W,
                               float thr) {
  return lab[p] == p && det(p / W, p % W) > thr;
}

// The root count of raster chunk c (``chunk`` pixels) of one image.
template <class T, class Lab>
__device__ inline int roots_count(const geometry::Plane<T>& det, const Lab& lab, int c, int H,
                                  int W, int chunk, float thr) {
  const int p1 = min(c * chunk + chunk, H * W);
  int cnt = 0;
  for (int p = c * chunk + threadIdx.x; p < p1; p += blockDim.x) cnt += is_root(det, lab, p, W, thr);
  return block_sum(cnt);
}

// Chunk c of one image: the ranks of its roots among the image's, after
// the counts ``cn`` of the chunks before it; those of rank < K go to
// ``roots`` (K words).  Chunk 0 also pads ``roots`` with H*W and writes the
// root count to ``nroots``.
template <class T, class Lab>
__device__ inline void roots_rank(const geometry::Plane<T>& det, const Lab& lab, const int* cn,
                                  int c, int nchunks, int* roots, int* nroots, int H, int W,
                                  int K, int chunk, float thr) {
  __shared__ int s_warp[32];
  const int N = H * W;
  int before = 0, total = 0;
  for (int i = threadIdx.x; i < nchunks; i += blockDim.x) {
    total += cn[i];
    if (i < c) before += cn[i];
  }
  before = block_sum(before);
  total = block_sum(total);
  if (c == 0) {
    for (int i = total + threadIdx.x; i < K; i += blockDim.x) roots[i] = N;
    if (threadIdx.x == 0) *nroots = total;
  }
  if (cn[c] == 0 || before >= K) return;  // uniform over the block
  // a contiguous run of the chunk per thread, ranked by a block-wide
  // exclusive prefix sum of the runs' root counts
  const int p0 = c * chunk;
  const int n = min(p0 + chunk, N) - p0;
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int begin = p0 + min(static_cast<int>(threadIdx.x) * per, n);
  const int end = min(begin + per, p0 + n);
  int cnt = 0;
  for (int p = begin; p < end; ++p) cnt += is_root(det, lab, p, W, thr);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int incl = cnt;
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int v = lane < nw ? s_warp[lane] : 0;
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(kFull, v, off);
      if (lane >= off) v += u;
    }
    if (lane < nw) s_warp[lane] = v;  // inclusive warp totals
  }
  __syncthreads();
  int rank = before + (warp > 0 ? s_warp[warp - 1] : 0) + incl - cnt;
  for (int p = begin; p < end && rank < K; ++p) {
    if (is_root(det, lab, p, W, thr)) roots[rank++] = p;
  }
}

// The pixel pass over pass tile (tx, ty) of one image: tile_rows rows by
// 32 * nw columns, warp w < nw walking its 32-column strip down the tile,
// lanes over the columns (warps from nw on only take part in the block's
// barriers).  Each pixel's slot is written, the extremes go to device
// memory by integer atomicMin/Max, one a slot and row for each warp (lanes
// ascend in x, so a slot's lowest lane holds its min x and its highest lane
// its max x), and the stats are summed in registers and warp trees
// (geometry.cuh StatsAcc) into the warp's partial set in shared memory;
// the block then sums its warps' sets in order into the tile's partials
// ``tp`` (K, C) and ``tc`` (K).  Shared memory ``sm``: K roots, then nw
// partial sets of (K, C) floats, then nw sets of K ints.
template <int CM, class T, class Lab>
__device__ inline void slots_tile(const geometry::Logits<T>& lg, const Lab& lab,
                                  const int* rootvals, int total, int* sl, int* mn, int* mx,
                                  float* tp, int* tc, int tx, int ty, int nw, int H, int W,
                                  int K, int tile_rows, float thr, int* sm) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int C = lg.C;
  int* root = sm;
  float* part = reinterpret_cast<float*>(sm + K);
  int* cnt = reinterpret_cast<int*>(part + nw * K * C);
  for (int i = threadIdx.x; i < K; i += blockDim.x) root[i] = rootvals[i];
  for (int i = threadIdx.x; i < nw * K * C; i += blockDim.x) part[i] = 0.f;
  for (int i = threadIdx.x; i < nw * K; i += blockDim.x) cnt[i] = 0;
  __syncthreads();
  const int N = H * W;
  const int nvalid = min(total, K);
  const int bg_slot = total < K ? K - 1 : K;
  const geometry::Plane<T> det{lg.p, lg.sy, lg.sx};
  if (warp < nw) {  // warp-uniform
    float* w_part = part + warp * K * C;
    int* w_cnt = cnt + warp * K;
    const int x = (tx * nw + warp) * 32 + lane;
    const int y0 = ty * tile_rows;
    const int y1 = min(y0 + tile_rows, H);
    geometry::StatsAcc<CM, T> acc;
    acc.reset(K);
    for (int y = y0; y < y1; ++y) {
      int slot = K;
      float d = 0.f;
      if (x < W) {
        acc.fetch(lg, y, x);
        d = det(y, x);
        const int lp = lab[y * W + x];  // loaded beside d, not after it
        const int l = d > thr ? lp : N;
        if (l == N) {
          slot = bg_slot;
        } else {
          int lo = 0, hi = nvalid;
          while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (root[mid] < l) lo = mid + 1; else hi = mid;
          }
          slot = (lo < nvalid && root[lo] == l) ? lo : K;
        }
        sl[y * W + x] = slot;
      }
      const unsigned grp = __match_any_sync(kFull, slot);
      if (slot < K) {
        if (lane == __ffs(grp) - 1) atomicMin(&mn[slot * H + y], x);
        if (lane == 31 - __clz(grp)) atomicMax(&mx[slot * H + y], x);
      }
      acc.add(lg, slot, d, K, w_part, w_cnt);
    }
    if (__ballot_sync(kFull, acc.slot < K)) acc.flush(acc.slot < K, K, C, w_part, w_cnt);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < K * C; i += blockDim.x) {
    float v = 0.f;
    for (int w = 0; w < nw; ++w) v += part[w * K * C + i];
    tp[i] = v;
  }
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    int a = 0;
    for (int w = 0; w < nw; ++w) a += cnt[w * K + k];
    tc[k] = a;
  }
}

// Finish item i of one image, i < K * C + K: a (slot, channel) sum over
// the image's ``tiles`` tile partials in order (det_sums for channel 0,
// cls_sums after), or a slot's pixel count (areas; and the zero column of
// cls_sums when C = 1).
__device__ inline void slots_finish_sum(const float* tp, const int* tc, float* areas,
                                        float* det_sums, float* cls_sums, int i, int K, int C,
                                        int tiles) {
  if (i < K * C) {
    float v = 0.f;
    for (int t = 0; t < tiles; ++t) v += tp[static_cast<long long>(t) * K * C + i];
    const int k = i / C;
    const int c = i - k * C;
    if (c == 0) {
      det_sums[k] = v;
    } else {
      cls_sums[k * (C - 1) + c - 1] = v;
    }
  } else if (i < K * C + K) {
    const int k = i - K * C;
    int a = 0;
    for (int t = 0; t < tiles; ++t) a += tc[static_cast<long long>(t) * K + k];
    areas[k] = static_cast<float>(a);
    if (C == 1) cls_sums[k] = 0.f;
  }
}

// Padding slot word j of one image (nvalid * H <= j < (K - 1) * H) takes
// the background's extremes, slot K-1's.
__device__ inline void slots_pad_extremes(int* mn, int* mx, int j, int H, int K) {
  const int src = (K - 1) * H + j % H;
  mn[j] = mn[src];
  mx[j] = mx[src];
}

}  // namespace tiled
