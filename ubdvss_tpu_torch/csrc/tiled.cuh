// The phases of the device-memory CCL (ccl_labels_tiled) and of the tiled
// slots (component_slots_tiled) as block-wide device functions over one
// work item each (a tile, a raster chunk, a row band, a group of sums),
// shared by ccl_kernel.cu and postproc_kernel.cu, which launch one kernel a
// phase, and geometry_kernel.cu's large K12c, which runs them all in one
// launch with grid-wide barriers between them.  One copy of each phase,
// and one launch plan (``Plan``, written by ops/cuda/postproc_kernel.py
// tiled_plan), keep the two routes' outputs equal bit for bit: the labels
// are canonical (each the minimum linear index of its component), and the
// stats are summed in the same per-warp, per-band and over-bands order.
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

// The launch plan, tiled_plan's int32 array in this order.  The CCL labels
// tiles of tile_h x tile_w pixels (ccl_threads threads a tile, seam_threads
// a tile's seams, four pixels a thread in the flatten).  The slots rank
// roots over raster chunks of ``chunk`` pixels, then run the pixel pass
// over bands of tile_rows rows by the full width, each row cut into nseg
// segments of seg columns, one segment at a time a warp (pass_warps warps
// a band), keeping the band's extremes in shared memory (ext_smem 1) or,
// where one warp's stats partial set leaves no room for them, in a
// device-memory slice of their own; and finish each image's sums in
// fin_blocks blocks of kFinishThreads.
struct Plan {
  int B, H, W, K, C;
  int tile_h, tile_w, ccl_threads, seam_threads;
  int chunk, nchunks;
  int pass_warps, tile_rows, seg, nseg, bands, ext_smem;
  int fin_blocks;
};
constexpr int kPlanInts = sizeof(Plan) / sizeof(int);
constexpr int kFinishThreads = 256;
constexpr int kRootsThreads = 256;

// The phases' shared-memory scratch, in words (the callers' dynamic shared
// memory in the one-launch kernel, so that no phase adds static shared
// memory to the largest one's): a roots block's and a finish block's.
constexpr int kRootSteps = 8;  // block steps of a roots round
constexpr int kRootsScratch = kRootSteps * 32;
constexpr int kFinishScratch = 2 * kFinishThreads;

// Bytes of dynamic shared memory of a CCL tile and of a pass band (the
// band's roots, then one stats partial set a warp and the band's extremes,
// at least the 32 words the roots' scan takes before they are cleared).
inline size_t ccl_tile_smem(const Plan& p) {
  return static_cast<size_t>(p.tile_h) * p.tile_w * sizeof(int);
}
inline size_t pass_smem(const Plan& p) {
  const size_t rest = static_cast<size_t>(p.pass_warps) * p.K * (p.C + 1) +
                      (p.ext_smem ? 2 * static_cast<size_t>(p.K) * p.tile_rows : 0);
  return (static_cast<size_t>(p.K) + (rest > 32 ? rest : 32)) * sizeof(int);
}

// The one-launch kernel's block: every phase's shared memory.
inline size_t large_smem(const Plan& p) {
  const size_t m = ccl_tile_smem(p) > pass_smem(p) ? ccl_tile_smem(p) : pass_smem(p);
  const size_t f = kFinishScratch * sizeof(int);
  return m > f ? m : f;
}

// The plan from the wrapper, checked against itself; false when it is not
// one tiled_plan could write.
inline bool read_plan(const int* a, int n, Plan* out) {
  if (a == nullptr || n != kPlanInts) return false;
  Plan p;
  int* f = reinterpret_cast<int*>(&p);
  for (int i = 0; i < kPlanInts; ++i) f[i] = a[i];
  const long long N = static_cast<long long>(p.H) * p.W;
  const bool ok =
      p.B > 0 && p.H > 0 && p.W > 0 && N < (1LL << 30) && p.K > 0 && p.C > 0 &&
      p.tile_h > 0 && p.tile_w > 0 && p.ccl_threads > 0 && p.ccl_threads % 32 == 0 &&
      p.ccl_threads <= 1024 && p.seam_threads > 0 && p.seam_threads % 32 == 0 &&
      p.seam_threads <= 1024 && ccl_tile_smem(p) <= 232448 && p.chunk > 0 &&
      p.nchunks == (N + p.chunk - 1) / p.chunk && p.pass_warps > 0 && p.pass_warps <= 8 &&
      p.tile_rows > 0 && p.seg > 0 && p.seg % 32 == 0 && p.nseg == (p.W + p.seg - 1) / p.seg &&
      p.bands == (p.H + p.tile_rows - 1) / p.tile_rows && (p.ext_smem == 0 || p.ext_smem == 1) &&
      p.fin_blocks == (p.K * (p.C + 1) + 31) / 32 && pass_smem(p) <= 232448;
  if (ok) *out = p;
  return ok;
}

// The plan's length, for the wrapper to check against its own.
extern "C" int tiled_plan_ints() { return kPlanInts; }

struct CoherentLabels {
  const int* p;
  __device__ int operator[](int i) const { return p[i]; }
};

// ---- the CCL ----

// Pass 1 of the CCL, tile (tx, ty) of one image: the tile labelled in
// ``lab_s`` (tile_h * tile_w words of shared memory) with geometry.cuh's
// three passes, then each pixel written the GLOBAL linear index of its
// tile-component's root (within a tile, raster order of (row, column) is
// the same locally and globally, so that root is the smallest global index
// of the tile-component).
template <class T>
__device__ inline void ccl_tile(const geometry::Plane<T>& det, int* labels, int tx, int ty,
                                const Plan& pl, float thr, bool eight, int* lab_s) {
  const int W = pl.W;
  const int x0 = tx * pl.tile_w;
  const int y0 = ty * pl.tile_h;
  const int tw = min(pl.tile_w, W - x0);
  const int n = tw * min(pl.tile_h, pl.H - y0);
  const int N = pl.H * W;
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

// Pass 2, tile (tx, ty): each foreground pixel on the tile's top row and
// left and right columns united, by geometry::union_roots on device
// memory, with the neighbours in other tiles that the merge's decision
// tree (geometry.cuh ccl_merge) would unite it with on the whole map: N
// alone when N is foreground (W, NW and NE are N's neighbours and reach it
// through their own unions), else W (or, without W, NW) and NE; W and N
// under 4-connectivity.  Pass 1 made the tree's unions inside the tile, so
// every union of the tree on the whole map is made, and the components are
// the map's.
__device__ inline void ccl_seam(int* labels, int tx, int ty, const Plan& pl, bool eight) {
  const int W = pl.W;
  const int x0 = tx * pl.tile_w;
  const int y0 = ty * pl.tile_h;
  const int tw = min(pl.tile_w, W - x0);
  const int th = min(pl.tile_h, pl.H - y0);
  const int N = pl.H * W;
  const geometry::FlatLabels lab{labels};
  const int sides = tw > 1 ? 2 : 1;  // a one-column tile's sides are one column
  for (int i = threadIdx.x; i < tw + sides * th; i += blockDim.x) {
    const int lx = i < tw ? i : (i < tw + th ? 0 : tw - 1);
    const int ly = i < tw ? 0 : (i < tw + th ? i - tw : i - tw - th);
    if (i >= tw && ly == 0) continue;  // the corners are the top row's
    const int x = x0 + lx;
    const int y = y0 + ly;
    const int p = y * W + x;
    if (lab(p) == N) continue;
    const bool n = y > 0 && lab(p - W) != N;
    const bool w = x > 0 && lab(p - 1) != N;
    if (!eight) {
      if (lx == 0 && w) geometry::union_roots(lab, p, p - 1);
      if (ly == 0 && n) geometry::union_roots(lab, p, p - W);
      continue;
    }
    if (n) {
      if (ly == 0) geometry::union_roots(lab, p, p - W);
      continue;
    }
    if (w) {
      if (lx == 0) geometry::union_roots(lab, p, p - 1);
    } else if (y > 0 && x > 0 && (lx == 0 || ly == 0) && lab(p - W - 1) != N) {
      geometry::union_roots(lab, p, p - W - 1);
    }
    if (y > 0 && x + 1 < W && (lx == tw - 1 || ly == 0) && lab(p - W + 1) != N)
      geometry::union_roots(lab, p, p - W + 1);
  }
}

// Pass 3 over the batch's (B, N) labels, ``total`` = B * N words: the
// groups of four words g0, g0 + step, ... (one 16-byte load a group; the
// labels start 16-byte aligned) take find(p), written only where it moved.
__device__ inline void ccl_flatten(int* labels, long long g0, long long step, long long total,
                                   int N) {
  for (long long g = g0; g * 4 < total; g += step) {
    const long long i = g * 4;
    int v[4];
    if (i + 4 <= total) {
      const int4 q = *reinterpret_cast<const int4*>(labels + i);
      v[0] = q.x;
      v[1] = q.y;
      v[2] = q.z;
      v[3] = q.w;
    } else {
      for (int j = 0; j < 4; ++j) v[j] = i + j < total ? labels[i + j] : N;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (v[j] == N) continue;
      const long long b = (i + j) / N;
      // plain loads: a word another thread rewrites meanwhile, or a stale
      // cached copy of it, is still an ancestor of the same root, and a
      // root's word never changes in this pass
      const int* lb = labels + b * N;
      int r = v[j];
      for (int a = lb[r]; a != r; a = lb[r]) r = a;
      if (r != v[j]) labels[i + j] = r;
    }
  }
}

// ---- the slots ----

template <class T, class Lab>
__device__ inline bool is_root(const geometry::Plane<T>& det, const Lab& lab, int p, int W,
                               float thr) {
  return lab[p] == p && det(p / W, p % W) > thr;
}

// Raster chunk c of one image (``chunk`` pixels): its root count to
// ``count`` and its first min(count, K) roots, ascending, to ``list`` (K
// words).  Lanes run over consecutive pixels, kRootSteps block steps of
// blockDim.x pixels a round, all of a round's labels loaded at once; each
// root is ranked by its (step, warp) ballot counts in raster order, so one
// pass over the chunk counts and lists.  ``scratch``: kRootsScratch words
// of shared memory (the block is at most 32 warps).
template <class T, class Lab>
__device__ inline void roots_chunk(const geometry::Plane<T>& det, const Lab& lab, int c, int N,
                                   int W, int K, int chunk, float thr, int* count, int* list,
                                   int* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int p0 = c * chunk;
  const int p1 = min(p0 + chunk, N);
  const unsigned below = (1u << lane) - 1u;
  int base = 0;  // the chunk's roots before this round
  for (int q0 = p0; q0 < p1; q0 += kRootSteps * blockDim.x) {  // uniform
    unsigned bits = 0;
#pragma unroll
    for (int i = 0; i < kRootSteps; ++i) {
      const int p = q0 + i * blockDim.x + threadIdx.x;
      if (p < p1 && is_root(det, lab, p, W, thr)) bits |= 1u << i;
    }
    // a barrier (the scratch is the last round's) that also says whether
    // the round holds a root at all: most do not
    if (!__syncthreads_or(bits != 0)) continue;
    unsigned m[kRootSteps];
#pragma unroll
    for (int i = 0; i < kRootSteps; ++i) m[i] = __ballot_sync(kFull, (bits >> i) & 1u);
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < kRootSteps; ++i) scratch[i * nw + warp] = __popc(m[i]);
    }
    __syncthreads();
    int pre[kRootSteps];
    int run = base;
#pragma unroll
    for (int i = 0; i < kRootSteps; ++i) {
      for (int w = 0; w < nw; ++w) {
        if (w == warp) pre[i] = run;
        run += scratch[i * nw + w];
      }
    }
    if (bits != 0 && base < K) {  // base: the roots before this round
#pragma unroll
      for (int i = 0; i < kRootSteps; ++i) {
        const int rank = pre[i] + __popc(m[i] & below);
        if (((bits >> i) & 1u) && rank < K) list[rank] = q0 + i * blockDim.x + threadIdx.x;
      }
    }
    base = run;
  }
  if (threadIdx.x == 0) *count = base;
}

// The first K roots of one image, ascending (N pads), into ``root`` (K
// words of shared memory), from the chunks' counts and lists: a block-wide
// exclusive scan of the counts, a contiguous run of chunks a thread, over
// ``s_warp`` (32 words of shared memory).  Returns the image's root count;
// ends with a __syncthreads().
__device__ inline int gather_roots(const int* counts, const int* lists, int nchunks, int K, int N,
                                   int* root, int* s_warp) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int per = (nchunks + blockDim.x - 1) / blockDim.x;
  const int c0 = min(static_cast<int>(threadIdx.x) * per, nchunks);
  const int c1 = min(c0 + per, nchunks);
  int own = 0;
  for (int c = c0; c < c1; ++c) own += counts[c];
  int incl = own;
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += v;
  }
  __syncthreads();  // s_warp may still be read by an earlier call
  if (lane == 31) s_warp[warp] = incl;
  for (int i = threadIdx.x; i < K; i += blockDim.x) root[i] = N;
  __syncthreads();
  int before = incl - own;
  int total = 0;
  for (int w = 0; w < nw; ++w) {
    before += w < warp ? s_warp[w] : 0;
    total += s_warp[w];
  }
  for (int c = c0; c < c1 && before < K; ++c) {
    const int n = min(counts[c], K - before);
    for (int j = 0; j < n; ++j) root[before + j] = lists[static_cast<long long>(c) * K + j];
    before += counts[c];
  }
  __syncthreads();
  return total;
}

// The pixel pass over band ty of one image: rows [ty * tile_rows, ...) by
// the full width.  The band's (row, segment) units, row-major, go to the
// warps in turn (warp w: units w, w + nw, ...); a warp walks its segment
// 32 columns a step, lanes over consecutive columns, so each class plane
// (or the channels-last run) is read along the row.  Each pixel finds its
// root's slot by binary search among the K smallest roots (gathered from
// the chunk lists), writes it, takes part in the band's per-row extremes
// (shared-memory atomicMin/Max by the lowest and highest lane of each slot
// in the step, lanes ascending in x), and adds its stats to the warp's
// registers (geometry.cuh StatsAcc, its tiled sums) and at each slot
// change to the warp's partial set in shared memory (past
// geometry.cuh's kOnePassChannels, one walk a class chunk, the later ones
// reading back the slots the first wrote).  The band
// then writes its rows of every slot's extremes (the padding slots the
// background's, slot K-1's) and the sum of its warps' sets, in order, as
// the band's partials ``tp`` (K, C) and ``tc`` (K); band 0 also writes
// ``rootvals`` and ``nroots``.  Warps from pass_warps on take part only in
// the block's barriers.  Shared memory ``sm``: pass_smem(pl) bytes; the
// band's extremes there, or in ``ext`` (2 K tile_rows words) when
// pl.ext_smem is 0.
template <int CM, class T, class Lab>
__device__ inline void slots_pass(const geometry::Logits<T>& lg, const Lab& lab,
                                  const int* counts, const int* lists, int* rootvals,
                                  int* nroots, int* sl, int* mn, int* mx, float* tp, int* tc,
                                  int* ext, int ty, const Plan& pl, float thr, int* sm) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int H = pl.H, W = pl.W, K = pl.K, C = pl.C, R = pl.tile_rows;
  const int nw = pl.pass_warps;
  const int N = H * W;
  int* root = sm;
  float* part = reinterpret_cast<float*>(sm + K);
  int* cnt = reinterpret_cast<int*>(part + nw * K * C);
  int* emn = pl.ext_smem ? cnt + nw * K : ext;
  int* emx = emn + K * R;
  // the scan's words are the first of the partials', cleared after it
  const int total = gather_roots(counts, lists, pl.nchunks, K, N, root, sm + K);
  for (int i = threadIdx.x; i < nw * K * C; i += blockDim.x) part[i] = 0.f;
  for (int i = threadIdx.x; i < nw * K; i += blockDim.x) cnt[i] = 0;
  for (int i = threadIdx.x; i < K * R; i += blockDim.x) {
    emn[i] = kBig;
    emx[i] = -1;
  }
  __syncthreads();
  if (ty == 0) {
    for (int i = threadIdx.x; i < K; i += blockDim.x) rootvals[i] = root[i];
    if (threadIdx.x == 0) *nroots = total;
  }
  const int nvalid = min(total, K);
  const int bg_slot = total < K ? K - 1 : K;
  const geometry::Plane<T> det{lg.p, lg.sy, lg.sx, lg.ph};
  const int y0 = ty * R;
  const int rows = min(R, H - y0);
  // one walk of the band a class chunk (geometry.cuh kWideChannels); the
  // first writes the slots and the extremes
  auto pass = [&](int chunk, bool lead) {
    float* w_part = part + warp * K * C;
    int* w_cnt = cnt + warp * K;
    geometry::StatsAcc<CM, T, true> acc;
    acc.set_chunk(chunk);
    acc.reset(K);
    for (int u = warp; u < rows * pl.nseg; u += nw) {
      const int r = u / pl.nseg;
      const int y = y0 + r;
      const int xs = (u - r * pl.nseg) * pl.seg;
      const int xe = min(xs + pl.seg, W);
      for (int x = xs + lane; x - lane < xe; x += 32) {
        int slot = K;
        float d = 0.f;
        if (x < xe) {
          acc.fetch(lg, y, x);
          if (lead) {
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
          } else {
            slot = sl[y * W + x];  // written by this thread in the first chunk's walk
          }
        }
        if (lead) {  // warp-uniform
          const unsigned grp = __match_any_sync(kFull, slot);
          if (slot < K) {
            if (lane == __ffs(grp) - 1) atomicMin(&emn[slot * R + r], x);
            if (lane == 31 - __clz(grp)) atomicMax(&emx[slot * R + r], x);
          }
        }
        acc.add(lg, slot, d, K, w_part, w_cnt);
      }
    }
    if (__ballot_sync(kFull, acc.slot < K)) acc.flush(acc.slot < K, K, C, w_part, w_cnt);
  };
  if (warp < nw) {  // warp-uniform
    if constexpr (CM == geometry::kWideChannels) {
      for (int chunk = 0; chunk < geometry::class_chunks<CM>(C); ++chunk) pass(chunk, chunk == 0);
    } else {
      pass(0, true);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < K * rows; i += blockDim.x) {
    const int k = i / rows;
    const int r = i - k * rows;
    const int src = (k >= nvalid && k < K - 1) ? K - 1 : k;
    mn[k * H + y0 + r] = emn[src * R + r];
    mx[k * H + y0 + r] = emx[src * R + r];
  }
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

// Finish block f of one image (kFinishThreads threads): the items
// i = 32 f + lane of the image's K*C sums and K counts, warp w summing the
// bands w, w + 8, ... in order, then the warps' sums in order, into
// det_sums (channel 0), cls_sums (channels 1..C-1; one zero column when
// C = 1) and areas.  ``scratch``: kFinishScratch words of shared memory.
__device__ inline void slots_finish(const float* tp, const int* tc, float* areas,
                                    float* det_sums, float* cls_sums, int f, int K, int C,
                                    int bands, int* scratch) {
  constexpr int nw = kFinishThreads / 32;
  auto s_v = reinterpret_cast<float(*)[32]>(scratch);
  auto s_n = reinterpret_cast<int(*)[32]>(scratch + kFinishThreads);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int i = f * 32 + lane;
  float v = 0.f;
  int n = 0;
  if (i < K * C) {
    for (int t = warp; t < bands; t += nw) v += tp[static_cast<long long>(t) * K * C + i];
  } else if (i < K * C + K) {
    for (int t = warp; t < bands; t += nw) n += tc[static_cast<long long>(t) * K + i - K * C];
  }
  __syncthreads();  // s_v and s_n may still be read by an earlier item
  s_v[warp][lane] = v;
  s_n[warp][lane] = n;
  __syncthreads();
  if (warp != 0) return;
  if (i < K * C) {
    float s = 0.f;
    for (int w = 0; w < nw; ++w) s += s_v[w][lane];
    const int k = i / C;
    const int c = i - k * C;
    if (c == 0) {
      det_sums[k] = s;
    } else {
      cls_sums[k * (C - 1) + c - 1] = s;
    }
  } else if (i < K * C + K) {
    int s = 0;
    for (int w = 0; w < nw; ++w) s += s_n[w][lane];
    const int k = i - K * C;
    areas[k] = static_cast<float>(s);
    if (C == 1) cls_sums[k] = 0.f;
  }
}

}  // namespace tiled
