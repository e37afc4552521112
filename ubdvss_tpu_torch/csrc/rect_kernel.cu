// Minimum-area rectangles from per-row component extremes.
//
// Two kernels, one per TPU kernel, returning the same nine rows per
// component: ux, uy, min_u, max_u, min_v, max_v, any_edge, p0x, p0y.
//   the compact kernel (rect_kernel<false>, entry rect_select)
//     replaces _rect_kernel_compact (ubdvss_tpu/ops/pallas/
//     rect_kernel.py:294): each convex chain compacted to its first M
//     points, directions projected over the packed points.
//   the exact kernel (rect_kernel<true>, entry rect_select_exact)
//     replaces _rect_kernel (rect_kernel.py:136): no cap
//     (M = H), directions projected over every valid row's two extremes,
//     the TPU kernel's point set.  The extremes of a projection are hull
//     points in exact arithmetic, but the f32 projection is not monotone in
//     the exact value, so an interior point can win by an ulp; projecting
//     the same points keeps the rows equal.
//
// Both keep the points that the TPU kernels' lockstep rounds keep when they
// convexify the left (min x) and right (max x) chains by deleting every
// strictly concave point: every point on the chain's hull boundary,
// collinear points kept.  Each chain's first M points by rank are packed
// (left in slots [0, M), right in [M, 2M)); with M < H a chain with more
// than M points loses the rest, as on the TPU.  Every edge between
// consecutive packed points of one chain is a caliper direction; the
// minimum area wins within amin*(1+1e-6)+1e-9, ties broken by the folded
// caliper angle, then the first slot, then the horizontal candidate — the
// TPU kernels' order.  Products and sums are rounded separately (no FMA
// contraction) so the kernels match their plain PyTorch version to the
// rounding of rsqrtf.
//
// Bound on this card: per component, directions x packed points x ~10
// flops over 8 B per row of input (0.13 GFLOP at B=64, K=16, M=64 with
// every chain full: ~2 us at 67 TFLOP/s f32).  What sets the time is one
// component's critical path: all B*K components are resident at once.
//
// Both are one template, rect_kernel<kExact>: one 128-thread block per
// component, with no loop that one thread runs for the others:
//   1. the valid rows are compacted by ballot and popc (threads over rows),
//      and the horizontal candidate is taken by block reductions;
//   2. one warp per chain runs the TPU kernels' lockstep rounds, every
//      strictly concave point deleted at once, its alive neighbours found
//      in bitmasks by clz/ffs: one round settles a convex or collinear
//      chain (the padding slots' background rows).  A chain still moving
//      after 4 rounds is finished by the whole block with the rule that a
//      row p stays iff the largest slope dx/dy from p back to an earlier
//      alive row is <= the smallest slope from p to a later one (a
//      supporting line through p leaves every point on one side; slopes
//      compared by int32 cross-multiplication): threads over rows, O(n)
//      steps each; the exact kernel first compacts each chain's alive rows
//      to a list of (x, y, row) and runs the rule over the lists, threads
//      over the alive rows of both chains, so that its cost is the square
//      of the rows still alive, not of H (on a rotated bar over 1088 rows,
//      H100 80GB HBM3: 0.57 ms with the rule over every row, 0.13-0.15 ms
//      with the lists);
//   3. a chain's kept rows are ranked by ballot and popc, its first M
//      packed (all of them in the exact kernel, where M = H);
//   4. the compact kernel: threads take the valid directions (consecutive
//      packed points of one chain) and project them over the valid packed
//      points only.  The exact kernel: a
//      direction equal to the one before it on its chain (a run of
//      collinear points with equal steps, such as a padding slot's
//      background rows) gives the same rows and loses the tie to it, so
//      only the others are kept, compacted in order; then a group of G
//      lanes takes each direction (G a power of two, G * directions <=
//      128), each lane projects every G-th valid row's two extremes, and
//      the group reduces min and max by shuffles.  Min and max do not
//      depend on order, so the rows are those of one thread walking every
//      row, and one component's critical path stays short at B=1;
//   5. the minimum area, the caliper key among the ties and the lowest
//      direction among those are block reductions.
// The exact kernel keeps a component's rows, points and directions in
// shared memory, about 116.5 B a row (rect_smem_bytes): it serves H up to
// kMaxExactHeight (1994 rows, an A4 page at 600 dpi is 1754), the height
// whose bytes and the static reduction slots fill one block's 232,448 B.
//
// Taller maps take the tall instance (rect_cluster_kernel, entry
// rect_select_exact_tall): the same selection, one component a cluster of
// kCS = 8 blocks of 256 threads, its arrays spread over the blocks' shared
// memory and read across the cluster (distributed shared memory):
//   A. each block counts the valid rows of its eighth of the map, the
//      cluster sums the counts (one barrier), and the rows are compacted in
//      order into a cluster-wide array, block r holding positions
//      [r hb, (r+1) hb); a component of at most kSoloRows (1024) rows is
//      finished by block 0 alone with block barriers once every block has
//      taken its part of R and of B's block-local levels (its arrays stay
//      spread, read through distributed shared memory), the others waiting
//      at the closing barrier: for those, eight blocks' barriers cost more
//      than their warps save;
//   R. the lockstep's first round, where every row is alive, each block
//      over its own positions, the results met at one cluster barrier: a
//      chain with no row strictly concave between its neighbours is convex
//      and keeps every row (the one-block kernel's rounds settle it in that
//      round), and skips B (a padding slot's background rows, an upright
//      bar, a convex blob).  A chain with a concave row
//      goes on: later rounds across the cluster cost more than the merges
//      they would save (a digital line or a noisy edge over a thousand rows
//      settles in none of them);
//   B. the chains' hulls in logarithmic depth: each warp takes 32-row
//      segments and keeps each chain's strict hull vertices within its
//      segment (a point off its segment's hull is off the chain's hull),
//      then the segments are merged pairwise over log2(segments) levels, a
//      warp a merge and chain: the bridge between two convex chains (their common
//      tangent, the earlier chain's first and the later chain's last point
//      on it) is found by a 32-way search over the later chain, each probe
//      a binary search over the earlier one, and the later chain's kept
//      vertices are copied behind the earlier chain's.  A level whose
//      merges stay inside one block waits at a block barrier, the others
//      at the cluster's.  The right chain runs on negated x, so both chains
//      are lower hulls;
//   C. on a chain with a concave row, a row is kept iff its point lies on
//      that chain's hull (a vertex, or on an edge by the int32 cross
//      product): exactly the points the lockstep rounds and the slope rule
//      keep, collinear points included; a convex chain keeps every row; the
//      kept points are ranked across the cluster (where both chains are
//      convex, each block writes its own rows as the kept points);
//   D. the directions (consecutive kept points; one equal to the one
//      before it on its chain dropped, as in the one-block kernel) are
//      ranked across the cluster;
//   E. each block projects every direction over its own rows (G lanes a
//      direction, as the one-block kernel), and the blocks' extremes are
//      reduced through distributed shared memory, 512 directions at a time;
//   F. the selection as in the one-block kernel (minimum area, caliper
//      key, lowest direction, the horizontal candidate), each step a block
//      reduction and a cluster barrier.
// A component with no valid row is written after the first barrier.  Maps
// past what eight blocks' shared memory holds (97 B a row, hb a power of
// two: 16,384 rows) keep the arrays in a device-memory workspace slot a
// cluster, read past L1 (ld.global.cg: another block of the cluster may
// have written them), and the clusters are persistent over the B * K
// components, which bounds the workspace.
#include <cooperative_groups.h>

#include <climits>

#include "common.cuh"

namespace cg = cooperative_groups;

// A debug build (-DRECT_TALL_STAMPS, scripts/torch_kernel_ab.py --only
// tall) records clock64() at the tall instance's step boundaries, thread 0
// of each component's block 0, for the split of its time over the steps,
// then the component's valid rows and the chains that went through the
// merges (16 slots a component).
#ifdef RECT_TALL_STAMPS
__device__ long long g_rect_stamps[1 << 17];
extern "C" int rect_stamps(long long* host, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_rect_stamps, sizeof(long long) * n));
}
extern "C" int rect_stamps_clear() {
  void* p = nullptr;
  const cudaError_t e = cudaGetSymbolAddress(&p, g_rect_stamps);
  return static_cast<int>(e != cudaSuccess ? e : cudaMemset(p, 0, sizeof(g_rect_stamps)));
}
#define TALL_STAMP(k) \
  if (rank == 0 && tid == 0 && comp < 8192) g_rect_stamps[comp * 16 + (k)] = clock64()
#define TALL_INFO(k, v) \
  if (rank == 0 && tid == 0 && comp < 8192) g_rect_stamps[comp * 16 + 8 + (k)] = (v)
#else
#define TALL_STAMP(k)
#define TALL_INFO(k, v)
#endif

namespace {

constexpr float kInf = 3.4e38f;
constexpr int kBig = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float fold_phi_key(float ux, float uy) {
  // the first 90-degree rotation of (ux, -uy) with x > 0 and y >= 0
  const float cx[4] = {ux, -uy, -ux, uy};
  const float cy[4] = {-uy, -ux, uy, ux};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (cx[i] > 0.f && cy[i] >= 0.f) return cy[i] / fmaxf(cx[i], 1e-30f);
  }
  return 0.f;
}

// One direction's projection extremes over the point (px, py).
__device__ __forceinline__ void project(float ux, float uy, float px, float py,
                                        float& mnu, float& mxu, float& mnv,
                                        float& mxv) {
  const float pu = __fadd_rn(__fmul_rn(ux, px), __fmul_rn(uy, py));
  const float pv = __fadd_rn(__fmul_rn(-uy, px), __fmul_rn(ux, py));
  mnu = fminf(mnu, pu);
  mxu = fmaxf(mxu, pu);
  mnv = fminf(mnv, pv);
  mxv = fmaxf(mxv, pv);
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// Slope (num / den, den > 0) comparisons by cross-multiplication.
__device__ __forceinline__ bool steeper(int n0, int d0, int n1, int d1) {
  return n0 * d1 > n1 * d0;
}

// The nearest set bit of the (words) bitmask strictly before / after bit
// 32k + lane, -1 where there is none.
__device__ __forceinline__ int prev_bit(const unsigned* m, int k, int lane) {
  unsigned w = m[k] & ((1u << lane) - 1u);
  while (w == 0 && k > 0) w = m[--k];
  return w ? 32 * k + 31 - __clz(w) : -1;
}

__device__ __forceinline__ int next_bit(const unsigned* m, int k, int lane, int nw) {
  unsigned w = m[k] & ~((2u << lane) - 1u);
  while (w == 0 && k + 1 < nw) w = m[++k];
  return w ? 32 * k + __ffs(w) - 1 : -1;
}

// One block of 4 warps per component, in both kernels (256 and 512 threads
// were slower for the exact kernel at both the stream's and a detect
// call's shapes).
constexpr int kThreads = 128;

// Block-wide ordered compaction: every thread of the block (kT threads)
// calls this once a pass with its flag; returns the thread's slot among the
// flagged threads of the pass, counting from n, and adds the pass's count
// to n.
template <int kT>
__device__ __forceinline__ int compact_slot(bool ok, int& n, int* s_cnt) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned m = __ballot_sync(kFull, ok);
  if (lane == 0) s_cnt[warp] = __popc(m);
  __syncthreads();
  int off = n + __popc(m & ((1u << lane) - 1u));
  for (int w = 0; w < kT / 32; ++w) {
    off += w < warp ? s_cnt[w] : 0;
    n += s_cnt[w];
  }
  __syncthreads();  // s_cnt is the next pass's
  return off;
}

// Bytes of a component's arrays: the exact kernel's valid rows as float4
// (min x, max x, y; H), the packed chain points (float2, 2M), for each of
// the 2M directions ux, uy, min_u, max_u, min_v, max_v, area and the
// caliper key, the compacted valid rows (y, min x, max x; H each), two
// chains' alive and deleted bitmasks, and the exact kernel's kept
// directions' slots (2M).  All in shared memory.
__host__ __device__ constexpr size_t rect_bitmask_bytes(int H) {
  return 16 * static_cast<size_t>((H + 31) / 32);
}

template <bool kExact>
__host__ __device__ constexpr size_t rect_smem_bytes(int H, int M) {
  return ((kExact ? 4 * static_cast<size_t>(H) : 0) + 4 * static_cast<size_t>(M) +
          16 * static_cast<size_t>(M) + 3 * static_cast<size_t>(H) +
          (kExact ? 2 * static_cast<size_t>(M) : 0)) *
             4 +
         rect_bitmask_bytes(H);
}

// The block reductions' slots, static shared memory beside the arrays.
template <int kT>
struct RectShared {
  int cnt[kT / 32], mn[kT / 32], mx[kT / 32], first[kT / 32], nchain[2], moving[2];
  float amin[kT / 32], phi[kT / 32];
};

// The largest H whose arrays fit one block's shared memory beside the
// reduction slots: the exact kernel's cap, the tall instance above it.
constexpr size_t kSmemLimit = 232448;
constexpr int max_exact_height() {
  int h = 1;
  while (rect_smem_bytes<true>(h + 1, h + 1) + sizeof(RectShared<kThreads>) <= kSmemLimit) ++h;
  return h;
}
constexpr int kMaxExactHeight = max_exact_height();
constexpr int kRounds = 4;  // lockstep rounds before the slope rule finishes

// One component, its arrays in ``big`` (shared memory).
template <bool kExact>
__device__ __forceinline__ void rect_component(
    const int* __restrict__ minx, const int* __restrict__ maxx, float* __restrict__ out,
    int comp, int K, int H, int M, float4* big, RectShared<kThreads>& st) {
  constexpr int kT = kThreads;
  float4* rows = big;  // kExact: (min x, max x, y) of the valid rows
  float2* pts = reinterpret_cast<float2*>(big + (kExact ? H : 0));  // left [0, M), right [M, 2M)
  const int D = 2 * M;
  const int NW = (H + 31) / 32;
  float* d_ux = reinterpret_cast<float*>(pts + D);  // per direction
  float* d_uy = d_ux + D;
  float* d_mnu = d_uy + D;
  float* d_mxu = d_mnu + D;
  float* d_mnv = d_mxu + D;
  float* d_mxv = d_mnv + D;
  float* d_area = d_mxv + D;
  float* d_phi = d_area + D;
  int* r_y = reinterpret_cast<int*>(d_phi + D);  // valid rows, compacted
  int* r_l = r_y + H;
  int* r_r = r_l + H;
  unsigned* alive = reinterpret_cast<unsigned*>(r_r + H);  // (2, NW)
  unsigned* dead = alive + 2 * NW;                                         // (2, NW)
  // kExact: kept directions' slots
  int* u_d = reinterpret_cast<int*>(dead + 2 * NW);
  constexpr int kW = kT / 32;
  int* const s_cnt = st.cnt;
  int* const s_mn = st.mn;
  int* const s_mx = st.mx;
  int* const s_first = st.first;
  int* const s_nchain = st.nchain;
  int* const s_moving = st.moving;
  float* const s_amin = st.amin;
  float* const s_phi = st.phi;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;

  // 1. compact the valid rows; the horizontal candidate's extents
  const long long base = static_cast<long long>(comp) * H;
  int n = 0, mn = kBig, mx = -kBig;
  for (int y0 = 0; y0 < H; y0 += kT) {
    const int y = y0 + tid;
    const int l = y < H ? minx[base + y] : 0;
    const int r = y < H ? maxx[base + y] : -1;
    const bool ok = r >= 0;
    const int off = compact_slot<kT>(ok, n, s_cnt);
    if (ok) {
      r_y[off] = y;
      r_l[off] = l;
      r_r[off] = r;
      if (kExact) {
        rows[off] = make_float4(static_cast<float>(l), static_cast<float>(r),
                                static_cast<float>(y), 0.f);
      }
      mn = min(mn, l);
      mx = max(mx, r);
    }
  }
  __syncthreads();
  mn = __reduce_min_sync(kFull, mn);
  mx = __reduce_max_sync(kFull, mx);
  if (lane == 0) {
    s_mn[warp] = mn;
    s_mx[warp] = mx;
  }
  __syncthreads();
  for (int w = 0; w < kW; ++w) {
    mn = min(mn, s_mn[w]);
    mx = max(mx, s_mx[w]);
  }
  const bool has = n > 0;
  const int top = has ? r_y[0] : kBig;
  const int bot = has ? r_y[n - 1] : -kBig;
  const bool hok = has && (r_r[0] - r_l[0] > 0 || r_r[n - 1] - r_l[n - 1] > 0);

  // 2. convexify both chains.  Warp 0 runs the left chain's lockstep
  // rounds, warp 1 the right one's, as the TPU kernels do: every strictly
  // concave point deleted at once, alive neighbours found in bitmasks.  A
  // chain still moving after kRounds is finished by the whole block with
  // the slope rule over the rows left (lockstep deletes no hull point, so
  // both end at the same set).  Then each chain's warp packs its first M
  // kept points by rank.
  const int nw = (n + 31) / 32;
  if (warp < 2 && has) {
    const int* xs = warp == 0 ? r_l : r_r;
    const int sign = warp == 0 ? 1 : -1;
    unsigned* al = alive + warp * NW;
    unsigned* dl = dead + warp * NW;
    for (int k = lane; k < nw; k += 32) {
      const int rest = n - 32 * k;
      al[k] = rest >= 32 ? kFull : (1u << rest) - 1u;
    }
    __syncwarp();
    bool settled = false;
    for (int round = 0; round < kRounds && !settled; ++round) {
      unsigned any = 0;
      for (int k = 0; k < nw; ++k) {
        const int i = 32 * k + lane;
        bool concave = false;
        if ((al[k] >> lane) & 1u) {
          const int j = prev_bit(al, k, lane);
          const int c = next_bit(al, k, lane, nw);
          if (j >= 0 && c >= 0) {
            const int cross = (xs[i] - xs[j]) * (r_y[c] - r_y[j]) -
                              (r_y[i] - r_y[j]) * (xs[c] - xs[j]);
            concave = sign * cross > 0;
          }
        }
        const unsigned dm = __ballot_sync(kFull, concave);
        if (lane == 0) dl[k] = dm;
        any |= dm;
      }
      __syncwarp();
      settled = any == 0;
      for (int k = lane; k < nw && !settled; k += 32) al[k] &= ~dl[k];
      __syncwarp();
    }
    if (lane == 0) s_moving[warp] = !settled;
  } else if (warp < 2 && lane == 0) {
    s_moving[warp] = 0;
  }
  __syncthreads();
  if (kExact && (s_moving[0] || s_moving[1])) {
    // the slope rule below over each chain's alive rows only: the rows
    // compacted in order to (x, y, row) lists, left in [0, n), right in
    // [H, H + n) of the directions' arrays (unused until step 3; the
    // compact kernel's, 2M a direction array, are too small for them)
    const int S = mx + 1;  // > |dx| of any two rows: a slope sentinel
    int4* lst = reinterpret_cast<int4*>(d_ux);
    int cl = 0, cr = 0;
    for (int i0 = 0; i0 < n; i0 += kT) {
      const int i = i0 + tid;
      const bool own = i < n;
      const unsigned bit = 1u << (i & 31);
      const bool al_l = own && (alive[i >> 5] & bit);
      const bool al_r = own && (alive[NW + (i >> 5)] & bit);
      const int ol = compact_slot<kT>(al_l, cl, s_cnt);
      if (al_l) lst[ol] = make_int4(r_l[i], r_y[i], i, 0);
      const int orr = compact_slot<kT>(al_r, cr, s_cnt);
      if (al_r) lst[H + orr] = make_int4(r_r[i], r_y[i], i, 0);
    }
    for (int k = tid; k < 2 * NW; k += kT) dead[k] = 0;
    __syncthreads();
    for (int a = tid; a < cl + cr; a += kT) {
      const bool left = a < cl;
      const int4* L = left ? lst : lst + H;
      const int cn = left ? cl : cr;
      const int ai = left ? a : a - cl;
      const int sg = left ? 1 : -1;
      const int4 p = L[ai];
      int e_n = -S, e_d = 1, f_n = S, f_d = 1;
      for (int b = 0; b < cn; ++b) {
        const int4 q = L[b];
        if (b < ai) {
          const int num = sg * (p.x - q.x);
          if (steeper(num, p.y - q.y, e_n, e_d)) { e_n = num; e_d = p.y - q.y; }
        } else if (b > ai) {
          const int num = sg * (q.x - p.x);
          if (steeper(f_n, f_d, num, q.y - p.y)) { f_n = num; f_d = q.y - p.y; }
        }
      }
      if (!steeper(e_n, e_d, f_n, f_d)) {
        atomicOr(&dead[(left ? 0 : NW) + (p.z >> 5)], 1u << (p.z & 31));
      }
    }
    __syncthreads();
    for (int k = tid; k < 2 * NW; k += kT) alive[k] = dead[k];
    __syncthreads();
  } else if (s_moving[0] || s_moving[1]) {
    // a row stays iff its largest slope dx/dy back to an alive row is <= its
    // smallest slope forward; threads over rows, both chains at once
    const int S = mx + 1;  // > |dx| of any two rows: a slope sentinel
    for (int i0 = 0; i0 < n; i0 += kT) {
      const int i = i0 + tid;
      const bool own = i < n;
      const int yi = own ? r_y[i] : 0;
      const int li = own ? r_l[i] : 0;
      const int ri = own ? r_r[i] : 0;
      const unsigned bit = 1u << (i & 31);
      const bool al_l = own && (alive[i >> 5] & bit);
      const bool al_r = own && (alive[NW + (i >> 5)] & bit);
      int le_n = -S, le_d = 1, lf_n = S, lf_d = 1;
      int re_n = -S, re_d = 1, rf_n = S, rf_d = 1;
      for (int j = 0; j < n; ++j) {
        const unsigned jb = 1u << (j & 31);
        const bool jl = alive[j >> 5] & jb;
        const bool jr = alive[NW + (j >> 5)] & jb;
        const int yj = r_y[j];
        if (j < i) {
          const int dy = yi - yj;
          if (jl && steeper(li - r_l[j], dy, le_n, le_d)) { le_n = li - r_l[j]; le_d = dy; }
          if (jr && steeper(r_r[j] - ri, dy, re_n, re_d)) { re_n = r_r[j] - ri; re_d = dy; }
        } else if (j > i) {
          const int dy = yj - yi;
          if (jl && steeper(lf_n, lf_d, r_l[j] - li, dy)) { lf_n = r_l[j] - li; lf_d = dy; }
          if (jr && steeper(rf_n, rf_d, ri - r_r[j], dy)) { rf_n = ri - r_r[j]; rf_d = dy; }
        }
      }
      const unsigned kl = __ballot_sync(kFull, al_l && !steeper(le_n, le_d, lf_n, lf_d));
      const unsigned kr = __ballot_sync(kFull, al_r && !steeper(re_n, re_d, rf_n, rf_d));
      if (lane == 0 && (i >> 5) < nw) {
        dead[i >> 5] = kl;
        dead[NW + (i >> 5)] = kr;
      }
    }
    __syncthreads();
    for (int k = tid; k < 2 * NW; k += kT) alive[k] = dead[k];
    __syncthreads();
  }
  if (warp < 2 && has) {
    const int* xs = warp == 0 ? r_l : r_r;
    const unsigned* al = alive + warp * NW;
    int kept = 0;
    for (int k = 0; k < nw; ++k) {
      const unsigned word = al[k];
      const int rank = kept + __popc(word & below);
      if (((word >> lane) & 1u) && rank < M) {
        const int i = 32 * k + lane;
        pts[warp * M + rank] = make_float2(static_cast<float>(xs[i]), static_cast<float>(r_y[i]));
      }
      kept += __popc(word);
    }
    if (lane == 0) s_nchain[warp] = min(kept, M);
  } else if (warp < 2 && lane == 0) {
    s_nchain[warp] = 0;
  }
  __syncthreads();
  const int nl = s_nchain[0];
  const int nr = s_nchain[1];

  // 3. the directions: d = e on the left chain, M + e on the right, for the
  // edge from packed point e to e + 1.  Two consecutive points of a chain
  // lie on different rows, so every such direction has el2 >= 1.
  const int ndl = max(nl - 1, 0);
  const int ndir = ndl + max(nr - 1, 0);
  float amin = kInf;
  int cnt = ndir;  // the directions the selection ranges over
  if (kExact) {
    // keep a direction unless it equals the one before it on its chain,
    // compacted in order: u_d[j] is the slot, index j its arrays
    cnt = 0;
    for (int c0 = 0; c0 < ndir; c0 += kT) {
      const int c = c0 + tid;
      const int d = c < ndl ? c : M + (c - ndl);
      float ex = 0.f, ey = 0.f;
      bool keep = false;
      if (c < ndir) {
        ex = pts[d + 1].x - pts[d].x;
        ey = pts[d + 1].y - pts[d].y;
        keep = c == 0 || c == ndl || ex != pts[d].x - pts[d - 1].x ||
               ey != pts[d].y - pts[d - 1].y;
      }
      const int j = compact_slot<kT>(keep, cnt, s_cnt);
      if (keep) {
        const float el2 = __fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey));
        const float inv = rsqrtf(fmaxf(el2, 1e-30f));
        u_d[j] = d;
        d_ux[j] = __fmul_rn(ex, inv);
        d_uy[j] = __fmul_rn(ey, inv);
      }
    }
    __syncthreads();
    // G lanes a direction, each over every G-th valid row's two extremes
    int G = 1;
    while (G < 32 && cnt * 2 * G <= kT) G *= 2;
    const int groups = kT / G;
    const int g = tid / G;
    const int gl = tid - g * G;
    for (int j0 = 0; j0 < cnt; j0 += groups) {
      const int j = j0 + g;
      const bool own = j < cnt;
      const float ux = own ? d_ux[j] : 0.f;
      const float uy = own ? d_uy[j] : 0.f;
      float mnu = kInf, mxu = -kInf, mnv = kInf, mxv = -kInf;
      if (own) {
#pragma unroll 2
        for (int i = gl; i < n; i += G) {
          const float4 q = rows[i];
          project(ux, uy, q.x, q.z, mnu, mxu, mnv, mxv);
          project(ux, uy, q.y, q.z, mnu, mxu, mnv, mxv);
        }
      }
      for (int off = G >> 1; off > 0; off >>= 1) {  // block-uniform
        mnu = fminf(mnu, __shfl_xor_sync(kFull, mnu, off));
        mxu = fmaxf(mxu, __shfl_xor_sync(kFull, mxu, off));
        mnv = fminf(mnv, __shfl_xor_sync(kFull, mnv, off));
        mxv = fmaxf(mxv, __shfl_xor_sync(kFull, mxv, off));
      }
      if (own && gl == 0) {
        const float area = __fmul_rn(__fsub_rn(mxu, mnu), __fsub_rn(mxv, mnv));
        d_mnu[j] = mnu;
        d_mxu[j] = mxu;
        d_mnv[j] = mnv;
        d_mxv[j] = mxv;
        d_area[j] = area;
        d_phi[j] = fold_phi_key(ux, uy);
        amin = fminf(amin, area);
      }
    }
  } else {
    // threads over the valid directions, each projected over the nl + nr
    // packed points
    for (int c = tid; c < ndir; c += kT) {
      const int d = c < ndl ? c : M + (c - ndl);
      const float ex = pts[d + 1].x - pts[d].x;
      const float ey = pts[d + 1].y - pts[d].y;
      const float el2 = __fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey));
      const float inv = rsqrtf(fmaxf(el2, 1e-30f));
      const float ux = __fmul_rn(ex, inv);
      const float uy = __fmul_rn(ey, inv);
      float mnu = kInf, mxu = -kInf, mnv = kInf, mxv = -kInf;
#pragma unroll 4
      for (int p = 0; p < nl; ++p) project(ux, uy, pts[p].x, pts[p].y, mnu, mxu, mnv, mxv);
#pragma unroll 4
      for (int p = M; p < M + nr; ++p) project(ux, uy, pts[p].x, pts[p].y, mnu, mxu, mnv, mxv);
      const float area = __fmul_rn(__fsub_rn(mxu, mnu), __fsub_rn(mxv, mnv));
      d_ux[d] = ux;
      d_uy[d] = uy;
      d_mnu[d] = mnu;
      d_mxu[d] = mxu;
      d_mnv[d] = mnv;
      d_mxv[d] = mxv;
      d_area[d] = area;
      d_phi[d] = fold_phi_key(ux, uy);
      amin = fminf(amin, area);
    }
  }
  // where direction c's values are: its slot, or (kExact) its index
  auto at = [&](int c) { return kExact ? c : (c < ndl ? c : M + (c - ndl)); };

  // 4. selection by block reductions: min area, then the caliper key within
  // the tie threshold, then the lowest direction; the horizontal
  // candidate's key is 0
  const float h_area =
      hok ? __fmul_rn(static_cast<float>(mx - mn), static_cast<float>(bot - top)) : kInf;
  amin = warp_min(amin);
  if (lane == 0) s_amin[warp] = amin;
  __syncthreads();
  for (int w = 0; w < kW; ++w) amin = fminf(amin, s_amin[w]);
  amin = fminf(amin, h_area);
  const float thresh = __fadd_rn(__fmul_rn(amin, 1.000001f), 1e-9f);
  float phi = kInf;
  for (int c = tid; c < cnt; c += kT) {
    if (d_area[at(c)] <= thresh) phi = fminf(phi, d_phi[at(c)]);
  }
  phi = warp_min(phi);
  if (lane == 0) s_phi[warp] = phi;
  __syncthreads();
  float best = (hok && h_area <= thresh) ? 0.f : kInf;
  for (int w = 0; w < kW; ++w) best = fminf(best, s_phi[w]);
  int first = INT_MAX;
  for (int c = tid; c < cnt; c += kT) {
    if (d_area[at(c)] <= thresh && d_phi[at(c)] <= best) {
      first = c;
      break;
    }
  }
  first = __reduce_min_sync(kFull, first);
  if (lane == 0) s_first[warp] = first;
  __syncthreads();
  if (tid != 0) return;
  for (int w = 0; w < kW; ++w) first = min(first, s_first[w]);
  float vals[6];
  if (first != INT_MAX) {
    const int f = at(first);
    vals[0] = d_ux[f];
    vals[1] = d_uy[f];
    vals[2] = d_mnu[f];
    vals[3] = d_mxu[f];
    vals[4] = d_mnv[f];
    vals[5] = d_mxv[f];
  } else {
    vals[0] = 1.f;
    vals[1] = 0.f;
    vals[2] = static_cast<float>(mn);
    vals[3] = static_cast<float>(mx);
    vals[4] = static_cast<float>(top);
    vals[5] = static_cast<float>(bot);
  }
  const int b = comp / K;
  const int k = comp - b * K;
  float* o = out + static_cast<long long>(b) * 9 * K + k;
#pragma unroll
  for (int r = 0; r < 6; ++r) o[r * K] = vals[r];
  o[6 * K] = (first != INT_MAX || hok) ? 1.f : 0.f;
  o[7 * K] = static_cast<float>(has ? r_l[0] : 0);
  o[8 * K] = static_cast<float>(has ? top : 0);
}

template <bool kExact>
__global__ void __launch_bounds__(kThreads)
rect_kernel(const int* __restrict__ minx, const int* __restrict__ maxx,
            float* __restrict__ out, int K, int H, int M) {
  extern __shared__ float4 smem4[];
  __shared__ RectShared<kThreads> st;
  rect_component<kExact>(minx, maxx, out, blockIdx.x, K, H, M, smem4, st);
}

// ---------------------------------------------------------------------------
// The tall instance: one component a cluster of kCS blocks (file comment).
// ---------------------------------------------------------------------------

constexpr int kCS = 8;        // blocks a cluster (the portable cluster size)
constexpr int kCT = 256;      // threads a block
constexpr int kCW = kCT / 32;
constexpr int kSeg = 32;      // rows a level-0 segment: one warp's
constexpr int kDc = 512;      // directions a projection chunk
constexpr int kScalars = 16;  // a block's slots for the cluster's reductions
constexpr int kSoloRows = 1024;  // a component of at most this many rows: block 0 alone
enum TallScalar {
  kSValid = 0, kSMn, kSMx, kSKeptL, kSKeptR, kSDirs, kSAmin, kSPhi, kSFirst, kSConcave
};

// The kernel's static shared memory.
struct TallShared {
  unsigned char* base[kCS];  // where each block's arrays start (its shared memory or workspace)
  int cnt[kCW];              // compact_slot's counts
  int red_i[kCW];
  float red_f[kCW];
};

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

// A block's arrays, from H alone (ops/cuda/rect_kernel.py tall_plan keeps a
// copy; rect_tall_plan returns these numbers for the card's test); hb, a
// power of two, is the compacted rows a block, so a position's block and
// index are a shift and a mask:
//   rows  float4 (min x, max x, y) of compacted positions [r hb, (r+1) hb);
//   hull  int2 [2][hb]: the chains' hull vertices, then their kept points;
//   dirs  float [8][db]: ux, uy, min u, max u, min v, max v, area, key;
//   cnt   int [2][hb / 32]: a segment group's vertex count;
//   kept  uint8 [hb]: bit c set where the position's point is on chain c;
//   scal  int [kScalars].
// Then, in shared memory whatever the mode, the projection's partial
// extremes (float4 [kDc]) and staged directions (float2 [kDc]).
struct TallLayout {
  int hb, db, off_hull, off_dirs, off_cnt, off_kept, off_scal, block_bytes, smem, in_shared, lg;
};

__host__ __device__ constexpr int tall_fixed_bytes() { return kDc * 16 + kDc * 8; }

__host__ __device__ inline TallLayout tall_layout(int H) {
  TallLayout t{};
  t.lg = 5;  // hb = 2^lg >= 32, the least with kCS hb >= H
  while ((kCS << t.lg) < H) ++t.lg;
  t.hb = 1 << t.lg;
  t.db = 2 * t.hb;
  t.off_hull = 16 * t.hb;
  t.off_dirs = t.off_hull + 2 * 8 * t.hb;
  t.off_cnt = t.off_dirs + 8 * 4 * t.db;
  t.off_kept = t.off_cnt + round16(2 * 4 * (t.hb / kSeg));
  t.off_scal = t.off_kept + round16(t.hb);
  t.block_bytes = t.off_scal + 4 * kScalars;
  t.in_shared = t.block_bytes + tall_fixed_bytes() + static_cast<int>(sizeof(TallShared)) <=
                static_cast<int>(kSmemLimit);
  t.smem = tall_fixed_bytes() + (t.in_shared ? t.block_bytes : 0);
  return t;
}

// The cluster-wide arrays: element idx of an array with 2^lg elements a
// block lives in block idx >> lg.  kShm: the blocks' shared memory (read
// through distributed shared memory); else a device-memory workspace, read
// past L1 (another block of the cluster may have written it).
template <bool kShm>
struct TallArrays {
  unsigned char* const* base;
  TallLayout L;
  int hs;  // segments a block

  template <typename T>
  __device__ __forceinline__ T* at(int off, int idx, int lg) const {
    return reinterpret_cast<T*>(base[idx >> lg] + off) + (idx & ((1 << lg) - 1));
  }
  template <typename T>
  __device__ __forceinline__ static T rd(const T* p) {
    if constexpr (kShm) {
      return *p;
    } else {
      return __ldcg(p);
    }
  }
  __device__ __forceinline__ float4* row(int P) const { return at<float4>(0, P, L.lg); }
  __device__ __forceinline__ int2* hull(int c, int P) const {
    return at<int2>(L.off_hull + c * 8 * L.hb, P, L.lg);
  }
  __device__ __forceinline__ float* dir(int a, int j) const {
    return at<float>(L.off_dirs + a * 4 * L.db, j, L.lg + 1);
  }
  __device__ __forceinline__ int* cnt(int c, int s) const {
    return at<int>(L.off_cnt + c * 4 * hs, s, L.lg - 5);
  }
  __device__ __forceinline__ unsigned char* kept(int P) const {
    return at<unsigned char>(L.off_kept, P, L.lg);
  }
  __device__ __forceinline__ int* scal(int r, int k) const {
    return reinterpret_cast<int*>(base[r] + L.off_scal) + k;
  }
};

// Block reductions over kCT threads through red (kCW slots); every thread
// gets the result.
__device__ __forceinline__ int block_sum(int v, int* red) {
  v = __reduce_add_sync(kFull, v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = 0;
  for (int w = 0; w < kCW; ++w) s += red[w];
  __syncthreads();
  return s;
}
__device__ __forceinline__ int block_min(int v, int* red) {
  v = __reduce_min_sync(kFull, v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  for (int w = 0; w < kCW; ++w) v = min(v, red[w]);
  __syncthreads();
  return v;
}
__device__ __forceinline__ int block_max(int v, int* red) {
  v = __reduce_max_sync(kFull, v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  for (int w = 0; w < kCW; ++w) v = max(v, red[w]);
  __syncthreads();
  return v;
}
__device__ __forceinline__ float block_min_f(float v, float* red) {
  v = warp_min(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  for (int w = 0; w < kCW; ++w) v = fminf(v, red[w]);
  __syncthreads();
  return v;
}

// Whether the lane's point (x, y) is a strict vertex of the lower hull of
// the first cnt lanes' points (y rising): its largest slope dx/dy back is
// below its smallest slope forward (sentinels -S, S; int32
// cross-multiplication), a warp's 32 shuffles.
__device__ __forceinline__ bool strict_vertex(int x, int y, int cnt, int S, int lane) {
  int en = -S, ed = 1, fn = S, fd = 1;
  for (int k = 0; k < 32; ++k) {
    const int xk = __shfl_sync(kFull, x, k), yk = __shfl_sync(kFull, y, k);
    if (k >= cnt) continue;
    if (k < lane) {
      if (steeper(x - xk, y - yk, en, ed)) {
        en = x - xk;
        ed = y - yk;
      }
    } else if (k > lane) {
      if (steeper(fn, fd, xk - x, yk - y)) {
        fn = xk - x;
        fd = yk - y;
      }
    }
  }
  return lane < cnt && steeper(fn, fd, en, ed);
}

// Merge the hulls of segment groups [sA, sB) (A) and [sB, ...) (B) of chain
// c, one warp: keep A up to the bridge's first point and B from its last,
// B's part copied behind A's; the group's count goes to segment sA.  Hulls
// are strict (no three vertices collinear); points are (x, y), y rising.
template <bool kShm>
__device__ __forceinline__ void merge_hulls(const TallArrays<kShm>& T, int c, int sA, int sB,
                                            int lane) {
  using A_ = TallArrays<kShm>;
  const int cA = A_::rd(T.cnt(c, sA)), cB = A_::rd(T.cnt(c, sB));
  if (cB == 0) return;
  const int bA = sA * kSeg, bB = sB * kSeg;
  int i = -1, j = 0;  // keep A[0 .. i], B[j ..]
  if (cA > 0) {
    // the tangent from (bx, by) to A: the first i whose next vertex is not
    // left of the line from vertex i to (bx, by)
    auto tangent = [&](int bx, int by) {
      int lo = 0, hi = cA - 1;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        const int2 a = A_::rd(T.hull(c, bA + mid)), a1 = A_::rd(T.hull(c, bA + mid + 1));
        if ((a1.x - a.x) * (by - a.y) >= (bx - a.x) * (a1.y - a.y)) {
          hi = mid;
        } else {
          lo = mid + 1;
        }
      }
      return lo;
    };
    // B's vertex jj is the bridge's or before it: its next vertex lies
    // strictly right of the tangent from A through it (monotone in jj)
    auto past = [&](int jj) {
      const int2 b = A_::rd(T.hull(c, bB + jj)), b1 = A_::rd(T.hull(c, bB + jj + 1));
      const int2 a = A_::rd(T.hull(c, bA + tangent(b.x, b.y)));
      return (b1.x - b.x) * (b.y - a.y) > (b.x - a.x) * (b1.y - b.y);
    };
    int lo = 0, hi = cB - 1;  // the first jj with past(jj); past(cB - 1) by definition
    while (lo < hi) {
      const int step = (hi - lo + 31) >> 5;
      const int jj = lo + lane * step;
      const unsigned m = __ballot_sync(kFull, jj < hi && past(jj));
      if (m) {
        const int k0 = __ffs(m) - 1;
        const int nhi = lo + k0 * step;
        lo = k0 > 0 ? lo + (k0 - 1) * step + 1 : lo;
        hi = nhi;
      } else {
        lo += (hi - 1 - lo) / step * step + 1;
      }
    }
    j = lo;
    const int2 b = A_::rd(T.hull(c, bB + j));
    i = tangent(b.x, b.y);
  }
  // B[j ..] behind A[i]: the destination precedes the source, so each
  // 32-vertex chunk is read before it is written
  const int dst = bA + i + 1, src = bB + j, n = cB - j;
  for (int k0 = 0; k0 < n; k0 += 32) {
    const bool own = k0 + lane < n;
    int2 v = make_int2(0, 0);
    if (own) v = A_::rd(T.hull(c, src + k0 + lane));
    __syncwarp();
    if (own) *T.hull(c, dst + k0 + lane) = v;
    __syncwarp();
  }
  if (lane == 0) *T.cnt(c, sA) = i + 1 + n;
}

// Step R: the lockstep's first round, where every row is alive, over
// positions [p_lo, p_hi): bit c set where a row of chain c is strictly
// concave between the rows before and after it.  A chain with no such row
// settles in that round (it is convex, every row on its hull) and keeps
// every row, as the one-block kernel's rounds keep them.
template <bool kShm>
__device__ __forceinline__ int concave_chains(const TallArrays<kShm>& T, int n, int p_lo,
                                              int p_hi) {
  using A_ = TallArrays<kShm>;
  int any = 0;
  for (int P = max(p_lo, 1) + threadIdx.x; P < min(p_hi, n - 1); P += kCT) {
    const float4 a = A_::rd(T.row(P - 1)), q = A_::rd(T.row(P)), e = A_::rd(T.row(P + 1));
    const int ya = static_cast<int>(a.z), yq = static_cast<int>(q.z), ye = static_cast<int>(e.z);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int xa = static_cast<int>(c == 0 ? a.x : a.y);
      const int xq = static_cast<int>(c == 0 ? q.x : q.y);
      const int xe = static_cast<int>(c == 0 ? e.x : e.y);
      const int cross = (xq - xa) * (ye - ya) - (yq - ya) * (xe - xa);
      if ((c == 0 ? cross : -cross) > 0) any |= 1 << c;
    }
  }
  return (__syncthreads_or(any & 1) ? 1 : 0) | (__syncthreads_or(any & 2) ? 2 : 0);
}

template <bool kShm>
__global__ void __cluster_dims__(kCS, 1, 1) __launch_bounds__(kCT, 4)
rect_cluster_kernel(const int* __restrict__ minx, const int* __restrict__ maxx,
                    float* __restrict__ out, unsigned char* __restrict__ ws, int n_comp, int K,
                    int H) {
  using A_ = TallArrays<kShm>;
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ TallShared st;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  const TallLayout L = tall_layout(H);
  const int cid = blockIdx.x / kCS, n_clusters = gridDim.x / kCS;
  float4* part = reinterpret_cast<float4*>(dyn + (kShm ? L.block_bytes : 0));
  float2* stg = reinterpret_cast<float2*>(part + kDc);
  if (tid < kCS) {  // a block's own shared memory through its local window (no DSMEM hop)
    st.base[tid] =
        !kShm ? ws + (static_cast<size_t>(cid) * kCS + tid) * L.block_bytes
        : tid == rank
            ? dyn
            : static_cast<unsigned char*>(cluster.map_shared_rank(static_cast<void*>(dyn), tid));
  }
  __syncthreads();
  cluster.sync();  // every block of the cluster runs before its memory is touched
  const TallArrays<kShm> T{st.base, L, L.hb / kSeg};
  auto csync = [&]() {
    if constexpr (!kShm) __threadfence();
    cluster.sync();
  };
  const int Hr = (H + kCS - 1) / kCS;  // map rows a block reads
  const int y_lo = min(H, rank * Hr), y_hi = min(H, y_lo + Hr);

  for (int comp = cid; comp < n_comp; comp += n_clusters) {
    const long long rbase = static_cast<long long>(comp) * H;
    const int b = comp / K;
    float* o = out + static_cast<long long>(b) * 9 * K + (comp - b * K);
    TALL_STAMP(0);

    // A. the valid rows: counts and extents, then compacted in order
    int cnt = 0, mn = kBig, mx = -kBig;
    for (int y = y_lo + tid; y < y_hi; y += kCT) {
      const int r = maxx[rbase + y];
      if (r >= 0) {
        ++cnt;
        mn = min(mn, minx[rbase + y]);
        mx = max(mx, r);
      }
    }
    cnt = block_sum(cnt, st.red_i);
    mn = block_min(mn, st.red_i);
    mx = block_max(mx, st.red_i);
    if (tid == 0) {
      *T.scal(rank, kSValid) = cnt;
      *T.scal(rank, kSMn) = mn;
      *T.scal(rank, kSMx) = mx;
    }
    csync();
    int n = 0, off = 0;
    for (int r = 0; r < kCS; ++r) {
      const int c = A_::rd(T.scal(r, kSValid));
      off += r < rank ? c : 0;
      n += c;
      mn = min(mn, A_::rd(T.scal(r, kSMn)));
      mx = max(mx, A_::rd(T.scal(r, kSMx)));
    }
    // a component of at most kSoloRows rows is finished by block 0 alone,
    // with block barriers (its arrays stay where they are, reached through
    // distributed shared memory); the others wait at the closing barrier
    const bool solo = n <= kSoloRows;
    const int nr = solo ? 1 : kCS;  // the blocks whose scalars count
    auto ssync = [&]() {
      if (solo) {
        __syncthreads();
      } else {
        csync();
      }
    };
    if (n == 0) {  // no row: the horizontal candidate's empty extents, no edge
      if (rank == 0 && tid == 0) {
        const float vals[9] = {1.f, 0.f, static_cast<float>(mn), static_cast<float>(mx),
                               static_cast<float>(kBig), static_cast<float>(-kBig), 0.f, 0.f, 0.f};
        for (int r = 0; r < 9; ++r) o[r * K] = vals[r];
      }
      csync();  // the scalars are the next component's
      continue;
    }
    for (int y0 = y_lo; y0 < y_hi; y0 += kCT) {
      const int y = y0 + tid;
      const int l = y < y_hi ? minx[rbase + y] : 0;
      const int r = y < y_hi ? maxx[rbase + y] : -1;
      const bool ok = r >= 0;
      const int P = compact_slot<kCT>(ok, off, st.cnt);
      if (ok)
        *T.row(P) = make_float4(static_cast<float>(l), static_cast<float>(r),
                                static_cast<float>(y), 0.f);
    }
    csync();
    TALL_STAMP(1);

    if (solo && n <= L.hb && rank != 0) {  // block 0 holds every position
      csync();  // block 0's closing barrier
      continue;
    }

    // R. the lockstep's first round, each block over its own positions
    // (block 0 over all where it holds them all), the blocks' results met
    // at one cluster barrier: a chain convex in every block skips B
    const int own_lo = min(n, rank * L.hb), own_hi = min(n, own_lo + L.hb);
    int moving;  // bit c: chain c has a concave row; its kept rows come from its merged hull
    if (solo && n <= L.hb) {
      moving = concave_chains<kShm>(T, n, 0, n);
    } else {
      const int concave = concave_chains<kShm>(T, n, own_lo, own_hi);
      if (tid == 0) *T.scal(rank, kSConcave) = concave;
      csync();
      moving = 0;
      for (int r = 0; r < kCS; ++r) moving |= A_::rd(T.scal(r, kSConcave));
      if (solo && rank != 0 && moving == 0) {  // block 0 finishes alone
        csync();  // block 0's closing barrier
        continue;
      }
    }
    TALL_STAMP(2);

    // B. level 0: each segment's strict hull vertices on each moving chain
    // (the right chain's x negated), by the slope rule within the warp
    const int S = mx + 1;  // > |dx| of any two points: a slope sentinel
    const int nseg = (n + kSeg - 1) / kSeg;
    const int s_lo = rank * T.hs, s_hi = min(nseg, s_lo + T.hs);  // the block's segments
    if (moving != 0) {
      for (int s = s_lo + warp; s < s_hi; s += kCW) {
        const int P = s * kSeg + lane;
        const bool ok = P < n;
        const float4 q = ok ? A_::rd(T.row(P)) : make_float4(0.f, 0.f, 0.f, 0.f);
        const int yy = static_cast<int>(q.z);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          if (!((moving >> c) & 1)) continue;
          const int xx = c == 0 ? static_cast<int>(q.x) : -static_cast<int>(q.y);
          const bool vert = strict_vertex(xx, yy, min(kSeg, n - s * kSeg), S, lane);
          const unsigned m = __ballot_sync(kFull, vert);
          if (vert) *T.hull(c, s * kSeg + __popc(m & below)) = make_int2(xx, yy);
          if (lane == 0) *T.cnt(c, s) = __popc(m);
        }
      }
      // the merge levels: groups of 2, 4, ... segments, each merged by the
      // warp of the block that holds its first segment; a solo component's
      // levels past the block-local ones are block 0's alone (one cluster
      // barrier hands them over), so every block's warps take level 0
      bool alone = solo && n <= L.hb;  // block 0 works alone
      for (int lv = 0; (1 << lv) < nseg; ++lv) {
        const int gsz = 2 << lv;
        const bool local = T.hs % gsz == 0;
        if (solo && !alone && !local) {
          csync();
          alone = true;
          if (rank != 0) break;
        }
        if (alone || local) {
          __syncthreads();  // the group's halves were written by this block
        } else {
          csync();
        }
        const int g_lo = alone ? 0 : (s_lo + gsz - 1) / gsz;
        const int g_hi = alone ? (nseg + gsz - 1) / gsz
                               : min((s_lo + T.hs + gsz - 1) / gsz, (nseg + gsz - 1) / gsz);
        for (int w = warp; w < 2 * (g_hi - g_lo); w += kCW) {  // a warp a group and chain
          const int sA = (g_lo + (w >> 1)) * gsz, sB = sA + gsz / 2;
          if (sB < nseg && ((moving >> (w & 1)) & 1)) merge_hulls<kShm>(T, w & 1, sA, sB, lane);
        }
      }
      if (solo && !alone) csync();  // every level stayed inside the blocks: hand over here
      if (solo && rank != 0) {
        csync();  // block 0's closing barrier
        continue;
      }
    }
    ssync();
    TALL_STAMP(3);
    TALL_INFO(0, n);
    TALL_INFO(1, moving);

    // C. the kept rows: on a chain convex in R every row, on a moving one a
    // point on its merged hull, a vertex or on an edge; ranked across the
    // cluster (both chains convex: kept point P is row P, written by the
    // block that holds it)
    const int p_lo = solo ? 0 : rank * L.hb, p_hi = solo ? n : min(n, p_lo + L.hb);
    int nk0 = n, nk1 = n;
    if (moving == 0) {
      for (int P = p_lo + tid; P < p_hi; P += kCT) {
        const float4 q = A_::rd(T.row(P));
        *T.hull(0, P) = make_int2(static_cast<int>(q.x), static_cast<int>(q.z));
        *T.hull(1, P) = make_int2(static_cast<int>(q.y), static_cast<int>(q.z));
      }
    } else {
      const int nv0 = moving & 1 ? A_::rd(T.cnt(0, 0)) : 0;
      const int nv1 = moving & 2 ? A_::rd(T.cnt(1, 0)) : 0;
      int kc0 = 0, kc1 = 0;
      for (int P = p_lo + tid; P < p_hi; P += kCT) {
        const float4 q = A_::rd(T.row(P));
        const int yy = static_cast<int>(q.z);
        unsigned char k = 0;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          bool on = true;
          if ((moving >> c) & 1) {
            const int xx = c == 0 ? static_cast<int>(q.x) : -static_cast<int>(q.y);
            int lo = 0, hi = (c == 0 ? nv0 : nv1) - 1;  // the last vertex at or above the row
            while (lo < hi) {
              const int mid = (lo + hi + 1) >> 1;
              if (A_::rd(T.hull(c, mid)).y <= yy) {
                lo = mid;
              } else {
                hi = mid - 1;
              }
            }
            const int2 v = A_::rd(T.hull(c, lo));
            on = v.y == yy;
            if (!on) {
              const int2 w = A_::rd(T.hull(c, lo + 1));
              on = (xx - v.x) * (w.y - v.y) == (w.x - v.x) * (yy - v.y);
            }
          }
          if (on) k |= static_cast<unsigned char>(1u << c);
        }
        kc0 += k & 1;
        kc1 += k >> 1;
        *T.kept(P) = k;
      }
      kc0 = block_sum(kc0, st.red_i);
      kc1 = block_sum(kc1, st.red_i);
      if (tid == 0) {
        *T.scal(rank, kSKeptL) = kc0;
        *T.scal(rank, kSKeptR) = kc1;
      }
      ssync();  // every block is done with the hulls: the kept points replace them
      int o0 = 0, o1 = 0;
      nk0 = nk1 = 0;
      for (int r = 0; r < nr; ++r) {
        const int c0 = A_::rd(T.scal(r, kSKeptL)), c1 = A_::rd(T.scal(r, kSKeptR));
        o0 += r < rank ? c0 : 0;
        o1 += r < rank ? c1 : 0;
        nk0 += c0;
        nk1 += c1;
      }
      for (int P0 = p_lo; P0 < p_hi; P0 += kCT) {
        const int P = P0 + tid;
        const bool own = P < p_hi;
        const unsigned k = own ? A_::rd(T.kept(P)) : 0u;
        const float4 q = own ? A_::rd(T.row(P)) : make_float4(0.f, 0.f, 0.f, 0.f);
        const int r0 = compact_slot<kCT>(k & 1u, o0, st.cnt);
        if (k & 1u) *T.hull(0, r0) = make_int2(static_cast<int>(q.x), static_cast<int>(q.z));
        const int r1 = compact_slot<kCT>((k >> 1) & 1u, o1, st.cnt);
        if (k & 2u) *T.hull(1, r1) = make_int2(static_cast<int>(q.y), static_cast<int>(q.z));
      }
    }
    ssync();
    TALL_STAMP(4);

    // D. the directions: candidate e of a chain is the edge from kept point
    // e to e + 1, left chain first; kept unless equal to the one before it
    const int ndl = max(nk0 - 1, 0), ndir = ndl + max(nk1 - 1, 0);
    const int c_lo = solo ? 0 : min(ndir, rank * L.db), c_hi = solo ? ndir : min(ndir, c_lo + L.db);
    auto candidate = [&](int cc, float& ex, float& ey) {
      const int ch = cc < ndl ? 0 : 1, e = ch ? cc - ndl : cc;
      const int2 p0 = A_::rd(T.hull(ch, e)), p1 = A_::rd(T.hull(ch, e + 1));
      ex = static_cast<float>(p1.x - p0.x);
      ey = static_cast<float>(p1.y - p0.y);
      if (e == 0) return true;
      const int2 pm = A_::rd(T.hull(ch, e - 1));
      return p1.x - p0.x != p0.x - pm.x || p1.y - p0.y != p0.y - pm.y;
    };
    {
      int kd = 0;
      for (int cc = c_lo + tid; cc < c_hi; cc += kCT) {
        float ex, ey;
        kd += candidate(cc, ex, ey);
      }
      kd = block_sum(kd, st.red_i);
      if (tid == 0) *T.scal(rank, kSDirs) = kd;
    }
    ssync();
    int nd = 0, od = 0;
    for (int r = 0; r < nr; ++r) {
      const int c = A_::rd(T.scal(r, kSDirs));
      od += r < rank ? c : 0;
      nd += c;
    }
    for (int c0 = c_lo; c0 < c_hi; c0 += kCT) {
      const int cc = c0 + tid;
      float ex = 0.f, ey = 0.f;
      const bool keep = cc < c_hi && candidate(cc, ex, ey);
      const int jd = compact_slot<kCT>(keep, od, st.cnt);
      if (keep) {
        const float el2 = __fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey));
        const float inv = rsqrtf(fmaxf(el2, 1e-30f));
        *T.dir(0, jd) = __fmul_rn(ex, inv);
        *T.dir(1, jd) = __fmul_rn(ey, inv);
      }
    }
    ssync();
    TALL_STAMP(5);

    // E. projections: each block every direction over its rows, kDc
    // directions at a time, the blocks' extremes reduced across the cluster
    for (int j0 = 0; j0 < nd; j0 += kDc) {
      const int m = min(kDc, nd - j0);
      for (int jj = tid; jj < m; jj += kCT)
        stg[jj] = make_float2(A_::rd(T.dir(0, j0 + jj)), A_::rd(T.dir(1, j0 + jj)));
      __syncthreads();
      int G = 1;
      while (G < 32 && m * 2 * G <= kCT) G *= 2;
      const int groups = kCT / G, g = tid / G, gl = tid - g * G;
      for (int jb = 0; jb < m; jb += groups) {
        const int jj = jb + g;
        const bool own = jj < m;
        const float2 u = own ? stg[jj] : make_float2(0.f, 0.f);
        float mnu = kInf, mxu = -kInf, mnv = kInf, mxv = -kInf;
        if (own) {
#pragma unroll 2
          for (int P = p_lo + gl; P < p_hi; P += G) {
            const float4 q = A_::rd(T.row(P));
            project(u.x, u.y, q.x, q.z, mnu, mxu, mnv, mxv);
            project(u.x, u.y, q.y, q.z, mnu, mxu, mnv, mxv);
          }
        }
        for (int sh = G >> 1; sh > 0; sh >>= 1) {
          mnu = fminf(mnu, __shfl_xor_sync(kFull, mnu, sh));
          mxu = fmaxf(mxu, __shfl_xor_sync(kFull, mxu, sh));
          mnv = fminf(mnv, __shfl_xor_sync(kFull, mnv, sh));
          mxv = fmaxf(mxv, __shfl_xor_sync(kFull, mxv, sh));
        }
        if (own && gl == 0) part[jj] = make_float4(mnu, mxu, mnv, mxv);
      }
      if (solo) {  // every block's partial extremes
        __syncthreads();
      } else {
        cluster.sync();
      }
      for (int jj = solo ? tid : rank + kCS * tid; jj < m; jj += solo ? kCT : kCS * kCT) {
        float mnu = kInf, mxu = -kInf, mnv = kInf, mxv = -kInf;
        for (int r = 0; r < nr; ++r) {
          const float4 pr = *cluster.map_shared_rank(part + jj, r);
          mnu = fminf(mnu, pr.x);
          mxu = fmaxf(mxu, pr.y);
          mnv = fminf(mnv, pr.z);
          mxv = fmaxf(mxv, pr.w);
        }
        const float2 u = stg[jj];
        const int j = j0 + jj;
        *T.dir(2, j) = mnu;
        *T.dir(3, j) = mxu;
        *T.dir(4, j) = mnv;
        *T.dir(5, j) = mxv;
        *T.dir(6, j) = __fmul_rn(__fsub_rn(mxu, mnu), __fsub_rn(mxv, mnv));
        *T.dir(7, j) = fold_phi_key(u.x, u.y);
      }
      ssync();  // the partials and staged directions are the next chunk's
    }
    TALL_STAMP(6);

    // F. selection: min area (the horizontal candidate's too), the caliper
    // key among the ties, the lowest direction among those
    const int j_lo = solo ? 0 : min(nd, rank * L.db), j_hi = solo ? nd : min(nd, j_lo + L.db);
    float am = kInf;
    for (int j = j_lo + tid; j < j_hi; j += kCT) am = fminf(am, A_::rd(T.dir(6, j)));
    am = block_min_f(am, st.red_f);
    if (tid == 0) *T.scal(rank, kSAmin) = __float_as_int(am);
    const float4 q0 = A_::rd(T.row(0)), q1 = A_::rd(T.row(n - 1));
    const bool hok = q0.y - q0.x > 0.f || q1.y - q1.x > 0.f;
    const float h_area =
        hok ? __fmul_rn(static_cast<float>(mx - mn), __fsub_rn(q1.z, q0.z)) : kInf;
    ssync();
    float amin = kInf;
    for (int r = 0; r < nr; ++r) amin = fminf(amin, __int_as_float(A_::rd(T.scal(r, kSAmin))));
    amin = fminf(amin, h_area);
    const float thresh = __fadd_rn(__fmul_rn(amin, 1.000001f), 1e-9f);
    float ph = kInf;
    for (int j = j_lo + tid; j < j_hi; j += kCT)
      if (A_::rd(T.dir(6, j)) <= thresh) ph = fminf(ph, A_::rd(T.dir(7, j)));
    ph = block_min_f(ph, st.red_f);
    if (tid == 0) *T.scal(rank, kSPhi) = __float_as_int(ph);
    ssync();
    float best = (hok && h_area <= thresh) ? 0.f : kInf;
    for (int r = 0; r < nr; ++r) best = fminf(best, __int_as_float(A_::rd(T.scal(r, kSPhi))));
    int first = INT_MAX;
    for (int j = j_lo + tid; j < j_hi; j += kCT) {
      if (A_::rd(T.dir(6, j)) <= thresh && A_::rd(T.dir(7, j)) <= best) {
        first = j;
        break;
      }
    }
    first = block_min(first, st.red_i);
    if (tid == 0) *T.scal(rank, kSFirst) = first;
    ssync();
    if (rank == 0 && tid == 0) {
      for (int r = 0; r < nr; ++r) first = min(first, A_::rd(T.scal(r, kSFirst)));
      float vals[6];
      if (first != INT_MAX) {
        for (int a = 0; a < 6; ++a) vals[a] = A_::rd(T.dir(a, first));
      } else {
        vals[0] = 1.f;
        vals[1] = 0.f;
        vals[2] = static_cast<float>(mn);
        vals[3] = static_cast<float>(mx);
        vals[4] = q0.z;
        vals[5] = q1.z;
      }
      for (int r = 0; r < 6; ++r) o[r * K] = vals[r];
      o[6 * K] = (first != INT_MAX || hok) ? 1.f : 0.f;
      o[7 * K] = q0.x;
      o[8 * K] = q0.z;
      TALL_STAMP(7);
    }
    csync();  // block 0 has read every block's arrays; they are the next component's
  }
}

template <bool kShm>
int launch_cluster(const void* minx, const void* maxx, void* out, void* ws, int n_comp, int K,
                   int H, int clusters, const TallLayout& L, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(rect_cluster_kernel<kShm>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, L.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  rect_cluster_kernel<kShm><<<clusters * kCS, kCT, L.smem, stream>>>(
      static_cast<const int*>(minx), static_cast<const int*>(maxx), static_cast<float*>(out),
      static_cast<unsigned char*>(ws), n_comp, K, H);
  return launch_status();
}

int launch_tall(const void* minx, const void* maxx, void* out, void* ws, int B, int K, int H,
                int slots, cudaStream_t stream) {
  if (B <= 0 || K <= 0 || H <= 0 || static_cast<long long>(B) * K * H >= (1LL << 31))
    return cudaErrorInvalidValue;
  const TallLayout L = tall_layout(H);
  const int n_comp = B * K;
  if (L.in_shared) return launch_cluster<true>(minx, maxx, out, ws, n_comp, K, H, n_comp, L, stream);
  if (ws == nullptr || slots <= 0) return cudaErrorInvalidValue;
  return launch_cluster<false>(minx, maxx, out, ws, n_comp, K, H, min(n_comp, slots), L, stream);
}

template <bool kExact>
int launch_rect(const void* minx, const void* maxx, void* out, int B, int K, int H, int M,
                void* stream) {
  const size_t smem = rect_smem_bytes<kExact>(H, M);
  cudaError_t e = cudaFuncSetAttribute(rect_kernel<kExact>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  rect_kernel<kExact><<<B * K, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(minx), static_cast<const int*>(maxx), static_cast<float*>(out),
      K, H, M);
  return launch_status();
}

}  // namespace

// minx, maxx (B, K, H) int32 -> out (B, 9, K) f32, chains compacted to M < H.
extern "C" int rect_select(const void* minx, const void* maxx, void* out,
                           int B, int K, int H, int M, void* stream) {
  if (B <= 0 || K <= 0 || H <= 0 || M <= 0) return cudaErrorInvalidValue;
  return launch_rect<false>(minx, maxx, out, B, K, H, M, stream);
}

// The same without compaction (M = H <= rect_exact_max_height()), every
// valid row projected.
extern "C" int rect_select_exact(const void* minx, const void* maxx, void* out,
                                 int B, int K, int H, void* stream) {
  if (B <= 0 || K <= 0 || H <= 0 || H > kMaxExactHeight) return cudaErrorInvalidValue;
  return launch_rect<true>(minx, maxx, out, B, K, H, H, stream);
}

// The same for any H, the tall instance (one component a cluster): its
// arrays in the cluster's shared memory where they fit (``ws`` unused),
// else ``ws`` holds ``slots`` workspace slots of rect_tall_slot_size(H)
// bytes, one a resident cluster.
extern "C" int rect_select_exact_tall(const void* minx, const void* maxx, void* out, void* ws,
                                      int B, int K, int H, int slots, void* stream) {
  return launch_tall(minx, maxx, out, ws, B, K, H, slots, static_cast<cudaStream_t>(stream));
}

// The exact kernel's height cap, from the formula the kernel uses; the
// wrapper computes the same from its copy of it, and the card's tests hold
// the two equal.
extern "C" int rect_exact_max_height() { return kMaxExactHeight; }

// The tall instance's workspace a cluster (0 where its arrays fit the
// cluster's shared memory).
extern "C" int rect_tall_slot_size(int H) {
  const TallLayout L = tall_layout(H);
  return L.in_shared ? 0 : kCS * L.block_bytes;
}

// The tall instance's layout at H, as ops/cuda/rect_kernel.py tall_plan
// computes it: cluster size, threads, rows and directions a block, the
// arrays' offsets and bytes a block, dynamic shared memory, in shared
// memory or not, static shared memory, the rows a block finishes alone (14
// ints).
extern "C" int rect_tall_plan(int H, int* out) {
  const TallLayout L = tall_layout(H);
  const int v[14] = {kCS, kCT, L.hb, L.db, L.off_hull, L.off_dirs, L.off_cnt, L.off_kept,
                     L.off_scal, L.block_bytes, L.smem, L.in_shared,
                     static_cast<int>(sizeof(TallShared)), kSoloRows};
  for (int i = 0; i < 14; ++i) out[i] = v[i];
  return 0;
}
