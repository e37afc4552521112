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
// Taller maps take the tall instance (rect_tall_kernel running
// rect_component<true, true>, entry rect_select_exact_tall): the same steps
// and the same selection, with the rows, points and directions in a
// device-memory workspace of 116 B a row a component that the caller
// allocates (only the chains' bitmasks stay in shared memory), 512 threads
// a block, and persistent blocks: block b takes components b, b + grid,
// ... in workspace slot b, so the workspace is bounded whatever B * K.  The
// workspace slots (475 KB a component at H = 4096) stay in L2 between the
// steps, so the tall instance is bound, as the one-block kernel, by one
// component's critical path.
#include <climits>

#include "common.cuh"

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
// call's shapes); 16 warps in the tall instance, whose slope rule and
// projections walk thousands of rows.
constexpr int kThreads = 128;
constexpr int kTallThreads = 512;

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
// directions' slots (2M).  All in shared memory, or (kTall) all but the
// bitmasks in the workspace.
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

// A component's workspace slot in the tall instance, 16-byte aligned.
__host__ __device__ constexpr size_t rect_tall_slot_bytes(int H) {
  return (rect_smem_bytes<true>(H, H) - rect_bitmask_bytes(H) + 15) / 16 * 16;
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

// One component.  ``big`` holds its arrays (shared memory, or kTall its
// workspace slot), ``bits`` (kTall) the bitmasks in shared memory.
template <bool kExact, bool kTall>
__device__ __forceinline__ void rect_component(
    const int* __restrict__ minx, const int* __restrict__ maxx, float* __restrict__ out,
    int comp, int K, int H, int M, float4* big, unsigned* bits,
    RectShared<kTall ? kTallThreads : kThreads>& st) {
  constexpr int kT = kTall ? kTallThreads : kThreads;
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
  unsigned* alive = kTall ? bits : reinterpret_cast<unsigned*>(r_r + H);  // (2, NW)
  unsigned* dead = alive + 2 * NW;                                         // (2, NW)
  // kExact: kept directions' slots
  int* u_d = kTall ? r_r + H : reinterpret_cast<int*>(dead + 2 * NW);
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
  rect_component<kExact, false>(minx, maxx, out, blockIdx.x, K, H, M, smem4, nullptr, st);
}

// Persistent blocks over the B * K components, block b in workspace slot b.
__global__ void __launch_bounds__(kTallThreads)
rect_tall_kernel(const int* __restrict__ minx, const int* __restrict__ maxx,
                 float* __restrict__ out, unsigned char* __restrict__ ws, int n_comp, int K,
                 int H) {
  extern __shared__ unsigned bits_s[];
  __shared__ RectShared<kTallThreads> st;
  float4* slot = reinterpret_cast<float4*>(ws + blockIdx.x * rect_tall_slot_bytes(H));
  for (int comp = blockIdx.x; comp < n_comp; comp += gridDim.x) {
    rect_component<true, true>(minx, maxx, out, comp, K, H, H, slot, bits_s, st);
    __syncthreads();  // the slot and the shared memory are the next component's
  }
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

// The same for any H, the tall instance: ``ws`` holds ``slots`` workspace
// slots of rect_tall_slot_bytes(H) (16-byte aligned), one a block.
extern "C" int rect_select_exact_tall(const void* minx, const void* maxx, void* out, void* ws,
                                      int B, int K, int H, int slots, void* stream) {
  if (B <= 0 || K <= 0 || H <= 0 || slots <= 0 ||
      static_cast<long long>(B) * K * H >= (1LL << 31))
    return cudaErrorInvalidValue;
  const size_t smem = rect_bitmask_bytes(H);
  if (smem + sizeof(RectShared<kTallThreads>) > kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(rect_tall_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_comp = B * K;
  rect_tall_kernel<<<n_comp < slots ? n_comp : slots, kTallThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(minx), static_cast<const int*>(maxx), static_cast<float*>(out),
      static_cast<unsigned char*>(ws), n_comp, K, H);
  return launch_status();
}

// The exact kernel's height cap and the tall instance's bytes a workspace
// slot (H < 2^24), from the formulas the kernels use; the wrapper computes
// the same from its copy of them, and the card's tests hold the two equal.
extern "C" int rect_exact_max_height() { return kMaxExactHeight; }

extern "C" int rect_tall_slot_size(int H) { return static_cast<int>(rect_tall_slot_bytes(H)); }
