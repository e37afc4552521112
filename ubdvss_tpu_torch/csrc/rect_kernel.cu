// Minimum-area rectangles from per-row component extremes.
//
// Two kernels, one per TPU kernel, returning the same nine rows per
// component: ux, uy, min_u, max_u, min_v, max_v, any_edge, p0x, p0y.
//   rect_compact_kernel replaces _rect_kernel_compact (ubdvss_tpu/ops/
//     pallas/rect_kernel.py:294): each convex chain compacted to its first M
//     points, directions projected over the packed points.
//   rect_exact_kernel replaces _rect_kernel (rect_kernel.py:136): no cap
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
// rect_compact_kernel runs one block of 128 threads per component, with no
// loop that one thread runs for the others:
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
//      steps each;
//   3. a chain's kept rows are ranked by ballot and popc, its first M
//      packed;
//   4. threads take the valid directions (consecutive packed points of one
//      chain) and project them over the valid packed points only;
//   5. the minimum area, the caliper key among the ties and the lowest
//      direction among those are block reductions.
// rect_exact_kernel runs one block per component: one thread per chain
// convexifies it with a monotone stack that pops only on strict concavity
// (int32 cross products), one thread per direction projects, thread 0
// selects.
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

// Convexify one chain (sign +1: left/min-x chain, -1: right/max-x chain)
// with a monotone stack, then pack its first M points into slots.
__device__ void convexify_pack(const int* v, const int* xv, int* st, int H,
                               int M, int sign, int* cx, int* cy, int* cok) {
  int n = 0;
  for (int y = 0; y < H; ++y) {
    if (xv[y] < 0) continue;  // empty row
    const int vx = v[y];
    while (n >= 2) {
      const int a = st[n - 2];
      const int p = st[n - 1];
      const int cross = (v[p] - v[a]) * (y - a) - (p - a) * (vx - v[a]);
      if (sign * cross > 0) --n; else break;
    }
    st[n++] = y;
  }
  for (int j = 0; j < M; ++j) {
    const bool ok = j < n;
    cx[j] = ok ? v[st[j]] : 0;
    cy[j] = ok ? st[j] : 0;
    cok[j] = ok ? 1 : 0;
  }
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

// Bytes of the compact kernel's shared memory: the packed chain points
// (float2, 2M), for each of the 2M slots' direction ux, uy, min_u, max_u,
// min_v, max_v, area and the caliper key, the compacted valid rows (y, min
// x, max x; H each) and two chains' alive and deleted bitmasks.
__host__ __device__ constexpr size_t compact_smem_bytes(int H, int M) {
  return (4 * static_cast<size_t>(M) + 16 * static_cast<size_t>(M) + 3 * static_cast<size_t>(H) +
          4 * static_cast<size_t>((H + 31) / 32)) * 4;
}

constexpr int kCompactThreads = 128;  // one block of 4 warps per component
constexpr int kRounds = 4;  // lockstep rounds before the slope rule finishes

__global__ void __launch_bounds__(kCompactThreads)
rect_compact_kernel(const int* __restrict__ minx, const int* __restrict__ maxx,
                    float* __restrict__ out, int K, int H, int M) {
  extern __shared__ float2 pts[];  // left [0, M), right [M, 2M)
  const int D = 2 * M;
  const int NW = (H + 31) / 32;
  float* d_ux = reinterpret_cast<float*>(pts + D);  // per direction slot d
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
  unsigned* dead = alive + 2 * NW;                        // (2, NW)
  constexpr int kW = kCompactThreads / 32;
  __shared__ int s_cnt[kW], s_mn[kW], s_mx[kW], s_first[kW], s_nchain[2], s_moving[2];
  __shared__ float s_amin[kW], s_phi[kW];

  const int comp = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;

  // 1. compact the valid rows; the horizontal candidate's extents
  const long long base = static_cast<long long>(comp) * H;
  int n = 0, mn = kBig, mx = -kBig;
  for (int y0 = 0; y0 < H; y0 += kCompactThreads) {
    const int y = y0 + tid;
    const int l = y < H ? minx[base + y] : 0;
    const int r = y < H ? maxx[base + y] : -1;
    const bool ok = r >= 0;
    const unsigned m = __ballot_sync(kFull, ok);
    if (lane == 0) s_cnt[warp] = __popc(m);
    __syncthreads();
    int off = n + __popc(m & below);
    for (int w = 0; w < kW; ++w) {
      off += w < warp ? s_cnt[w] : 0;
      n += s_cnt[w];
    }
    if (ok) {
      r_y[off] = y;
      r_l[off] = l;
      r_r[off] = r;
      mn = min(mn, l);
      mx = max(mx, r);
    }
    __syncthreads();
  }
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
  if (s_moving[0] || s_moving[1]) {
    // a row stays iff its largest slope dx/dy back to an alive row is <= its
    // smallest slope forward; threads over rows, both chains at once
    const int S = mx + 1;  // > |dx| of any two rows: a slope sentinel
    for (int i0 = 0; i0 < n; i0 += kCompactThreads) {
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
    for (int k = tid; k < 2 * NW; k += kCompactThreads) alive[k] = dead[k];
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

  // 3. threads over the valid directions (d = e on the left chain, M + e
  // on the right), each projected over the nl + nr packed points.  Two
  // consecutive points of a chain lie on different rows, so every such
  // direction has el2 >= 1.
  const int ndl = max(nl - 1, 0);
  const int ndir = ndl + max(nr - 1, 0);
  float amin = kInf;
  for (int c = tid; c < ndir; c += kCompactThreads) {
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
  for (int c = tid; c < ndir; c += kCompactThreads) {
    const int d = c < ndl ? c : M + (c - ndl);
    if (d_area[d] <= thresh) phi = fminf(phi, d_phi[d]);
  }
  phi = warp_min(phi);
  if (lane == 0) s_phi[warp] = phi;
  __syncthreads();
  float best = (hok && h_area <= thresh) ? 0.f : kInf;
  for (int w = 0; w < kW; ++w) best = fminf(best, s_phi[w]);
  int first = INT_MAX;
  for (int c = tid; c < ndir; c += kCompactThreads) {
    const int d = c < ndl ? c : M + (c - ndl);
    if (d_area[d] <= thresh && d_phi[d] <= best) {
      first = d;
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
    vals[0] = d_ux[first];
    vals[1] = d_uy[first];
    vals[2] = d_mnu[first];
    vals[3] = d_mxu[first];
    vals[4] = d_mnv[first];
    vals[5] = d_mxv[first];
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

// M == H: the points are every valid row's (minx, y), (maxx, y).
__global__ void rect_exact_kernel(const int* __restrict__ minx,
                                  const int* __restrict__ maxx,
                                  float* __restrict__ out, int K, int H) {
  extern __shared__ int sm[];
  const int M = H;
  const int D = 2 * M;
  int* mv = sm;             // H
  int* xv = mv + H;         // H
  int* st_l = xv + H;       // H
  int* st_r = st_l + H;     // H
  int* cx = st_r + H;       // D
  int* cy = cx + D;         // D
  int* cok = cy + D;        // D
  float* f = reinterpret_cast<float*>(cok + D);
  float* s_ux = f;          // D each
  float* s_uy = s_ux + D;
  float* s_mnu = s_uy + D;
  float* s_mxu = s_mnu + D;
  float* s_mnv = s_mxu + D;
  float* s_mxv = s_mnv + D;
  float* s_area = s_mxv + D;
  float* s_phi = s_area + D;
  int* s_eok = reinterpret_cast<int*>(s_phi + D);
  __shared__ int h_minall, h_maxall, h_ytop, h_ybot, h_has, h_ok, h_p0x;

  const int comp = blockIdx.x;
  const int tid = threadIdx.x;
  const long long base = static_cast<long long>(comp) * H;
  for (int i = tid; i < H; i += blockDim.x) {
    mv[i] = minx[base + i];
    xv[i] = maxx[base + i];
  }
  __syncthreads();

  if (tid == 0) convexify_pack(mv, xv, st_l, H, M, +1, cx, cy, cok);
  if (tid == 32) convexify_pack(xv, xv, st_r, H, M, -1, cx + M, cy + M, cok + M);
  if (tid == 64) {
    int mn = kBig, mx = -kBig, top = kBig, bot = -kBig, has = 0;
    for (int y = 0; y < H; ++y) {
      if (xv[y] < 0) continue;
      mn = min(mn, mv[y]);
      mx = max(mx, xv[y]);
      top = min(top, y);
      bot = max(bot, y);
      has = 1;
    }
    const bool top_two = has && xv[top] - mv[top] > 0;
    const bool bot_two = has && xv[bot] - mv[bot] > 0;
    h_minall = mn;
    h_maxall = mx;
    h_ytop = top;
    h_ybot = bot;
    h_has = has;
    h_ok = has && (top_two || bot_two);
    h_p0x = has ? mv[top] : 0;
  }
  __syncthreads();

  // one thread per packed edge direction
  for (int d = tid; d < D; d += blockDim.x) {
    const bool last = d == M - 1 || d == D - 1;
    const int nx = d + 1 < D ? cx[d + 1] : 0;
    const int ny = d + 1 < D ? cy[d + 1] : 0;
    const int nok = d + 1 < D ? cok[d + 1] : 0;
    const float ex = static_cast<float>(nx - cx[d]);
    const float ey = static_cast<float>(ny - cy[d]);
    const float el2 = __fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey));
    const bool eok = cok[d] == 1 && nok == 1 && !last && el2 > 0.f;
    const float inv = rsqrtf(fmaxf(el2, 1e-30f));
    const float ux = __fmul_rn(ex, inv);
    const float uy = __fmul_rn(ey, inv);
    float mnu = kInf, mxu = -kInf, mnv = kInf, mxv = -kInf;
    for (int y = 0; y < H; ++y) {
      if (xv[y] < 0) continue;
      const float py = static_cast<float>(y);
      project(ux, uy, static_cast<float>(mv[y]), py, mnu, mxu, mnv, mxv);
      project(ux, uy, static_cast<float>(xv[y]), py, mnu, mxu, mnv, mxv);
    }
    s_ux[d] = ux;
    s_uy[d] = uy;
    s_mnu[d] = mnu;
    s_mxu[d] = mxu;
    s_mnv[d] = mnv;
    s_mxv[d] = mxv;
    s_eok[d] = eok;
    s_area[d] = eok ? __fmul_rn(__fsub_rn(mxu, mnu), __fsub_rn(mxv, mnv)) : kInf;
    s_phi[d] = eok ? fold_phi_key(ux, uy) : kInf;
  }
  __syncthreads();

  if (tid != 0) return;
  const bool hok = h_ok;
  const float h_area =
      hok ? __fmul_rn(static_cast<float>(h_maxall - h_minall),
                      static_cast<float>(h_ybot - h_ytop))
          : kInf;
  float amin = kInf;
  for (int d = 0; d < D; ++d) amin = fminf(amin, s_area[d]);
  amin = fminf(amin, h_area);
  const float thresh = __fadd_rn(__fmul_rn(amin, 1.000001f), 1e-9f);
  float phi_e = kInf;
  for (int d = 0; d < D; ++d) {
    if (s_eok[d] && s_area[d] <= thresh) phi_e = fminf(phi_e, s_phi[d]);
  }
  const float phi_h = (hok && h_area <= thresh) ? 0.f : kInf;
  const float best = fminf(phi_e, phi_h);
  int first = -1;
  for (int d = 0; d < D; ++d) {
    if (s_eok[d] && s_area[d] <= thresh && s_phi[d] <= best) {
      first = d;
      break;
    }
  }
  // the horizontal candidate's key is 0 <= best, so it hits whenever valid
  const bool hit_h = hok;
  float vals[6];
  if (first >= 0) {
    vals[0] = s_ux[first];
    vals[1] = s_uy[first];
    vals[2] = s_mnu[first];
    vals[3] = s_mxu[first];
    vals[4] = s_mnv[first];
    vals[5] = s_mxv[first];
  } else {
    vals[0] = 1.f;
    vals[1] = 0.f;
    vals[2] = static_cast<float>(h_minall);
    vals[3] = static_cast<float>(h_maxall);
    vals[4] = static_cast<float>(h_ytop);
    vals[5] = static_cast<float>(h_ybot);
  }
  const int b = comp / K;
  const int k = comp - b * K;
  float* o = out + static_cast<long long>(b) * 9 * K + k;
#pragma unroll
  for (int r = 0; r < 6; ++r) o[r * K] = vals[r];
  o[6 * K] = (first >= 0 || hit_h) ? 1.f : 0.f;
  o[7 * K] = static_cast<float>(h_p0x);
  o[8 * K] = static_cast<float>(h_has ? h_ytop : 0);
}

}  // namespace

// minx, maxx (B, K, H) int32 -> out (B, 9, K) f32, chains compacted to M < H.
extern "C" int rect_select(const void* minx, const void* maxx, void* out,
                           int B, int K, int H, int M, void* stream) {
  if (B <= 0 || K <= 0 || H <= 0 || M <= 0) return cudaErrorInvalidValue;
  const size_t smem = compact_smem_bytes(H, M);
  cudaError_t e = cudaFuncSetAttribute(
      rect_compact_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  rect_compact_kernel<<<B * K, kCompactThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(minx), static_cast<const int*>(maxx),
      static_cast<float*>(out), K, H, M);
  return launch_status();
}

// The same without compaction (M = H, so H <= 512).
extern "C" int rect_select_exact(const void* minx, const void* maxx, void* out,
                                 int B, int K, int H, void* stream) {
  if (B <= 0 || K <= 0 || H <= 0 || 2 * H > 1024) return cudaErrorInvalidValue;
  const int D = 2 * H;
  const size_t smem = (4 * static_cast<size_t>(H) + 3 * D) * sizeof(int) +
                      8 * static_cast<size_t>(D) * sizeof(float) + D * sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      rect_exact_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int threads = (D + 31) / 32 * 32 < 96 ? 96 : (D + 31) / 32 * 32;
  rect_exact_kernel<<<B * K, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(minx), static_cast<const int*>(maxx),
      static_cast<float*>(out), K, H);
  return launch_status();
}
