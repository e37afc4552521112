// Minimum-area rectangles from per-row component extremes, with each
// convex chain compacted to M hull points.
//
// Replaces the TPU kernel _rect_kernel_compact (ubdvss_tpu/ops/pallas/
// rect_kernel.py:294) and returns the same nine rows per component: ux, uy,
// min_u, max_u, min_v, max_v, any_edge, p0x, p0y.
//
// One thread block per component.  The TPU kernel convexifies the left
// (min x) and right (max x) chains by lockstep rounds that delete every
// strictly concave point at once; here one thread per chain runs a
// monotone stack that pops only on strict concavity (int32 cross
// products), which reaches the same set of points — every point on the
// chain's hull boundary, collinear points kept — and a third warp computes
// the horizontal candidate meanwhile.  Each chain's first M points by rank
// are packed (left in slots [0, M), right in [M, 2M)); a chain with more
// than M points loses the rest, as on the TPU.  Then one thread per packed
// edge direction projects all 2M points, and thread 0 takes the minimum
// area within amin*(1+1e-6)+1e-9, breaks ties by the folded caliper angle,
// then the first slot, then the horizontal candidate — the TPU kernel's
// order.  Products and sums are rounded separately (no FMA contraction)
// so the kernel matches its plain PyTorch version to the rounding of
// rsqrtf.
//
// Bound on this card: per component 2M directions x 2M points x ~8 flops
// (0.13 GFLOP at B=64, K=16, M=64: ~2 us at 67 TFLOP/s f32) over 1 KB of
// input; in practice the serial chain walk (H steps) bounds each block,
// and B*K blocks in flight hide it.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr float kInf = 3.4e38f;
constexpr int kBig = 1 << 30;

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

__global__ void rect_kernel(const int* __restrict__ minx,
                            const int* __restrict__ maxx,
                            float* __restrict__ out, int K, int H, int M) {
  extern __shared__ int sm[];
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
    for (int p = 0; p < D; ++p) {
      if (cok[p] != 1) continue;
      const float px = static_cast<float>(cx[p]);
      const float py = static_cast<float>(cy[p]);
      const float pu = __fadd_rn(__fmul_rn(ux, px), __fmul_rn(uy, py));
      const float pv = __fadd_rn(__fmul_rn(-uy, px), __fmul_rn(ux, py));
      mnu = fminf(mnu, pu);
      mxu = fmaxf(mxu, pu);
      mnv = fminf(mnv, pv);
      mxv = fmaxf(mxv, pv);
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

// minx, maxx (B, K, H) int32 -> out (B, 9, K) f32.
extern "C" int rect_select(const void* minx, const void* maxx, void* out,
                           int B, int K, int H, int M, void* stream) {
  if (B <= 0 || K <= 0 || H <= 0 || M <= 0 || 2 * M > 1024) return cudaErrorInvalidValue;
  const int D = 2 * M;
  const size_t smem = (4 * static_cast<size_t>(H) + 3 * D) * sizeof(int) +
                      8 * static_cast<size_t>(D) * sizeof(float) + D * sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      rect_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int threads = std::max(96, (D + 31) / 32 * 32);
  rect_kernel<<<B * K, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(minx), static_cast<const int*>(maxx),
      static_cast<float*>(out), K, H, M);
  return launch_status();
}
