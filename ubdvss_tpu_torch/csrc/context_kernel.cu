// One layer of the dilated separable context module, with the 1x1 head
// fused into the last layer's launch.
//
// Replaces the TPU kernel _context_kernel (ubdvss_tpu/ops/pallas/
// context_kernel.py:39), which keeps one image's (C, H, W) activation in
// VMEM across all layers.  A Hopper block has at most 227 KB of shared
// memory and the (24, 128, 128) f32 activation is 1.5 MB, so this kernel
// runs one launch per layer instead and streams the activation through
// device memory and L2.
//
// Per output pixel (one thread each): the 3x3 dilation-d depthwise taps of
// all C input channels with zero fill at the borders (TF "SAME"), kept in
// registers; the C x C pointwise product, bias and ReLU; for the last layer
// the O x C head and its bias.  All arithmetic is f32 FMA on the CUDA cores
// (no TF32).  Weights (< 10 KB) sit in shared memory and every thread of a
// block reads the same address, a broadcast.
//
// Bound on this card: each layer reads C and writes C (or O) f32 channels
// per pixel, ~192 B/px, so the per-layer design is bound by device memory
// (~0.42 ms for 7 layers at B=64, 128x128 maps, 3.35 TB/s); the work of the
// whole module (~12.8 GFLOP at that size) is bound by f32 FMA throughput at
// ~0.19 ms.  Neighbouring threads take neighbouring x, so every tap load of
// a warp is one coalesced 128-byte row segment, and the 9 taps of a
// channel mostly hit L1/L2.
#include "common.cuh"

namespace {

constexpr int kMaxO = 32;
constexpr int kThreads = 256;

template <int C>
__global__ void __launch_bounds__(kThreads)
context_layer_kernel(const float* __restrict__ x, float* __restrict__ out,
                     const float* __restrict__ dw,   // (9, C) tap-major
                     const float* __restrict__ pwt,  // (C, C) [out][in]
                     const float* __restrict__ pb,   // (C)
                     const float* __restrict__ hwt,  // (O, C) or null
                     const float* __restrict__ hb,   // (O) or null
                     int B, int H, int W, int d, int O) {
  __shared__ float s_dw[9 * C];
  __shared__ float s_pw[C * C];
  __shared__ float s_pb[C];
  __shared__ float s_hw[kMaxO * C];
  __shared__ float s_hb[kMaxO];
  const bool with_head = hwt != nullptr;
  for (int i = threadIdx.x; i < 9 * C; i += blockDim.x) s_dw[i] = dw[i];
  for (int i = threadIdx.x; i < C * C; i += blockDim.x) s_pw[i] = pwt[i];
  for (int i = threadIdx.x; i < C; i += blockDim.x) s_pb[i] = pb[i];
  if (with_head) {
    for (int i = threadIdx.x; i < O * C; i += blockDim.x) s_hw[i] = hwt[i];
    for (int i = threadIdx.x; i < O; i += blockDim.x) s_hb[i] = hb[i];
  }
  __syncthreads();

  const long long HW = static_cast<long long>(H) * W;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= B * HW) return;
  const int b = static_cast<int>(idx / HW);
  const int p = static_cast<int>(idx - b * HW);
  const int y = p / W;
  const int xw = p - y * W;
  const float* xb = x + static_cast<long long>(b) * C * HW;

  // depthwise: taps in the reference order (ty, tx) = (-1,-1) ... (1,1)
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
#pragma unroll
  for (int ty = -1; ty <= 1; ++ty) {
    const int yy = y + ty * d;
    if (yy < 0 || yy >= H) continue;
#pragma unroll
    for (int tx = -1; tx <= 1; ++tx) {
      const int xx = xw + tx * d;
      if (xx < 0 || xx >= W) continue;
      const float* src = xb + static_cast<long long>(yy) * W + xx;
      const float* wt = s_dw + ((ty + 1) * 3 + (tx + 1)) * C;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = fmaf(src[c * HW], wt[c], acc[c]);
    }
  }

  // pointwise + bias + ReLU
  float act[C];
#pragma unroll
  for (int o = 0; o < C; ++o) {
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) s = fmaf(s_pw[o * C + c], acc[c], s);
    act[o] = fmaxf(s + s_pb[o], 0.f);
  }

  float* ob = out + static_cast<long long>(b) * (with_head ? O : C) * HW + p;
  if (!with_head) {
#pragma unroll
    for (int o = 0; o < C; ++o) ob[o * HW] = act[o];
    return;
  }
  for (int o = 0; o < O; ++o) {
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) s = fmaf(s_hw[o * C + c], act[c], s);
    ob[o * HW] = s + s_hb[o];
  }
}

template <int C>
void launch(const float* x, float* out, const float* dw, const float* pwt,
            const float* pb, const float* hwt, const float* hb, int B, int H,
            int W, int d, int O, cudaStream_t stream) {
  const long long n = static_cast<long long>(B) * H * W;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  context_layer_kernel<C><<<blocks, kThreads, 0, stream>>>(
      x, out, dw, pwt, pb, hwt, hb, B, H, W, d, O);
}

}  // namespace

// x (B, C, H, W) -> out (B, C, H, W), or (B, O, H, W) when hwt is not null.
// C must be 8, 16, 24 or 32 and O at most 32.
extern "C" int context_layer(const void* x, void* out, const void* dw,
                             const void* pwt, const void* pb, const void* hwt,
                             const void* hb, int B, int C, int H, int W, int d,
                             int O, void* stream) {
  if (O > kMaxO || B <= 0 || H <= 0 || W <= 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto fx = static_cast<const float*>(x);
  auto fo = static_cast<float*>(out);
  auto fdw = static_cast<const float*>(dw);
  auto fpw = static_cast<const float*>(pwt);
  auto fpb = static_cast<const float*>(pb);
  auto fhw = static_cast<const float*>(hwt);
  auto fhb = static_cast<const float*>(hb);
  switch (C) {
    case 8: launch<8>(fx, fo, fdw, fpw, fpb, fhw, fhb, B, H, W, d, O, s); break;
    case 16: launch<16>(fx, fo, fdw, fpw, fpb, fhw, fhb, B, H, W, d, O, s); break;
    case 24: launch<24>(fx, fo, fdw, fpw, fpb, fhw, fhb, B, H, W, d, O, s); break;
    case 32: launch<32>(fx, fo, fdw, fpw, fpb, fhw, fhb, B, H, W, d, O, s); break;
    default: return cudaErrorInvalidValue;
  }
  return launch_status();
}
