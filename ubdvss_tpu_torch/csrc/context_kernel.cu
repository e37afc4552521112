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
// Per output pixel: the 3x3 dilation-d depthwise taps of all C input
// channels with zero fill at the borders (TF "SAME"), kept in registers;
// the C x C pointwise product, bias and ReLU; for the last layer the O x C
// head and its bias.  All arithmetic is f32 FMA on the CUDA cores (no
// TF32).  Weights (< 10 KB) sit in shared memory and every thread of a
// block reads the same address, a broadcast.
//
// Bound on this card: each layer reads C and writes C (or O) f32 channels
// per pixel, ~192 B/px, so the per-layer design is bound by device memory
// (~0.41 ms for 7 layers at B=64, 128x128 maps, 3.35 TB/s); the work of the
// whole module (~12.8 GFLOP at that size) is bound by f32 FMA throughput at
// ~0.19 ms.  Neighbouring threads take neighbouring x, so every tap load of
// a warp is one coalesced row segment, and the 9 taps of a channel mostly
// hit L1/L2.
//
// ``packed``: the head's last launch writes its logits phase-major, as the
// TPU package's packed route hands them to its postprocessing
// (s2d_context_head(unpack=False), ubdvss_tpu/ops/pallas/
// context_kernel.py:388-450): (B, 4 O, H/2, W/2), channel (2 py + px) O + o
// for pixel (2 i + py, 2 j + px), whose NHWC view is the phase-major
// (B, H/2, W/2, 4 O).  The same arithmetic as the plain store, and the
// same bytes written; a warp's stores go to two planes (the two column
// phases of its row), 16 contiguous floats each.
//
// Widths (every C >= 1 and O >= 1, as the TPU kernel takes them from its
// inputs):
//   * C in {8, 16, 24, 32} with O <= 32 ("exact"): context_exact_kernel,
//     two pixels a thread d rows apart, weights in static shared memory
//     (its section below);
//   * every other C <= 32, or O > 32 ("narrow"): the register kernel, a
//     thread a pixel, compiled for that C, context_layer_kernel<C>, every
//     channel loop exactly C long and every weight at a compile-time
//     offset, all weights (the head's O rows and biases too) in dynamic
//     shared memory, so any O whose weights fit one block.  It replaces a
//     kernel that ran the loops of the next compiled width with each
//     channel guarded by the real C: at C = 10 that issued 256 predicated
//     pointwise FMAs a pixel for 100,
//     each with a scalar weight load at a runtime offset.  A tile of pixels
//     by C channels (the wide instance below, brought down to these widths:
//     8, 4 or 2 runs of 128 pixels a tile) was measured against it and lost
//     (scripts/torch_kernel_ab.py --only widths; PERF.md §6): at
//     these widths the pointwise is small beside the taps' loads, and a
//     thread a pixel keeps them all in flight with no barrier.  The same
//     sums in the same order, so the outputs are the guarded kernel's bit
//     for bit.  Bound: 80 B a pixel a layer at C = 10 (device memory, 0.19
//     ms for the 7 layers and the 17-logit head at (64, 10, 128²), against
//     0.05 for the operations);
//   * 32 < C <= 128 where its block fits (the head's weights included):
//     context_layer_tile<OT>, a tile of kTileP consecutive pixels of one
//     image by all C channels a block.  The depthwise results go to shared
//     memory, s_acc[c][p], a thread a pixel and every other channel, so a
//     warp's tap loads are one coalesced row segment; the pointwise is the
//     small product (P x C) (C x C)^T, register-tiled: each thread holds
//     4 pixels x OT outputs, reads its 4 pixels of channel c as one float4
//     and the OT weights of its warp's output group as float4 broadcasts
//     (weights staged once a block, grouped [group][c][OT rounded to 4]),
//     3 loads for 24-64 FMAs where a thread a pixel spent one load an FMA.
//     The head reads the layer's activations, written back over s_acc, as a
//     second such product.  Blocks are persistent and walk the tiles, three
//     an SM up to 64 channels, on maps of fewer than 2^30 pixels (int tap
//     offsets; larger ones take the columns below).  Each sum is taken in
//     the order the other instances take it (taps (-1,-1) ... (1,1), border
//     taps skipped; c = 0..C-1, one fmaf each, then the bias), so the
//     outputs are theirs bit for bit.  Bound: bytes, 384 B a pixel a layer
//     at C = 48, against 2 (9 C + C^2) FLOP, ~14 FLOP a byte where the
//     card's f32 rate over its memory rate is ~20;
//   * any other C (past 128, a block that does not fit, or a map of 2^30
//     pixels and more): context_layer_wide, where acc[C] and act[C] may no
//     longer fit a thread's registers: each thread keeps its pixel's
//     depthwise results (and, for the head, its activations) in a column of
//     dynamic shared memory, C words blockDim.x apart, which only that
//     thread touches, and runs the pointwise and the head in chunks of
//     kOutChunk output channels held in registers; the weights are read
//     from device memory, every lane of a warp at one address (an L1
//     broadcast).  The same sums in the same order.  A block of 128
//     threads, or 64 or 32 where C columns do not fit.
#include "common.cuh"

// A debug build (-DCONTEXT_STAMPS, scripts/torch_kernel_ab.py --only widths
// --parts exact) sums the exact instance's clock64() cycles by phase over
// the warps, as each warp's lane 0 sees them: the depthwise, the pointwise
// (with its stores), the head (with its stores), then the warps counted.
#ifdef CONTEXT_STAMPS
__device__ unsigned long long g_context_cycles[4];
extern "C" int context_cycles(unsigned long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_context_cycles, sizeof(g_context_cycles)));
}
extern "C" int context_cycles_clear() {
  void* p = nullptr;
  const cudaError_t e = cudaGetSymbolAddress(&p, g_context_cycles);
  return static_cast<int>(e != cudaSuccess ? e : cudaMemset(p, 0, sizeof(g_context_cycles)));
}
#define CONTEXT_STAMP(k)                                                            \
  if ((threadIdx.x & 31) == 0) {                                                    \
    const long long now_ = clock64();                                               \
    atomicAdd(&g_context_cycles[k], static_cast<unsigned long long>(now_ - t_stamp)); \
    if ((k) == 0) atomicAdd(&g_context_cycles[3], 1ull);                            \
    t_stamp = now_;                                                                 \
  }
#else
#define CONTEXT_STAMP(k)
#endif

namespace {

constexpr int kMaxO = 32;
constexpr int kNarrowMax = 32;  // the register kernel's widths
constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 232448;  // bytes of shared memory a block may use

// The narrow register kernel: its weights' dynamic shared memory (it has
// no static), and whether that fits one block.
inline size_t narrow_smem(int C, int O) {
  return (9 * static_cast<size_t>(C) + static_cast<size_t>(C) * C + C +
          static_cast<size_t>(O) * (C + 1)) * sizeof(float);
}
inline bool narrow_fits(int C, int O) { return C <= kNarrowMax && narrow_smem(C, O) <= kMaxSmem; }

// The wide kernel's block: 128 threads, or 64 or 32 where C columns (2 C
// with the head) of that many floats do not fit; 0 where none fits.
inline size_t wide_smem(int C, bool head, int T) {
  return static_cast<size_t>(head ? 2 : 1) * C * T * sizeof(float);
}
inline int wide_threads(int C, bool head) {
  for (int T = 128; T >= 32; T /= 2) {
    if (wide_smem(C, head, T) <= kMaxSmem) return T;
  }
  return 0;
}

// Every weight and bias in dynamic shared memory (narrow_smem), for any O.
template <int C>
__global__ void __launch_bounds__(kThreads)
context_layer_kernel(const float* __restrict__ x, float* __restrict__ out,
                     const float* __restrict__ dw,   // (9, C) tap-major
                     const float* __restrict__ pwt,  // (C, C) [out][in]
                     const float* __restrict__ pb,   // (C)
                     const float* __restrict__ hwt,  // (O, C) or null
                     const float* __restrict__ hb,   // (O) or null
                     int B, int H, int W, int d, int O, int packed) {
  extern __shared__ float s_weights[];
  float* s_dw = s_weights;
  float* s_pw = s_dw + 9 * C;
  float* s_pb = s_pw + C * C;
  float* s_hw = s_pb + C;
  float* s_hb = s_hw + O * C;
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
  long long os = HW;  // between output channels
  if (packed) {
    os = HW / 4;
    ob = out + (static_cast<long long>(b) * 4 + 2 * (y & 1) + (xw & 1)) * O * os +
         static_cast<long long>(y >> 1) * (W >> 1) + (xw >> 1);
  }
  for (int o = 0; o < O; ++o) {
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) s = fmaf(s_hw[o * C + c], act[c], s);
    ob[o * os] = s + s_hb[o];
  }
}

// ---- the exact instance: C in {8, 16, 24, 32}, O <= kMaxO ----
//
// P pixels a thread (2, or 1 where the map is too short for a second), d
// rows apart in one column: pixel k at (y0 + k d, x).  Their taps lie on the
// P + 2 rows y0 + (j - 1) d, j = 0 .. P + 1, so a thread loads each of those
// rows' three taps of a channel once and feeds them to every pixel whose tap
// it is: 12 loads a channel for two pixels where a thread a pixel makes 18.
// A warp takes 32 consecutive x of one row of threads, so every tap load is
// one coalesced row segment.  Rows are taken in groups of P d, one row of
// threads a residue of y mod d, the last group cut at the map's edge
// (exact_thread_rows), so a row of threads always has its first pixel on the
// map.  The weights sit in static shared memory, 16-byte aligned, and are
// read as float4 broadcasts, each feeding 4 P FMAs of the pointwise and the
// head.  Each tap's C loads go out together behind a branch on its place on
// the map (a tap off the map is skipped, as in the other instances), and a
// block of 128 threads keeps its registers at 128 (170 at 32 channels), so
// 16 warps (12) an SM hide the loads.
//
// Measured (scripts/torch_kernel_ab.py --only widths --parts exact, PERF.md
// §6): the parent kernel, a thread a pixel with the weights already read as
// float4, spent 2,624 instructions a pixel at 24 channels and 10.2K of its
// 14K cycles a warp in the depthwise; this one 1,704 and 8.4K a pixel.
// Slower, all bit for bit: one or four pixels a thread (four: 8 warps an
// SM, or spills), zero-filled branch-free taps and a second register
// buffer for the next tap (the compiler hoists every load and spills), a
// tap row's three taps at once, cp.async staging of the taps through
// shared memory, 256- and 512-thread blocks whose rows share tap rows in
// L1.
//
// The sums keep the order of the other instances: taps (-1,-1) ... (1,1),
// border taps skipped, one fmaf a channel; c = 0 .. C-1, one fmaf each, then
// the bias (and ReLU), so the outputs are theirs bit for bit.  A layer
// writes each output channel as soon as it is summed; the head layer keeps
// the P C activations in registers and sums its O outputs from them.
constexpr int kExactThreads = 128;

// Rows of threads an image: groups of P d rows, a row of threads a residue
// of y mod d in each, the last group's residues only as far as the map
// goes (ops/cuda/context_kernel.py exact_thread_rows).
inline int exact_thread_rows(int H, int d, int P) {
  const long long group = static_cast<long long>(P) * d;
  const int full = static_cast<int>((H - 1) / group);  // the groups before the last
  const long long tail = H - full * group;              // rows of the last group
  return full * d + static_cast<int>(tail < d ? tail : d);
}

// Blocks of kExactThreads an SM each instance keeps room for, which sets
// its registers (65,536 / (128 blocks)): 4 (128 registers), or 3 (170) at
// two pixels of 32 channels, where 128 would spill (-Xptxas -v).
template <int C, int P, bool kHead>
constexpr int exact_min_blocks() {
  return P == 2 && C == 32 ? 3 : 4;
}

template <int C, int P, bool kHead>
__global__ void __launch_bounds__(kExactThreads, (exact_min_blocks<C, P, kHead>()))
context_exact_kernel(const float* __restrict__ x, float* __restrict__ out,
                     const float* __restrict__ dw, const float* __restrict__ pwt,
                     const float* __restrict__ pb, const float* __restrict__ hwt,
                     const float* __restrict__ hb, int H, int W, int d, int O, int packed,
                     int rows) {
  static_assert(C % 4 == 0, "float4 weight rows");
  constexpr int kRows = P + 2;  // tap rows a thread
  __shared__ __align__(16) float s_dw[9 * C];
  __shared__ __align__(16) float s_pw[C * C];
  __shared__ float s_pb[C];
  __shared__ __align__(16) float s_hw[kHead ? kMaxO * C : 4];
  __shared__ float s_hb[kHead ? kMaxO : 1];
  constexpr int T = kExactThreads;
  for (int i = threadIdx.x; i < 9 * C; i += T) s_dw[i] = dw[i];
  for (int i = threadIdx.x; i < C * C; i += T) s_pw[i] = pwt[i];
  for (int i = threadIdx.x; i < C; i += T) s_pb[i] = pb[i];
  if constexpr (kHead) {
    for (int i = threadIdx.x; i < O * C; i += T) s_hw[i] = hwt[i];
    for (int i = threadIdx.x; i < O; i += T) s_hb[i] = hb[i];
  }
  __syncthreads();

  // a row of blocks an image (blockIdx.y): thread q of the image's rows x W
  const int q = blockIdx.x * T + threadIdx.x;
  if (q >= rows * W) return;
#ifdef CONTEXT_STAMPS
  long long t_stamp = clock64();
#endif
  const int b = blockIdx.y;
  const int t = q / W, xw = q - t * W;
  const int g = t / d;
  const int y0 = g * P * d + (t - g * d);  // the first pixel's row, always on the map

  // depthwise: for each pixel k the taps (ty, tx) = (-1,-1) ... (1,1) in
  // this order (tap row j = k + 1 + ty), border taps skipped, one fmaf a
  // channel; a tap's C loads go out together
  const long long HW = static_cast<long long>(H) * W, dW = static_cast<long long>(d) * W;
  const float* xb = x + (static_cast<long long>(b) * C * H + y0) * W + xw;
  float acc[P][C];
#pragma unroll
  for (int k = 0; k < P; ++k)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[k][c] = 0.f;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int yy = y0 + (j - 1) * d;
    if (yy < 0 || yy >= H) continue;
#pragma unroll
    for (int tx = 0; tx < 3; ++tx) {
      if ((tx == 0 && xw < d) || (tx == 2 && xw + d >= W)) continue;
      const float* src = xb + (j - 1) * dW + (tx - 1) * d;
      float v[C];
#pragma unroll
      for (int c = 0; c < C; ++c) v[c] = __ldg(src + c * HW);
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const int ty = j - 1 - k;
        if (ty < -1 || ty > 1) continue;
        const float* wt = s_dw + ((ty + 1) * 3 + tx) * C;
#pragma unroll
        for (int c = 0; c < C; c += 4) {
          const float4 w4 = *reinterpret_cast<const float4*>(wt + c);
          acc[k][c] = fmaf(v[c], w4.x, acc[k][c]);
          acc[k][c + 1] = fmaf(v[c + 1], w4.y, acc[k][c + 1]);
          acc[k][c + 2] = fmaf(v[c + 2], w4.z, acc[k][c + 2]);
          acc[k][c + 3] = fmaf(v[c + 3], w4.w, acc[k][c + 3]);
        }
      }
    }
  }
  CONTEXT_STAMP(0);

  // pointwise + bias + ReLU: s = sum over c of w[o][c] acc[c], c = 0 .. C-1
  unsigned on_map = 1;  // pixel k on the map: bit k
#pragma unroll
  for (int k = 1; k < P; ++k)
    if (y0 + k * d < H) on_map |= 1u << k;
  float act[kHead ? P : 1][kHead ? C : 1];
  float* ob = out + (static_cast<long long>(b) * C * H + y0) * W + xw;
#pragma unroll
  for (int o = 0; o < C; ++o) {
    float s[P];
#pragma unroll
    for (int k = 0; k < P; ++k) s[k] = 0.f;
#pragma unroll
    for (int c = 0; c < C; c += 4) {
      const float4 wv = *reinterpret_cast<const float4*>(s_pw + o * C + c);
#pragma unroll
      for (int k = 0; k < P; ++k) {
        s[k] = fmaf(wv.x, acc[k][c], s[k]);
        s[k] = fmaf(wv.y, acc[k][c + 1], s[k]);
        s[k] = fmaf(wv.z, acc[k][c + 2], s[k]);
        s[k] = fmaf(wv.w, acc[k][c + 3], s[k]);
      }
    }
    const float bias = s_pb[o];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const float a = fmaxf(s[k] + bias, 0.f);
      if constexpr (kHead) {
        act[k][o] = a;
      } else {
        if (on_map >> k & 1u) ob[o * HW + k * dW] = a;
      }
    }
  }
  CONTEXT_STAMP(1);
  if constexpr (kHead) {
    // the head: O outputs from the activations, c = 0 .. C-1, then the bias;
    // stored plane by plane, or phase-major with ``packed``
    long long os = HW;
    float* obk[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int y = y0 + k * d;
      obk[k] = out + (static_cast<long long>(b) * O * H + y) * W + xw;
      if (packed) {
        os = HW / 4;
        obk[k] = out + (static_cast<long long>(b) * 4 + 2 * (y & 1) + (xw & 1)) * O * os +
                 static_cast<long long>(y >> 1) * (W >> 1) + (xw >> 1);
      }
    }
    for (int o = 0; o < O; ++o) {
      float s[P];
#pragma unroll
      for (int k = 0; k < P; ++k) s[k] = 0.f;
#pragma unroll
      for (int c = 0; c < C; c += 4) {
        const float4 wv = *reinterpret_cast<const float4*>(s_hw + o * C + c);
#pragma unroll
        for (int k = 0; k < P; ++k) {
          s[k] = fmaf(wv.x, act[k][c], s[k]);
          s[k] = fmaf(wv.y, act[k][c + 1], s[k]);
          s[k] = fmaf(wv.z, act[k][c + 2], s[k]);
          s[k] = fmaf(wv.w, act[k][c + 3], s[k]);
        }
      }
      const float bias = s_hb[o];
#pragma unroll
      for (int k = 0; k < P; ++k)
        if (on_map >> k & 1u) obk[k][o * os] = s[k] + bias;
    }
    CONTEXT_STAMP(2);
  }
}

// C > 32 (any C), any O: a thread a pixel, its depthwise results and its
// activations in its own column of dynamic shared memory (s_acc[c][t],
// s_act[c][t], t = threadIdx.x), the pointwise and the head kOutChunk
// outputs at a time in registers; weights read from device memory at
// warp-uniform addresses.  No thread reads another's column, so no
// barrier is needed.
constexpr int kOutChunk = 32;

__global__ void __launch_bounds__(128)
context_layer_wide(const float* __restrict__ x, float* __restrict__ out,
                   const float* __restrict__ dw, const float* __restrict__ pwt,
                   const float* __restrict__ pb, const float* __restrict__ hwt,
                   const float* __restrict__ hb, int B, int C, int H, int W, int d, int O,
                   int packed) {
  extern __shared__ float s_wide[];
  const int T = blockDim.x;
  float* s_acc = s_wide + threadIdx.x;  // s_acc[c * T]
  float* s_act = s_acc + C * T;         // the head's activations, s_act[c * T]
  const bool with_head = hwt != nullptr;
  const long long HW = static_cast<long long>(H) * W;
  const long long idx = static_cast<long long>(blockIdx.x) * T + threadIdx.x;
  if (idx >= B * HW) return;
  const int b = static_cast<int>(idx / HW);
  const int p = static_cast<int>(idx - b * HW);
  const int y = p / W;
  const int xw = p - y * W;
  const float* xb = x + static_cast<long long>(b) * C * HW + p;

  // depthwise, channel by channel: the taps in the reference order
  for (int c = 0; c < C; ++c) {
    float a = 0.f;
#pragma unroll
    for (int ty = -1; ty <= 1; ++ty) {
      const int yy = y + ty * d;
      if (yy < 0 || yy >= H) continue;
#pragma unroll
      for (int tx = -1; tx <= 1; ++tx) {
        const int xx = xw + tx * d;
        if (xx < 0 || xx >= W) continue;
        a = fmaf(xb[c * HW + static_cast<long long>(ty * d) * W + tx * d],
                 __ldg(dw + ((ty + 1) * 3 + (tx + 1)) * C + c), a);
      }
    }
    s_acc[c * T] = a;
  }

  float* ob = out + static_cast<long long>(b) * (with_head ? O : C) * HW + p;
  // pointwise + bias + ReLU, kOutChunk outputs at a time
  for (int o0 = 0; o0 < C; o0 += kOutChunk) {
    float s[kOutChunk];
#pragma unroll
    for (int j = 0; j < kOutChunk; ++j) s[j] = 0.f;
    for (int c = 0; c < C; ++c) {
      const float a = s_acc[c * T];
#pragma unroll
      for (int j = 0; j < kOutChunk; ++j) {
        if (o0 + j < C) s[j] = fmaf(__ldg(pwt + static_cast<long long>(o0 + j) * C + c), a, s[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kOutChunk; ++j) {
      if (o0 + j < C) {
        const float v = fmaxf(s[j] + __ldg(pb + o0 + j), 0.f);
        if (with_head) {
          s_act[(o0 + j) * T] = v;
        } else {
          ob[(o0 + j) * HW] = v;
        }
      }
    }
  }
  if (!with_head) return;
  long long os = HW;
  if (packed) {
    os = HW / 4;
    ob = out + (static_cast<long long>(b) * 4 + 2 * (y & 1) + (xw & 1)) * O * os +
         static_cast<long long>(y >> 1) * (W >> 1) + (xw >> 1);
  }
  for (int o0 = 0; o0 < O; o0 += kOutChunk) {
    float s[kOutChunk];
#pragma unroll
    for (int j = 0; j < kOutChunk; ++j) s[j] = 0.f;
    for (int c = 0; c < C; ++c) {
      const float a = s_act[c * T];
#pragma unroll
      for (int j = 0; j < kOutChunk; ++j) {
        if (o0 + j < O) s[j] = fmaf(__ldg(hwt + static_cast<long long>(o0 + j) * C + c), a, s[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kOutChunk; ++j) {
      if (o0 + j < O) ob[(o0 + j) * os] = s[j] + __ldg(hb + o0 + j);
    }
  }
}

// ---- the tile instance: 32 < C <= 128 ----
constexpr int kTileP = 128;        // pixels a tile
constexpr int kTileThreads = 256;  // a thread a pixel of the depthwise, every other channel
constexpr int kTileWarps = kTileThreads / 32;

// outputs a warp takes (its group), so that the C outputs make at most
// kTileWarps groups: 0 past 128 channels
inline int tile_ot(int C) {
  return C <= 32 ? 0 : C <= 48 ? 6 : C <= 64 ? 8 : C <= 96 ? 12 : C <= 128 ? 16 : 0;
}
__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

// Dynamic shared memory of context_layer_tile: the tile's C x kTileP
// depthwise results, the pointwise and (head) the head weights by output
// group, [group][c][round4(OT)], then the depthwise taps, the biases.
inline size_t tile_smem(int C, int O, bool head) {
  const int ot = tile_ot(C);
  if (ot == 0) return kMaxSmem + 1;
  const size_t g = (C + ot - 1) / ot, gh = head ? (O + ot - 1) / ot : 0;
  return (static_cast<size_t>(C) * kTileP + (g + gh) * C * round4(ot) + 9 * static_cast<size_t>(C) +
          C + (head ? O : 0)) * sizeof(float);
}
// the tile instance runs a call of C channels and an O-output head on a map
// of H x W (its tap offsets are ints)
inline bool tile_fits(int C, int O, int H, int W) {
  return tile_ot(C) > 0 && tile_smem(C, O, true) <= kMaxSmem &&
         static_cast<long long>(H) * W < (1LL << 30);
}

// the outputs [g OT, g OT + OT) of the thread's 4 pixels (p, p + 1, p + 2,
// p + 3 of the tile): s[j][k] = sum over c of w[g][c][j] a[c][p + k], in
// the order c = 0..C-1, one fmaf each
template <int OT>
__device__ __forceinline__ void tile_product(float (&s)[OT][4], const float* __restrict__ a,
                                             const float* __restrict__ w, int C, int p) {
  constexpr int OTP = round4(OT);
#pragma unroll
  for (int j = 0; j < OT; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) s[j][k] = 0.f;
#pragma unroll 2
  for (int c = 0; c < C; ++c) {
    const float4 v = *reinterpret_cast<const float4*>(a + c * kTileP + p);
    float wt[OTP];
#pragma unroll
    for (int j = 0; j < OTP; j += 4) {
      const float4 q = *reinterpret_cast<const float4*>(w + c * OTP + j);
      wt[j] = q.x;
      wt[j + 1] = q.y;
      wt[j + 2] = q.z;
      wt[j + 3] = q.w;
    }
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      s[j][0] = fmaf(wt[j], v.x, s[j][0]);
      s[j][1] = fmaf(wt[j], v.y, s[j][1]);
      s[j][2] = fmaf(wt[j], v.z, s[j][2]);
      s[j][3] = fmaf(wt[j], v.w, s[j][3]);
    }
  }
}

// Four consecutive pixels' values of one output channel to device memory:
// plane (B, n, H, W) from q = q0 + p (flattened y W + x), or with
// ``packed`` the phase-major (B, 4 n, H/2, W/2).  A float4 (two float2
// when packed) where the four are one aligned run of a row.
__device__ __forceinline__ void tile_store(float* __restrict__ out, const float (&v)[4], int b,
                                           int o, int n, long long q, int np_left, int H, int W,
                                           int packed) {
  const long long HW = static_cast<long long>(H) * W;
  if (!packed) {
    float* dst = out + (static_cast<long long>(b) * n + o) * HW + q;
    if ((HW & 3) == 0) {
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (k < np_left) dst[k] = v[k];
    }
    return;
  }
  const long long Q = HW / 4;
  if ((W & 3) == 0) {  // the four are x .. x + 3 of one row, x a multiple of 4
    const int y = static_cast<int>(q / W), x = static_cast<int>(q - static_cast<long long>(y) * W);
    const long long cell = static_cast<long long>(y >> 1) * (W >> 1) + (x >> 1);
    float* p0 = out + ((static_cast<long long>(b) * 4 + 2 * (y & 1)) * n + o) * Q + cell;
    *reinterpret_cast<float2*>(p0) = make_float2(v[0], v[2]);
    *reinterpret_cast<float2*>(p0 + n * Q) = make_float2(v[1], v[3]);
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (k >= np_left) break;
    const long long qk = q + k;
    const int y = static_cast<int>(qk / W), x = static_cast<int>(qk - static_cast<long long>(y) * W);
    out[((static_cast<long long>(b) * 4 + 2 * (y & 1) + (x & 1)) * n + o) * Q +
        static_cast<long long>(y >> 1) * (W >> 1) + (x >> 1)] = v[k];
  }
}

// Three blocks an SM up to 64 channels (OT <= 8: 80 registers a thread),
// two past them (128).  A thread loads the taps of kUnroll channels before
// it sums them: four, or two at OT = 8, whose four spill under the
// three-block cap (-Xptxas -v; each the fastest of the two in
// scripts/torch_kernel_ab.py --only widths on the H100).
template <int OT>
__global__ void __launch_bounds__(kTileThreads, OT <= 8 ? 3 : 2)
context_layer_tile(const float* __restrict__ x, float* __restrict__ out,
                   const float* __restrict__ dw, const float* __restrict__ pwt,
                   const float* __restrict__ pb, const float* __restrict__ hwt,
                   const float* __restrict__ hb, int B, int C, int H, int W, int d, int O,
                   int packed) {
  constexpr int OTP = round4(OT), kUnroll = OT == 8 ? 2 : 4;
  extern __shared__ __align__(16) float s_tile[];
  const bool with_head = hwt != nullptr;
  const int G = (C + OT - 1) / OT, GH = with_head ? (O + OT - 1) / OT : 0;
  float* s_acc = s_tile;                // [C][kTileP]
  float* s_pw = s_acc + C * kTileP;     // [G][C][OTP]
  float* s_hw = s_pw + G * C * OTP;     // [GH][C][OTP]
  float* s_dw = s_hw + GH * C * OTP;    // [9][C]
  float* s_pb = s_dw + 9 * C;           // [C]
  float* s_hb = s_pb + C;               // [O]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < G * C * OTP; i += kTileThreads) {
    const int j = i % OTP, c = (i / OTP) % C, o = (i / (OTP * C)) * OT + j;
    s_pw[i] = j < OT && o < C ? pwt[o * C + c] : 0.f;
  }
  for (int i = tid; i < GH * C * OTP; i += kTileThreads) {
    const int j = i % OTP, c = (i / OTP) % C, o = (i / (OTP * C)) * OT + j;
    s_hw[i] = j < OT && o < O ? hwt[o * C + c] : 0.f;
  }
  for (int i = tid; i < 9 * C; i += kTileThreads) s_dw[i] = dw[i];
  for (int i = tid; i < C; i += kTileThreads) s_pb[i] = pb[i];
  if (with_head)
    for (int i = tid; i < O; i += kTileThreads) s_hb[i] = hb[i];
  __syncthreads();

  const long long HW = static_cast<long long>(H) * W;
  const long long per_image = (HW + kTileP - 1) / kTileP;
  const long long n_tiles = per_image * B;
  const int n_out = with_head ? O : C;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = static_cast<int>(tile / per_image);
    const long long q0 = (tile - b * per_image) * kTileP;
    const int np = static_cast<int>(min(static_cast<long long>(kTileP), HW - q0));
    // depthwise: pixel p, channels c0, c0 + 2, ...; taps in the reference
    // order, border taps skipped
    {
      constexpr int kStep = kTileThreads / kTileP;
      const int p = tid % kTileP, c0 = tid / kTileP;
      const long long q = q0 + p;
      const int y = p < np ? static_cast<int>(q / W) : 0;
      const int xw = p < np ? static_cast<int>(q - static_cast<long long>(y) * W) : 0;
      unsigned valid = 0;
      int off[9];
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const int ty = t / 3 - 1, tx = t % 3 - 1, yy = y + ty * d, xx = xw + tx * d;
        off[t] = ty * d * W + tx * d;
        if (p < np && yy >= 0 && yy < H && xx >= 0 && xx < W) valid |= 1u << t;
      }
      const float* xp = x + static_cast<long long>(b) * C * HW + q;
      for (int c = c0; c < C; c += kStep * kUnroll) {
        float v[kUnroll][9];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int cc = c + u * kStep;
#pragma unroll
          for (int t = 0; t < 9; ++t)
            v[u][t] = cc < C && (valid >> t & 1u) ? __ldg(xp + cc * HW + off[t]) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int cc = c + u * kStep;
          if (cc >= C) break;
          float a = 0.f;
#pragma unroll
          for (int t = 0; t < 9; ++t)
            if (valid >> t & 1u) a = fmaf(v[u][t], s_dw[t * C + cc], a);
          s_acc[cc * kTileP + p] = a;
        }
      }
    }
    __syncthreads();
    // pointwise + bias + ReLU: warp g's outputs, the lane's four pixels
    const int p = 4 * lane;
    const long long q = q0 + p;
    float s[OT][4];
    if (warp < G) tile_product<OT>(s, s_acc, s_pw + warp * C * OTP, C, p);
    if (with_head) __syncthreads();  // every warp has read s_acc
    if (warp < G) {
#pragma unroll
      for (int j = 0; j < OT; ++j) {
        const int o = warp * OT + j;
        if (o >= C) break;
        float v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = fmaxf(s[j][k] + s_pb[o], 0.f);
        if (with_head) {
          *reinterpret_cast<float4*>(s_acc + o * kTileP + p) = make_float4(v[0], v[1], v[2], v[3]);
        } else if (p < np) {
          tile_store(out, v, b, o, n_out, q, np - p, H, W, 0);
        }
      }
    }
    if (with_head) {
      __syncthreads();  // the activations are in s_acc
      for (int g = warp; g < GH; g += kTileWarps) {
        tile_product<OT>(s, s_acc, s_hw + g * C * OTP, C, p);
        if (p >= np) continue;
#pragma unroll
        for (int j = 0; j < OT; ++j) {
          const int o = g * OT + j;
          if (o >= O) break;
          float v[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) v[k] = s[j][k] + s_hb[o];
          tile_store(out, v, b, o, n_out, q, np - p, H, W, packed);
        }
      }
    }
    __syncthreads();  // the next tile's depthwise overwrites s_acc
  }
}

template <int OT>
int launch_tile_ot(const float* x, float* out, const float* dw, const float* pwt, const float* pb,
                   const float* hwt, const float* hb, int B, int C, int H, int W, int d, int O,
                   int packed, cudaStream_t stream) {
  const int smem = static_cast<int>(tile_smem(C, O, hwt != nullptr));
  const long long n_tiles = (static_cast<long long>(H) * W + kTileP - 1) / kTileP * B;
  int grid = 0;
  const int e = persistent_grid<context_layer_tile<OT>>(smem, n_tiles, &grid, kTileThreads);
  if (e != cudaSuccess) return e;
  context_layer_tile<OT><<<grid, kTileThreads, smem, stream>>>(x, out, dw, pwt, pb, hwt, hb, B, C,
                                                               H, W, d, O, packed);
  return cudaSuccess;
}

int launch_tile(const float* x, float* out, const float* dw, const float* pwt, const float* pb,
                const float* hwt, const float* hb, int B, int C, int H, int W, int d, int O,
                int packed, cudaStream_t s) {
  switch (tile_ot(C)) {
    case 6: return launch_tile_ot<6>(x, out, dw, pwt, pb, hwt, hb, B, C, H, W, d, O, packed, s);
    case 8: return launch_tile_ot<8>(x, out, dw, pwt, pb, hwt, hb, B, C, H, W, d, O, packed, s);
    case 12: return launch_tile_ot<12>(x, out, dw, pwt, pb, hwt, hb, B, C, H, W, d, O, packed, s);
    case 16: return launch_tile_ot<16>(x, out, dw, pwt, pb, hwt, hb, B, C, H, W, d, O, packed, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int C>
int launch(const float* x, float* out, const float* dw, const float* pwt,
           const float* pb, const float* hwt, const float* hb, int B, int H,
           int W, int d, int O, int packed, cudaStream_t stream) {
  const long long n = static_cast<long long>(B) * H * W;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  const int smem = static_cast<int>(narrow_smem(C, hwt != nullptr ? O : 0));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(context_layer_kernel<C>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  context_layer_kernel<C><<<blocks, kThreads, smem, stream>>>(
      x, out, dw, pwt, pb, hwt, hb, B, H, W, d, O, packed);
  return cudaSuccess;
}

template <int C, int P, bool kHead>
int launch_exact_p(const float* x, float* out, const float* dw, const float* pwt, const float* pb,
                   const float* hwt, const float* hb, int B, int H, int W, int d, int O,
                   int packed, int rows, int threads, cudaStream_t stream) {
  const dim3 grid((rows * W + threads - 1) / threads, B);
  context_exact_kernel<C, P, kHead><<<grid, threads, 0, stream>>>(
      x, out, dw, pwt, pb, hwt, hb, H, W, d, O, packed, rows);
  return cudaSuccess;
}

// The exact instance's plan (ops/cuda/context_kernel.py exact_plan): P
// pixels a thread (1 or 2), rows of threads an image, which must be
// exact_thread_rows(H, d, P), and kExactThreads threads a block; a row of
// blocks an image.
inline bool exact_plan_ok(int B, int H, int W, int d, int P, int rows, int threads) {
  return d > 0 && (P == 1 || P == 2) && rows == exact_thread_rows(H, d, P) &&
         threads == kExactThreads && B <= 65535;
}

template <int C>
int launch_exact(const float* x, float* out, const float* dw, const float* pwt, const float* pb,
                 const float* hwt, const float* hb, int B, int H, int W, int d, int O, int packed,
                 int P, int rows, int threads, cudaStream_t s) {
  const bool head = hwt != nullptr;
#define CONTEXT_EXACT(PP, HEAD)                                                                  \
  launch_exact_p<C, PP, HEAD>(x, out, dw, pwt, pb, hwt, hb, B, H, W, d, O, packed, rows, threads, \
                              s)
  if (P == 1) return head ? CONTEXT_EXACT(1, true) : CONTEXT_EXACT(1, false);
  return head ? CONTEXT_EXACT(2, true) : CONTEXT_EXACT(2, false);
#undef CONTEXT_EXACT
}

// Every C <= 32 off the compiled widths, or a head past kMaxO outputs: the
// register kernel compiled for C, its head in dynamic shared memory.
template <int C>
int launch_narrow(int c, const float* x, float* out, const float* dw, const float* pwt,
                  const float* pb, const float* hwt, const float* hb, int B, int H, int W, int d,
                  int O, int packed, cudaStream_t stream) {
  if constexpr (C > kNarrowMax) {
    return cudaErrorInvalidValue;
  } else {
    if (c == C) return launch<C>(x, out, dw, pwt, pb, hwt, hb, B, H, W, d, O, packed, stream);
    return launch_narrow<C + 1>(c, x, out, dw, pwt, pb, hwt, hb, B, H, W, d, O, packed, stream);
  }
}

int launch_wide(const float* x, float* out, const float* dw, const float* pwt, const float* pb,
                const float* hwt, const float* hb, int B, int C, int H, int W, int d, int O,
                int packed, cudaStream_t stream) {
  const int T = wide_threads(C, hwt != nullptr);
  if (T == 0) return cudaErrorInvalidValue;
  const size_t smem = wide_smem(C, hwt != nullptr, T);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        context_layer_wide, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const long long n = static_cast<long long>(B) * H * W;
  const unsigned blocks = static_cast<unsigned>((n + T - 1) / T);
  context_layer_wide<<<blocks, T, smem, stream>>>(x, out, dw, pwt, pb, hwt, hb, B, C, H, W, d, O,
                                                  packed);
  return cudaSuccess;
}

}  // namespace

// x (B, C, H, W) -> out (B, C, H, W), or (B, O, H, W) when hwt is not null,
// or with ``packed`` (and hwt) the phase-major (B, 4 O, H/2, W/2), H and W
// even.  Any C >= 1 and O >= 1 (the instance as the header says: the tile
// instance where tile_fits(C, O, H, W), for every layer of the call); past the
// wide kernel's shared memory (2 C columns of 32 floats) cudaErrorInvalidValue.
// P, rows and threads: the exact instance's plan (ops/cuda/context_kernel.py
// exact_plan: P pixels a thread, rows of threads an image, threads a block),
// read by no other instance.
extern "C" int context_layer(const void* x, void* out, const void* dw,
                             const void* pwt, const void* pb, const void* hwt,
                             const void* hb, int B, int C, int H, int W, int d,
                             int O, int packed, int P, int rows, int threads, void* stream) {
  if (O <= 0 || C <= 0 || B <= 0 || H <= 0 || W <= 0 ||
      (packed && (hwt == nullptr || H % 2 != 0 || W % 2 != 0)))
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto fx = static_cast<const float*>(x);
  auto fo = static_cast<float*>(out);
  auto fdw = static_cast<const float*>(dw);
  auto fpw = static_cast<const float*>(pwt);
  auto fpb = static_cast<const float*>(pb);
  auto fhw = static_cast<const float*>(hwt);
  auto fhb = static_cast<const float*>(hb);
  int e = cudaSuccess;
  if (O <= kMaxO && (C == 8 || C == 16 || C == 24 || C == 32)) {
    if (!exact_plan_ok(B, H, W, d, P, rows, threads)) return cudaErrorInvalidValue;
#define CONTEXT_EXACT(CC) \
  launch_exact<CC>(fx, fo, fdw, fpw, fpb, fhw, fhb, B, H, W, d, O, packed, P, rows, threads, s)
    switch (C) {
      case 8: e = CONTEXT_EXACT(8); break;
      case 16: e = CONTEXT_EXACT(16); break;
      case 24: e = CONTEXT_EXACT(24); break;
      default: e = CONTEXT_EXACT(32); break;
    }
#undef CONTEXT_EXACT
  } else if (narrow_fits(C, O)) {
    e = launch_narrow<1>(C, fx, fo, fdw, fpw, fpb, fhw, fhb, B, H, W, d, O, packed, s);
  } else if (tile_fits(C, O, H, W)) {
    e = launch_tile(fx, fo, fdw, fpw, fpb, fhw, fhb, B, C, H, W, d, O, packed, s);
  } else {
    e = launch_wide(fx, fo, fdw, fpw, fpb, fhw, fhb, B, C, H, W, d, O, packed, s);
  }
  if (e != cudaSuccess) return e;
  return launch_status();
}
