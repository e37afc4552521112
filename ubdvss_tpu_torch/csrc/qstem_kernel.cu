// The int8 trunk's stem in one launch: the image quantized, layer 0 (3x3
// stride 2, one input channel) and layer 1 (3x3 stride 2), each with its
// dequant + bias + ReLU + requant epilogue; only layer 1's int8 map is
// written.
//
// Replaces no Pallas kernel: in the JAX package these are _quantize_input
// (ubdvss_tpu/ops/quant.py:315-329) and the first two _qconv calls of
// int8_trunk_apply (:276-292, :307-309), which XLA compiles.
//
// Bound on this card: a B=64 512x512 uint8 batch reads 16.8 MB and writes
// 25.2 MB of layer 1's int8 map: 12.5 us at 3.35 TB/s.  Layer 0's 100.7 MB
// int8 map, which a layer-by-layer trunk writes and reads back, stays in
// shared memory.  The work that remains is layer 0's 100.7 M requantized
// outputs (the epilogue, about 8 f32 operations each).
//
// Design (ops/cuda/qconv_kernel.py tile_plan, kind "stem"):
//   * persistent blocks walk th x tw tiles of layer 1's output, staging the
//     next tile's raw input window by cp.async while they compute the
//     current one; a tile quantizes its (4 th + 3) x (4 tw + 3) input
//     window into shared memory once (raw
//     grayscale as one fused rounding of x * 127/127.5 - 127, a normalized
//     image as x * 127, both half to even; zero outside the image: SAME
//     padding is int8 zero, whatever the input kind);
//   * layer 0: the (2 th + 1) x (2 tw + 1) outputs layer 1 reads, 16
//     pixels an s8 mma.sync m16n8k16 whose K is the 3x3 window as three
//     rows of four bytes (the fourth byte and the fourth row carry zero
//     weights), so an A register is one window row's four bytes, two
//     aligned shared-memory words and a byte permute; they go to shared
//     memory as int8 NHWC, zero where they fall outside layer 0's map,
//     since layer 1's SAME padding pads layer 0's output;
//   * layer 1: qconv_kernel.cu's m16n8k32 scheme (qconv.cuh Conv3x3) at
//     stride 2 on that tile, two runs a warp at a time, then the staged
//     contiguous store of each 16-pixel run.
// Odd sizes pad as same_pad computes (the plan's pt0, pl0, pt1, pl1).
//
// qlayer0_tc_kernel is layer 0 alone, as the calibration's bias correction
// reads it (tile_plan kind "layer0"): tiles of th x tw layer-0 outputs, the
// (2 th + 1) x (2 tw + 1) input window staged and quantized as above, the
// same m16n8k16 MMAs, and an f32 epilogue: y = fmaf((float)acc, ws, b)
// and the exact (float)acc, each 16-pixel run staged and stored
// contiguously.
//
// Past 32 channels (c0 or c1; the plan's ``generic``) qstem_any_kernel and
// qlayer0_any_kernel run the same tiles: the stem's window quantized and
// its layer 0 computed without a branch a value, eight n8 tiles a pass,
// its layer 1 through qconv.cuh ConvAny, eight n8 tiles a pass, a run
// staged and stored contiguous where one pass holds its channels, two
// blocks an SM; layer 0 alone an n8 tile at a time, its f32 runs staged
// as qlayer0_tc_kernel's, four blocks an SM.
#include "qconv.cuh"

// A debug build (-DQSTEM_STAMPS, scripts/torch_kernel_ab.py --only widths)
// sums qstem_any_kernel's clock64() cycles by phase for each block, as its
// thread 0 sees them between the block's barriers: the next window's wait
// with the barrier before a tile, the quantization, layer 0, layer 1
// (closed by a barrier of its own in this build), then the tiles walked.
#ifdef QSTEM_STAMPS
__device__ long long g_qstem_cycles[5 * 2048];
extern "C" int qstem_cycles(long long* host, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_qstem_cycles, sizeof(long long) * n));
}
extern "C" int qstem_cycles_clear() {
  void* p = nullptr;
  const cudaError_t e = cudaGetSymbolAddress(&p, g_qstem_cycles);
  return static_cast<int>(e != cudaSuccess ? e : cudaMemset(p, 0, sizeof(g_qstem_cycles)));
}
#define QSTEM_STAMP(k)                                      \
  if (threadIdx.x == 0 && blockIdx.x < 2048) {              \
    const long long now_ = clock64();                       \
    long long* cycles_ = g_qstem_cycles + 5 * blockIdx.x;   \
    cycles_[k] += now_ - t_stamp;                           \
    if ((k) == 3) ++cycles_[4];                             \
    t_stamp = now_;                                         \
  }
#else
#define QSTEM_STAMP(k)
#endif

namespace {

using namespace qk;

// the value v of an image pixel, quantized to int8 (in the low byte)
__device__ __forceinline__ uint32_t quantize_value(float v, int kind) {
  v = kind == kF32Norm ? __fmul_rn(v, 127.f) : fmaf(v, kRawScale, -127.f);
  v = fminf(fmaxf(v, -127.f), 127.f);
  return static_cast<uint32_t>(__float_as_int(__fadd_rn(v, kMagic)));
}

struct StemTile {
  int b, Y1, X1;  // image, layer 1's first row and column
  int R0, C0;     // layer 0's tile origin
  int IR, IC;     // the input window's origin
};

__device__ __forceinline__ StemTile decode(const Plan& p, int tile) {
  const int ct = tile % p.n_ct;
  tile /= p.n_ct;
  const int rt = tile % p.n_rt, b = tile / p.n_rt;
  const int Y1 = rt * p.th, X1 = ct * p.tw;
  const int R0 = 2 * Y1 - p.pt1, C0 = 2 * X1 - p.pl1;
  return {b, Y1, X1, R0, C0, 2 * R0 - p.pt0, 2 * C0 - p.pl0};
}

// The raw input window of a tile into buf by 16-byte cp.async, one warp a
// row: the aligned 16-byte blocks that hold the row's pixels inside the
// image (an aligned block lies in the page of the bytes it holds, so the
// few bytes around the row are read but never used).  Pixels outside the
// image are not read: the quantization writes 0 there.
__device__ __forceinline__ void issue_window(uint8_t* buf, const void* x, const Plan& p,
                                             const StemTile& st, int warp, int lane) {
  const int xlo = max(st.IC, 0), xhi = min(st.IC + p.inw, p.W);
  const int esz = p.in_kind == kU8Raw ? 1 : 4;
  for (int r = warp; r < p.inh; r += kWarps) {
    const int yy = st.IR + r;
    if (yy < 0 || yy >= p.H || xhi <= xlo) continue;
    const long long rb = (static_cast<long long>(st.b) * p.H + yy) * p.W;
    const uintptr_t a0 = reinterpret_cast<uintptr_t>(x) + (rb + xlo) * esz;
    const uintptr_t a1 = reinterpret_cast<uintptr_t>(x) + (rb + xhi) * esz;
    const uintptr_t base = a0 & ~static_cast<uintptr_t>(15);
    const int blocks = static_cast<int>((a1 - base + 15) >> 4);
    uint8_t* dst = buf + r * p.raw_row;
    for (int e = lane; e < blocks; e += 32)
      cp_async16(dst + 16 * e, reinterpret_cast<const void*>(base + 16 * e));
  }
}

// The window quantized into s_in (inh rows of in_row int8), one warp a row,
// four pixels a lane at a time (one 4-byte store); 0 outside the image
// (SAME padding pads the quantized image with 0).
__device__ __forceinline__ void quantize_window(uint8_t* s_in, const uint8_t* buf, const void* x,
                                                const Plan& p, const StemTile& st, int warp,
                                                int lane) {
  const int xlo = max(st.IC, 0), xhi = min(st.IC + p.inw, p.W);
  const bool u8 = p.in_kind == kU8Raw;
  const int esz = u8 ? 1 : 4;
  for (int r = warp; r < p.inh; r += kWarps) {
    const int yy = st.IR + r;
    const bool row_in = yy >= 0 && yy < p.H;
    const long long rb = (static_cast<long long>(st.b) * p.H + (row_in ? yy : 0)) * p.W;
    // the row's first pixel in the image sits at this byte of the row buffer
    const int sh = static_cast<int>((reinterpret_cast<uintptr_t>(x) + (rb + xlo) * esz) & 15);
    const uint8_t* src = buf + r * p.raw_row + sh;
    for (int c = 4 * lane; c < p.inw; c += 128) {
      uint32_t word = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int xx = st.IC + c + i;
        if (row_in && xx >= xlo && xx < xhi) {
          const float f = u8 ? __fsub_rn(__int_as_float(0x4B000000 | src[xx - xlo]), 8388608.f)
                             : reinterpret_cast<const float*>(src)[xx - xlo];  // (float)u8 exactly
          word |= (quantize_value(f, p.in_kind) & 0xFF) << (8 * i);
        }
      }
      *reinterpret_cast<uint32_t*>(s_in + r * p.in_row + c) = word;
    }
  }
}

// quantize_window without a branch a pixel, as the any-width kernels take
// it (the compiled kernels keep theirs): the row buffer's index clamped
// into the row's pixels inside the image, 0 selected outside it
template <bool U8>
__device__ __forceinline__ void quantize_rows(uint8_t* s_in, const uint8_t* buf, const void* x,
                                              const Plan& p, const StemTile& st, int warp,
                                              int lane) {
  const int xlo = max(st.IC, 0), xhi = min(st.IC + p.inw, p.W);
  const int last = max(xhi - xlo - 1, 0);
  for (int r = warp; r < p.inh; r += kWarps) {
    const int yy = st.IR + r;
    const bool row_in = yy >= 0 && yy < p.H;
    const long long rb = (static_cast<long long>(st.b) * p.H + (row_in ? yy : 0)) * p.W;
    const int sh = static_cast<int>((reinterpret_cast<uintptr_t>(x) + (rb + xlo) * (U8 ? 1 : 4)) & 15);
    const uint8_t* src = buf + r * p.raw_row + sh;
    for (int c = 4 * lane; c < p.inw; c += 128) {
      uint32_t word = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int xi = st.IC + c + i - xlo;
        const int xc = min(max(xi, 0), last);
        const float f = U8 ? __fsub_rn(__int_as_float(0x4B000000 | src[xc]), 8388608.f)
                           : reinterpret_cast<const float*>(src)[xc];
        const uint32_t q = quantize_value(f, p.in_kind) & 0xFF;
        word |= (row_in && xi >= 0 && xi <= xhi - xlo - 1 ? q : 0u) << (8 * i);
      }
      *reinterpret_cast<uint32_t*>(s_in + r * p.in_row + c) = word;
    }
  }
}

// A "layer0" tile: layer 0's th x tw outputs from (R0, C0), reading the
// input window at (IR, IC).
__device__ __forceinline__ StemTile decode_layer0(const Plan& p, int tile) {
  const int ct = tile % p.n_ct;
  tile /= p.n_ct;
  const int rt = tile % p.n_rt, b = tile / p.n_rt;
  const int R0 = rt * p.th, C0 = ct * p.tw;
  return {b, 0, 0, R0, C0, 2 * R0 - p.pt0, 2 * C0 - p.pl0};
}

// Layer 0's K words for lane (g, t) of n8 tile n: word t of output channel
// 8n + g holds window row t's three taps (the fourth byte and t = 3 zero).
template <int NT0>
__device__ __forceinline__ void layer0_fragments(int* s_w0, const int8_t* q0, const Plan& p,
                                                 int c0) {
  const int tid = threadIdx.x;
  if (tid < NT0 * 32) {
    const int lane = tid & 31, co = 8 * (tid >> 5) + (lane >> 2), tt = lane & 3;
    uint32_t w = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int src = p.k0_src[4 * tt + k];
      if (src >= 0 && co < c0) w |= static_cast<uint32_t>(static_cast<uint8_t>(q0[src + co])) << (8 * k);
    }
    s_w0[tid] = static_cast<int>(w);
  }
}

template <int NT0>
__global__ void __launch_bounds__(kThreads, 3)
qlayer0_tc_kernel(const void* __restrict__ x, const int8_t* __restrict__ q0,
                  const float* __restrict__ ws0, const float* __restrict__ b0,
                  float* __restrict__ y, float* __restrict__ acc_out,
                  const __grid_constant__ Plan p) {
  extern __shared__ __align__(16) uint8_t smem[];
  int* s_w0 = reinterpret_cast<int*>(smem + p.off_w0);
  float* s_vec = reinterpret_cast<float*>(smem + p.off_vec);
  uint8_t* s_in = smem + p.off_tile;
  const uint32_t* s_in_w = reinterpret_cast<const uint32_t*>(s_in);
  uint8_t* const raw = smem + p.off_raw;  // two buffers of raw_bytes
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int c0 = p.cout, l0w = p.l0w;
  uint8_t* stage = smem + p.off_stage + warp * p.stage_bytes;

  int tile = blockIdx.x;
  issue_window(raw, x, p, decode_layer0(p, tile), warp, lane);
  cp_async_commit();
  layer0_fragments<NT0>(s_w0, q0, p, c0);
  if (tid < 32) {
    s_vec[tid] = tid < c0 ? ws0[tid] : 0.f;
    s_vec[32 + tid] = tid < c0 ? b0[tid] : 0.f;
  }
  __syncthreads();
  int bw0[NT0];
#pragma unroll
  for (int n = 0; n < NT0; ++n) bw0[n] = s_w0[n * 32 + lane];
  const int n0 = p.l0h * l0w, mts0 = (n0 + 15) / 16;
  const int trow = p.k0_off[4 * t];  // lane t gathers window row t (t = 3: zero weights)

  for (int k = 0; tile < p.n_tiles; ++k, tile += gridDim.x) {
    const int next = tile + gridDim.x;
    if (next < p.n_tiles)
      issue_window(raw + ((k + 1) & 1) * p.raw_bytes, x, p, decode_layer0(p, next), warp, lane);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    const StemTile st = decode_layer0(p, tile);
    quantize_window(s_in, raw + (k & 1) * p.raw_bytes, x, p, st, warp, lane);
    __syncthreads();
    // 16 pixels an MMA tile: a run of one tile row (tw is a multiple of 16)
    for (int m = warp; m < mts0; m += kWarps) {
      const int pix = m * 16;
      const int r = (pix * p.l0w_magic) >> 20, c = pix - r * l0w;  // pix / l0w
      if (st.R0 + r >= p.H0 || st.C0 + c >= p.W0) continue;
      int a[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int byte = 2 * r * p.in_row + trow + 2 * (c + g + 8 * h);
        const uint32_t lo = s_in_w[byte >> 2], hi = s_in_w[(byte >> 2) + 1];
        a[h] = t < 3 ? static_cast<int>((byte & 2) ? __byte_perm(lo, hi, 0x5432) : lo) : 0;
      }
      int acc[NT0][4];
      init_acc(acc);
#pragma unroll
      for (int n = 0; n < NT0; ++n) mma_k16(acc[n], a[0], a[1], bw0[n]);
      // y, then the accumulator: staged pixel-major, one contiguous run
      const int nvalid = min(16, p.W0 - (st.C0 + c));
      const long long o =
          ((static_cast<long long>(st.b) * p.H0 + st.R0 + r) * p.W0 + st.C0 + c) * c0;
#pragma unroll
      for (int k2 = 0; k2 < 2; ++k2) {
        float* dst = k2 ? acc_out : y;
        if (dst == nullptr) continue;
        dst += o;
        uint8_t* s8 = stage + (reinterpret_cast<uintptr_t>(dst) & 15);
        float* sf = reinterpret_cast<float*>(s8);
#pragma unroll
        for (int n = 0; n < NT0; ++n) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int ch = 8 * n + 2 * t + e;
              if (ch < c0) {
                const float av = acc_float<false>(acc[n][2 * h + e]);
                sf[(g + 8 * h) * c0 + ch] = k2 ? av : fmaf(av, s_vec[ch], s_vec[32 + ch]);
              }
            }
          }
        }
        __syncwarp();
        warp_store(s8, reinterpret_cast<uint8_t*>(dst), nvalid * c0 * 4, lane);
        __syncwarp();
      }
    }
  }
}

template <int NW1, int NT1>
__global__ void __launch_bounds__(kThreads, 3)
qstem_tc_kernel(const void* __restrict__ x, const int8_t* __restrict__ q0,
                const float* __restrict__ ws0, const float* __restrict__ b0,
                const float* __restrict__ s1, const int8_t* __restrict__ q1,
                const float* __restrict__ ws1, const float* __restrict__ b1,
                const float* __restrict__ s2, int8_t* __restrict__ out,
                const __grid_constant__ Plan p) {
  constexpr int NT0 = (NW1 + 1) / 2;  // layer 0's n8 tiles: its c0 = 4 NW1 outputs
  using Conv = Conv3x3<NT1, NW1, 2>;
  extern __shared__ __align__(16) uint8_t smem[];
  int* s_w = reinterpret_cast<int*>(smem + p.off_w);
  int* s_w0 = reinterpret_cast<int*>(smem + p.off_w0);
  float* s_vec = reinterpret_cast<float*>(smem + p.off_vec);
  uint8_t* s_in = smem + p.off_tile;
  const uint32_t* s_in_w = reinterpret_cast<const uint32_t*>(s_in);
  uint8_t* s_l0 = smem + p.off_l0;
  uint8_t* const raw = smem + p.off_raw;  // two buffers of raw_bytes
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int c0 = 4 * NW1, c1 = p.cout, l0w = p.l0w;

  // the first tile's window, then the weights and vectors while it arrives
  int tile = blockIdx.x;
  issue_window(raw, x, p, decode(p, tile), warp, lane);
  cp_async_commit();
  layer0_fragments<NT0>(s_w0, q0, p, c0);
  // layer 1's weights staged raw in the layer-0 tile (free until layer 0
  // runs), then packed
  copy_to_shared(reinterpret_cast<int8_t*>(s_l0), q1, 9 * c0 * c1);
  __syncthreads();
  pack_fragments(s_w, reinterpret_cast<const int8_t*>(s_l0), p, NT1, c1);
  if (tid < 32) {
    s_vec[tid] = tid < c0 ? ws0[tid] : 0.f;
    s_vec[32 + tid] = tid < c0 ? b0[tid] : 0.f;
    s_vec[64 + tid] = tid < c0 ? s1[tid] : 0.f;
    s_vec[96 + tid] = tid < c1 ? ws1[tid] : 0.f;
    s_vec[128 + tid] = tid < c1 ? b1[tid] : 0.f;
    s_vec[160 + tid] = tid < c1 ? s2[tid] : 0.f;
  }
  __syncthreads();
  int bw0[NT0];
#pragma unroll
  for (int n = 0; n < NT0; ++n) bw0[n] = s_w0[n * 32 + lane];
  Conv conv;
  conv.load(s_w, p, lane);
  uint8_t* stage = smem + p.off_stage + warp * p.stage_bytes;
  const uint32_t* l0 = reinterpret_cast<const uint32_t*>(s_l0);
  const int runs = p.tw / 16, n_mt = p.th * runs;
  const int n0 = p.l0h * l0w, mts0 = (n0 + 15) / 16;
  const int trow = p.k0_off[4 * t];  // lane t gathers window row t (t = 3: zero weights)

  for (int k = 0; tile < p.n_tiles; ++k, tile += gridDim.x) {
    const int next = tile + gridDim.x;
    if (next < p.n_tiles)
      issue_window(raw + ((k + 1) & 1) * p.raw_bytes, x, p, decode(p, next), warp, lane);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    const StemTile st = decode(p, tile);

    // 1. the input window, quantized
    quantize_window(s_in, raw + (k & 1) * p.raw_bytes, x, p, st, warp, lane);
    __syncthreads();

    // 2. layer 0 on the (2 th + 1) x (2 tw + 1) tile, into shared memory.
    // K byte 4 ty + tx is window row ty, column tx of the 3x3 window (tx = 3
    // and ty = 3 carry zero weights), so lane t's A word is four bytes of
    // window row t: two aligned words and a byte permute.
    for (int m = warp; m < mts0; m += kWarps) {
      int pix[2], a[2];
      bool ok[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        pix[h] = m * 16 + g + 8 * h;
        const bool in = pix[h] < n0;
        const int r = (pix[h] * p.l0w_magic) >> 20, c = pix[h] - r * l0w;  // pix / l0w
        ok[h] = in && st.R0 + r >= 0 && st.R0 + r < p.H0 && st.C0 + c >= 0 && st.C0 + c < p.W0;
        const int byte = in ? 2 * r * p.in_row + trow + 2 * c : 0;
        const uint32_t lo = s_in_w[byte >> 2], hi = s_in_w[(byte >> 2) + 1];
        a[h] = t < 3 ? static_cast<int>((byte & 2) ? __byte_perm(lo, hi, 0x5432) : lo) : 0;
      }
      int acc[NT0][4];
      init_acc(acc);
#pragma unroll
      for (int n = 0; n < NT0; ++n) mma_k16(acc[n], a[0], a[1], bw0[n]);
#pragma unroll
      for (int n = 0; n < NT0; ++n) {
        const int c = 8 * n + 2 * t;
        if (c >= c0) continue;
        const float2 w = *reinterpret_cast<const float2*>(s_vec + c);
        const float2 bb = *reinterpret_cast<const float2*>(s_vec + 32 + c);
        const float2 sc = *reinterpret_cast<const float2*>(s_vec + 64 + c);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (pix[h] >= n0) continue;
          const uint16_t v = ok[h] ? pack2(requant<false>(acc[n][2 * h], w.x, bb.x, sc.x),
                                           requant<false>(acc[n][2 * h + 1], w.y, bb.y, sc.y))
                                   : static_cast<uint16_t>(0);
          *reinterpret_cast<uint16_t*>(s_l0 + pix[h] * c0 + c) = v;
        }
      }
    }
    __syncthreads();

    // 3. layer 1 from the tile, stride 2, two runs a warp at a time
    for (int m = warp; m < n_mt; m += 2 * kWarps) {
      int ys[2], xs[2];
      bool ok[2];
      const uint32_t* a[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int mm = min(m + h * kWarps, n_mt - 1);
        const int i = mm / runs, jx = (mm - i * runs) * 16;
        ys[h] = st.Y1 + i;
        xs[h] = st.X1 + jx;
        ok[h] = m + h * kWarps < n_mt && ys[h] < p.Ho && xs[h] < p.Wo;
        a[h] = l0 + (2 * i * l0w + 2 * jx) * NW1;
      }
      if (!ok[0] && !ok[1]) continue;
      int acc0[NT1][4], acc1[NT1][4];
      init_acc(acc0);
      init_acc(acc1);
      conv.mma2(acc0, acc1, a[0], a[1]);
      const long long row0 = static_cast<long long>(st.b) * p.Ho;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!ok[h]) continue;
        uint8_t* dst = reinterpret_cast<uint8_t*>(out) + ((row0 + ys[h]) * p.Wo + xs[h]) * c1;
        uint8_t* sg = stage + (reinterpret_cast<uintptr_t>(dst) & 15);
        if (h == 0)
          stage_int8<NT1, Conv::WIDE>(sg, acc0, c1, s_vec + 96, conv.p0, conv.p1, t);
        else
          stage_int8<NT1, Conv::WIDE>(sg, acc1, c1, s_vec + 96, conv.p0, conv.p1, t);
        __syncwarp();
        warp_store(sg, dst, min(16, p.Wo - xs[h]) * c1, lane);
        __syncwarp();
      }
    }
  }
}

// ---- any width (the plan's ``generic``: c0 or c1 past 32) ----

// Layer 0's K words of every n8 tile (layer0_fragments at a runtime tile
// count): s_w0[n * 32 + lane].
__device__ __forceinline__ void layer0_fragments_any(int* s_w0, const int8_t* q0, const Plan& p,
                                                     int c0) {
  const int nt0 = (c0 + 7) / 8;
  for (int i = threadIdx.x; i < nt0 * 32; i += kThreads) {
    const int lane = i & 31, co = 8 * (i >> 5) + (lane >> 2), tt = lane & 3;
    uint32_t w = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int src = p.k0_src[4 * tt + k];
      if (src >= 0 && co < c0) w |= static_cast<uint32_t>(static_cast<uint8_t>(q0[src + co])) << (8 * k);
    }
    s_w0[i] = static_cast<int>(w);
  }
}

// Layer 0 alone at any width with its f32 epilogue (qlayer0_tc_kernel's
// tiles, A gather and stores), an n8 tile at a time: each 16-pixel run's y,
// then its accumulator, staged pixel-major in the warp's buffer at the
// destination's address mod 16 and stored as one contiguous span by
// warp_store (an 8-byte store a lane from the registers, which filled
// whole sectors only at some widths, took 1.2-4x as long).  Four blocks an
// SM (32 warps) up to 64 channels: the launch bound caps a thread at 64
// registers, and a block's shared memory is about 22 KB and its staging.
__global__ void __launch_bounds__(kThreads, 4)
qlayer0_any_kernel(const void* __restrict__ x, const int8_t* __restrict__ q0,
                   const float* __restrict__ ws0, const float* __restrict__ b0,
                   float* __restrict__ y, float* __restrict__ acc_out,
                   const __grid_constant__ Plan p) {
  extern __shared__ __align__(16) uint8_t smem[];
  int* s_w0 = reinterpret_cast<int*>(smem + p.off_w0);
  float* s_vec = reinterpret_cast<float*>(smem + p.off_vec);
  uint8_t* s_in = smem + p.off_tile;
  const uint32_t* s_in_w = reinterpret_cast<const uint32_t*>(s_in);
  uint8_t* const raw = smem + p.off_raw;  // two buffers of raw_bytes
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int c0 = p.cout, l0w = p.l0w, nt0 = (c0 + 7) / 8, CP = round32(c0);
  uint8_t* stage = smem + p.off_stage + warp * p.stage_bytes;

  int tile = blockIdx.x;
  issue_window(raw, x, p, decode_layer0(p, tile), warp, lane);
  cp_async_commit();
  layer0_fragments_any(s_w0, q0, p, c0);
  for (int i = tid; i < CP; i += kThreads) {
    s_vec[i] = i < c0 ? ws0[i] : 0.f;
    s_vec[CP + i] = i < c0 ? b0[i] : 0.f;
  }
  __syncthreads();
  const int n0 = p.l0h * l0w, mts0 = (n0 + 15) / 16;
  const int trow = p.k0_off[4 * t];

  for (int k = 0; tile < p.n_tiles; ++k, tile += gridDim.x) {
    const int next = tile + gridDim.x;
    if (next < p.n_tiles)
      issue_window(raw + ((k + 1) & 1) * p.raw_bytes, x, p, decode_layer0(p, next), warp, lane);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    const StemTile st = decode_layer0(p, tile);
    if (p.in_kind == kU8Raw)
      quantize_rows<true>(s_in, raw + (k & 1) * p.raw_bytes, x, p, st, warp, lane);
    else
      quantize_rows<false>(s_in, raw + (k & 1) * p.raw_bytes, x, p, st, warp, lane);
    __syncthreads();
    for (int m = warp; m < mts0; m += kWarps) {
      const int pix = m * 16;
      const int r = (pix * p.l0w_magic) >> 20, c = pix - r * l0w;  // pix / l0w
      if (st.R0 + r >= p.H0 || st.C0 + c >= p.W0) continue;
      int a[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int byte = 2 * r * p.in_row + trow + 2 * (c + g + 8 * h);
        const uint32_t lo = s_in_w[byte >> 2], hi = s_in_w[(byte >> 2) + 1];
        a[h] = t < 3 ? static_cast<int>((byte & 2) ? __byte_perm(lo, hi, 0x5432) : lo) : 0;
      }
      const int nvalid = min(16, p.W0 - (st.C0 + c));
      const long long o = ((static_cast<long long>(st.b) * p.H0 + st.R0 + r) * p.W0 + st.C0 + c);
      // y, then the accumulator: staged pixel-major (the MMAs again for the
      // second, one k16 step an n8 tile), one contiguous run
#pragma unroll
      for (int k2 = 0; k2 < 2; ++k2) {
        float* dst = k2 ? acc_out : y;
        if (dst == nullptr) continue;
        dst += o * c0;
        uint8_t* s8 = stage + (reinterpret_cast<uintptr_t>(dst) & 15);
        float* sf = reinterpret_cast<float*>(s8);
        for (int n = 0; n < nt0; ++n) {
          int acc[4] = {kMagicBits, kMagicBits, kMagicBits, kMagicBits};
          mma_k16(acc, a[0], a[1], s_w0[n * 32 + lane]);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int ch = 8 * n + 2 * t + e;
              if (ch >= c0) continue;
              const float av = acc_float<false>(acc[2 * h + e]);
              sf[(g + 8 * h) * c0 + ch] = k2 ? av : fmaf(av, s_vec[ch], s_vec[CP + ch]);
            }
          }
        }
        __syncwarp();
        warp_store(s8, reinterpret_cast<uint8_t*>(dst), nvalid * c0 * 4, lane);
        __syncwarp();
      }
    }
  }
}

// The stem at any width: qstem_tc_kernel's tiles, window and layer-0 tile
// in shared memory.  The window is quantized and layer 0 computed without
// a branch a value (a branch a pixel pair and its reconvergence cost more
// than the values' arithmetic): layer 0 eight n8 tiles a pass, unrolled,
// their B fragments and vectors in registers, every MMA issued before the
// epilogues, its tile padded to whole 16-pixel runs so that a run's
// pixels past the tile are written and never read.  Layer 1 goes through
// ConvAny at stride 2, kPassTiles n8 tiles a pass (a warp's second run
// skipped where it lies past the tile).  Where one pass holds every
// channel (c1 <= 64, the plan's
// stage_bytes), each run's int8 outputs are requantized into the warp's
// staging buffer (16 pixels of c1 bytes, at its destination's address mod
// 16) and stored as one contiguous span by warp_store; past that, where a
// run's pixels are whole only after the last pass, each lane stores its
// two channels of its two pixels from the registers.  The vectors: ws0,
// b0, s1 at a stride of round32(c0), then ws1, b1, s2 at round32(c1).
// Two blocks an SM: the launch bound caps a thread at 128 registers, and
// tile_plan sizes the block's shared memory for two up to 64 channels.
template <bool WIDE>
__global__ void __launch_bounds__(kThreads, 2)
qstem_any_kernel(const void* __restrict__ x, const int8_t* __restrict__ q0,
                 const float* __restrict__ ws0, const float* __restrict__ b0,
                 const float* __restrict__ s1, const int8_t* __restrict__ q1,
                 const float* __restrict__ ws1, const float* __restrict__ b1,
                 const float* __restrict__ s2, int8_t* __restrict__ out,
                 const __grid_constant__ Plan p) {
  extern __shared__ __align__(16) uint8_t smem[];
  int* s_w = reinterpret_cast<int*>(smem + p.off_w);
  int* s_w0 = reinterpret_cast<int*>(smem + p.off_w0);
  float* s_vec = reinterpret_cast<float*>(smem + p.off_vec);
  int* s_koff = reinterpret_cast<int*>(smem + p.off_koff);
  uint8_t* s_in = smem + p.off_tile;
  const uint32_t* s_in_w = reinterpret_cast<const uint32_t*>(s_in);
  uint8_t* s_l0 = smem + p.off_l0;
  uint8_t* const raw = smem + p.off_raw;  // two buffers of raw_bytes
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int c0 = p.c0, c1 = p.cout, l0w = p.l0w, nt0 = (c0 + 7) / 8, nt1 = (c1 + 7) / 8;
  const int C0P = round32(c0), C1P = round32(c1);
  float* v1 = s_vec + 3 * C0P;  // ws1, b1, s2

  int tile = blockIdx.x;
  issue_window(raw, x, p, decode(p, tile), warp, lane);
  cp_async_commit();
  layer0_fragments_any(s_w0, q0, p, c0);
  k_offsets_any(s_koff, p, true);
  pack_fragments_any(s_w, q1, p, c0, c1);
  for (int i = tid; i < C0P; i += kThreads) {
    s_vec[i] = i < c0 ? ws0[i] : 0.f;
    s_vec[C0P + i] = i < c0 ? b0[i] : 0.f;
    s_vec[2 * C0P + i] = i < c0 ? s1[i] : 0.f;
  }
  for (int i = tid; i < C1P; i += kThreads) {
    v1[i] = i < c1 ? ws1[i] : 0.f;
    v1[C1P + i] = i < c1 ? b1[i] : 0.f;
    v1[2 * C1P + i] = i < c1 ? s2[i] : 0.f;
  }
  __syncthreads();
  ConvAny conv;
  conv.load(s_w, s_koff, p, c1, 2, lane);
  const uint32_t* l0 = reinterpret_cast<const uint32_t*>(s_l0);
  // a warp's staging: one run's c1 bytes a pixel, where one pass holds them
  uint8_t* stage = smem + p.off_stage + warp * p.stage_bytes;
  const bool staged = p.stage_bytes > 0;
  const int runs = p.tw / 16, n_mt = p.th * runs;
  const int n0 = p.l0h * l0w, mts0 = (n0 + 15) / 16;
  const int trow = p.k0_off[4 * t];
#ifdef QSTEM_STAMPS
  long long t_stamp = clock64();
#endif

  for (int k = 0; tile < p.n_tiles; ++k, tile += gridDim.x) {
    const int next = tile + gridDim.x;
    if (next < p.n_tiles)
      issue_window(raw + ((k + 1) & 1) * p.raw_bytes, x, p, decode(p, next), warp, lane);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    QSTEM_STAMP(0);
    const StemTile st = decode(p, tile);

    // 1. the input window, quantized
    if (p.in_kind == kU8Raw)
      quantize_rows<true>(s_in, raw + (k & 1) * p.raw_bytes, x, p, st, warp, lane);
    else
      quantize_rows<false>(s_in, raw + (k & 1) * p.raw_bytes, x, p, st, warp, lane);
    __syncthreads();
    QSTEM_STAMP(1);

    // 2. layer 0 on the (2 th + 1) x (2 tw + 1) tile: its B fragments and
    // vectors in registers, eight n8 tiles a pass, unrolled, without a branch
    // a value
    for (int nb = 0; nb < nt0; nb += kPassTiles) {
      int bw[kPassTiles];
      float2 w[kPassTiles], bb[kPassTiles], sc[kPassTiles];
#pragma unroll
      for (int j = 0; j < kPassTiles; ++j) {
        const int c = min(8 * (nb + j) + 2 * t, C0P - 2);
        bw[j] = nb + j < nt0 ? s_w0[(nb + j) * 32 + lane] : 0;
        w[j] = *reinterpret_cast<const float2*>(s_vec + c);
        bb[j] = *reinterpret_cast<const float2*>(s_vec + C0P + c);
        sc[j] = *reinterpret_cast<const float2*>(s_vec + 2 * C0P + c);
      }
      for (int m = warp; m < mts0; m += kWarps) {
        int pix[2], a[2];
        bool ok[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          pix[h] = m * 16 + g + 8 * h;
          const bool in = pix[h] < n0;
          const int r = (pix[h] * p.l0w_magic) >> 20, c = pix[h] - r * l0w;  // pix / l0w
          ok[h] = in && st.R0 + r >= 0 && st.R0 + r < p.H0 && st.C0 + c >= 0 && st.C0 + c < p.W0;
          const int byte = in ? 2 * r * p.in_row + trow + 2 * c : 0;
          const uint32_t lo = s_in_w[byte >> 2], hi = s_in_w[(byte >> 2) + 1];
          a[h] = t < 3 ? static_cast<int>((byte & 2) ? __byte_perm(lo, hi, 0x5432) : lo) : 0;
        }
        int acc[kPassTiles][4];
        init_acc(acc);
#pragma unroll
        for (int j = 0; j < kPassTiles; ++j) mma_k16(acc[j], a[0], a[1], bw[j]);
#pragma unroll
        for (int j = 0; j < kPassTiles; ++j) {
          const int c = 8 * (nb + j) + 2 * t;
          // the tile holds whole 16-pixel runs: a pixel past it is never read
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint16_t v = pack2(requant<false>(acc[j][2 * h], w[j].x, bb[j].x, sc[j].x),
                                     requant<false>(acc[j][2 * h + 1], w[j].y, bb[j].y, sc[j].y));
            if (c < c0) *reinterpret_cast<uint16_t*>(s_l0 + pix[h] * c0 + c) = ok[h] ? v : uint16_t(0);
          }
        }
      }
    }
    __syncthreads();
    QSTEM_STAMP(2);

    // 3. layer 1 from the tile, stride 2, two runs a warp at a time
    const long long row0 = static_cast<long long>(st.b) * p.Ho;
    for (int m = warp; m < n_mt; m += 2 * kWarps) {
      int ys[2], xs[2];
      bool ok[2];
      const uint32_t* a[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int mm = min(m + h * kWarps, n_mt - 1);
        const int i = mm / runs, jx = (mm - i * runs) * 16;
        ys[h] = st.Y1 + i;
        xs[h] = st.X1 + jx;
        ok[h] = m + h * kWarps < n_mt && ys[h] < p.Ho && xs[h] < p.Wo;
        a[h] = l0 + (2 * i * l0w + 2 * jx) * p.nw;
      }
      if (!ok[0] && !ok[1]) continue;
      const bool two = m + kWarps < n_mt;
      for (int g0 = 0; g0 < nt1; g0 += kPassTiles) {
        int acc[2][kPassTiles][4];
        init_acc(acc[0]);
        init_acc(acc[1]);
        conv.mma2(acc[0], acc[1], a[0], a[1], g0, min(kPassTiles, nt1 - g0), two);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!ok[h]) continue;
          const int nvalid = min(16, p.Wo - xs[h]);
          uint8_t* dst = reinterpret_cast<uint8_t*>(out) + ((row0 + ys[h]) * p.Wo + xs[h]) * c1;
          uint8_t* sg = stage + (reinterpret_cast<uintptr_t>(dst) & 15);
#pragma unroll
          for (int n = 0; n < kPassTiles; ++n) {
            if (g0 + n >= nt1) continue;
            const int c = 8 * (g0 + n) + 2 * t;  // c1 a multiple of 4: c + 1 < c1 where c < c1
            const float2 w = *reinterpret_cast<const float2*>(v1 + c);
            const float2 bb = *reinterpret_cast<const float2*>(v1 + C1P + c);
            const float2 sc = *reinterpret_cast<const float2*>(v1 + 2 * C1P + c);
            const uint16_t q0v = pack2(requant<WIDE>(acc[h][n][0], w.x, bb.x, sc.x),
                                       requant<WIDE>(acc[h][n][1], w.y, bb.y, sc.y));
            const uint16_t q1v = pack2(requant<WIDE>(acc[h][n][2], w.x, bb.x, sc.x),
                                       requant<WIDE>(acc[h][n][3], w.y, bb.y, sc.y));
            if (c < c1 && staged) {
              *reinterpret_cast<uint16_t*>(sg + conv.p0 * c1 + c) = q0v;
              *reinterpret_cast<uint16_t*>(sg + conv.p1 * c1 + c) = q1v;
            } else if (c < c1) {
              if (conv.p0 < nvalid) *reinterpret_cast<uint16_t*>(dst + conv.p0 * c1 + c) = q0v;
              if (conv.p1 < nvalid) *reinterpret_cast<uint16_t*>(dst + conv.p1 * c1 + c) = q1v;
            }
          }
          if (staged) {  // the run's one pass is whole: one contiguous span
            __syncwarp();
            warp_store(sg, dst, nvalid * c1, lane);
            __syncwarp();
          }
        }
      }
    }
#ifdef QSTEM_STAMPS
    __syncthreads();
#endif
    QSTEM_STAMP(3);
  }
}

template <bool WIDE>
int launch_any(const void* x, const void* q0, const void* ws0, const void* b0, const void* s1,
               const void* q1, const void* ws1, const void* b1, const void* s2, void* out,
               const Plan& p, cudaStream_t stream) {
  int grid = 0;
  const int e = persistent_grid<qstem_any_kernel<WIDE>>(p.smem, p.n_tiles, &grid);
  if (e != cudaSuccess) return e;
  qstem_any_kernel<WIDE><<<grid, kThreads, p.smem, stream>>>(
      x, static_cast<const int8_t*>(q0), static_cast<const float*>(ws0),
      static_cast<const float*>(b0), static_cast<const float*>(s1),
      static_cast<const int8_t*>(q1), static_cast<const float*>(ws1),
      static_cast<const float*>(b1), static_cast<const float*>(s2), static_cast<int8_t*>(out), p);
  return launch_status();
}

template <int NW1, int NT1>
int launch(const void* x, const void* q0, const void* ws0, const void* b0, const void* s1,
           const void* q1, const void* ws1, const void* b1, const void* s2, void* out,
           const Plan& p, cudaStream_t stream) {
  using Conv = Conv3x3<NT1, NW1, 2>;
  if (p.nsteps != Conv::KS || p.row_step != Conv::RS || p.acc_wide != Conv::WIDE)
    return cudaErrorInvalidValue;
  int grid = 0;
  const int e = persistent_grid<qstem_tc_kernel<NW1, NT1>>(p.smem, p.n_tiles, &grid);
  if (e != cudaSuccess) return e;
  qstem_tc_kernel<NW1, NT1><<<grid, kThreads, p.smem, stream>>>(
      x, static_cast<const int8_t*>(q0), static_cast<const float*>(ws0),
      static_cast<const float*>(b0), static_cast<const float*>(s1),
      static_cast<const int8_t*>(q1), static_cast<const float*>(ws1),
      static_cast<const float*>(b1), static_cast<const float*>(s2), static_cast<int8_t*>(out), p);
  return launch_status();
}

template <int NW1>
int dispatch(int nt1, const void* x, const void* q0, const void* ws0, const void* b0,
             const void* s1, const void* q1, const void* ws1, const void* b1, const void* s2,
             void* out, const Plan& p, cudaStream_t s) {
  switch (nt1) {
    case 1: return launch<NW1, 1>(x, q0, ws0, b0, s1, q1, ws1, b1, s2, out, p, s);
    case 2: return launch<NW1, 2>(x, q0, ws0, b0, s1, q1, ws1, b1, s2, out, p, s);
    case 3: return launch<NW1, 3>(x, q0, ws0, b0, s1, q1, ws1, b1, s2, out, p, s);
    default: return launch<NW1, 4>(x, q0, ws0, b0, s1, q1, ws1, b1, s2, out, p, s);
  }
}

template <int NT0>
int launch_layer0(const void* x, const void* q0, const void* ws0, const void* b0, void* y,
                  void* acc, const Plan& p, cudaStream_t stream) {
  int grid = 0;
  const int e = persistent_grid<qlayer0_tc_kernel<NT0>>(p.smem, p.n_tiles, &grid);
  if (e != cudaSuccess) return e;
  qlayer0_tc_kernel<NT0><<<grid, kThreads, p.smem, stream>>>(
      x, static_cast<const int8_t*>(q0), static_cast<const float*>(ws0),
      static_cast<const float*>(b0), static_cast<float*>(y), static_cast<float*>(acc), p);
  return launch_status();
}

}  // namespace

// Layer 0 alone with its f32 epilogue (the bias correction): x the (B, H,
// W) image as qstem_tc takes it; q0: HWIO int8 (3, 3, 1, C0), ws0, b0: f32
// (C0); y: f32 (B, H0, W0, C0) = fmaf((float)acc, ws0, b0); acc: the exact
// (float)acc there too, or null.  plan: the ints of tile_plan("layer0", ...).
extern "C" int qlayer0_tc(const void* x, const void* q0, const void* ws0, const void* b0,
                          void* y, void* acc, const int* plan, int plan_ints, void* stream) {
  if (plan_ints != qconv_plan_ints()) return cudaErrorInvalidValue;
  Plan p;
  memcpy(&p, plan, sizeof(Plan));
  if (p.n_tiles <= 0 || p.cout <= 0 || (p.cout > 32 && !p.generic) || p.f32 != 1 ||
      p.in_kind < kU8Raw || p.in_kind > kF32Norm || p.l0h != p.th || p.l0w != p.tw ||
      p.stage_bytes < 64 * p.cout + 16)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (p.generic) {
    int grid = 0;
    const int e = persistent_grid<qlayer0_any_kernel>(p.smem, p.n_tiles, &grid);
    if (e != cudaSuccess) return e;
    qlayer0_any_kernel<<<grid, kThreads, p.smem, s>>>(
        x, static_cast<const int8_t*>(q0), static_cast<const float*>(ws0),
        static_cast<const float*>(b0), static_cast<float*>(y), static_cast<float*>(acc), p);
    return launch_status();
  }
  switch ((p.cout + 7) / 8) {
    case 1: return launch_layer0<1>(x, q0, ws0, b0, y, acc, p, s);
    case 2: return launch_layer0<2>(x, q0, ws0, b0, y, acc, p, s);
    case 3: return launch_layer0<3>(x, q0, ws0, b0, y, acc, p, s);
    default: return launch_layer0<4>(x, q0, ws0, b0, y, acc, p, s);
  }
}

// x: the (B, H, W) image, uint8 (in_kind 1) or f32 (2 raw, 3 normalized);
// q0: HWIO int8 (3, 3, 1, C0), ws0, b0, s1: f32 (C0); q1: HWIO int8 (3, 3,
// C0, C1), ws1, b1, s2: f32 (C1); out: int8 (B, Ho, Wo, C1).  plan: the ints
// of tile_plan("stem", ...), plan_ints of them.
extern "C" int qstem_tc(const void* x, const void* q0, const void* ws0, const void* b0,
                        const void* s1, const void* q1, const void* ws1, const void* b1,
                        const void* s2, void* out, const int* plan, int plan_ints, void* stream) {
  if (plan_ints != qconv_plan_ints()) return cudaErrorInvalidValue;
  Plan p;
  memcpy(&p, plan, sizeof(Plan));
  if (p.generic) {
    if (p.n_tiles <= 0 || p.c0 % 4 != 0 || p.c0 <= 0 || p.nw != p.c0 / 4 || p.cout % 4 != 0 ||
        p.cout <= 0 || p.tw % 16 != 0 || p.nsteps != (9 * p.nw + 7) / 8 ||
        p.in_kind < kU8Raw || p.in_kind > kF32Norm || p.f32 != 0 ||
        (p.row_step != 1 && p.row_step != 2) || p.acc_wide < 0 || p.acc_wide > 2 ||
        (p.cout <= 8 * kPassTiles ? p.stage_bytes < 16 * p.cout + 16 : p.stage_bytes != 0))
      return cudaErrorInvalidValue;
    auto s = static_cast<cudaStream_t>(stream);
    return p.acc_wide ? launch_any<true>(x, q0, ws0, b0, s1, q1, ws1, b1, s2, out, p, s)
                      : launch_any<false>(x, q0, ws0, b0, s1, q1, ws1, b1, s2, out, p, s);
  }
  if (p.n_tiles <= 0 || p.c0 % 4 != 0 || p.c0 <= 0 || p.c0 > 32 || p.cout % 4 != 0 ||
      p.cout <= 0 || p.cout > 32 || p.tw % 16 != 0 || p.nsteps != p.c0 / 4 + 1 ||
      p.in_kind < kU8Raw || p.in_kind > kF32Norm || p.f32 != 0)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const int nt1 = (p.cout + 7) / 8;
  switch (p.c0 / 4) {
    case 1: return dispatch<1>(nt1, x, q0, ws0, b0, s1, q1, ws1, b1, s2, out, p, s);
    case 2: return dispatch<2>(nt1, x, q0, ws0, b0, s1, q1, ws1, b1, s2, out, p, s);
    case 3: return dispatch<3>(nt1, x, q0, ws0, b0, s1, q1, ws1, b1, s2, out, p, s);
    case 4: return dispatch<4>(nt1, x, q0, ws0, b0, s1, q1, ws1, b1, s2, out, p, s);
    case 5: return dispatch<5>(nt1, x, q0, ws0, b0, s1, q1, ws1, b1, s2, out, p, s);
    case 6: return dispatch<6>(nt1, x, q0, ws0, b0, s1, q1, ws1, b1, s2, out, p, s);
    case 7: return dispatch<7>(nt1, x, q0, ws0, b0, s1, q1, ws1, b1, s2, out, p, s);
    default: return dispatch<8>(nt1, x, q0, ws0, b0, s1, q1, ws1, b1, s2, out, p, s);
  }
}
