// The int8 trunk's context layers on the tensor cores: one 3x3 stride-1
// dilated int8 conv with its dequant + bias + ReLU + requant epilogue, and
// (qconv_head) the last context layer with the 1x1 head fused in.  The
// same kernel with an f32 epilogue runs one int8-input layer alone for the
// calibration's bias correction (qconv_tc_f32), and qrequant requantizes
// that layer's accumulators with the corrected bias.
//
// Replaces no Pallas kernel: in the JAX package these layers are XLA's
// int8 convs, _qconv (ubdvss_tpu/ops/quant.py:276-292: conv_general_dilated
// with preferred_element_type=int32, then acc * ws + b, ReLU, round(y * s),
// clip, int8; the head returns acc * ws + b as f32), chained by
// int8_trunk_apply (:295-312); the bias correction (:165-203) computes a
// layer's acc once, reads acc * ws + b, and requantizes acc with the bias
// it corrected.  PyTorch has no int8 convolution on CUDA.
//
// Bound on this card: a context layer of the main path (B=64, 128x128, 24
// channels) reads 25.2 MB of int8 and writes 25.2 MB: 15.0 us at 3.35
// TB/s, against 10.9 G int8 operations, 5.5 us at 1,979 TOPS — bytes.  The
// fused launch reads 25.2 MB and writes 71.3 MB of f32 logits: 28.8 us.
//
// Design (the plan, ops/cuda/qconv_kernel.py tile_plan, fixes every index):
//   * a tile is th phase rows x tw columns of one image: a dilated layer
//     is split into d row phases, so a tile reads th + 2 halo rows whatever
//     d is, and tw + 2d contiguous columns (a stride-2 layer 2 th + 1 rows
//     of 2 tw + 1 columns); the halo is staged into shared memory by
//     16-byte cp.async (8 or 4 where map rows are not whole 16-byte
//     chunks), zero outside the map (SAME padding, the plan's pad_t and
//     pad_l: a 3x3 stride-1 layer pads d each side);
//   * the blocks are persistent (as many as stay resident, three an SM at
//     the main path's shapes): each packs the weights once and walks the
//     tiles blockIdx, blockIdx + gridDim, ..., staging the next tile's halo
//     into a second buffer while it computes the current one;
//   * each warp takes 16-pixel runs of a tile row as the M of the s8
//     mma.sync m16n8k32; N is the output channels (three n8 tiles for 24);
//     K is (tap, 4-channel word), 9 taps x Cin/4 words padded with zero
//     weights to whole k32 steps (seven for 24 channels; a 1x1 layer's one
//     tap, the window's centre, fills the first steps and the rest are
//     skipped).  An A register is
//     one channel word of one pixel at one tap, read straight from the halo
//     (no im2col; with an even number of words a lane's two words of a step
//     are one 8-byte load); the B fragments are packed from the HWIO kernel
//     into shared memory once a block; a warp runs two runs' MMAs
//     interleaved, reading each B fragment once for both (qconv.cuh
//     Conv3x3);
//   * the epilogue (qconv.cuh) requantizes in registers, writes the run's
//     int8 NHWC bytes into a per-warp staging buffer, and the warp stores
//     them as one contiguous run, 16 bytes a lane;
//   * qconv_head: the staged int8 run is the head's A operand (K = Cout
//     padded to 32, N = the logits padded to n8 tiles); its f32 logits go
//     through a second staging buffer to one contiguous store;
//   * F32 (qconv_tc_f32): the epilogue writes y = fmaf((float)acc, ws, b)
//     and the exact (float)acc beside it, each staged and stored as one
//     contiguous run, four n8 tiles whatever Cout (up to 32 f32 outputs,
//     the head's 17 too);
//     qrequant then reads acc once (16 B in, 4 B out a thread).
// The compiled instances above take input channels and int8 outputs a
// multiple of 4 up to 32 and logits up to 32; every other width runs
// qconv_any_kernel (the plan's ``generic``, qconv.cuh ConvAny): the same
// tiles, halos and runs with the channel words, k steps and n8 tiles from
// the plan, the output channels eight n8 tiles at a time, int8 outputs
// staged and stored as contiguous runs as the compiled epilogue stores
// them, f32 outputs stored straight from the registers, a head's k steps
// over its Cout, two blocks an SM; qrequant takes any channel count.  The
// wrappers pad a count that is not a multiple of 4
// (ops/cuda/qconv_kernel.py pad_layer).
#include "qconv.cuh"

namespace {

using namespace qk;

struct Tile {
  int b, ph, r0, x0;  // image, phase, first phase row, first column
};

__device__ __forceinline__ Tile decode(const Plan& p, int tile) {
  const int ct = tile % p.n_ct;
  tile /= p.n_ct;
  const int rt = tile % p.n_rt;
  tile /= p.n_rt;
  return {tile / p.phases, tile % p.phases, rt * p.th, ct * p.tw};
}

// Where a tile's halo starts in its buffer: with align16 (every map row a
// whole number of 16-byte chunks) at the byte offset that matches the
// source's address mod 16, so the rows copy as aligned 16-byte chunks.
template <int STRIDE>
__device__ __forceinline__ int halo_shift(const int8_t* x, const Plan& p, const Tile& tl) {
  const uintptr_t g =
      reinterpret_cast<uintptr_t>(x) +
      static_cast<uintptr_t>((static_cast<long long>(STRIDE) * tl.x0 - p.pad_l) * 4 * p.nw);
  return p.align16 ? static_cast<int>(g & 15) : 0;
}

// Stage a tile's halo into buf: phase rows r0-1 .. r0+th, columns x0-d ..
// x0+tw+d-1 (stride 2: input rows 2 r0 - pad_t .. 2 (r0 + th) - pad_t,
// columns likewise), a row every row_words words, halo byte q of a row at
// byte halo_shift + q; by cp.async of 16 bytes (align16), else 8 (NW even:
// a pixel is whole 8-byte chunks) or 4; zero outside the map (SAME padding).
// NW = 0: the plan's channel words (the any-width kernel), 4-byte copies.
template <int NW, int STRIDE>
__device__ __forceinline__ void issue_halo(uint32_t* buf, const int8_t* x, const Plan& p,
                                           const Tile& tl) {
  const int CB = NW != 0 ? 4 * NW : 4 * p.nw;  // bytes a pixel
  const int RB = 4 * p.row_words, span = p.halo_w * CB, sh = halo_shift<STRIDE>(x, p, tl);
  const int xin = STRIDE * tl.x0 - p.pad_l;  // the halo's first input column
  uint8_t* b8 = reinterpret_cast<uint8_t*>(buf);
  for (int hr = 0; hr < p.halo_h; ++hr) {
    const int y = tl.ph + STRIDE * p.d * tl.r0 + p.d * hr - p.pad_t;
    const bool in = y >= 0 && y < p.H;
    const int lo = in ? max(0, -xin) * CB : span;  // the row's bytes in the map
    const int hi = in ? min(p.halo_w, p.W - xin) * CB : span;
    uint8_t* row = b8 + hr * RB;
    const int8_t* src =
        x + ((static_cast<long long>(tl.b) * p.H + (in ? y : 0)) * p.W + xin) * CB;
    if (p.align16) {
      for (int j = threadIdx.x; j < RB / 16; j += kThreads) {
        const int q0 = 16 * j - sh;  // the halo byte at the chunk's start
        if (q0 >= lo && q0 + 16 <= hi) {
          cp_async16(row + 16 * j, src + q0);
        } else if (q0 + 16 <= lo || q0 >= hi) {
          *reinterpret_cast<int4*>(row + 16 * j) = make_int4(0, 0, 0, 0);
        } else {
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            const int q = q0 + 4 * w;
            if (q >= lo && q < hi) {
              cp_async4(row + 16 * j + 4 * w, src + q);
            } else {
              *reinterpret_cast<uint32_t*>(row + 16 * j + 4 * w) = 0;
            }
          }
        }
      }
    } else {
      constexpr int C = NW != 0 && NW % 2 == 0 ? 8 : 4;  // bytes a copy
      for (int e = threadIdx.x; e < span / C; e += kThreads) {
        const int q = C * e;
        if (q >= lo && q < hi) {
          if constexpr (C == 8) {
            cp_async8(row + q, src + q);
          } else {
            cp_async4(row + q, src + q);
          }
        } else {
          *reinterpret_cast<uint32_t*>(row + q) = 0;
          if constexpr (C == 8) *reinterpret_cast<uint32_t*>(row + q + 4) = 0;
        }
      }
    }
  }
}

// One run's epilogue with the head: requantize, run the head on the staged
// int8 run (K = cout channels padded to 32 with zero B words, N = 4 n8
// tiles) and store its f32 logits, staged and contiguous.  With the plan's
// ``packed`` the staging is the same and only the store's addressing
// differs: the logits go phase-major, (B, Ho/2, Wo/2, 4 nh) with channel
// (2 (y & 1) + (x & 1)) nh + c for pixel (y, x), so the run's pixels 2k and
// 2k + 1 (a run starts at an even column) are 2 nh contiguous floats of
// cell (y / 2, x0 / 2 + k) at phase row y & 1, the next pair 4 nh floats
// further on; the lanes store them 4 bytes each.
template <int NT, bool WIDE>
__device__ __forceinline__ void finish_run(const int (&acc)[NT][4], const Plan& p, void* out,
                                           long long pix, int nvalid, uint8_t* stage,
                                           const float* s_vec, const int* s_wh, int p0, int p1,
                                           int lane) {
  const int t = lane & 3, cout = p.cout, nh = p.nh;
  stage_int8<NT, WIDE>(stage, acc, cout, s_vec, p0, p1, t);
  __syncwarp();
  const int cw = cout / 4;
  const uint32_t* h0 = reinterpret_cast<const uint32_t*>(stage + p0 * cout);
  const uint32_t* h1 = reinterpret_cast<const uint32_t*>(stage + p1 * cout);
  const int w0 = t < cw ? t : 0, w1 = 4 + t < cw ? 4 + t : 0;
  const int a[4] = {static_cast<int>(h0[w0]), static_cast<int>(h1[w0]), static_cast<int>(h0[w1]),
                    static_cast<int>(h1[w1])};
  int hacc[4][4];
  init_acc(hacc);
#pragma unroll
  for (int n = 0; n < 4; ++n) mma_k32(hacc[n], a, s_wh[n * 64 + lane], s_wh[n * 64 + 32 + lane]);
  float* dst = static_cast<float*>(out) + pix * nh;
  const int al = p.packed ? 0 : static_cast<int>(reinterpret_cast<uintptr_t>(dst) & 15);
  uint8_t* st8 = stage + ((16 * cout + 15) & ~15);
  float* st = reinterpret_cast<float*>(st8 + al);
  const float* hws = s_vec + 96;
  const float* hb = s_vec + 128;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int c = 8 * n + 2 * t;
    if (c < nh) {
      st[p0 * nh + c] = fmaf(acc_float<false>(hacc[n][0]), hws[c], hb[c]);
      st[p1 * nh + c] = fmaf(acc_float<false>(hacc[n][2]), hws[c], hb[c]);
    }
    if (c + 1 < nh) {
      st[p0 * nh + c + 1] = fmaf(acc_float<false>(hacc[n][1]), hws[c + 1], hb[c + 1]);
      st[p1 * nh + c + 1] = fmaf(acc_float<false>(hacc[n][3]), hws[c + 1], hb[c + 1]);
    }
  }
  __syncwarp();
  if (p.packed) {
    const long long row = pix / p.Wo;  // b Ho + y, Ho even
    const int x = static_cast<int>(pix - row * p.Wo);
    float* cell = static_cast<float*>(out) +
                  (((row >> 1) * (p.Wo >> 1) + (x >> 1)) * 4 + 2 * (row & 1)) * nh;
    const int pair = 2 * nh;
    for (int i = lane; i < nvalid * nh; i += 32) {
      const int k = i / pair;
      cell[k * 2 * pair + (i - k * pair)] = st[i];
    }
  } else {
    warp_store(st8 + al, reinterpret_cast<uint8_t*>(dst), nvalid * nh * 4, lane);
  }
  __syncwarp();
}

// The two runs m and m + kWarps of a tile: where their A operands start,
// their first pixels, and whether each lies inside the map (a run index past
// the tile is clamped to a valid one, computed but not stored).
struct RunPair {
  const uint32_t* a[2];
  int y[2], x[2];
  bool ok[2];
};

template <int STRIDE>
__device__ __forceinline__ RunPair run_pair(const Plan& p, const Tile& tl, const uint32_t* buf,
                                            int m, int n_mt, int runs, int rw) {
  RunPair r;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int mm = min(m + h * kWarps, n_mt - 1);
    const int i = mm / runs, jx = (mm - i * runs) * 16;
    r.y[h] = tl.ph + p.d * (tl.r0 + i);
    r.x[h] = tl.x0 + jx;
    r.ok[h] = m + h * kWarps < n_mt && r.y[h] < p.Ho && r.x[h] < p.Wo;
    r.a[h] = buf + STRIDE * (i * rw + jx * p.nw);
  }
  return r;
}

// F32: one run's pre-activations y = fmaf((float)acc, ws, b) and, where
// acc_out is given, the exact (float)acc (channels 8n + 2t, +1 of pixels
// p0, p1), each staged pixel-major in the warp's buffer and stored as one
// contiguous run of its first nvalid pixels, 16 bytes a lane.
template <int NT, bool WIDE>
__device__ __forceinline__ void store_f32(const int (&acc)[NT][4], long long pix, int nvalid,
                                          float* y, float* acc_out, int cout, const float* vec,
                                          int p0, int p1, uint8_t* stage, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    float* dst = k ? acc_out : y;
    if (dst == nullptr) continue;
    dst += pix * cout;
    uint8_t* s8 = stage + (reinterpret_cast<uintptr_t>(dst) & 15);
    float* st = reinterpret_cast<float*>(s8);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * n + 2 * t + e;
          if (c < cout) {
            const float a = acc_float<WIDE>(acc[n][2 * h + e]);
            st[(h ? p1 : p0) * cout + c] = k ? a : fmaf(a, vec[c], vec[32 + c]);
          }
        }
      }
    }
    __syncwarp();
    warp_store(s8, reinterpret_cast<uint8_t*>(dst), nvalid * cout * 4, lane);
    __syncwarp();
  }
}

template <int NT, int NW, int STRIDE, bool F32>
__global__ void __launch_bounds__(kThreads, 3)
qconv_tc_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ q,
                const float* __restrict__ ws, const float* __restrict__ bias,
                const float* __restrict__ s_out, const int8_t* __restrict__ qh,
                const float* __restrict__ wsh, const float* __restrict__ bh,
                void* __restrict__ out, float* __restrict__ acc_out,
                const __grid_constant__ Plan p) {
  using Conv = Conv3x3<NT, NW, STRIDE>;
  extern __shared__ __align__(16) uint8_t smem[];
  int* s_w = reinterpret_cast<int*>(smem + p.off_w);
  int* s_wh = reinterpret_cast<int*>(smem + p.off_w0);
  float* s_vec = reinterpret_cast<float*>(smem + p.off_vec);
  uint32_t* const halo = reinterpret_cast<uint32_t*>(smem + p.off_tile);  // two buffers
  const int hbuf = p.tile_bytes / 4;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cout = p.cout, nh = p.nh, rw = p.row_words;

  // the first tile's halo, then the weights and vectors while it arrives;
  // the weights are staged raw in the second halo buffer, then packed
  int tile = blockIdx.x;
  issue_halo<NW, STRIDE>(halo, x, p, decode(p, tile));
  cp_async_commit();
  int8_t* s_q = reinterpret_cast<int8_t*>(halo + hbuf);
  const int qbytes = p.ks * p.ks * p.cin * cout;
  copy_to_shared(s_q, q, qbytes);
  if (nh > 0) copy_to_shared(s_q + ((qbytes + 15) & ~15), qh, cout * nh);
  __syncthreads();
  pack_fragments(s_w, s_q, p, NT, cout);
  if (nh > 0) {
    const int8_t* s_qh = s_q + ((qbytes + 15) & ~15);
    for (int i = tid; i < 4 * 64; i += kThreads) {
      const int ln = i & 31, w = 4 * ((i >> 5) & 1) + (ln & 3), co = 8 * (i >> 6) + (ln >> 2);
      s_wh[i] = 4 * w < cout && co < nh ? pack4(s_qh + 4 * w * nh + co, nh) : 0;
    }
  }
  if (tid < 32) {
    s_vec[tid] = tid < cout ? ws[tid] : 0.f;
    s_vec[32 + tid] = tid < cout ? bias[tid] : 0.f;
    s_vec[64 + tid] = tid < cout && !F32 ? s_out[tid] : 0.f;
    s_vec[96 + tid] = tid < nh ? wsh[tid] : 0.f;
    s_vec[128 + tid] = tid < nh ? bh[tid] : 0.f;
  }
  __syncthreads();
  Conv conv;
  conv.load(s_w, p, lane);
  uint8_t* stage = smem + p.off_stage + warp * p.stage_bytes;
  const int runs = p.tw / 16, n_mt = p.th * runs;

  for (int k = 0; tile < p.n_tiles; ++k, tile += gridDim.x) {
    // the next tile's halo into the other buffer while this one is computed
    const int next = tile + gridDim.x;
    if (next < p.n_tiles)
      issue_halo<NW, STRIDE>(halo + ((k + 1) & 1) * hbuf, x, p, decode(p, next));
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    const Tile tl = decode(p, tile);
    const uint32_t* buf = halo + (k & 1) * hbuf + halo_shift<STRIDE>(x, p, tl) / 4;
    // two 16-pixel runs a warp at a time: m and m + kWarps
    const long long row0 = static_cast<long long>(tl.b) * p.Ho;
    for (int m = warp; m < n_mt; m += 2 * kWarps) {
      const RunPair r = run_pair<STRIDE>(p, tl, buf, m, n_mt, runs, rw);
      if (!r.ok[0] && !r.ok[1]) continue;
      int acc0[NT][4], acc1[NT][4];
      init_acc(acc0);
      init_acc(acc1);
      conv.mma2(acc0, acc1, r.a[0], r.a[1], F32 ? p.nsteps : Conv::KS);
      const long long pix0 = (row0 + r.y[0]) * p.Wo + r.x[0], pix1 = (row0 + r.y[1]) * p.Wo + r.x[1];
      if constexpr (F32) {
        float* y = static_cast<float*>(out);
        if (r.ok[0])
          store_f32<NT, Conv::WIDE>(acc0, pix0, min(16, p.Wo - r.x[0]), y, acc_out, cout, s_vec,
                                    conv.p0, conv.p1, stage, lane);
        if (r.ok[1])
          store_f32<NT, Conv::WIDE>(acc1, pix1, min(16, p.Wo - r.x[1]), y, acc_out, cout, s_vec,
                                    conv.p0, conv.p1, stage, lane);
        continue;
      }
      if (nh == 0) {  // both runs staged, then stored: one pair of warp barriers
        uint8_t* d0 = static_cast<uint8_t*>(out) + pix0 * cout;
        uint8_t* d1 = static_cast<uint8_t*>(out) + pix1 * cout;
        uint8_t* st0 = stage + (reinterpret_cast<uintptr_t>(d0) & 15);
        uint8_t* st1 = stage + p.stage_bytes / 2 + (reinterpret_cast<uintptr_t>(d1) & 15);
        stage_int8<NT, Conv::WIDE>(st0, acc0, cout, s_vec, conv.p0, conv.p1, lane & 3);
        stage_int8<NT, Conv::WIDE>(st1, acc1, cout, s_vec, conv.p0, conv.p1, lane & 3);
        __syncwarp();
        if (r.ok[0]) warp_store(st0, d0, min(16, p.Wo - r.x[0]) * cout, lane);
        if (r.ok[1]) warp_store(st1, d1, min(16, p.Wo - r.x[1]) * cout, lane);
        __syncwarp();
        continue;
      }
      if (r.ok[0])
        finish_run<NT, Conv::WIDE>(acc0, p, out, pix0, min(16, p.Wo - r.x[0]), stage, s_vec,
                                   s_wh, conv.p0, conv.p1, lane);
      if (r.ok[1])
        finish_run<NT, Conv::WIDE>(acc1, p, out, pix1, min(16, p.Wo - r.x[1]), stage, s_vec,
                                   s_wh, conv.p0, conv.p1, lane);
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
}

// ---- any width (qconv.cuh ConvAny): the plan's ``generic`` ----

// One run's head at any width: the run's requantized int8 outputs staged
// in ``st`` (16 pixels of cout bytes) are the A operand (K = cout, its
// words past cout / 4 reading word 0 against zero B words), the head's
// n8 tiles run kGroupTiles at a time, and each lane stores its logits
// straight to device memory (phase-major with the plan's ``packed``).
__device__ __forceinline__ void head_run_any(const uint8_t* st, const Plan& p, float* out,
                                             long long row, int x0, int nvalid, const int* s_wh,
                                             const float* hws, const float* hb, int p0, int p1,
                                             int lane) {
  const int t = lane & 3, cout = p.cout, nh = p.nh, cw = cout / 4;
  const int kh = (cw + 7) / 8, nth = (nh + 7) / 8;
  const uint32_t* h0 = reinterpret_cast<const uint32_t*>(st + p0 * cout);
  const uint32_t* h1 = reinterpret_cast<const uint32_t*>(st + p1 * cout);
  for (int g0 = 0; g0 < nth; g0 += kGroupTiles) {
    int hacc[kGroupTiles][4];
    init_acc(hacc);
    for (int ks = 0; ks < kh; ++ks) {
      const int w0 = 8 * ks + t < cw ? 8 * ks + t : 0;
      const int w1 = 8 * ks + 4 + t < cw ? 8 * ks + 4 + t : 0;
      const int a[4] = {static_cast<int>(h0[w0]), static_cast<int>(h1[w0]),
                        static_cast<int>(h0[w1]), static_cast<int>(h1[w1])};
#pragma unroll
      for (int n = 0; n < kGroupTiles; ++n) {
        if (g0 + n < nth) {
          const int* b = s_wh + ((ks * nth + g0 + n) * 2) * 32 + lane;
          mma_k32(hacc[n], a, b[0], b[32]);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < kGroupTiles; ++n) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int px = h ? p1 : p0;
        if (px >= nvalid) continue;
        const int x = x0 + px;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * (g0 + n) + 2 * t + e;
          if (g0 + n >= nth || c >= nh) continue;
          // the conversion instruction: K = Cout products, exact below 2^24
          const float v = fmaf(acc_float<true>(hacc[n][2 * h + e]), hws[c], hb[c]);
          long long o;
          if (p.packed) {  // row = b Ho + y, Ho even
            o = (((row >> 1) * (p.Wo >> 1) + (x >> 1)) * 4 + 2 * (row & 1) + (x & 1)) * nh + c;
          } else {
            o = (row * p.Wo + x) * nh + c;
          }
          out[o] = v;
        }
      }
    }
  }
}

// The conv kernel at any width: qconv_tc_kernel's tiles, halos and runs,
// each run pair's output channels eight n8 tiles at a time (one pass up to
// 64 channels; the MMAs of a warp's second run skipped where it lies past
// the tile).  int8 outputs are requantized into the warp's staging buffer
// (two runs of 16 pixels of cout bytes, each at its destination's address
// mod 16), and each run is stored as one contiguous span, 16 bytes a lane;
// with the head the staged runs are head_run_any's A operand instead.  F32
// outputs are stored straight from the registers, two channels a lane (one
// 8-byte store each where cout is even).
// Two blocks an SM: the launch bound caps a thread at 128 registers, and
// tile_plan sizes a generic block's shared memory for two.
template <int STRIDE, bool WIDE, bool F32>
__global__ void __launch_bounds__(kThreads, 2)
qconv_any_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ q,
                 const float* __restrict__ ws, const float* __restrict__ bias,
                 const float* __restrict__ s_out, const int8_t* __restrict__ qh,
                 const float* __restrict__ wsh, const float* __restrict__ bh,
                 void* __restrict__ out, float* __restrict__ acc_out,
                 const __grid_constant__ Plan p) {
  extern __shared__ __align__(16) uint8_t smem[];
  int* s_w = reinterpret_cast<int*>(smem + p.off_w);
  int* s_wh = reinterpret_cast<int*>(smem + p.off_w0);
  float* s_vec = reinterpret_cast<float*>(smem + p.off_vec);
  int* s_koff = reinterpret_cast<int*>(smem + p.off_koff);
  uint32_t* const halo = reinterpret_cast<uint32_t*>(smem + p.off_tile);  // two buffers
  const int hbuf = p.tile_bytes / 4;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, t = lane & 3;
  const int cout = p.cout, nh = p.nh, rw = p.row_words;
  const int CP = round32(cout), NP = round32(nh);

  int tile = blockIdx.x;
  issue_halo<0, STRIDE>(halo, x, p, decode(p, tile));
  cp_async_commit();
  k_offsets_any(s_koff, p, false);
  pack_fragments_any(s_w, q, p, p.cin, cout);
  if (nh > 0) {
    const int kh = (cout / 4 + 7) / 8, nth = (nh + 7) / 8;
    for (int i = tid; i < kh * nth * 64; i += kThreads) {
      const int ln = i & 31, r = (i >> 5) & 1, tl = (i >> 6) % nth, ks = (i >> 6) / nth;
      const int w = 8 * ks + 4 * r + (ln & 3), co = 8 * tl + (ln >> 2);
      s_wh[i] = 4 * w < cout && co < nh ? pack4(qh + 4 * w * nh + co, nh) : 0;
    }
  }
  for (int i = tid; i < CP; i += kThreads) {
    s_vec[i] = i < cout ? ws[i] : 0.f;
    s_vec[CP + i] = i < cout ? bias[i] : 0.f;
    s_vec[2 * CP + i] = i < cout && !F32 ? s_out[i] : 0.f;
  }
  for (int i = tid; i < NP; i += kThreads) {
    s_vec[3 * CP + i] = i < nh ? wsh[i] : 0.f;
    s_vec[3 * CP + NP + i] = i < nh ? bh[i] : 0.f;
  }
  __syncthreads();
  ConvAny conv;
  conv.load(s_w, s_koff, p, cout, STRIDE, lane);
  uint8_t* stage = smem + p.off_stage + warp * p.stage_bytes;
  const int runs = p.tw / 16, n_mt = p.th * runs, nt = (cout + 7) / 8;
  const int half = (p.stage_bytes / 2) & ~15;  // the second run's staging
  constexpr int NG = kPassTiles;  // n8 tiles a pass: 64 channels

  for (int k = 0; tile < p.n_tiles; ++k, tile += gridDim.x) {
    const int next = tile + gridDim.x;
    if (next < p.n_tiles)
      issue_halo<0, STRIDE>(halo + ((k + 1) & 1) * hbuf, x, p, decode(p, next));
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    const Tile tl = decode(p, tile);
    const uint32_t* buf = halo + (k & 1) * hbuf + halo_shift<STRIDE>(x, p, tl) / 4;
    const long long row0 = static_cast<long long>(tl.b) * p.Ho;
    for (int m = warp; m < n_mt; m += 2 * kWarps) {
      const RunPair r = run_pair<STRIDE>(p, tl, buf, m, n_mt, runs, rw);
      if (!r.ok[0] && !r.ok[1]) continue;
      const bool two = m + kWarps < n_mt;
      long long pix[2];
      uint8_t* st[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        pix[h] = (row0 + r.y[h]) * p.Wo + r.x[h];
        const uintptr_t dst = reinterpret_cast<uintptr_t>(static_cast<uint8_t*>(out) + pix[h] * cout);
        st[h] = stage + h * half + (nh > 0 ? 0 : static_cast<int>(dst & 15));
      }
      for (int g0 = 0; g0 < nt; g0 += NG) {
        int acc[2][NG][4];
        init_acc(acc[0]);
        init_acc(acc[1]);
        conv.mma2(acc[0], acc[1], r.a[0], r.a[1], g0, min(NG, nt - g0), two);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!r.ok[h]) continue;
          const int nvalid = min(16, p.Wo - r.x[h]);
#pragma unroll
          for (int n = 0; n < NG; ++n) {
            const int c = 8 * (g0 + n) + 2 * t;
            if (g0 + n >= nt || c >= cout) continue;
            if constexpr (F32) {
              // channels c, c + 1 of rows g, g + 8: a float2 each where cout
              // is even, else a float each
#pragma unroll
              for (int v = 0; v < 2; ++v) {
                const int px = v ? conv.p1 : conv.p0;
                if (px >= nvalid) continue;
                const long long o = (pix[h] + px) * cout + c;
                float* y = static_cast<float*>(out) + o;
                const float a0 = acc_float<WIDE>(acc[h][n][2 * v]);
                const float y0 = fmaf(a0, s_vec[c], s_vec[CP + c]);
                if ((cout & 1) == 0) {
                  const float a1 = acc_float<WIDE>(acc[h][n][2 * v + 1]);
                  *reinterpret_cast<float2*>(y) = make_float2(y0, fmaf(a1, s_vec[c + 1], s_vec[CP + c + 1]));
                  if (acc_out != nullptr) *reinterpret_cast<float2*>(acc_out + o) = make_float2(a0, a1);
                  continue;
                }
                y[0] = y0;
                if (acc_out != nullptr) acc_out[o] = a0;
                if (c + 1 < cout) {
                  const float a1 = acc_float<WIDE>(acc[h][n][2 * v + 1]);
                  y[1] = fmaf(a1, s_vec[c + 1], s_vec[CP + c + 1]);
                  if (acc_out != nullptr) acc_out[o + 1] = a1;
                }
              }
            } else {  // channels c, c + 1 (cout is a multiple of 4) of rows g, g + 8
              const float2 w = *reinterpret_cast<const float2*>(s_vec + c);
              const float2 b = *reinterpret_cast<const float2*>(s_vec + CP + c);
              const float2 s = *reinterpret_cast<const float2*>(s_vec + 2 * CP + c);
              *reinterpret_cast<uint16_t*>(st[h] + conv.p0 * cout + c) =
                  pack2(requant<WIDE>(acc[h][n][0], w.x, b.x, s.x),
                        requant<WIDE>(acc[h][n][1], w.y, b.y, s.y));
              *reinterpret_cast<uint16_t*>(st[h] + conv.p1 * cout + c) =
                  pack2(requant<WIDE>(acc[h][n][2], w.x, b.x, s.x),
                        requant<WIDE>(acc[h][n][3], w.y, b.y, s.y));
            }
          }
        }
      }
      if constexpr (!F32) {
        __syncwarp();
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!r.ok[h]) continue;
          const int nvalid = min(16, p.Wo - r.x[h]);
          if (nh > 0) {
            head_run_any(st[h], p, static_cast<float*>(out), row0 + r.y[h], r.x[h], nvalid, s_wh,
                         s_vec + 3 * CP, s_vec + 3 * CP + NP, conv.p0, conv.p1, lane);
          } else {
            warp_store(st[h], static_cast<uint8_t*>(out) + pix[h] * cout, nvalid * cout, lane);
          }
        }
        __syncwarp();
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
}

template <int STRIDE, bool WIDE, bool F32>
int launch_any(const void* x, const void* q, const void* ws, const void* b, const void* s_out,
               const void* qh, const void* wsh, const void* bh, void* out, void* acc_out,
               const Plan& p, cudaStream_t stream) {
  int grid = 0;
  const int e =
      persistent_grid<qconv_any_kernel<STRIDE, WIDE, F32>>(p.smem, p.n_tiles, &grid);
  if (e != cudaSuccess) return e;
  qconv_any_kernel<STRIDE, WIDE, F32><<<grid, kThreads, p.smem, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(ws), static_cast<const float*>(b),
      static_cast<const float*>(s_out), static_cast<const int8_t*>(qh),
      static_cast<const float*>(wsh), static_cast<const float*>(bh), out,
      static_cast<float*>(acc_out), p);
  return launch_status();
}

template <int NT, int NW, int STRIDE, bool F32>
int launch(const void* x, const void* q, const void* ws, const void* b, const void* s_out,
           const void* qh, const void* wsh, const void* bh, void* out, void* acc_out,
           const Plan& p, cudaStream_t stream) {
  using Conv = Conv3x3<NT, NW, STRIDE>;
  if ((F32 ? p.nsteps > Conv::KS : p.nsteps != Conv::KS) || p.row_step != Conv::RS ||
      p.acc_wide != Conv::WIDE)
    return cudaErrorInvalidValue;
  int grid = 0;
  const int e = persistent_grid<qconv_tc_kernel<NT, NW, STRIDE, F32>>(p.smem, p.n_tiles, &grid);
  if (e != cudaSuccess) return e;
  qconv_tc_kernel<NT, NW, STRIDE, F32><<<grid, kThreads, p.smem, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(ws), static_cast<const float*>(b),
      static_cast<const float*>(s_out), static_cast<const int8_t*>(qh),
      static_cast<const float*>(wsh), static_cast<const float*>(bh), out,
      static_cast<float*>(acc_out), p);
  return launch_status();
}

template <int NT>
int dispatch(int nw, const void* x, const void* q, const void* ws, const void* b,
             const void* s_out, const void* qh, const void* wsh, const void* bh, void* out,
             const Plan& p, cudaStream_t s) {
  switch (nw) {
    case 1: return launch<NT, 1, 1, false>(x, q, ws, b, s_out, qh, wsh, bh, out, nullptr, p, s);
    case 2: return launch<NT, 2, 1, false>(x, q, ws, b, s_out, qh, wsh, bh, out, nullptr, p, s);
    case 3: return launch<NT, 3, 1, false>(x, q, ws, b, s_out, qh, wsh, bh, out, nullptr, p, s);
    case 4: return launch<NT, 4, 1, false>(x, q, ws, b, s_out, qh, wsh, bh, out, nullptr, p, s);
    case 5: return launch<NT, 5, 1, false>(x, q, ws, b, s_out, qh, wsh, bh, out, nullptr, p, s);
    case 6: return launch<NT, 6, 1, false>(x, q, ws, b, s_out, qh, wsh, bh, out, nullptr, p, s);
    case 7: return launch<NT, 7, 1, false>(x, q, ws, b, s_out, qh, wsh, bh, out, nullptr, p, s);
    default: return launch<NT, 8, 1, false>(x, q, ws, b, s_out, qh, wsh, bh, out, nullptr, p, s);
  }
}

// the f32 instances: four n8 tiles (up to 32 outputs) at any input width
template <int STRIDE>
int dispatch_f32(int nw, const void* x, const void* q, const void* ws, const void* b, void* y,
                 void* acc, const Plan& p, cudaStream_t s) {
  constexpr int N = 4;
  const void* z = nullptr;
  switch (nw) {
    case 1: return launch<N, 1, STRIDE, true>(x, q, ws, b, z, z, z, z, y, acc, p, s);
    case 2: return launch<N, 2, STRIDE, true>(x, q, ws, b, z, z, z, z, y, acc, p, s);
    case 3: return launch<N, 3, STRIDE, true>(x, q, ws, b, z, z, z, z, y, acc, p, s);
    case 4: return launch<N, 4, STRIDE, true>(x, q, ws, b, z, z, z, z, y, acc, p, s);
    case 5: return launch<N, 5, STRIDE, true>(x, q, ws, b, z, z, z, z, y, acc, p, s);
    case 6: return launch<N, 6, STRIDE, true>(x, q, ws, b, z, z, z, z, y, acc, p, s);
    case 7: return launch<N, 7, STRIDE, true>(x, q, ws, b, z, z, z, z, y, acc, p, s);
    default: return launch<N, 8, STRIDE, true>(x, q, ws, b, z, z, z, z, y, acc, p, s);
  }
}

// Requantization of exact accumulators, four channels (one int8 word) a
// thread: 16 bytes in, 4 out; the per-channel vectors in shared memory.
__global__ void __launch_bounds__(kThreads)
qrequant_kernel(const float4* __restrict__ acc, const float* __restrict__ ws,
                const float* __restrict__ b, const float* __restrict__ s_out,
                uint32_t* __restrict__ out, long long n_words, int cw) {
  __shared__ float s_vec[3][32];
  if (threadIdx.x < 32) {
    const int c = threadIdx.x;
    const bool in = c < 4 * cw;
    s_vec[0][c] = in ? ws[c] : 0.f;
    s_vec[1][c] = in ? b[c] : 0.f;
    s_vec[2][c] = in ? s_out[c] : 0.f;
  }
  __syncthreads();
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n_words;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    const float4 a = acc[i];
    const int c = 4 * static_cast<int>(i % cw);
    const float v[4] = {a.x, a.y, a.z, a.w};
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      word |= (requant_float(v[j], s_vec[0][c + j], s_vec[1][c + j], s_vec[2][c + j]) & 0xFFu)
              << (8 * j);
    out[i] = word;
  }
}

// Requantization at any channel count: one accumulator a thread, its
// channel's vectors read from device memory.
__global__ void __launch_bounds__(kThreads)
qrequant_any_kernel(const float* __restrict__ acc, const float* __restrict__ ws,
                    const float* __restrict__ b, const float* __restrict__ s_out,
                    int8_t* __restrict__ out, long long n, int C) {
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    const int c = static_cast<int>(i % C);
    out[i] = static_cast<int8_t>(
        requant_float(acc[i], __ldg(ws + c), __ldg(b + c), __ldg(s_out + c)) & 0xFFu);
  }
}

// The plan's any-width instance, or cudaErrorInvalidValue where the plan
// is not one tile_plan writes for it.
inline bool any_plan_ok(const Plan& p, bool f32) {
  return p.generic == 1 && p.n_tiles > 0 && p.cin > 0 && p.cin % 4 == 0 && p.nw == p.cin / 4 &&
         p.cout > 0 && p.tw % 16 == 0 && p.nh >= 0 && p.f32 == static_cast<int>(f32) &&
         p.acc_wide >= 0 && p.acc_wide <= 2 && (f32 || p.cout % 4 == 0) &&
         (p.row_step == 1 || p.row_step == 2) &&
         p.nsteps == ((p.ks == 1 ? 1 : 9) * p.nw + 7) / 8;
}

}  // namespace

// x: int8 (B, H, W, Cin); q: HWIO int8 (3, 3, Cin, Cout); ws, b, s_out: f32
// (Cout).  With qh (HWIO int8 (1, 1, Cout, O)), wsh, bh (f32 (O)): out is
// f32 (B, H, W, O) logits, or with the plan's ``packed`` the phase-major
// (B, H/2, W/2, 4 O); else int8 (B, H, W, Cout).  plan: the ints of
// tile_plan("conv", ...), plan_ints of them.
extern "C" int qconv_tc(const void* x, const void* q, const void* ws, const void* b,
                        const void* s_out, const void* qh, const void* wsh, const void* bh,
                        void* out, const int* plan, int plan_ints, void* stream) {
  if (plan_ints != qconv_plan_ints()) return cudaErrorInvalidValue;
  Plan p;
  memcpy(&p, plan, sizeof(Plan));
  auto s = static_cast<cudaStream_t>(stream);
  if (p.generic) {
    if (!any_plan_ok(p, false) || (p.nh > 0) != (qh != nullptr) || p.stride != 1 || p.ks != 3 ||
        (p.packed && (p.nh == 0 || p.Ho % 2 != 0 || p.Wo % 2 != 0)))
      return cudaErrorInvalidValue;
    return p.acc_wide ? launch_any<1, true, false>(x, q, ws, b, s_out, qh, wsh, bh, out, nullptr,
                                                   p, s)
                      : launch_any<1, false, false>(x, q, ws, b, s_out, qh, wsh, bh, out,
                                                    nullptr, p, s);
  }
  const int nt = (p.cout + 7) / 8;
  if (p.n_tiles <= 0 || p.cin % 4 != 0 || p.cin <= 0 || p.cin > 32 || p.cout % 4 != 0 ||
      p.cout <= 0 || p.cout > 32 || p.nh < 0 || p.nh > 32 || p.nw != p.cin / 4 || p.tw % 16 != 0 ||
      (p.nh > 0) != (qh != nullptr) || p.f32 != 0 || p.stride != 1 || p.ks != 3 ||
      (p.packed && (p.nh == 0 || p.Ho % 2 != 0 || p.Wo % 2 != 0)))
    return cudaErrorInvalidValue;
  switch (nt) {
    case 1: return dispatch<1>(p.nw, x, q, ws, b, s_out, qh, wsh, bh, out, p, s);
    case 2: return dispatch<2>(p.nw, x, q, ws, b, s_out, qh, wsh, bh, out, p, s);
    case 3: return dispatch<3>(p.nw, x, q, ws, b, s_out, qh, wsh, bh, out, p, s);
    default: return dispatch<4>(p.nw, x, q, ws, b, s_out, qh, wsh, bh, out, p, s);
  }
}

// One int8-input layer alone with its f32 epilogue (the bias correction):
// x int8 (B, H, W, Cin); q HWIO int8 (ks, ks, Cin, Cout): 3x3 at stride 1
// with the plan's dilation or at stride 2, or 1x1; ws, b f32 (Cout).  y:
// f32 (B, Ho, Wo, Cout) = fmaf((float)acc, ws, b); acc: the exact
// (float)acc, or null.  plan: the ints of tile_plan("layer", ...).
extern "C" int qconv_tc_f32(const void* x, const void* q, const void* ws, const void* b, void* y,
                            void* acc, const int* plan, int plan_ints, void* stream) {
  if (plan_ints != qconv_plan_ints()) return cudaErrorInvalidValue;
  Plan p;
  memcpy(&p, plan, sizeof(Plan));
  if (p.generic) {
    if (!any_plan_ok(p, true) || p.nh != 0 || (p.ks != 3 && p.ks != 1) ||
        (p.stride != 1 && (p.stride != 2 || p.d != 1 || p.ks != 3)))
      return cudaErrorInvalidValue;
    auto s = static_cast<cudaStream_t>(stream);
    const void* z = nullptr;
    if (p.stride == 1)
      return p.acc_wide ? launch_any<1, true, true>(x, q, ws, b, z, z, z, z, y, acc, p, s)
                        : launch_any<1, false, true>(x, q, ws, b, z, z, z, z, y, acc, p, s);
    return p.acc_wide ? launch_any<2, true, true>(x, q, ws, b, z, z, z, z, y, acc, p, s)
                      : launch_any<2, false, true>(x, q, ws, b, z, z, z, z, y, acc, p, s);
  }
  if (p.n_tiles <= 0 || p.cin % 4 != 0 || p.cin <= 0 || p.cin > 32 || p.cout <= 0 ||
      p.cout > 32 || p.nh != 0 || p.nw != p.cin / 4 || p.tw % 16 != 0 || p.f32 != 1 ||
      (p.ks != 3 && p.ks != 1) || (p.stride != 1 && (p.stride != 2 || p.d != 1 || p.ks != 3)))
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return p.stride == 1 ? dispatch_f32<1>(p.nw, x, q, ws, b, y, acc, p, s)
                       : dispatch_f32<2>(p.nw, x, q, ws, b, y, acc, p, s);
}

// acc: f32 (n_pix, C) accumulators, any C; ws, b, s_out: f32 (C).  out:
// int8 (n_pix, C) = clamp(rint(max(fmaf(acc, ws, b), 0) * s_out), -127,
// 127): four channels a thread where C is a multiple of 4 up to 32, else
// one (qrequant_any_kernel).
extern "C" int qrequant(const void* acc, const void* ws, const void* b, const void* s_out,
                        void* out, long long n_pix, int C, void* stream) {
  if (n_pix <= 0 || C <= 0) return cudaErrorInvalidValue;
  if (C > 32 || C % 4 != 0) {
    const long long n = n_pix * C;
    const long long blocks = (n + kThreads - 1) / kThreads;
    qrequant_any_kernel<<<static_cast<unsigned>(blocks < 8 * 132 ? blocks : 8 * 132), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(acc), static_cast<const float*>(ws),
        static_cast<const float*>(b), static_cast<const float*>(s_out),
        static_cast<int8_t*>(out), n, C);
    return launch_status();
  }
  const long long n_words = n_pix * (C / 4);
  const long long blocks = (n_words + kThreads - 1) / kThreads;
  qrequant_kernel<<<static_cast<unsigned>(blocks < 8 * 132 ? blocks : 8 * 132), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(acc), static_cast<const float*>(ws), static_cast<const float*>(b),
      static_cast<const float*>(s_out), static_cast<uint32_t*>(out), n_words, C / 4);
  return launch_status();
}
