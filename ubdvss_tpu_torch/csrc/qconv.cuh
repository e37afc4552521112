// Shared by the int8 kernels (qconv_kernel.cu, qstem_kernel.cu): the
// launch plan, the s8 tensor-core MMAs of a 3x3 layer, the requantization
// epilogue and the staged warp store.
//
// The plan comes from ops/cuda/qconv_kernel.py (tile_plan), which lays out
// every index the kernels use: tiles, halos, row phases, the (tap, channel
// word) order of the MMA's K dimension and the shared-memory regions.
// The wrapper passes it as ints; struct Plan reads them in that order.
//
// Epilogue arithmetic, exact, and below 32 input channels without a
// conversion instruction (the H100 converts at 16 results a clock an SM,
// an eighth of its f32 rate):
//   * the accumulators start at the bits of 1.5 * 2^23, so the s32 MMA
//     leaves acc + 0x4B400000; while -2^22 <= acc < 2^22 those are the bits
//     of the float 12582912 + acc (the binade [2^23, 2^24), spacing 1), and
//     subtracting 12582912 gives (float)acc exactly.  A K of at most 252
//     int8 products keeps |acc| <= 252 * 128^2 = 4,128,768 inside that
//     window: every layer of up to 28 input channels, layer 0, the head.
//     A 3x3 layer of 32 input channels reaches 9 * 32 * 127^2 = 4,645,152,
//     past it, so its accumulators (WIDE, the plan's acc_wide) go through
//     the conversion instruction, exact below 2^24: (float)(biased -
//     0x4B400000);
//     past 2^24 (a 3x3 layer of 116 input channels and more: the plan's
//     acc_wide 2) the same instruction rounds to nearest even, as XLA's
//     s32 -> f32 convert does, and the value is what the JAX package
//     computes, not (float)acc exactly;
//   * y = fmaf((float)acc, ws, b) — ONE rounding, which is what XLA's CPU
//     compiler makes of acc * ws + b under jit (a fused multiply-add);
//   * v = clamp(__fmul_rn(fmaxf(y, 0), s), -127, 127); clamping before the
//     rounding equals clamping after it, the bounds being integers;
//   * round(v) half to even, as rintf and jnp.round: v + 12582912 in
//     round-to-nearest-even leaves round(v) in the low bits, whose low byte
//     is the int8.
// nvcc's flags keep --use_fast_math off, so none of this is reassociated.
#pragma once

#include <cstdint>
#include <cstring>

#include "common.cuh"

namespace qk {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxKWords = 72;  // the K table of the compiled widths: 9 taps x 8 channel words
constexpr int kMagicBits = 0x4B400000;
constexpr float kMagic = 12582912.f;  // 1.5 * 2^23
constexpr float kRawScale = static_cast<float>(127.0 / 127.5);

// what the stem reads (ops/cuda/qconv_kernel.py IN_*)
enum InKind { kU8Raw = 1, kF32Raw = 2, kF32Norm = 3 };

// ops/cuda/qconv_kernel.py PLAN_FIELDS, then the K order
struct Plan {
  int B, H, W, Ho, Wo, cin, cout, nh;
  int d, phases, th, tw, n_rt, n_ct, halo_h, halo_w;
  int nw, nsteps, row_step, n_tiles;
  int smem, off_w, off_w0, off_vec, off_stage, stage_bytes, off_tile, tile_bytes;
  int off_l0, off_raw, raw_bytes, raw_row, row_words, align16;
  int H0, W0, pt0, pl0, pt1, pl1, l0h, l0w, inh, inw, c0, in_kind, in_row, l0w_magic;
  int acc_wide;  // the 3x3 int8-input layer's Conv3x3::WIDE
  int stride, ks, pad_t, pad_l, f32;  // a layer alone (the calibration's kinds)
  int packed;  // qconv_head: the logits phase-major (B, Ho/2, Wo/2, 4 nh)
  int generic, off_koff;  // the any-width kernels (ConvAny) and their K offsets' region
  int a_off[kMaxKWords];  // shared-memory word offset of each K word's A from a pixel's first tap
  int b_src[kMaxKWords];  // HWIO byte index of each K word's first channel at output 0; -1: padding
  int k0_off[16];         // layer 0: input-window byte offset of each K byte (tap)
  int k0_src[16];         // layer 0: HWIO index of each K byte's tap at output 0; -1: padding
};

__device__ __forceinline__ int pack4(const int8_t* p, int step) {
  return static_cast<int>(static_cast<uint32_t>(static_cast<uint8_t>(p[0])) |
                          static_cast<uint32_t>(static_cast<uint8_t>(p[step])) << 8 |
                          static_cast<uint32_t>(static_cast<uint8_t>(p[2 * step])) << 16 |
                          static_cast<uint32_t>(static_cast<uint8_t>(p[3 * step])) << 24);
}

// D += A (16x32 s8, row) * B (32x8 s8, col).  A: rows g, g+8 x words t, 4+t;
// B: words t, 4+t of column g; D: rows g, g+8 x columns 2t, 2t+1.
__device__ __forceinline__ void mma_k32(int (&d)[4], const int (&a)[4], int b0, int b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D += A (16x16 s8) * B (16x8 s8).  A: rows g, g+8 x word t; B: word t of column g.
__device__ __forceinline__ void mma_k16(int (&d)[4], int a0, int a1, int b) {
  asm("mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(b));
}

template <int N>
__device__ __forceinline__ void init_acc(int (&acc)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = kMagicBits;
}

// (float)acc of an accumulator started at kMagicBits; WIDE: |acc| may leave
// the magic's window (a 3x3 layer of 32 input channels)
template <bool WIDE>
__device__ __forceinline__ float acc_float(int biased) {
  if constexpr (WIDE) return __int2float_rn(biased - kMagicBits);
  return __fsub_rn(__int_as_float(biased), kMagic);
}

// the int8 of the exact (float)acc requantized, in the low byte
__device__ __forceinline__ uint32_t requant_float(float acc, float ws, float b, float s) {
  const float y = fmaf(acc, ws, b);
  const float v = fminf(fmaxf(__fmul_rn(fmaxf(y, 0.f), s), -127.f), 127.f);
  return static_cast<uint32_t>(__float_as_int(__fadd_rn(v, kMagic)));
}

// the requantized int8 of a biased accumulator in the low byte
template <bool WIDE>
__device__ __forceinline__ uint32_t requant(int biased, float ws, float b, float s) {
  return requant_float(acc_float<WIDE>(biased), ws, b, s);
}

// two requantized channels as 16 bits
__device__ __forceinline__ uint16_t pack2(uint32_t lo, uint32_t hi) {
  return static_cast<uint16_t>(__byte_perm(lo, hi, 0x0040));
}

// The 3x3 int8-input layer of a kernel, NW = Cin / 4 channel words a pixel
// and STRIDE 1 or 2, as its MMAs see it.  The B fragments stay in shared
// memory (read once a step for two runs), which keeps the registers a thread
// holds low enough for three blocks an SM.
//   * K steps: (9 NW + 7) / 8 k32 steps of (tap, channel word).  With NW
//     even the plan pairs the words: lane t's K words t and 4+t of a step
//     are channel words 2c, 2c+1 of one tap, so one 8-byte load fetches
//     both; with NW odd they are two 4-byte loads.
//   * Rows: the 16 MMA rows are a run of 16 pixels of a tile row; rows g
//     and g+8 take pixels g and g+8, or 2g and 2g+1 (RS = 2, where that
//     spreads the loads over the shared-memory banks better); the plan's
//     row_step must equal RS.
template <int NT, int NW, int STRIDE>
struct Conv3x3 {
  static constexpr int KS = (9 * NW + 7) / 8;
  static constexpr bool PAIRED = NW % 2 == 0;
  static constexpr int RS = PAIRED ? (STRIDE == 2 && (2 * NW) % 8 == 4 ? 2 : 1)
                                   : ((NW * STRIDE) % 8 != 4 && (2 * NW * STRIDE) % 8 == 4 ? 2 : 1);
  // K = 36 NW int8 products: past 252 (NW = 8) |acc| may leave the magic's window
  static constexpr bool WIDE = 9 * NW > 63;
  static constexpr int PIXW = STRIDE * NW;              // words between a row's input pixels
  static constexpr int DROW = (RS == 2 ? 1 : 8) * PIXW;  // words from row g's pixel to row g+8's

  int off[KS][PAIRED ? 1 : 2];  // the lane's A word offsets a step
  int p0, p1;                   // the pixels of rows g and g+8 in a run
  const int2* bfrag;            // the lane's B fragments: [k step][n tile] int2 (shared)

  __device__ __forceinline__ void load(const int* s_w, const Plan& p, int lane) {
    const int t = lane & 3, g = lane >> 2;
    p0 = RS == 2 ? 2 * g : g;
    p1 = RS == 2 ? 2 * g + 1 : g + 8;
    bfrag = reinterpret_cast<const int2*>(s_w) + lane;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      off[s][0] = p.a_off[8 * s + t];
      if constexpr (!PAIRED) off[s][1] = p.a_off[8 * s + 4 + t];
    }
  }

  // the A fragment of step s for the run whose row g pixel's first tap is at a
  __device__ __forceinline__ void fragment(int (&f)[4], const uint32_t* a, int s) const {
    if constexpr (PAIRED) {
      const uint2 x0 = *reinterpret_cast<const uint2*>(a + off[s][0]);
      const uint2 x1 = *reinterpret_cast<const uint2*>(a + DROW + off[s][0]);
      f[0] = static_cast<int>(x0.x);
      f[1] = static_cast<int>(x1.x);
      f[2] = static_cast<int>(x0.y);
      f[3] = static_cast<int>(x1.y);
    } else {
      f[0] = static_cast<int>(a[off[s][0]]);
      f[1] = static_cast<int>(a[DROW + off[s][0]]);
      f[2] = static_cast<int>(a[off[s][1]]);
      f[3] = static_cast<int>(a[DROW + off[s][1]]);
    }
  }

  // two runs' MMAs, interleaved, each B fragment read once for both: a0, a1
  // point at the first tap of run 0's and run 1's first pixel (words); the
  // first ns of the KS steps (a 1x1 layer's K is one tap's words)
  __device__ __forceinline__ void mma2(int (&acc0)[NT][4], int (&acc1)[NT][4],
                                       const uint32_t* a0, const uint32_t* a1,
                                       int ns = KS) const {
    a0 += p0 * PIXW;
    a1 += p0 * PIXW;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      if (s >= ns) break;
      int f0[4], f1[4];
      fragment(f0, a0, s);
      fragment(f1, a1, s);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int2 b = bfrag[(s * NT + n) * 32];
        mma_k32(acc0[n], f0, b.x, b.y);
        mma_k32(acc1[n], f1, b.x, b.y);
      }
    }
  }
};

// The 16 pixels' int8 outputs of an MMA tile (channels 8n + 2t, +1 of rows
// g, g+8 = pixels p0, p1) into a pixel-major staging buffer of `cout` bytes
// a pixel.  vec: ws, b, s_out, 32 floats each.
template <int NT, bool WIDE>
__device__ __forceinline__ void stage_int8(uint8_t* st, const int (&acc)[NT][4], int cout,
                                           const float* vec, int p0, int p1, int t) {
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = 8 * n + 2 * t;
    if (c < cout) {
      const float2 w = *reinterpret_cast<const float2*>(vec + c);
      const float2 b = *reinterpret_cast<const float2*>(vec + 32 + c);
      const float2 s = *reinterpret_cast<const float2*>(vec + 64 + c);
      *reinterpret_cast<uint16_t*>(st + p0 * cout + c) =
          pack2(requant<WIDE>(acc[n][0], w.x, b.x, s.x), requant<WIDE>(acc[n][1], w.y, b.y, s.y));
      *reinterpret_cast<uint16_t*>(st + p1 * cout + c) =
          pack2(requant<WIDE>(acc[n][2], w.x, b.x, s.x), requant<WIDE>(acc[n][3], w.y, b.y, s.y));
    }
  }
}

// One warp copies n bytes (a multiple of 4) from shared memory to device
// memory: 4-byte words up to dst's first 16-byte boundary, then 16-byte
// stores, then the 4-byte tail.  src holds the bytes at the same address
// mod 16 as dst.
__device__ __forceinline__ void warp_store(const uint8_t* src, uint8_t* dst, int n, int lane) {
  const int head = min(n, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15));
  if (4 * lane < head)
    *reinterpret_cast<uint32_t*>(dst + 4 * lane) = *reinterpret_cast<const uint32_t*>(src + 4 * lane);
  const int body_end = head + ((n - head) & ~15);
#pragma unroll 1
  for (int o = head + 16 * lane; o < body_end; o += 512)
    *reinterpret_cast<int4*>(dst + o) = *reinterpret_cast<const int4*>(src + o);
  const int o = body_end + 4 * lane;
  if (o < n) *reinterpret_cast<uint32_t*>(dst + o) = *reinterpret_cast<const uint32_t*>(src + o);
}

// n bytes from device to shared memory by the whole block, 16 bytes a
// thread where both are 16-byte aligned: a layer's weights, which every
// block reads at once, go through few, wide requests.
__device__ __forceinline__ void copy_to_shared(int8_t* dst, const int8_t* src, int n) {
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
    for (int i = threadIdx.x; i < n / 16; i += kThreads)
      reinterpret_cast<int4*>(dst)[i] = reinterpret_cast<const int4*>(src)[i];
    for (int i = n / 16 * 16 + threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
  }
}

// The B fragments of a 3x3 int8-input layer, packed from its HWIO kernel
// (q, staged in shared memory) into shared memory as [k step][n tile]
// [lane][register] words, so a lane reads its two registers of an n tile
// as one 8-byte load.
__device__ __forceinline__ void pack_fragments(int* s_w, const int8_t* q, const Plan& p, int nt,
                                               int cout) {
  const int n = p.nsteps * nt * 64;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = i & 1, lane = (i >> 1) & 31, tile = (i >> 6) % nt, s = (i >> 6) / nt;
    const int j = 8 * s + 4 * r + (lane & 3), co = 8 * tile + (lane >> 2);
    const int src = p.b_src[j];
    s_w[i] = src >= 0 && co < cout ? pack4(q + src + co, cout) : 0;
  }
}

__device__ __forceinline__ void cp_async4(void* smem_dst, const void* src) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(sa), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async8(void* smem_dst, const void* src) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(sa), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every group but the newest complete
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// ---- any width (the plan's ``generic``): Cin or Cout past 32, a head of
// more than 32 logits.  The compiled instances above fix the channel words
// and n8 tiles at compile time; these take them from the plan and run the
// output channels in passes of n8 tiles (kPassTiles in the 3x3 layers of
// the conv kernel and the stem: 64 channels in one pass; kGroupTiles in
// the fused head), each pass's K loop over every step.  The K order
// is the plain one (K word j = 8 s + 4 r + t is tap j / nw, channel word
// j % nw; zero weights past 9 nw), each K
// word's A offset in a table in shared memory (k_offsets_any), the B
// fragments packed straight from the HWIO weights in device memory.
constexpr int kPassTiles = 8;
constexpr int kGroupTiles = 4;

__host__ __device__ constexpr int round32(int n) { return (n + 31) / 32 * 32; }

// The A word offset of every K word of a plan's int8-input layer: a 3x3
// kernel's taps row-major or a 1x1 kernel's window centre, at the conv's
// halo rows (row_words, dilation d) or the stem's layer-0 tile (l0w).
__device__ __forceinline__ void k_offsets_any(int* s_koff, const Plan& p, bool stem) {
  const int nw = p.nw, ntaps = p.ks == 1 ? 1 : 9;
  for (int j = threadIdx.x; j < 8 * p.nsteps; j += kThreads) {
    int off = 0;
    if (j < ntaps * nw) {
      const int tap = j / nw, cw = j - tap * nw;
      const int ty = p.ks == 1 ? 1 : tap / 3, tx = p.ks == 1 ? 1 : tap - 3 * (tap / 3);
      off = stem ? (ty * p.l0w + tx) * nw + cw : ty * p.row_words + tx * p.d * nw + cw;
    }
    s_koff[j] = off;
  }
}

// The B fragments of such a layer from its HWIO kernel q (ks, ks, cin,
// cout) in device memory, as pack_fragments lays them out: [k step][n
// tile][lane][register] words.
__device__ __forceinline__ void pack_fragments_any(int* s_w, const int8_t* q, const Plan& p,
                                                   int cin, int cout) {
  const int nw = p.nw, ntaps = p.ks == 1 ? 1 : 9, nt = (cout + 7) / 8;
  const int n = p.nsteps * nt * 64;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = i & 1, lane = (i >> 1) & 31, tile = (i >> 6) % nt, s = (i >> 6) / nt;
    const int j = 8 * s + 4 * r + (lane & 3), co = 8 * tile + (lane >> 2);
    int w = 0;
    if (j < ntaps * nw && co < cout) {
      const int tap = j / nw, cw = j - tap * nw;
      w = pack4(q + (static_cast<long long>(tap) * cin + 4 * cw) * cout + co, cout);
    }
    s_w[i] = w;
  }
}

// A 3x3 (or 1x1) int8-input layer at any width, as its MMAs see it:
// Conv3x3's scheme with the step count, the pixel stride and the row map
// from the plan, the A offsets from the shared table and each output
// group's n8 tiles taken from the packed B fragments.
struct ConvAny {
  int nsteps, nt, pixw, drow, p0, p1, t;
  const int* koff;
  const int2* bfrag;

  __device__ __forceinline__ void load(const int* s_w, const int* s_koff, const Plan& p,
                                       int cout, int stride, int lane) {
    t = lane & 3;
    const int g = lane >> 2;
    p0 = p.row_step == 2 ? 2 * g : g;
    p1 = p.row_step == 2 ? 2 * g + 1 : g + 8;
    nsteps = p.nsteps;
    nt = (cout + 7) / 8;
    pixw = stride * p.nw;
    drow = (p.row_step == 2 ? 1 : 8) * pixw;
    koff = s_koff;
    bfrag = reinterpret_cast<const int2*>(s_w) + lane;
  }

  // two runs' MMAs for the n8 tiles [g0, g0 + ng) (ng <= NG): a0, a1
  // point at the first tap of each run's first pixel (words); without
  // ``two`` (the warp's second run lies past its tile) run 0's alone
  template <int NG>
  __device__ __forceinline__ void mma2(int (&acc0)[NG][4], int (&acc1)[NG][4],
                                       const uint32_t* a0, const uint32_t* a1, int g0, int ng,
                                       bool two = true) const {
    a0 += p0 * pixw;
    a1 += p0 * pixw;
    for (int s = 0; s < nsteps; ++s) {
      const int o0 = koff[8 * s + t], o1 = koff[8 * s + 4 + t];
      const int f0[4] = {static_cast<int>(a0[o0]), static_cast<int>(a0[drow + o0]),
                         static_cast<int>(a0[o1]), static_cast<int>(a0[drow + o1])};
      if (two) {
        const int f1[4] = {static_cast<int>(a1[o0]), static_cast<int>(a1[drow + o0]),
                           static_cast<int>(a1[o1]), static_cast<int>(a1[drow + o1])};
#pragma unroll
        for (int n = 0; n < NG; ++n) {
          if (n < ng) {
            const int2 b = bfrag[(s * nt + g0 + n) * 32];
            mma_k32(acc0[n], f0, b.x, b.y);
            mma_k32(acc1[n], f1, b.x, b.y);
          }
        }
      } else {  // two loops: one with a predicated second MMA ran 14-23% slower
#pragma unroll
        for (int n = 0; n < NG; ++n) {
          if (n < ng) {
            const int2 b = bfrag[(s * nt + g0 + n) * 32];
            mma_k32(acc0[n], f0, b.x, b.y);
          }
        }
      }
    }
  }
};

}  // namespace qk

extern "C" int qconv_plan_ints() { return static_cast<int>(sizeof(qk::Plan) / sizeof(int)); }
