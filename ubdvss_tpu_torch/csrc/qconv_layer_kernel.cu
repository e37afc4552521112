// One layer of the int8 trunk alone, any of its kinds, with f32 or int8
// output: what the PTQ bias correction (ops/quant.py bias_correct_qparams)
// walks layer by layer, reading each layer's f32 pre-activation acc * ws + b
// before it requantizes with the corrected bias.  Serving runs the trunk's
// own kernels (qstem_kernel.cu, qconv_kernel.cu), which write no f32
// pre-activation and no single stem layer.
//
// Replaces no Pallas kernel: in the JAX package this layer is XLA's int8
// conv, _qconv (ubdvss_tpu/ops/quant.py:276-292: lax.conv_general_dilated
// with preferred_element_type=int32, then acc * ws + b, ReLU, round(y * s),
// clip, int8), and for layer 0 also the input quantization of a normalized
// image, _quantize_input (:315-329).  PyTorch has no int8 convolution on
// CUDA.
//
// What it computes, per output pixel (one thread each), NHWC throughout:
//   * acc[co] = sum over the 3x3 (or 1x1) taps and the input channels of
//     x[int8] * q[int8], exact in int32; SAME padding as XLA computes it
//     (the wrapper passes pad_top / pad_left), out-of-bounds taps skipped;
//   * y = fmaf((float)acc, ws[co], b[co]) — ONE rounding, which is what
//     XLA's CPU compiler makes of acc * ws + b under jit (a fused
//     multiply-add); written out here, not left to nvcc's contraction;
//     __int2float_rn is exact for any |acc| < 2^24;
//   * f32 output (s_out null): y; else
//     int8(clamp(rintf(__fmul_rn(fmaxf(y, 0), s_out[co])), -127, 127)),
//     rintf rounding half to even as jnp.round does.
// Layer 0 (one input channel) reads the normalized f32 image itself and
// quantizes each tap in registers as rintf(x * 127).
//
// Design (simple and exact): the layer's weights go to shared memory at
// block start, packed there from the HWIO int8 kernel as 32-bit words of
// four input channels ([tap][word][co], zeros past C_out), so a warp reads
// each word as a broadcast and four output channels with one 16-byte load;
// each input word meets them through __dp4a.  All C_out accumulators live
// in registers (MAXC of 8, 16, 24 or 32).  Input channels must be a
// multiple of 4 and at most 32; int8 outputs a multiple of 4.  It is bound
// by dp4a issue (1,296 a pixel of a 24-channel 3x3 layer), which a
// calibration pays once.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxWords = 8;  // input channels <= 32

// what the layer reads: int8 NHWC activations, or the normalized image of layer 0
enum InKind { kInt8 = 0, kF32Norm = 1 };

struct Geometry {
  int B, H, W, Cin, Ho, Wo, Cout, stride, dil, pad_t, pad_l;
};

__device__ __forceinline__ int pack4(const int8_t* p, int step) {
  return static_cast<int>(static_cast<uint32_t>(static_cast<uint8_t>(p[0])) |
                          static_cast<uint32_t>(static_cast<uint8_t>(p[step])) << 8 |
                          static_cast<uint32_t>(static_cast<uint8_t>(p[2 * step])) << 16 |
                          static_cast<uint32_t>(static_cast<uint8_t>(p[3 * step])) << 24);
}

__device__ __forceinline__ int quantize_pixel(const float* x, long long i) {
  return static_cast<int>(fminf(fmaxf(rintf(__fmul_rn(x[i], 127.f)), -127.f), 127.f));
}

template <int MAXC, int KS, int IN>
__global__ void __launch_bounds__(kThreads)
qconv_kernel(const void* __restrict__ x, const int8_t* __restrict__ q,
             const float* __restrict__ ws, const float* __restrict__ bias,
             const float* __restrict__ s_out, void* __restrict__ out, Geometry g) {
  constexpr int T = KS * KS;
  __shared__ int4 s_w4[T * kMaxWords * MAXC / 4];
  __shared__ float s_ws[MAXC], s_b[MAXC], s_so[MAXC];
  int* s_w = reinterpret_cast<int*>(s_w4);
  const int nw = IN == kInt8 ? g.Cin / 4 : 1;
  // weights, HWIO int8 -> [tap][word][co] words (layer 0: [tap][co] ints)
  for (int i = threadIdx.x; i < T * nw * MAXC; i += blockDim.x) {
    const int o = i % MAXC;
    const int tw = i / MAXC;
    int v = 0;
    if (o < g.Cout) {
      if constexpr (IN == kInt8) {
        const int t = tw / nw, w = tw % nw;
        v = pack4(q + (t * g.Cin + 4 * w) * g.Cout + o, g.Cout);
      } else {
        v = q[tw * g.Cout + o];
      }
    }
    s_w[i] = v;
  }
  for (int o = threadIdx.x; o < MAXC; o += blockDim.x) {
    const bool in = o < g.Cout;
    s_ws[o] = in ? ws[o] : 0.f;
    s_b[o] = in ? bias[o] : 0.f;
    s_so[o] = in && s_out != nullptr ? s_out[o] : 0.f;
  }
  __syncthreads();

  const long long n = static_cast<long long>(g.B) * g.Ho * g.Wo;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int ox = static_cast<int>(idx % g.Wo);
  const long long r = idx / g.Wo;
  const int oy = static_cast<int>(r % g.Ho);
  const int b = static_cast<int>(r / g.Ho);

  int acc[MAXC];
#pragma unroll
  for (int c = 0; c < MAXC; ++c) acc[c] = 0;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int iy = oy * g.stride - g.pad_t + (t / KS) * g.dil;
    const int ix = ox * g.stride - g.pad_l + (t % KS) * g.dil;
    if (iy < 0 || iy >= g.H || ix < 0 || ix >= g.W) continue;
    const long long pix = (static_cast<long long>(b) * g.H + iy) * g.W + ix;
    if constexpr (IN == kInt8) {
      const int* src = reinterpret_cast<const int*>(static_cast<const int8_t*>(x) + pix * g.Cin);
      for (int w = 0; w < nw; ++w) {
        const int xv = __ldg(src + w);
        const int4* wp = s_w4 + (t * nw + w) * (MAXC / 4);
#pragma unroll
        for (int c4 = 0; c4 < MAXC / 4; ++c4) {
          const int4 wv = wp[c4];
          acc[4 * c4 + 0] = __dp4a(xv, wv.x, acc[4 * c4 + 0]);
          acc[4 * c4 + 1] = __dp4a(xv, wv.y, acc[4 * c4 + 1]);
          acc[4 * c4 + 2] = __dp4a(xv, wv.z, acc[4 * c4 + 2]);
          acc[4 * c4 + 3] = __dp4a(xv, wv.w, acc[4 * c4 + 3]);
        }
      }
    } else {
      const int xq = quantize_pixel(static_cast<const float*>(x), pix);
      const int4* wp = s_w4 + t * (MAXC / 4);
#pragma unroll
      for (int c4 = 0; c4 < MAXC / 4; ++c4) {
        const int4 wv = wp[c4];
        acc[4 * c4 + 0] += xq * wv.x;
        acc[4 * c4 + 1] += xq * wv.y;
        acc[4 * c4 + 2] += xq * wv.z;
        acc[4 * c4 + 3] += xq * wv.w;
      }
    }
  }

  if (s_out == nullptr) {  // f32 NHWC: the pre-activation, or the head's logits
    float* o = static_cast<float*>(out) + idx * g.Cout;
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      if (c < g.Cout) o[c] = fmaf(__int2float_rn(acc[c]), s_ws[c], s_b[c]);
    }
    return;
  }
  int* o = reinterpret_cast<int*>(static_cast<int8_t*>(out) + idx * g.Cout);
#pragma unroll
  for (int c4 = 0; c4 < MAXC / 4; ++c4) {
    if (4 * c4 >= g.Cout) break;
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 4 * c4 + j;
      const float y = fmaf(__int2float_rn(acc[c]), s_ws[c], s_b[c]);
      const float v = fminf(fmaxf(rintf(__fmul_rn(fmaxf(y, 0.f), s_so[c])), -127.f), 127.f);
      word |= static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(v))) << (8 * j);
    }
    o[c4] = static_cast<int>(word);
  }
}

template <int MAXC, int KS, int IN>
void launch(const void* x, const int8_t* q, const float* ws, const float* b,
            const float* s_out, void* out, const Geometry& g, cudaStream_t stream) {
  const long long n = static_cast<long long>(g.B) * g.Ho * g.Wo;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  qconv_kernel<MAXC, KS, IN><<<blocks, kThreads, 0, stream>>>(x, q, ws, b, s_out, out, g);
}

template <int MAXC>
int dispatch(int in_kind, int ks, const void* x, const int8_t* q, const float* ws,
             const float* b, const float* s_out, void* out, const Geometry& g,
             cudaStream_t s) {
  if (in_kind == kInt8 && ks == 3) launch<MAXC, 3, kInt8>(x, q, ws, b, s_out, out, g, s);
  else if (in_kind == kInt8 && ks == 1) launch<MAXC, 1, kInt8>(x, q, ws, b, s_out, out, g, s);
  else if (in_kind == kF32Norm && ks == 3) launch<MAXC, 3, kF32Norm>(x, q, ws, b, s_out, out, g, s);
  else return cudaErrorInvalidValue;
  return launch_status();
}

}  // namespace

// x: int8 (B, H, W, Cin) for in_kind 0; the normalized f32 (B, H, W) image
// of layer 0 (Cin = 1) for in_kind 1.
// q: HWIO int8 (ks, ks, Cin, Cout); ws, b: f32 (Cout); s_out: f32 (Cout),
// or null for f32 logits.  out: int8 or f32 (B, Ho, Wo, Cout).
extern "C" int qconv_layer(const void* x, const void* q, const void* ws, const void* b,
                           const void* s_out, void* out, int in_kind, int B, int H, int W,
                           int Cin, int Ho, int Wo, int Cout, int ks, int stride, int dil,
                           int pad_t, int pad_l, void* stream) {
  const bool int8_in = in_kind == kInt8;
  if (B <= 0 || H <= 0 || W <= 0 || Ho <= 0 || Wo <= 0 || Cout <= 0 || Cout > 32 ||
      (int8_in ? (Cin % 4 != 0 || Cin <= 0 || Cin > 4 * kMaxWords) : Cin != 1) ||
      (s_out != nullptr && Cout % 4 != 0))
    return cudaErrorInvalidValue;
  const Geometry g{B, H, W, Cin, Ho, Wo, Cout, stride, dil, pad_t, pad_l};
  auto s = static_cast<cudaStream_t>(stream);
  auto qq = static_cast<const int8_t*>(q);
  auto fws = static_cast<const float*>(ws);
  auto fb = static_cast<const float*>(b);
  auto fso = static_cast<const float*>(s_out);
  if (Cout <= 8) return dispatch<8>(in_kind, ks, x, qq, fws, fb, fso, out, g, s);
  if (Cout <= 16) return dispatch<16>(in_kind, ks, x, qq, fws, fb, fso, out, g, s);
  if (Cout <= 24) return dispatch<24>(in_kind, ks, x, qq, fws, fb, fso, out, g, s);
  return dispatch<32>(in_kind, ks, x, qq, fws, fb, fso, out, g, s);
}
