// The two phases of the component geometry, as block-wide device functions
// shared by ccl_kernel.cu (K1), postproc_kernel.cu (K2) and
// geometry_kernel.cu (K12c, both phases in one cluster of blocks), so
// that each algorithm has one copy; phase 2 also sums the per-component
// stats.  Every thread of the block calls them.
//
// The logits are f32 or bf16 (T = float or __nv_bfloat16; the bf16 route's
// trunk hands bf16 logits to postprocessing, as the JAX package does).
// Every load widens a logit to f32 exactly, so the threshold compares, the
// sigmoid and the softmax run in f32 on either type.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>
#include <utility>

namespace geometry {

constexpr int kBig = 1 << 30;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// A class probability as the stats add it: on bf16 logits it is rounded to
// bf16 (round to nearest even) and widened back, as the JAX package stores
// the softmax at the logits' dtype before its f32 sums
// (ubdvss_tpu/ops/pallas/postproc_kernel.py:461-466); on f32 logits as is.
template <class T>
__device__ __forceinline__ float at_logit_precision(float v) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

// The stats keep a pixel's class logits and its class sums in registers,
// each logit loaded once, in one pixel pass: CM is the logit channel count
// C as a compile-time constant, exact for 1 (detection only) and 17 (the
// main path's), else the least guarded bound that holds C (kStatsBounds),
// whose class loops run every class slot of the bound with no branch on C.
// A bound's class logits and sums fit the registers its block leaves a
// thread with no spill (stats_block: 8 classes at 1024 threads, 40 at 512,
// 64 at 256; the exact 16 classes at 1024 spill 4-28 B).  Past them
// kWideChannels, a marker for any C: the class logits in chunks of
// kChunkClasses on 512 threads, one pixel pass a chunk (slot_pass, tiled.cuh
// slots_pass), the first finding each pixel's slot and the others reading
// it back, each pixel's softmax max and denominator taken over all C - 1
// class logits in every pass.
constexpr int kMainChannels = 17;
constexpr int kStatsBounds[] = {5, 9, 16, 25, 33, 41, 65};
constexpr int kFullBlockChannels = 9;  // the largest bound on 1024 threads
constexpr int kOnePassChannels = 65;
constexpr int kWideChannels = kOnePassChannels + 1;
constexpr int kChunkClasses = 40;

// Calls f(std::integral_constant<int, CM>()) for C channels: C itself at 1
// and kMainChannels, else the first of kStatsBounds from I on that holds
// C, else kWideChannels.
template <int I = 0, class F>
inline int with_channel_bound(int C, F&& f) {
  if constexpr (I == 0) {
    if (C == 1) return f(std::integral_constant<int, 1>());
    if (C == kMainChannels) return f(std::integral_constant<int, kMainChannels>());
  }
  if constexpr (I == sizeof(kStatsBounds) / sizeof(int)) {
    return f(std::integral_constant<int, kWideChannels>());
  } else {
    if (C <= kStatsBounds[I]) return f(std::integral_constant<int, kStatsBounds[I]>());
    return with_channel_bound<I + 1>(C, f);
  }
}

// The class loops of CM run the bound's every class slot.
template <int CM>
__host__ __device__ constexpr bool guarded_channels() {
  return CM != 1 && CM != kMainChannels && CM != kWideChannels;
}

// Threads of a K2 or K12c block at CM, whose registers hold a thread's
// class logits and sums (64 a thread at 1024, 128 at 512, 255 at 256):
// where a block's virtual warps outnumber its warps, each warp runs
// several in turn (slot_pass).
template <int CM>
__host__ __device__ constexpr int stats_block() {
  if (CM <= kFullBlockChannels || CM == kMainChannels) return 1024;
  return CM <= kChunkClasses + 1 || CM == kWideChannels ? 512 : 256;
}

// Blocks an SM of the tiled pass and of the large K12c (256 threads) at
// CM: 64 registers a thread at the exact 1 and kMainChannels, 80 at the
// bounds of 1024-thread stats blocks (the large K12c spills at 64), 128
// or 255 past them.
template <int CM>
__host__ __device__ constexpr int tiled_blocks() {
  if (CM == 1 || CM == kMainChannels) return 4;
  if (CM <= kFullBlockChannels) return 3;
  return CM <= kChunkClasses + 1 || CM == kWideChannels ? 2 : 1;
}

// The class chunks of a pixel pass for C channels at CM: one, or for
// kWideChannels one a kChunkClasses classes.
template <int CM>
__device__ __forceinline__ int class_chunks(int C) {
  if constexpr (CM == kWideChannels) {
    return (C - 2) / kChunkClasses + 1;
  } else {
    return 1;
  }
}

// Phase 1: threshold + connected-component labelling, in shared memory.
//
// On return every foreground pixel (logit > thr) of the (H, W) map holds
// the minimum linear index of its 8-connected (or 4-connected) component
// and background holds H*W, the contract of the TPU kernel _ccl_kernel
// (ubdvss_tpu/ops/pallas/ccl_kernel.py:116).
//
// Block-wide union-find over the label map (Playne & Hawick, IEEE TPDS
// 2018; the block-based variants of Allegretti, Bolelli & Grana, IEEE TPDS
// 2019), three passes with a __syncthreads() after each, whatever the
// components' shapes:
//   1. initialise: lab[p] = p on foreground, H*W on background;
//   2. merge: every foreground pixel unions with its foreground neighbours
//      earlier in raster order, halving the paths its finds walk (a column
//      of N unions would otherwise walk the column again for every pixel);
//   3. flatten: lab[p] = find(p).
// A parent always points to a smaller index of the same component (a union
// links the larger root under the smaller with atomicMin, and retries when
// that root was linked elsewhere meanwhile), so each component's root is
// its minimum linear index and the flattened labels are exactly the TPU
// kernel's, with no round loop and no cap.
//
// The merge takes the scan mask of Wu, Otoo & Suzuki's decision tree for
// 8-connectivity: when N is foreground the pixel unions with N alone (W, NW
// and NE are neighbours of N and reach it through their own unions);
// otherwise with W (or, without W, with NW) and with NE.  4-connectivity
// unions with W and N.
//
// The label map is reached through an accessor: lab(p) is the word of
// linear index p, in one block's shared memory (FlatLabels) or split by
// rows over the blocks of a cluster (SplitLabels over two, BandLabels over
// more, K12c), where the unions reach the other blocks' words through
// distributed shared memory.
struct FlatLabels {
  volatile int* base;
  __device__ volatile int& operator()(int p) const { return base[p]; }
};

// Rows [0, split / W) in lo, the rest in hi.
struct SplitLabels {
  volatile int* lo;
  volatile int* hi;
  int split;
  __device__ volatile int& operator()(int p) const { return p < split ? lo[p] : hi[p - split]; }
};

// The band of ``span`` words that holds linear index p (p < 2^24, so the
// product is within one band of p / span and one step corrects it).
__device__ __forceinline__ int band_of(int p, int span, float inv) {
  int r = __float2int_rz(__int2float_rn(p) * inv);
  r -= r * span > p;
  r += (r + 1) * span <= p;
  return r;
}

// Rows [r S, (r + 1) S) in block r's words, ``span`` = S W words a band,
// each at the start of its block's shared memory: ``own`` is this block's,
// which start at linear index ``own0``, and the cluster maps it to block
// r's (cluster.map_shared_rank, one instruction).  The CCL passes of a
// block start at its own pixels and walk only to smaller indices (a parent
// is always smaller), so an index from own0 on is the block's own word,
// reached without a lookup.
struct BandLabels {
  int* own;
  int own0, span;
  float inv;  // 1 / span
  __device__ volatile int& operator()(int p) const {
    if (p >= own0) return const_cast<volatile int*>(own)[p - own0];
    const int r = band_of(p, span, inv);
    return const_cast<volatile int*>(
        cooperative_groups::cluster_group::map_shared_rank(own, r))[p - r * span];
  }
};

template <class Lab>
__device__ inline int find_root(const Lab& lab, int p) {
  for (int r = lab(p); r != p; r = lab(p)) p = r;
  return p;
}

// find_root that also points every other node of the path it walks at its
// grandparent (path halving), so that later walks are shorter.  Safe while
// unions run: it writes only to nodes that are not roots, each time an
// ancestor in the same component, and a link that an atomicMin in
// union_roots makes on a node that is no longer a root may be overwritten
// only because that union then retries from the node's parent.  Not for the
// flatten pass, where another thread may already have written a node's
// final label.
template <class Lab>
__device__ inline int find_root_halving(const Lab& lab, int p) {
  while (true) {
    const int r = lab(p);
    if (r == p) return p;
    const int g = lab(r);
    if (g != r) lab(p) = g;
    p = g;
  }
}

template <class Lab>
__device__ inline void union_roots(const Lab& lab, int a, int b) {
  while (true) {
    a = find_root_halving(lab, a);
    b = find_root_halving(lab, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(const_cast<int*>(&lab(b)), a);
    if (old == b) return;  // b was a root and now points to a
    b = old;  // b was linked under `old` meanwhile: join old's set and a's
  }
}

// The three passes over the pixels [p0, p1) of the block, rows y0 on (the
// merge takes no neighbour above row y0); fg(p) says whether p is
// foreground.  Each ends before its __syncthreads().
template <class Lab, class Fg>
__device__ inline void ccl_init(const Lab& lab, const Fg& fg, int p0, int p1, int N) {
  for (int p = p0 + threadIdx.x; p < p1; p += blockDim.x) lab(p) = fg(p) ? p : N;
}

template <class Lab>
__device__ inline void ccl_merge(const Lab& lab, int W, int y0, int p0, int p1, int N,
                                 bool eight) {
  for (int p = p0 + threadIdx.x; p < p1; p += blockDim.x) {
    if (lab(p) == N) continue;
    const int y = p / W;
    const int x = p - y * W;
    const bool w = x > 0 && lab(p - 1) != N;
    const bool n = y > y0 && lab(p - W) != N;
    if (!eight) {
      if (w) union_roots(lab, p, p - 1);
      if (n) union_roots(lab, p, p - W);
      continue;
    }
    if (n) {
      union_roots(lab, p, p - W);
      continue;
    }
    if (w) {
      union_roots(lab, p, p - 1);
    } else if (y > y0 && x > 0 && lab(p - W - 1) != N) {
      union_roots(lab, p, p - W - 1);
    }
    if (y > y0 && x + 1 < W && lab(p - W + 1) != N) union_roots(lab, p, p - W + 1);
  }
}

template <class Lab>
__device__ inline void ccl_flatten(const Lab& lab, int p0, int p1, int N) {
  for (int p = p0 + threadIdx.x; p < p1; p += blockDim.x) {
    if (lab(p) != N) lab(p) = find_root(lab, p);
  }
}

template <class T>
__device__ inline void ccl_labels_shared(const T* __restrict__ lg, volatile int* lab_s, int H,
                                         int W, float thr, bool eight) {
  const int N = H * W;
  const FlatLabels lab{lab_s};
  ccl_init(lab, [&](int p) { return widen(lg[p]) > thr; }, 0, N, N);
  __syncthreads();
  ccl_merge(lab, W, 0, 0, N, N, eight);
  __syncthreads();
  ccl_flatten(lab, 0, N, N);
  __syncthreads();
}

// The unions across the seam above row y0 (y0 > 0): every foreground pixel
// of row y0 with its foreground neighbours in row y0 - 1 (N; for
// 8-connectivity NW and NE when N is background, since NW and NE are N's
// own neighbours otherwise).  With ccl_merge over the rows on each side,
// this is the merge of the whole map.
template <class Lab>
__device__ inline void ccl_seam(const Lab& lab, int W, int y0, int N, bool eight) {
  for (int x = threadIdx.x; x < W; x += blockDim.x) {
    const int p = y0 * W + x;
    if (lab(p) == N) continue;
    const int q = p - W;
    if (lab(q) != N) {
      union_roots(lab, p, q);
    } else if (eight) {
      if (x > 0 && lab(q - 1) != N) union_roots(lab, p, q - 1);
      if (x + 1 < W && lab(q + 1) != N) union_roots(lab, p, q + 1);
    }
  }
}

// Read-only views of a finished label map for the slot phase: lab[p].
struct GlobalLabels {
  const int* __restrict__ p;
  __device__ int operator[](int i) const { return __ldg(p + i); }
};

struct SplitView {
  const int* lo;
  const int* hi;
  int split;
  __device__ int operator[](int p) const { return p < split ? lo[p] : hi[p - split]; }
};

// The finished bands of BandLabels, read anywhere (the pixel pass).
struct BandView {
  int* own;
  int own0, span;
  float inv;
  __device__ int operator[](int p) const {
    if (static_cast<unsigned>(p - own0) < static_cast<unsigned>(span)) return own[p - own0];
    const int r = band_of(p, span, inv);
    return cooperative_groups::cluster_group::map_shared_rank(own, r)[p - r * span];
  }
};

// Where pixel (y, x) of an image lies beside its row and column strides
// sy, sx: (y >> s) sy + (y & m) py + (x >> s) sx + (x & m) px.  An
// ordinary map (NHWC, or the (C, H, W) planes of the context kernel) has
// s = m = 0 and no phase strides: y sy + x sx.  A phase-major
// space-to-depth map (the packed route's (B, H/2, W/2, 4C) logits,
// channel (2 (y & 1) + (x & 1)) C + c) has s = m = 1: sy and sx step over
// 2x2 cells, and py = 2 C sc, px = C sc pick the pixel within its cell.
struct Phase {
  long long py = 0, px = 0;
  int s = 0, m = 0;
};

// The phase of a packed map's strides (both 0: an ordinary map).
inline Phase phase_of(long long py, long long px) {
  const int packed = py != 0 || px != 0;
  return Phase{py, px, packed, packed};
}

__device__ __forceinline__ long long pixel_offset(int y, int x, long long sy, long long sx,
                                                  const Phase& ph) {
  return (y >> ph.s) * sy + (y & ph.m) * ph.py + (x >> ph.s) * sx + (x & ph.m) * ph.px;
}

// One image's (H, W, C) logits of type T at element strides: channel 0 is
// the detection logit, 1..C-1 the class logits.  The context kernel writes
// (C, H, W) planes, so a pixel's channels lie H*W apart and neighbouring
// pixels are neighbours in memory; cuDNN's bf16 head may write channels
// last, where a pixel's channels are neighbours; the packed route's logits
// are phase-major (``ph``).
template <class T>
struct Logits {
  const T* p;
  long long sy, sx, sc;
  int C;
  Phase ph;
  __device__ const T* at(int y, int x) const { return p + pixel_offset(y, x, sy, sx, ph); }
};

// One image's (H, W) detection logits at element strides, widened to f32.
template <class T>
struct Plane {
  const T* p;
  long long sy, sx;
  Phase ph;
  __device__ float operator()(int y, int x) const {
    return widen(p[pixel_offset(y, x, sy, sx, ph)]);
  }
};

constexpr unsigned kFull = 0xffffffffu;

// The position of the j-th (from 0) set bit of m, j < popc(m).
__device__ __forceinline__ int nth_set_bit(unsigned m, int j) {
  int pos = 0;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) {
    const unsigned low = m & ((1u << w) - 1u);
    const int c = __popc(low);
    if (j >= c) {
      j -= c;
      m >>= w;
      pos += w;
    } else {
      m = low;
    }
  }
  return pos;
}

// Phase 2b: the per-slot stats, accumulated in phase 2's pixel pass: the
// pixel count, the sum of sigmoid(det logit) and the sums of the softmax
// over the C-1 class logits, as the one-hot contractions of the TPU module
// around K2 (ubdvss_tpu/ops/pallas/postproc_kernel.py:441-467) give them.
// The sums are taken in an order that depends only on the data and the
// block size, so two launches agree bit for bit and K2 and K12c, which both
// run this, agree with each other:
//   1. each thread adds its pixels, in its pass order, into registers for
//      the slot of its last pixel (CM: C at compile time, or a bound); a
//      pixel's class logits are loaded with its detection logit and label,
//      before its slot is known, so that one memory latency, not two, lies
//      on each step of a thread's pass;
//   2. when a thread's slot changes, and at the end of the pass, it
//      flushes them: the flushing lanes of the warp are grouped by slot
//      (__match_any_sync), each group is summed by a tree over its lanes'
//      ranks (shuffles), and the group's rank 0 adds the sum to the warp's
//      partial set in shared memory, ``part`` (K, C) floats and ``cnt``
//      (K) ints, one set per virtual warp of the pass (slot_pass);
//   3. slot_finish (band_finish on a cluster past two blocks) sums the
//      partials in the virtual warps' order.
// sigmoid and softmax follow torch's formulas with expf; on bf16 logits
// each class probability is rounded to bf16 before it is added
// (at_logit_precision), the sigmoid and the counts are not.  K2 and K12c
// divide each exponential by the sum; the tiled pass (kTiled) takes the
// max and the sum by pairwise trees and multiplies by the correctly
// rounded reciprocal of the sum, which shortens its dependent chain a
// pixel (within an ulp or two of the division; its stats are held to the
// f64 sums, not to K2's bits).
//
// Up to kOnePassChannels a pixel's class logits are loaded together
// (fetch), its max and denominator taken from the registers in channel
// order, and every class sum is held in one pass, so the sums are those a
// pass a chunk would take, bit for bit.  kWideChannels (C >
// kOnePassChannels): the accumulator holds the classes [c0, c0 +
// kChunkClasses) of its pass's chunk (``c0``, set_chunk), and the count and
// the sigmoid only in the first chunk's pass; each pixel's max and
// denominator are taken over all C - 1 class logits, in channel order,
// reloading them.
template <int CM, class T, bool kTiled = false>
struct StatsAcc {
  static constexpr bool kWide = CM == kWideChannels;
  static constexpr bool kExact = !guarded_channels<CM>() && !kWide;  // C == CM
  static constexpr int kN = kWide ? kChunkClasses : (CM > 1 ? CM - 1 : 1);  // array size
  static constexpr int kClasses = kWide ? kN : CM - 1;  // the class loops' bound
  // at a guarded bound fetch() loads the classes below C and gives every
  // class slot past them -inf, whose exponential adds +0 to the
  // denominator and to a sum no flush reads, so the class loops run every
  // slot with no branch on C and the sums are those of the classes alone,
  // bit for bit
  static constexpr bool kGuarded = guarded_channels<CM>();
  int slot;
  int cnt;
  float det;
  float cls[kN];
  float e[kN];  // the pixel's class logits, from fetch()
  int c0 = 0;   // kWide: the chunk's first class
  const T* q = nullptr;  // kWide: the pixel's logits, from fetch()

  __device__ void set_chunk(int chunk) {
    if constexpr (kWide) c0 = chunk * kN;
  }
  // the chunk's first class: 0 but for kWideChannels
  __device__ int first() const {
    if constexpr (kWide) {
      return c0;
    } else {
      return 0;
    }
  }
  // whether this pass sums the count and the sigmoid
  __device__ bool lead_chunk() const { return first() == 0; }

  __device__ void fetch(const Logits<T>& lg, int y, int x) {
    if constexpr (kWide) {
      q = lg.at(y, x);
#pragma unroll
      for (int c = 0; c < kN; ++c) {
        e[c] = widen(q[(c0 + c < lg.C - 1 ? 1 + c0 + c : 1) * lg.sc]);
      }
      return;
    }
    const T* q = lg.at(y, x);
#pragma unroll
    for (int c = 0; c < CM - 1; ++c) {
      q += lg.sc;
      if constexpr (kGuarded) {
        e[c] = c < lg.C - 1 ? widen(*q) : __int_as_float(0xff800000);  // -inf
      } else {
        e[c] = widen(*q);
      }
    }
  }

  __device__ void reset(int s) {
    slot = s;
    cnt = 0;
    det = 0.f;
#pragma unroll
    for (int c = 0; c < kClasses; ++c) cls[c] = 0.f;
  }

  // Warp-wide: lanes with ``go`` add their sums to the warp's partials.
  __device__ void flush(bool go, int K, int C, float* part, int* cnt_s) const {
    const int key = go ? slot : K;
    const int lane = threadIdx.x & 31;
    const unsigned grp = __match_any_sync(kFull, key);
    const int rank = __popc(grp & ((1u << lane) - 1u));
    const int size = __popc(grp);
    const int steps = 32 - __clz(__reduce_max_sync(kFull, static_cast<unsigned>(size)) - 1u);
    int src[5];
    unsigned take = 0;
#pragma unroll
    for (int s = 0; s < 5; ++s) {
      src[s] = lane;
      if (s < steps) {  // warp-uniform
        const int off = 1 << s;
        const bool t = (rank & (2 * off - 1)) == 0 && rank + off < size;
        if (t) src[s] = nth_set_bit(grp, rank + off);
        take |= static_cast<unsigned>(t) << s;
      }
    }
    auto group_sum = [&](auto v) {
#pragma unroll
      for (int s = 0; s < 5; ++s) {
        if (s < steps) {  // warp-uniform
          const auto o = __shfl_sync(kFull, v, src[s]);
          if ((take >> s) & 1u) v += o;
        }
      }
      return v;
    };
    const bool lead = rank == 0 && key < K;
    float* ps = part + key * C;
    if (lead_chunk()) {  // warp-uniform
      const int n = group_sum(go ? cnt : 0);
      const float d = group_sum(go ? det : 0.f);
      if (lead) {
        cnt_s[key] += n;
        ps[0] += d;
      }
    }
    const int f = first();
#pragma unroll
    for (int c = 0; c < kClasses; ++c) {
      if (kExact || f + c < C - 1) {  // uniform
        const float v = group_sum(go ? cls[c] : 0.f);
        if (lead) ps[1 + f + c] += v;
      }
    }
  }

  // kWideChannels: the max and the denominator of the pixel's softmax over
  // all C - 1 class logits, in channel order (the tiled pass's
  // denominator as its reciprocal).
  __device__ void wide_softmax(const Logits<T>& lg, float* mx, float* den) const {
    float m = __int_as_float(0xff800000);  // -inf
    for (int c = 0; c < lg.C - 1; ++c) m = fmaxf(m, widen(q[(1 + c) * lg.sc]));
    float s = 0.f;
    for (int c = 0; c < lg.C - 1; ++c) s += expf(widen(q[(1 + c) * lg.sc]) - m);
    *mx = m;
    *den = s;
  }

  // The tiled pass's sums of one pixel (add's, by trees and a reciprocal).
  __device__ void add_tiled(const Logits<T>& lg, float d) {
    if constexpr (kWide) {
      if (lead_chunk()) det += __frcp_rn(1.f + expf(-d));
      float mx, den;
      wide_softmax(lg, &mx, &den);
      const float inv = __frcp_rn(den);
#pragma unroll
      for (int c = 0; c < kN; ++c) cls[c] += at_logit_precision<T>(expf(e[c] - mx) * inv);
      return;
    }
    det += __frcp_rn(1.f + expf(-d));
    if constexpr (CM == 1) return;
    constexpr int n = CM > 1 ? CM - 1 : 1;
    float t[n];
#pragma unroll
    for (int c = 0; c < n; ++c) t[c] = e[c];
#pragma unroll
    for (int w = 1; w < n; w *= 2) {
#pragma unroll
      for (int c = 0; c + w < n; c += 2 * w) t[c] = fmaxf(t[c], t[c + w]);
    }
    const float mx = t[0];
#pragma unroll
    for (int c = 0; c < n; ++c) {
      e[c] = expf(e[c] - mx);
      t[c] = e[c];
    }
#pragma unroll
    for (int w = 1; w < n; w *= 2) {
#pragma unroll
      for (int c = 0; c + w < n; c += 2 * w) t[c] += t[c + w];
    }
    const float inv = __frcp_rn(t[0]);
#pragma unroll
    for (int c = 0; c < n; ++c) cls[c] += at_logit_precision<T>(e[c] * inv);
  }

  // Warp-wide: one pixel of slot ``s`` (K: none) with detection logit d
  // and the class logits that fetch() loaded.
  __device__ void add(const Logits<T>& lg, int s, float d, int K, float* part, int* cnt_s) {
    const bool change = s != slot;
    const bool go = change && slot < K;
    if (__ballot_sync(kFull, go)) flush(go, K, lg.C, part, cnt_s);
    if (change) reset(s);
    if (s >= K) return;
    cnt += 1;
    if constexpr (kTiled) {
      add_tiled(lg, d);
      return;
    }
    if constexpr (kWide) {
      if (lead_chunk()) det += 1.f / (1.f + expf(-d));
      float mx, den;
      wide_softmax(lg, &mx, &den);
#pragma unroll
      for (int c = 0; c < kN; ++c) cls[c] += at_logit_precision<T>(expf(e[c] - mx) / den);
      return;
    }
    det += 1.f / (1.f + expf(-d));
    if (CM == 1) return;
    float mx = __int_as_float(0xff800000);  // -inf
#pragma unroll
    for (int c = 0; c < CM - 1; ++c) mx = fmaxf(mx, e[c]);
    float den = 0.f;
#pragma unroll
    for (int c = 0; c < CM - 1; ++c) {
      e[c] = expf(e[c] - mx);
      den += e[c];
    }
#pragma unroll
    for (int c = 0; c < CM - 1; ++c) cls[c] += at_logit_precision<T>(e[c] / den);
  }
};

// Phase 2: root count, the K smallest roots, the slot map, each slot's
// per-row x extremes and its stats, from the detection logits and the raw
// labels (global or shared memory, which this phase only reads), as the
// TPU's _roots_slots_extremes (ubdvss_tpu/ops/pallas/postproc_kernel.py:182)
// plus the stats around it, including its padding slots: when an image has
// fewer than K components, the padding slots hold the root value H*W, which
// the TPU kernel matches against the background label, so background
// pixels take the LAST padding slot (K-1) and every padding slot carries
// the background's per-row extremes.  Callers mask padding slots by
// rootvals.
//
// One image's phase 2 runs on a cluster of ``blocks`` blocks (SlotPlan),
// K2's and K12c's alike, in one order.  On two blocks (a batch that fills
// the card, B >= 34 at 132 SMs):
//   slot_roots   every block of the image ranks the roots itself (K2), or
//                those of its own rows (K12c, which then joins the lists);
//   slot_pass    the pixel pass over the block's share of the virtual
//                warps, writing slots, extremes and stats partials;
//   slot_finish  one block writes the extremes, roots and stats.
// On a wider cluster (few images), each block holds a band of rows:
//   slot_rank    each block ranks the roots of its own band, with coalesced
//                loads, and clears its extremes and partials (slot_clear)
//                while the cluster's barrier completes; join_roots then
//                takes the image's K smallest from the blocks' lists in
//                block order;
//   slot_pass    as on two blocks;
//   band_finish  the outputs, each block a share of them.

// The launch plan of K2 and K12c (ops/cuda/postproc_kernel.py slot_plan,
// whose choice slot_plan below mirrors): ``blocks`` blocks an image in one
// cluster, each running ``sets`` virtual warps of the pixel pass, one stats
// partial set each, so blocks * sets virtual warps an image, block r's
// the r-th run of ``sets``.  The sums run over the partial sets in the
// virtual warps' order: on two blocks one running sum over all of them; on
// a wider cluster each block's running sum of its own sets, then the
// running sum of the blocks' sums.  K2 and K12c take one plan, so they
// agree bit for bit.
struct SlotPlan {
  int blocks, sets;
};

// The cluster sizes of a plan: the least, then up to kMaxSlotCtas, past
// the portable 8 only where the card allows it (non-portable).
constexpr int kSlotCtas = 2;
constexpr int kMaxSlotCtas = 16;

__host__ __device__ constexpr bool valid_plan(const SlotPlan& pl) {
  return (pl.blocks == 2 || pl.blocks == 4 || pl.blocks == 8 || pl.blocks == 16) &&
         pl.sets >= 1 && pl.sets <= 32;
}

// The plan of B images whose blocks hold ``sets`` virtual warps each (the
// Python stats_warps) on a card of ``sms`` SMs, where ``room[i]`` clusters
// of 16 >> i blocks (16, 8, 4) run at once: the largest cluster of 16, 8
// or 4 blocks that keeps every image's blocks on the card at once (blocks
// * B <= sms, B <= its room); else two blocks (the main path's B=64 and
// beyond).
inline SlotPlan slot_plan(int B, int sets, int sms, const int* room) {
  for (int i = 0; i < 3; ++i) {
    const int g = kMaxSlotCtas >> i;
    if (static_cast<long long>(g) * B <= sms && B <= room[i]) return {g, sets};
  }
  return {kSlotCtas, sets};
}

// The rows of a block's band: ceil(H / blocks).
__host__ __device__ inline int band_rows(int H, int blocks) { return (H + blocks - 1) / blocks; }

// The per-image state in shared memory: ``sm`` holds K roots (ascending,
// H*W pads), (K, H) min x, (K, H) max x, then the stats partials, (K, C)
// floats and K ints for each virtual warp the block runs, then the block's
// own ranked roots (K) and their count.
struct SlotSmem {
  int* root;
  int* mn;
  int* mx;
  float* part;
  int* cnt;
  int* ranked;
  __device__ SlotSmem(int* sm, int K, int H, int C, int sets)
      : root(sm), mn(sm + K), mx(sm + K + K * H),
        part(reinterpret_cast<float*>(sm + K + 2 * K * H)),
        cnt(reinterpret_cast<int*>(part + sets * K * C)), ranked(cnt + sets * K) {}
};

// Its words: K + 2 K H + sets K (C + 1) + K + 1.
__host__ __device__ constexpr long long slot_smem_words(int K, int H, int C, int sets) {
  return 2LL * K + 1 + 2LL * K * H + static_cast<long long>(sets) * K * (C + 1);
}

// A debug build (-DSLOTS_STAMPS, scripts/torch_kernel_ab.py --only widths
// --parts stats) sums each block's clock64() cycles by step over the
// blocks, as its thread 0 sees them: K12c's CCL, the roots (ranked and
// joined), the pixel pass, the finish (each with the cluster barrier after
// it), then the blocks counted.
#ifdef SLOTS_STAMPS
__device__ unsigned long long g_slot_cycles[5];
extern "C" int slot_cycles(unsigned long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_slot_cycles, sizeof(g_slot_cycles)));
}
extern "C" int slot_cycles_clear() {
  const unsigned long long zero[5] = {0, 0, 0, 0, 0};
  return static_cast<int>(cudaMemcpyToSymbol(g_slot_cycles, zero, sizeof(zero)));
}
#define SLOT_STAMP(k)                                                             \
  if (threadIdx.x == 0) {                                                         \
    const long long now_ = clock64();                                             \
    atomicAdd(&geometry::g_slot_cycles[k],                                        \
              static_cast<unsigned long long>(now_ - t_stamp));                   \
    if ((k) == 3) atomicAdd(&geometry::g_slot_cycles[4], 1ULL);                   \
    t_stamp = now_;                                                               \
  }
#define SLOT_STAMP_START long long t_stamp = clock64()
#else
#define SLOT_STAMP(k)
#define SLOT_STAMP_START
#endif

// Roots (foreground pixels whose label is their own index) among the pixels
// [p0, p1), ranked in raster order by a block-wide exclusive prefix sum
// (warp shuffles; the block is a whole number of warps); those of rank < K
// go to ``roots`` (K words, N pads).  Also clears the extremes and the
// block's ``sets`` stats partial sets.  Returns the root count of the
// range.  Ends with a __syncthreads().
template <class Det, class Lab>
__device__ inline int slot_roots(const Det& det, const Lab& lab, const SlotSmem& s, int* roots,
                                 int p0, int p1, int H, int W, int K, int C, int sets,
                                 float thr) {
  __shared__ int s_warp[32];
  const int N = H * W;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  for (int i = tid; i < K; i += blockDim.x) roots[i] = N;
  for (int i = tid; i < K * H; i += blockDim.x) {
    s.mn[i] = kBig;
    s.mx[i] = -1;
  }
  for (int i = tid; i < sets * K * C; i += blockDim.x) s.part[i] = 0.f;
  for (int i = tid; i < sets * K; i += blockDim.x) s.cnt[i] = 0;

  // count roots in a contiguous raster chunk per thread
  const int chunk = (p1 - p0 + blockDim.x - 1) / blockDim.x;
  const int begin = p0 + min(tid * chunk, p1 - p0);
  const int end = min(begin + chunk, p1);
  int cnt = 0;
  for (int p = begin; p < end; ++p) cnt += (lab[p] == p && det(p / W, p % W) > thr);

  // block-wide exclusive prefix sum of the counts
  int incl = cnt;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int v = lane < nw ? s_warp[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(kFull, v, off);
      if (lane >= off) v += u;
    }
    if (lane < nw) s_warp[lane] = v;  // inclusive warp totals
  }
  __syncthreads();
  const int total = s_warp[nw - 1];
  int rank = (warp > 0 ? s_warp[warp - 1] : 0) + incl - cnt;
  for (int p = begin; p < end && rank < K; ++p) {
    if (lab[p] == p && det(p / W, p % W) > thr) roots[rank++] = p;
  }
  __syncthreads();
  return total;
}

// The tiles of blockDim.x pixels whose labels a thread of slot_rank loads
// at once (a chunk), so that one load latency, not one a tile, lies on the
// ranking's path.
constexpr int kRankTiles = 8;

// Ranks the roots (foreground pixels whose label is their own index) among
// the pixels [p0, p1) in raster order, a chunk of kRankTiles tiles of
// blockDim.x pixels at a time, lanes over consecutive pixels: each thread
// loads its pixels' labels at once, each warp's roots of a tile are ranked
// by a ballot, and the (tile, warp) counts by one prefix over the chunk;
// those of rank < K go to ``roots`` (K words), their count to *count.
// Ends with the count written by thread 0 and not yet seen by the others
// (a __syncthreads, or the cluster barrier that join_roots waits for,
// follows).
template <class Det, class Lab>
__device__ inline void slot_rank(const Det& det, const Lab& lab, int* roots, int* count, int p0,
                                 int p1, int W, int K, float thr) {
  __shared__ int s_cnt[kRankTiles * 32 + 1];  // (tile, warp) counts, then their prefix and total
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  int base = 0;
  for (int t0 = p0; t0 < p1; t0 += kRankTiles * blockDim.x) {
    const int nt = min(kRankTiles, (p1 - t0 + blockDim.x - 1) / blockDim.x);  // tiles in the chunk
    int lv[kRankTiles];
#pragma unroll
    for (int j = 0; j < kRankTiles; ++j) {
      const int p = t0 + j * blockDim.x + tid;
      lv[j] = p < p1 ? lab[p] : -1;
    }
    unsigned mine = 0;  // bit j: the thread's pixel of tile j is a root
#pragma unroll
    for (int j = 0; j < kRankTiles; ++j) {
      const int p = t0 + j * blockDim.x + tid;
      if (lv[j] == p) {
        const int y = p / W;
        mine |= static_cast<unsigned>(det(y, p - y * W) > thr) << j;
      }
    }
#pragma unroll
    for (int j = 0; j < kRankTiles; ++j) {
      if (j < nt) {  // block-uniform
        const unsigned ball = __ballot_sync(kFull, (mine >> j) & 1u);
        if (lane == 0) s_cnt[j * nw + warp] = __popc(ball);
      }
    }
    __syncthreads();
    if (warp == 0) {  // exclusive prefix of the counts in (tile, warp) order
      const int n = nt * nw;
      const int per = (n + 31) / 32;  // at most kRankTiles
      int v[kRankTiles];
      int sum = 0;
#pragma unroll
      for (int i = 0; i < kRankTiles; ++i) {
        const int k = lane * per + i;
        v[i] = i < per && k < n ? s_cnt[k] : 0;
        sum += v[i];
      }
      int incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int u = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += u;
      }
      int run = incl - sum;
#pragma unroll
      for (int i = 0; i < kRankTiles; ++i) {
        const int k = lane * per + i;
        if (i < per && k < n) s_cnt[k] = run;
        run += v[i];
      }
      if (lane == 31) s_cnt[n] = incl;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kRankTiles; ++j) {
      if (j >= nt) break;  // block-uniform
      const unsigned ball = __ballot_sync(kFull, (mine >> j) & 1u);
      if ((mine >> j) & 1u) {
        const int rank = base + s_cnt[j * nw + warp] + __popc(ball & below);
        if (rank < K) roots[rank] = t0 + j * blockDim.x + tid;
      }
    }
    base += s_cnt[nt * nw];
    __syncthreads();  // s_cnt is the next chunk's
  }
  if (tid == 0) *count = base;
}

// Clears the block's extremes and its ``sets`` stats partial sets.
__device__ inline void slot_clear(const SlotSmem& s, int H, int K, int C, int sets) {
  for (int i = threadIdx.x; i < K * H; i += blockDim.x) {
    s.mn[i] = kBig;
    s.mx[i] = -1;
  }
  for (int i = threadIdx.x; i < sets * K * C; i += blockDim.x) s.part[i] = 0.f;
  for (int i = threadIdx.x; i < sets * K; i += blockDim.x) s.cnt[i] = 0;
}

// After a cluster barrier that follows every block's slot_rank (and
// slot_clear): the image's K smallest roots into s.root (H*W pads), block
// r's list after those of the blocks before it (its band's pixels come
// after theirs in raster order).  Returns the image's root count.  Ends
// with a __syncthreads().
__device__ inline int join_roots(const cooperative_groups::cluster_group& cluster,
                                 const SlotSmem& s, int blocks, int K, int N) {
  __shared__ int s_first[kMaxSlotCtas + 1];  // the blocks' first ranks, then the count
  const int tid = threadIdx.x;
  if (tid < 32) {
    const int c = tid < blocks ? cluster.map_shared_rank(s.ranked, tid)[K] : 0;
    int incl = c;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, off);
      if (tid >= off) incl += v;
    }
    if (tid < blocks) s_first[tid + 1] = incl;
    if (tid == 0) s_first[0] = 0;
  }
  __syncthreads();
  const int total = s_first[blocks];
  for (int k = tid; k < K; k += blockDim.x) {
    int r = 0;
    while (r + 1 < blocks && s_first[r + 1] <= k) ++r;
    s.root[k] = k < total ? cluster.map_shared_rank(s.ranked, r)[k - s_first[r]] : N;
  }
  __syncthreads();
  return total;
}

// The pixel pass.  The image's (32-column strip, row) pairs, strip-major,
// are cut into ``nv`` runs, one per virtual warp; a warp walks its run with
// lanes over the strip's columns, so a lane goes down its column and its
// slot changes only at a component's edge, and every warp-wide stats call
// sees the whole warp.  The block runs the ``sets`` virtual warps first,
// first + 1, ...: warp w runs first + w + j * nw for every j that stays
// below first + sets (nw the block's warps; one j where the block has a
// warp a virtual warp), each into the partial set v - first.  Each pixel
// finds its root's slot by binary search among the ranked roots, writes
// it, and takes part in the per-row extremes (shared-memory atomicMin/Max)
// and the stats; a later class chunk's pass (kWideChannels) reads the slot
// its own thread wrote.  Ends with a __syncthreads().
template <int CM, class T, class Det, class Lab>
__device__ inline void slot_pass(const Det& det, const Logits<T>& lg, const Lab& lab,
                                 const SlotSmem& s, int H, int W, int K, float thr, int total,
                                 int first, int sets, int nv, int* __restrict__ slots) {
  const int N = H * W;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int nvalid = min(total, K);
  const int bg_slot = total < K ? K - 1 : K;
  const int runs = (W + 31) / 32 * H;
  const int per_v = (runs + nv - 1) / nv;
  // one pass a class chunk (kWideChannels); the first writes the slots
  // and the extremes
  auto pass = [&](int chunk, bool lead) {
    auto walk = [&](int set) {
      const int v = first + set;
      float* w_part = s.part + set * K * lg.C;
      int* w_cnt = s.cnt + set * K;
      StatsAcc<CM, T> acc;
      acc.set_chunk(chunk);
      acc.reset(K);
      const int r0 = min(v * per_v, runs);
      const int r1 = min(r0 + per_v, runs);
      int y = r0 % H;
      int x = r0 / H * 32 + lane;
      for (int r = r0; r < r1; ++r, ++y) {
        if (y == H) {
          y = 0;
          x += 32;
        }
        const int p = y * W + x;
        int slot = K;
        float d = 0.f;
        if (x < W) {
          acc.fetch(lg, y, x);
          if (lead) {
            d = det(y, x);
            const int lp = lab[p];  // loaded beside d, not after it
            const int l = d > thr ? lp : N;
            if (l == N) {
              slot = bg_slot;
            } else {
              int lo = 0, hi = nvalid;
              while (lo < hi) {
                const int mid = (lo + hi) >> 1;
                if (s.root[mid] < l) lo = mid + 1; else hi = mid;
              }
              slot = (lo < nvalid && s.root[lo] == l) ? lo : K;
            }
            slots[p] = slot;
            if (slot < K) {
              atomicMin(&s.mn[slot * H + y], x);
              atomicMax(&s.mx[slot * H + y], x);
            }
          } else {
            slot = slots[p];
          }
        }
        acc.add(lg, slot, d, K, w_part, w_cnt);
      }
      if (__ballot_sync(kFull, acc.slot < K)) acc.flush(acc.slot < K, K, lg.C, w_part, w_cnt);
    };
    if constexpr (stats_block<CM>() >= 1024) {
      walk(warp);  // a warp a virtual warp: the block is 32 x sets threads
    } else {
      for (int set = warp; set < sets; set += nw) walk(set);  // warp-uniform
    }
  };
  if constexpr (CM == kWideChannels) {
    for (int chunk = 0; chunk < class_chunks<CM>(lg.C); ++chunk) pass(chunk, chunk == 0);
  } else {
    pass(0, true);
  }
  __syncthreads();
}

// The outputs of one image on two blocks: the stats summed over the ``nv``
// virtual warps' partial sets in their order (sets [0, nv/2) in ``lo``,
// the rest in ``hi``, which may be another block's shared memory) into
// areas (K), det_sums (K) and cls_sums (K, max(C-1, 1)) — with C = 1 one
// zero column — then rootvals (K), minx/maxx (K, H), the padding slots all
// carrying the background's extremes, and nroots (1).
__device__ inline void slot_finish(const SlotSmem& s, const float* hi_part, const int* hi_cnt,
                                   int H, int K, int C, int total, int nv,
                                   int* __restrict__ rootvals, int* __restrict__ minx,
                                   int* __restrict__ maxx, int* __restrict__ nroots,
                                   float* __restrict__ areas, float* __restrict__ det_sums,
                                   float* __restrict__ cls_sums) {
  const int half = nv / 2;
  for (int i = threadIdx.x; i < K * C; i += blockDim.x) {
    float v = 0.f;
    for (int w = 0; w < half; ++w) v += s.part[w * K * C + i];
    for (int w = 0; w < nv - half; ++w) v += hi_part[w * K * C + i];
    const int k = i / C;
    const int c = i - k * C;
    if (c == 0) {
      det_sums[k] = v;
    } else {
      cls_sums[k * (C - 1) + c - 1] = v;
    }
  }
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    int a = 0;
    for (int w = 0; w < half; ++w) a += s.cnt[w * K + k];
    for (int w = 0; w < nv - half; ++w) a += hi_cnt[w * K + k];
    areas[k] = static_cast<float>(a);
    if (C == 1) cls_sums[k] = 0.f;
  }
  const int nvalid = min(total, K);
  for (int i = threadIdx.x; i < K * H; i += blockDim.x) {
    const int k = i / H;
    const int src = (k >= nvalid && k < K - 1) ? (K - 1) * H + (i - k * H) : i;
    minx[i] = s.mn[src];
    maxx[i] = s.mx[src];
  }
  for (int k = threadIdx.x; k < K; k += blockDim.x) rootvals[k] = s.root[k];
  if (threadIdx.x == 0) *nroots = total;
}

// The outputs of one image on a wider cluster, after its block has run its
// pixel pass, each block a slice of them (block r the r-th of G runs of
// consecutive items, its threads over consecutive items, so that a warp's
// loads fall in distinct banks): the stats summed over the partial sets in
// the plan's order (SlotPlan: a block's sets, then the blocks) into areas
// (K), det_sums (K) and cls_sums (K, max(C-1, 1)) — with C = 1 one zero
// column — then the extremes merged over the blocks into minx / maxx (K,
// H), the padding slots all carrying the background's extremes, rootvals
// (K) and nroots (1).  The other blocks' shared memory is read through the
// cluster, between the two cluster barriers here.
__device__ inline void band_finish(const cooperative_groups::cluster_group& cluster,
                                   const SlotSmem& s, int rank, const SlotPlan& pl, int H, int K,
                                   int C, int total, int* __restrict__ rootvals,
                                   int* __restrict__ minx, int* __restrict__ maxx,
                                   int* __restrict__ nroots, float* __restrict__ areas,
                                   float* __restrict__ det_sums, float* __restrict__ cls_sums) {
  const int G = pl.blocks;
  const int KC = K * C;
  // each block's running sum of its own sets, into set 0 (slot_pass ended
  // with the block's barrier)
  for (int i = threadIdx.x; i < KC; i += blockDim.x) {
    float v = s.part[i];
    for (int w = 1; w < pl.sets; ++w) v += s.part[w * KC + i];
    s.part[i] = v;
  }
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    int a = s.cnt[k];
    for (int w = 1; w < pl.sets; ++w) a += s.cnt[w * K + k];
    s.cnt[k] = a;
  }
  cluster.sync();
  // block rank's slice of n items
  auto slice = [&](int n, int* lo, int* hi) {
    const int len = (n + G - 1) / G;
    *lo = min(rank * len, n);
    *hi = min(*lo + len, n);
  };
  int i0, i1;
  slice(KC, &i0, &i1);
  for (int i = i0 + threadIdx.x; i < i1; i += blockDim.x) {
    float v = 0.f;
#pragma unroll 4
    for (int r = 0; r < G; ++r) v += (r == rank ? s.part : cluster.map_shared_rank(s.part, r))[i];
    const int k = i / C;
    const int c = i - k * C;
    if (c == 0) {
      det_sums[k] = v;
    } else {
      cls_sums[k * (C - 1) + c - 1] = v;
    }
  }
  slice(K, &i0, &i1);
  for (int k = i0 + threadIdx.x; k < i1; k += blockDim.x) {
    int a = 0;
#pragma unroll 4
    for (int r = 0; r < G; ++r) a += (r == rank ? s.cnt : cluster.map_shared_rank(s.cnt, r))[k];
    areas[k] = static_cast<float>(a);
    if (C == 1) cls_sums[k] = 0.f;
    rootvals[k] = s.root[k];
  }
  const int nvalid = min(total, K);
  slice(K * H, &i0, &i1);
  for (int i = i0 + threadIdx.x; i < i1; i += blockDim.x) {
    const int k = i / H;
    const int src = (k >= nvalid && k < K - 1) ? (K - 1) * H + (i - k * H) : i;
    int lo = kBig, hi = -1;
#pragma unroll 4
    for (int r = 0; r < G; ++r) {
      lo = min(lo, (r == rank ? s.mn : cluster.map_shared_rank(s.mn, r))[src]);
      hi = max(hi, (r == rank ? s.mx : cluster.map_shared_rank(s.mx, r))[src]);
    }
    minx[i] = lo;
    maxx[i] = hi;
  }
  if (rank == 0 && threadIdx.x == 0) *nroots = total;
  cluster.sync();  // every block's shared memory lives until the others have read it
}

// ---- the cluster launch of K2 and K12c (host) ----

// Allows ``kernel`` its dynamic shared memory and, past 8 blocks, a
// non-portable cluster size.
template <class... KArgs>
inline cudaError_t allow_cluster(void (*kernel)(KArgs...), int blocks, size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e == cudaSuccess && blocks > 8)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

inline cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr, int blocks, int grid,
                                         int threads, size_t smem, cudaStream_t stream) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(blocks);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of ``blocks`` blocks of ``kernel`` the card runs at once
// (cudaOccupancyMaxActiveClusters) into *room.
template <class... KArgs>
inline int cluster_room(void (*kernel)(KArgs...), int blocks, int threads, size_t smem,
                        int* room) {
  cudaError_t e = allow_cluster(kernel, blocks, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(&attr, blocks, blocks, threads, smem, nullptr);
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(room, reinterpret_cast<const void*>(kernel), &cfg));
}

// Launches ``kernel`` over B images at plan ``pl``: pl.blocks * B blocks
// of ``threads`` threads, a cluster an image (cudaLaunchKernelEx).  A
// launch the card refuses returns its error.
template <class... KArgs, class... Args>
inline int launch_cluster(void (*kernel)(KArgs...), const SlotPlan& pl, int B, int threads,
                          size_t smem, cudaStream_t stream, Args&&... args) {
  cudaError_t e = allow_cluster(kernel, pl.blocks, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(&attr, pl.blocks, pl.blocks * B, threads, smem, stream);
  e = cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace geometry
