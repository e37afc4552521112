"""The int8 trunk's convolutions: plain versions, the tile plan and the
CUDA kernels.

Counterpart of the JAX package's ``_qconv`` and ``_quantize_input``
(``ubdvss_tpu/ops/quant.py:276-292``, :315-329), which XLA compiles: an
int8 x int8 -> int32 convolution (3x3 stride 2, 3x3 stride 1 with
dilation d, or 1x1), then ``acc * ws + b``, and for every layer but the
head ReLU and the requantization ``clip(round(y * s_out), -127, 127)`` to
int8.  Layer 0 reads the image (one channel) and quantizes it on the fly.

On the card the trunk is three kernels (``csrc/qstem_kernel.cu``,
``csrc/qconv_kernel.cu``), each counting its launches:

  * ``qstem`` — layers 0 and 1 in one launch: the image in, layer 1's
    int8 map out; layer 0's outputs stay in shared memory;
  * ``qconv`` — one 3x3 stride-1 dilated int8 layer on the tensor cores;
  * ``qconv_head`` — the last context layer with the 1x1 head fused in,
    f32 logits out.

The calibration's bias correction reads each layer alone, with its f32
pre-activation, and computes its accumulator once (as the JAX package's
``bias_correct_qparams``): ``qconv_layer_f32`` writes a layer's
``acc * ws + b`` and the exact ``(float)acc`` in one launch — layer 0 by
``qlayer0_tc`` in ``csrc/qstem_kernel.cu``, every int8-input layer (3x3 at
stride 1 or 2, the 1x1 head) by ``qconv_tc_kernel`` with an f32 epilogue —
and ``requantize`` turns the accumulators into the next layer's int8 input
with the corrected bias (``qrequant``, ``csrc/qconv_kernel.cu``).

Widths: the kernels' compiled instances take channel counts a multiple of
4 up to ``COMPILED_CHANNELS`` (32); past it the any-width kernels run (the
plan's ``generic``: the K order, the k steps and the n8 tiles from the
plan, the output channels eight n8 tiles at a time in the conv kernel
and the stem, whose int8 runs are staged and stored contiguous and whose
blocks the plan sizes for two an SM), and the wrappers pad
any count that is not a multiple of 4 (``pad_layer``, ``pad_scale``: zero
weights, and for padded outputs ws = 1, b = 0, s_out = 1, so they hold
exact zeros) and slice the padding off what they return.  The only refusal
left is a plan past one block's shared memory.  The epilogue reads the
accumulator by ``acc_mode``: without a conversion below 2^22, with the
conversion instruction past it, which past 2^24 rounds to nearest even as
XLA's s32 -> f32 convert does.

Every index the kernels rely on — the tiles and their halos, the split of
a dilated layer into row phases, the (tap, channel word) order of the
MMA's K dimension with its zero padding, the shared-memory layout — comes
from one function here, ``tile_plan``, which the wrappers pass to the
kernels as a block of ints.  The CPU tests hold the plan's coverage and
K order; the card tests hold the kernels against the plain versions.

Rounding as the JAX package rounds under ``jit``, where XLA's CPU compiler
fuses ``acc * ws + b`` (and the raw input's ``x * (127/127.5) - 127``)
into one fused multiply-add:

  * the card writes ``fmaf`` explicitly;
  * the plain version (``qconv_reference``) takes the exact product in
    f64 and rounds the sum to f32 once.  f32(acc) and ``ws`` have 24
    significant bits each, so the product is exact in f64; the sum is
    exact while |b| and |acc * ws| lie within 2^29 of each other (or one
    is 0), which holds far beyond any layer's weights.

``round`` is half to even everywhere (``torch.round``, the kernels' add of
1.5 * 2^23, ``jnp.round``).  The plain version's convolution runs in f64
on the int8 values, where every partial sum is an integer below 2^53, so
it is exact at any width, in any summation order (cuDNN is switched off
for it on the card: its FFT and Winograd algorithms would not keep the
sums exact).

Layouts are the JAX package's: activations NHWC, kernels HWIO int8.  The
kernels pack their weight fragments themselves at block start, so a
layer's tensors go to them as they are.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

import torch.nn.functional as F

from ubdvss_tpu_torch.models.model import conv2d_same, same_pad
from ubdvss_tpu_torch.ops.cuda import _build
from ubdvss_tpu_torch.ops.cuda.context_kernel import _s2d

# The compiled instances take channel counts a multiple of 4 up to
# COMPILED_CHANNELS (input words and n8 tiles fixed at compile time); wider
# layers, or heads of more logits, run the any-width kernels (the plan's
# ``generic``), and the wrappers pad other counts to a multiple of 4
# (``pad_layer``).
COMPILED_CHANNELS = 32
SHARED_MEMORY_LIMIT = 232_448  # bytes a block may use on the H100

# the input quantization's constants as the JAX package rounds them to f32
_RAW_SCALE = float(np.float32(127.0 / 127.5))


def quantize_input(x: torch.Tensor, raw_gray: bool) -> torch.Tensor:
    """The JAX package's ``_quantize_input``: normalized f32 (B, H, W[, 1])
    in [-1, 1], or with ``raw_gray`` raw [0, 255] grayscale (B, H, W), ->
    int8 (B, H, W, 1).  The raw recipe ``x * (127/127.5) - 127`` is rounded
    once (an exact f64 product and sum, then f32), as under ``jit``."""
    x = x.to(torch.float32)
    if raw_gray:
        y = (x.to(torch.float64) * _RAW_SCALE - 127.0).to(torch.float32)
    else:
        y = x * 127.0
    return torch.clamp(torch.round(y), -127, 127).to(torch.int8).reshape(x.shape[:3] + (1,))


def qconv_acc_reference(x: torch.Tensor, layer: dict, stride: int, dil: int,
                        raw_gray: bool = False, padding=None) -> torch.Tensor:
    """Plain version of a layer's accumulator: int8 (B, H, W, Cin) -> the
    exact int32 sums converted to f32 (B, Ho, Wo, Cout), exact while
    |acc| < 2^24 (up to 112 input channels of a 3x3 layer; the packed int8
    trunk's 4x channels add only zeros), rounded to nearest even past it as
    XLA's convert rounds.  A non-int8 ``x`` is the image of layer 0
    and is quantized first (``quantize_input``).  TF "SAME" padding, or
    ``padding`` = ((top, bottom), (left, right)) explicit zeros (the
    packed stem's ((0, 1), (0, 1)), as the JAX package's ``_qconv``)."""
    if x.dtype != torch.int8:
        x = quantize_input(x, raw_gray)
    k = layer["q"].permute(3, 2, 0, 1).to(torch.float64)  # HWIO -> OIHW
    xd = x.permute(0, 3, 1, 2).to(torch.float64)
    with torch.backends.cudnn.flags(enabled=False):
        if padding is None:
            acc = conv2d_same(xd, k, None, stride, dil)
        else:
            (t, b), (left, r) = padding
            acc = F.conv2d(F.pad(xd, (left, r, t, b)), k, None, stride, 0, dil)
    return acc.to(torch.float32).permute(0, 2, 3, 1).contiguous()


def requantize_reference(acc: torch.Tensor, ws: torch.Tensor, b: torch.Tensor,
                         s_out: torch.Tensor | None) -> torch.Tensor:
    """The epilogue on exact accumulators (..., C): ``acc * ws + b`` as the
    exact f64 product plus the bias rounded once to f32; with ``s_out`` then
    ReLU, ``round(y * s_out)`` half to even, clamp to +-127, int8."""
    y = (acc.to(torch.float64) * ws.to(torch.float64) + b.to(torch.float64)).to(torch.float32)
    if s_out is None:
        return y
    r = torch.round(torch.clamp(y, min=0.0) * s_out.to(torch.float32))
    return torch.clamp(r, -127, 127).to(torch.int8)


def qconv_reference(
    x: torch.Tensor, layer: dict, s_out: torch.Tensor | None, stride: int, dil: int,
    raw_gray: bool = False, padding=None,
) -> torch.Tensor:
    """Plain version of one layer, the JAX package's ``_qconv``: int8
    (B, H, W, Cin) -> int8 (B, Ho, Wo, Cout), or f32 logits when ``s_out``
    is None.  A non-int8 ``x`` is the image of layer 0 and is quantized
    first (``quantize_input``); ``padding`` as ``qconv_acc_reference``."""
    acc = qconv_acc_reference(x, layer, stride, dil, raw_gray, padding)
    return requantize_reference(acc, layer["ws"], layer["b"], s_out).contiguous()


def qstem_reference(x, layer0, s1, layer1, s2, raw_gray=False) -> torch.Tensor:
    """Plain version of ``qstem``: layer 0 on the image, then layer 1."""
    return qconv_reference(qconv_reference(x, layer0, s1, 2, 1, raw_gray), layer1, s2, 2, 1)


def qconv_head_reference(x, layer, s_out, dil, head, packed: bool = False) -> torch.Tensor:
    """Plain version of ``qconv_head``: the 3x3 layer, then the 1x1 head;
    with ``packed`` the logits' ``_s2d`` (phase-major), contiguous."""
    out = qconv_reference(qconv_reference(x, layer, s_out, 1, dil), head, None, 1, 1)
    return _s2d(out).contiguous() if packed else out


# ---------------------------------------------------------------------------
# The tile plan
# ---------------------------------------------------------------------------

THREADS = 256  # a block: eight warps
WARPS = THREADS // 32
MAX_K_WORDS = 72  # the compiled instances' K table: 9 taps x 8 channel words, nine k32 steps
_MAX_TH, _MAX_TW = 8, 128  # qconv's output tile: 8 phase rows x up to 128 columns
_MIN_BLOCKS = 2 * 132  # smaller tiles below this many tiles (132 SMs)
_SMEM_TARGET = 75 * 1024  # a conv block's shared memory: three blocks an SM
# an any-width conv or stem block's: two blocks an SM (the SM's 233,472
# bytes, less the 1 KB the card reserves for each block), as their launch
# bounds ask
SMEM_TWO_BLOCKS = 233_472 // 2 - 1024
PASS_TILES = 8  # the any-width 3x3 layers' n8 tiles a pass (csrc/qconv.cuh kPassTiles)

# the order of the ints the kernels read (struct Plan in csrc/qconv.cuh)
PLAN_FIELDS = (
    "B", "H", "W", "Ho", "Wo", "cin", "cout", "nh",
    "d", "phases", "th", "tw", "n_rt", "n_ct", "halo_h", "halo_w",
    "nw", "nsteps", "row_step", "n_tiles",
    "smem", "off_w", "off_w0", "off_vec", "off_stage", "stage_bytes", "off_tile", "tile_bytes",
    "off_l0", "off_raw", "raw_bytes", "raw_row", "row_words", "align16",
    "H0", "W0", "pt0", "pl0", "pt1", "pl1", "l0h", "l0w", "inh", "inw", "c0", "in_kind",
    "in_row", "l0w_magic", "acc_wide", "stride", "ks", "pad_t", "pad_l", "f32", "packed",
    "generic", "off_koff",
)
IN_U8_RAW, IN_F32_RAW, IN_F32_NORM = 1, 2, 3


def _r16(n: int) -> int:
    return -(-n // 16) * 16


def _row_step(nw: int, stride: int) -> int:
    """How the 16 rows of an MMA tile map to its 16 pixels: rows g and g+8
    take pixels g and g+8 (1), or 2g and 2g+1 (2), whichever spreads a
    step's A loads over more shared-memory banks (``csrc/qconv.cuh``
    ``Conv3x3::RS``, which must agree).  With nw even a lane loads 8 bytes
    (two paired words) a row; with nw odd 4 bytes, and a pixel stride of 4
    mod 8 words starts the eight pixels of a row group on eight distinct
    4-bank groups."""
    if nw % 2 == 0:
        return 2 if stride == 2 and (2 * nw) % 8 == 4 else 1
    ws = nw * stride
    return 2 if ws % 8 != 4 and (2 * ws) % 8 == 4 else 1


def acc_mode(cin: int) -> int:
    """How the epilogue reads the accumulator of a 3x3 layer of ``cin``
    int8 input channels (``csrc/qconv.cuh``), by its bound 9 cin 127^2
    (the plan's ``acc_wide``, which the kernels' WIDE must agree with):

      * 0 below 2^22: the accumulator started at the bits of 1.5 * 2^23
        reads as that float plus acc, no conversion instruction (up to 28
        channels);
      * 1 below 2^24: the conversion instruction, exact (32 to 112);
      * 2 from 2^24 on (116 channels and more): the same instruction,
        which then rounds to nearest even as XLA's s32 -> f32 convert
        does, so the epilogue reads what the JAX package computes."""
    bound = 9 * cin * 127 * 127
    return 0 if bound < 1 << 22 else (1 if bound < 1 << 24 else 2)


def is_generic(kind: str, cin: int, cout: int, c0: int = 0, nh: int = 0) -> bool:
    """Whether a plan runs the any-width kernels: a width past the compiled
    instances' COMPILED_CHANNELS (the stem's c0 and c1, a layer's Cin and
    Cout, a head's logits)."""
    widths = {"stem": (c0, cout), "layer0": (cout,)}.get(kind, (cin, cout, nh))
    return max(widths) > COMPILED_CHANNELS


def _r32(n: int) -> int:
    return -(-n // 32) * 32


_TAPS_3X3 = tuple((ty, tx, 3 * ty + tx) for ty in range(3) for tx in range(3))
_TAPS_1X1 = ((1, 1, 0),)  # a 1x1 kernel read at the centre of a 3x3 window


def _k_order(nw: int, cin: int, cout: int, word_offset,
             taps=_TAPS_3X3, generic: bool = False) -> tuple[list, list, int]:
    """The MMA's K dimension as (tap, channel word) pairs, padded with zero
    weights to a whole number of 32-byte k steps.  K word j = 8 s + 4 r + t
    of step s is what lane t holds in register r of the A (and B) fragment.

      * nw even: the words are paired so that a lane's two words of a step
        are one 8-byte load: pair q = 4 s + t is tap q // (nw/2), channel
        words 2 (q % (nw/2)) + r, r = 0, 1;
      * nw odd, and every ``generic`` plan (the any-width kernels compute
        this order themselves, ``csrc/qconv.cuh`` k_offsets_any): K word
        j < 9 nw is tap j // nw, channel word j % nw.

    ``taps`` are (window row, window column, HWIO tap index): row-major in
    the 3x3 window, or the centre alone for a 1x1 kernel.  Returns, for
    each of the K words (at least ``MAX_K_WORDS``, the compiled instances'
    table), the shared-memory word offset of its A operand from a pixel's
    first tap (``word_offset(ty, tx, cw)``; 0 for padding, whose B words
    are zero) and the HWIO byte index of its B word's first channel at
    output 0 (-1 for padding), and the number of k steps."""
    n = len(taps)
    nsteps = -(-n * nw // 8)
    size = max(MAX_K_WORDS, 8 * nsteps)
    a_off, b_src = [0] * size, [-1] * size
    if nw % 2 == 0 and not generic:
        words = []
        for q in range(n * nw // 2):
            s, t = divmod(q, 4)
            tap, cp = divmod(q, nw // 2)
            words += [(8 * s + 4 * r + t, tap, 2 * cp + r) for r in (0, 1)]
    else:
        words = [(j, *divmod(j, nw)) for j in range(n * nw)]
    for j, tap, cw in words:
        ty, tx, k = taps[tap]
        a_off[j] = word_offset(ty, tx, cw)
        b_src[j] = (k * cin + 4 * cw) * cout
    return a_off, b_src, nsteps


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """What a kernel launch reads: ``fields`` (``PLAN_FIELDS``) and the K
    order.  ``kind`` is "conv" (``qconv``, ``qconv_head``) or "stem"."""

    kind: str
    fields: dict
    a_off: tuple
    b_src: tuple
    k0_off: tuple
    k0_src: tuple

    def __getattr__(self, name):
        try:
            return self.__dict__["fields"][name]
        except KeyError:
            raise AttributeError(name) from None

    @functools.cached_property
    def ints(self) -> np.ndarray:
        """The ints in the kernels' order (built once a plan): the fields,
        then the compiled instances' K table (its first MAX_K_WORDS words;
        a generic plan's kernels compute their K order themselves)."""
        return np.array([self.fields[f] for f in PLAN_FIELDS] + list(self.a_off[:MAX_K_WORDS])
                        + list(self.b_src[:MAX_K_WORDS]) + list(self.k0_off)
                        + list(self.k0_src), np.int32)

    def decode(self, tile: int) -> tuple:
        """Tile ``tile`` as the kernels decode it: (image, tile row origin,
        column origin, phase)."""
        f = self.fields
        ct, r = tile % f["n_ct"], tile // f["n_ct"]
        rt, r = r % f["n_rt"], r // f["n_rt"]
        ph, b = r % f["phases"], r // f["phases"]
        return b, rt * f["th"], ct * f["tw"], ph

    def tile_outputs(self, tile: int) -> tuple[int, np.ndarray, np.ndarray]:
        """(image, rows, columns) of the output pixels tile ``tile`` writes:
        the tile's rows (phase rows for a dilated conv) by its columns,
        those past the map left out, as the kernels mask them."""
        f = self.fields
        b, r0, x0, ph = self.decode(tile)
        rows = ph + f["d"] * (r0 + np.arange(f["th"]))
        cols = x0 + np.arange(f["tw"])
        return b, rows[rows < f["Ho"]], cols[cols < f["Wo"]]


@functools.lru_cache(maxsize=256)
def tile_plan(kind: str, B: int, H: int, W: int, cin: int, cout: int, *, dil: int = 1,
              c0: int = 0, nh: int = 0, in_kind: int = 0, stride: int = 1,
              ks: int = 3, packed: bool = False) -> TilePlan:
    """The launch plan of one kernel call (cached: a serving loop asks for
    the same few shapes, and building a plan takes tens of microseconds of
    host time).

    ``kind="conv"``: a 3x3 stride-1 int8 layer with dilation ``dil`` on a
    (B, H, W, cin) map to ``cout`` int8 channels, with a 1x1 head to ``nh``
    f32 logits when ``nh`` > 0 (phase-major, ``qconv_head``'s ``packed``,
    with ``packed``).  A dilated layer is split into ``d`` row
    phases (rows y = phase + d k): within a phase a tap's row offset is one
    phase row, so a tile of ``th`` phase rows reads ``th + 2`` halo rows at
    every dilation.  Columns stay contiguous (``tw`` wide, a multiple of
    16, with ``d`` halo columns each side), so a tile row is one contiguous
    run of NHWC bytes in and out.  Each warp takes 16-pixel runs of a tile
    row as the M of its MMA tiles.  A block is resident for the whole
    launch: it packs the weights once and walks the tiles blockIdx,
    blockIdx + gridDim, ..., staging the next tile's halo by cp.async into
    a second buffer while it computes the current one.

    ``kind="stem"``: layers 0 and 1 on a (B, H, W) image (``in_kind``:
    uint8 raw, f32 raw or f32 normalized) to ``c0`` and then ``cout``
    channels.  A block owns a ``th`` x ``tw`` tile of layer 1's output; it
    quantizes the (4 th + 3) x (4 tw + 3) input window into shared memory
    once, computes the (2 th + 1) x (2 tw + 1) layer-0 outputs layer 1
    reads (zero where they fall outside layer 0's map: layer 1's SAME
    padding), and convolves them.  The next tile's raw window (the image's
    bytes or floats) is staged by cp.async into a second buffer meanwhile;
    a uint8 row is copied as the aligned 4-byte words that hold it.

    The calibration's kinds, one layer alone with an f32 epilogue (``acc *
    ws + b`` and the exact ``(float)acc``):

      * ``kind="layer"``: an int8 (B, H, W, cin) map through a ``ks`` x
        ``ks`` kernel — 3x3 at ``stride`` 1 with dilation ``dil`` (the
        context layers, tiled as "conv"), 3x3 at stride 2 (layer 1: a tile
        of ``th`` x ``tw`` outputs reads 2 th + 1 halo rows of 2 tw + 1
        columns), or 1x1 (the head, read as the centre tap of a 3x3 window,
        its K one tap's words) — to ``cout`` <= 32 f32 channels; the
        kernel's f32 instances take four n8 tiles whatever ``cout``;
      * ``kind="layer0"``: layer 0 on a (B, H, W) image (``in_kind``) to
        ``cout`` channels: ``th`` x ``tw`` tiles of its outputs, each
        reading and quantizing its (2 th + 1) x (2 tw + 1) input window as
        the stem does.
    """
    if kind == "layer" and (stride not in (1, 2) or ks not in (1, 3)
                            or (dil != 1 and (stride != 1 or ks != 3))
                            or (ks == 1 and stride != 1)):
        raise ValueError(f"layer plan: stride {stride}, kernel {ks}x{ks}, dilation {dil}")
    if packed and (kind != "conv" or not nh or H % 2 or W % 2):
        raise ValueError(f"a packed store is the head's, on even maps: {kind}, nh={nh}, {H}x{W}")
    generic = is_generic(kind, cin, cout, c0, nh)
    f = dict.fromkeys(PLAN_FIELDS, 0)
    f.update(B=B, H=H, W=W, cin=cin, cout=cout, nh=nh, in_kind=in_kind, d=dil,
             packed=int(packed), generic=int(generic))
    nt = -(-cout // 8)
    # the per-channel vectors: ws, b, s_out and the next three (the head's
    # or layer 1's), each padded to 32 floats or, at any width, to a
    # multiple of 32
    vec = 6 * 32 * 4
    k0_off, k0_src = [0] * 16, [-1] * 16
    koff = 0  # generic: the K words' A offsets, computed by the kernel
    if kind in ("conv", "layer"):
        f32 = kind == "layer"
        if f32:
            nt, nh = (nt if generic else 4), 0  # the compiled f32 instances take every n8 tile
        else:
            stride, ks = 1, 3
        nw = cin // 4
        if stride == 1:
            Ho, Wo = H, W
            phases = min(dil, H)
            R = -(-H // dil)  # rows of the longest phase
        else:
            Ho, Wo = -(-H // 2), -(-W // 2)
            phases, R = 1, Ho
        taps = _TAPS_3X3 if ks == 3 else _TAPS_1X1
        nsteps_k = -(-len(taps) * nw // 8)
        if generic:
            vec = 4 * max(6 * 32, 3 * _r32(cout) + 2 * _r32(nh))
            koff = 4 * 8 * nsteps_k
            # a warp stages its two requantized runs: each at its
            # destination's address mod 16 for the contiguous store, or
            # (a head) as the head's A operand; f32 outputs go straight from
            # the registers
            stage = 0 if f32 else (2 * _r16(16 * cout) if nh else 2 * _r16(16 * cout) + 32)
            w0_bytes = -(-cout // 32) * -(-nh // 8) * 64 * 4 if nh else 0
        else:
            # a warp's staging: two int8 runs, or one int8 run and its
            # logits, or (f32) one run of f32 outputs
            stage = (_r16(64 * cout + 16) if f32 else
                     _r16(16 * cout) + (_r16(64 * nh + 16) if nh else _r16(16 * cout) + 32))
            w0_bytes = 4 * 64 * 4 if nh else 0
        fixed = (_r16(nsteps_k * nt * 256) + _r16(w0_bytes) + _r16(vec) + WARPS * stage
                 + _r16(koff))

        def halo_rows(th):
            return th + 2 if stride == 1 else 2 * th + 1

        def halo_cols(tw):
            return tw + 2 * dil if stride == 1 else 2 * tw + 1

        # the tile's columns: up to _MAX_TW, split evenly; at any width
        # narrower (down to 16) where a one-row tile's halos would not fit
        # two blocks an SM, or failing that one
        for limit in (SMEM_TWO_BLOCKS, SHARED_MEMORY_LIMIT) if generic else (SHARED_MEMORY_LIMIT,):
            for max_tw in (_MAX_TW, 64, 32, 16) if generic else (_MAX_TW,):
                n_ct = -(-Wo // max_tw)
                tw = _r16(-(-Wo // n_ct))
                if fixed + 2 * halo_rows(1) * _r16(halo_cols(tw) * cin + 15) <= limit:
                    break
            else:
                continue
            break
        halo_w = halo_cols(tw)
        # the tile's rows: three blocks an SM (any width: two), enough
        # tiles for the card, and the phase's rows split evenly (any width:
        # down to one row)
        min_th = 1 if generic else 2
        target = SMEM_TWO_BLOCKS if generic else _SMEM_TARGET
        th = min(_MAX_TH, R)
        while th > min_th and fixed + 2 * halo_rows(th) * _r16(halo_w * cin + 15) > target:
            th -= 1
        while th > 2 and B * phases * -(-R // th) * n_ct < _MIN_BLOCKS:
            th = -(-th // 2)
        th = -(-R // -(-R // th))
        halo_h = halo_rows(th)
        # a halo row in shared memory: whole 16-byte chunks, room for the
        # shift that matches the source's alignment (align16: every map row is
        # whole 16-byte chunks, so one shift serves the tile's rows)
        row_words = _r16(halo_w * cin + 15) // 4
        a_off, b_src, nsteps = _k_order(nw, cin, cout,
                                        lambda ty, tx, cw: ty * row_words + tx * dil * nw + cw,
                                        taps, generic)
        if ks == 1:
            pad_t = pad_l = 1  # the centre of the window is the output pixel
        else:
            pad_t, pad_l = same_pad(H, 3, stride, dil)[0], same_pad(W, 3, stride, dil)[0]
        f.update(phases=phases, n_rt=-(-R // th), n_ct=n_ct, halo_h=halo_h, halo_w=halo_w,
                 row_step=_row_step(nw, stride), row_words=row_words,
                 align16=int(W * cin % 16 == 0), acc_wide=acc_mode(cin), stride=stride, ks=ks,
                 pad_t=pad_t, pad_l=pad_l, f32=int(f32))
        # a halo buffer; the second also stages the compiled instances' raw
        # weights at block start (the any-width kernels pack them from
        # device memory)
        tile = halo_h * row_words * 4
        if not generic:
            tile = max(tile, _r16(ks * ks * cin * cout) + _r16(cout * nh))
        tiles, l0_bytes, raw_row, raw = 2 * tile, 0, 0, 0
    elif kind == "layer0":
        H0, W0 = -(-H // 2), -(-W // 2)
        Ho, Wo, nw, nsteps = H0, W0, 0, 0
        # a warp's staged run of f32 outputs
        stage = _r16(64 * cout + 16)
        if generic:
            vec = 4 * max(6 * 32, 2 * _r32(cout))
        a_off, b_src = [0] * MAX_K_WORDS, [-1] * MAX_K_WORDS
        tw = 64 if W0 > 32 else 32
        th = min(_MAX_TH, H0)
        while th > 2 and B * -(-H0 // th) * -(-W0 // tw) < _MIN_BLOCKS:
            th = -(-th // 2)
        inh, inw = 2 * th + 1, 2 * tw + 1
        in_row = -(-inw // 4) * 4
        for ty in range(3):  # K byte 4 ty + tx: window row ty, column tx (as "stem")
            for tx in range(4):
                k0_off[4 * ty + tx] = ty * in_row + tx
                k0_src[4 * ty + tx] = (3 * ty + tx) * cout if tx < 3 else -1
        pt0, pl0 = same_pad(H, 3, 2)[0], same_pad(W, 3, 2)[0]
        f.update(H0=H0, W0=W0, pt0=pt0, pl0=pl0, l0h=th, l0w=tw, inh=inh, inw=inw, c0=cout,
                 phases=1, n_rt=-(-H0 // th), n_ct=-(-W0 // tw), in_row=in_row,
                 l0w_magic=-(-(1 << 20) // tw), stride=2, ks=3, pad_t=pt0, pad_l=pl0, f32=1)
        w0_bytes, tile = -(-cout // 8) * 32 * 4, _r16(inh * in_row + 4)
        tiles, l0_bytes = tile, 0
        raw_row = _r16((1 if in_kind == IN_U8_RAW else 4) * inw + 15)
        raw = _r16(inh * raw_row)
    elif kind == "stem":
        H0, W0 = -(-H // 2), -(-W // 2)
        Ho, Wo = -(-H0 // 2), -(-W0 // 2)
        nw = c0 // 4
        # a 16- or 32-wide tile, whichever leaves fewer masked columns
        tw = min((16, 32), key=lambda t: (-(-Wo // t) * t, -t))
        th = min(_MAX_TH, Ho)
        while th > 2 and B * -(-Ho // th) * -(-Wo // tw) < _MIN_BLOCKS:
            th = -(-th // 2)
        nsteps_k = -(-9 * nw // 8)
        raw_px = 1 if in_kind == IN_U8_RAW else 4
        if generic:
            vec = 4 * max(6 * 32, 3 * _r32(c0) + 3 * _r32(cout))
            koff = 4 * 8 * nsteps_k
            # a warp stages one run of layer 1's requantized outputs at its
            # destination's address mod 16, for the contiguous store, where
            # one pass holds every channel; past that the kernel stores from
            # the registers
            stage = _r16(16 * cout) + 16 if cout <= 8 * PASS_TILES else 0

            def stem_smem(th):  # fragments, staging, the layer-0 tile, two raw windows
                l0h, l0w = 2 * th + 1, 2 * tw + 1
                inh, inw = 2 * l0h + 1, 2 * l0w + 1
                return (_r16(nsteps_k * nt * 256) + _r16(-(-c0 // 8) * 128) + _r16(vec)
                        + WARPS * stage + _r16(koff) + _r16(inh * (-(-inw // 4) * 4) + 4)
                        + _r16(_r16(l0h * l0w) * c0) + 2 * _r16(inh * _r16(raw_px * inw + 15)))

            # the tile's rows: two blocks an SM (the kernel's launch bound)
            # where fewer rows fit them and still give every warp a run of
            # layer 1, else one block of as many rows as fit
            for limit in (SMEM_TWO_BLOCKS, SHARED_MEMORY_LIMIT):
                t_h = th
                while t_h > 1 and stem_smem(t_h) > limit:
                    t_h -= 1
                if stem_smem(t_h) <= limit and (t_h == th or t_h * (tw // 16) >= WARPS):
                    break
            th = t_h
        else:
            stage = _r16(16 * cout) + 16  # a warp's staged run, as above
        l0h, l0w = 2 * th + 1, 2 * tw + 1
        inh, inw = 2 * l0h + 1, 2 * l0w + 1
        in_row = -(-inw // 4) * 4  # the quantized window's row stride, whole words
        a_off, b_src, nsteps = _k_order(nw, c0, cout,
                                        lambda ty, tx, cw: (ty * l0w + tx) * nw + cw,
                                        generic=generic)
        # layer 0's K: byte 4 ty + tx is window row ty, column tx; column 3
        # and row 3 have zero weights, so a lane's A word is one row's bytes
        for ty in range(3):
            for tx in range(4):
                k0_off[4 * ty + tx] = ty * in_row + tx
                k0_src[4 * ty + tx] = (3 * ty + tx) * c0 if tx < 3 else -1
        f.update(H0=H0, W0=W0, pt0=same_pad(H, 3, 2)[0], pl0=same_pad(W, 3, 2)[0],
                 pt1=same_pad(H0, 3, 2)[0], pl1=same_pad(W0, 3, 2)[0], l0h=l0h, l0w=l0w,
                 inh=inh, inw=inw, c0=c0, phases=1, n_rt=-(-Ho // th), n_ct=-(-Wo // tw),
                 row_step=_row_step(nw, 2), in_row=in_row, acc_wide=acc_mode(c0),
                 l0w_magic=-(-(1 << 20) // l0w))  # pix // l0w == pix * magic >> 20
        # the window, and one word past it that a gather's second load may touch
        w0_bytes, tile = -(-c0 // 8) * 32 * 4, _r16(inh * in_row + 4)
        # the layer-0 tile (any width: whole 16-pixel runs, which its
        # kernel's layer 0 writes without a branch) also stages the compiled
        # instances' layer-1 raw weights at block start
        tiles = tile
        l0_bytes = _r16(l0h * l0w) * c0 if generic else max(l0h * l0w * c0, 9 * c0 * cout)
        # a raw window row: the aligned 16-byte blocks holding inw pixels
        raw_row = _r16(raw_px * inw + 15)
        raw = _r16(inh * raw_row)
    else:
        raise ValueError(f"unknown plan kind {kind!r}")
    # shared memory, each region 16-byte aligned
    off = 0
    regions = {}
    for name, size in (("off_w", nsteps * nt * 64 * 4), ("off_w0", w0_bytes), ("off_vec", vec),
                       ("off_stage", WARPS * stage), ("off_tile", tiles), ("off_l0", l0_bytes),
                       ("off_raw", 2 * raw), ("off_koff", koff)):
        regions[name] = off
        off += _r16(size)
    f.update(regions, Ho=Ho, Wo=Wo, th=th, tw=tw, nw=nw, nsteps=nsteps, stage_bytes=stage,
             tile_bytes=tile, raw_bytes=raw, raw_row=raw_row, smem=off)
    f["n_tiles"] = B * f["phases"] * f["n_rt"] * f["n_ct"]
    return TilePlan(kind, f, tuple(a_off), tuple(b_src), tuple(k0_off), tuple(k0_src))


def pack_fragments(q: np.ndarray, plan: TilePlan) -> np.ndarray:
    """The B fragments a kernel packs at block start from the HWIO int8
    kernel ``q`` (3, 3, Cin, Cout) of a plan's 3x3 int8-input layer, as
    (k step, n tile, lane, register) int32 words: lane (g, t) = (lane // 4,
    lane % 4) holds K words 8 step + 4 register + t of output channel
    8 n + g, four input channels a word, the lowest channel in the lowest
    byte; zero past Cout and in the padding."""
    cout = q.shape[-1]
    flat = q.reshape(-1).view(np.uint8).astype(np.uint32)
    nt = -(-cout // 8)
    out = np.zeros((plan.nsteps, nt, 32, 2), np.uint32)
    for s, n, lane, r in np.ndindex(out.shape):
        j, co = 8 * s + 4 * r + lane % 4, 8 * n + lane // 4
        src = plan.b_src[j]
        if src >= 0 and co < cout:
            idx = src + co + cout * np.arange(4)
            out[s, n, lane, r] = np.bitwise_or.reduce(flat[idx] << (8 * np.arange(4, dtype=np.uint32)))
    return out.view(np.int32)


# ---------------------------------------------------------------------------
# The wrappers
# ---------------------------------------------------------------------------

_PLAN = _build.P  # a host pointer to the plan's int32s
_FUNCS_CONV = {"qconv_tc": [_build.P] * 9 + [_PLAN, _build.I, _build.P],
               "qconv_plan_ints": []}
_FUNCS_STEM = {"qstem_tc": [_build.P] * 10 + [_PLAN, _build.I, _build.P],
               "qconv_plan_ints": []}


def _check_layer(layer: dict, name: str, dev, ks: int, cin: int | None = None) -> tuple[int, int]:
    q = layer["q"]
    _build.check_input(q, f"{name}.q", torch.int8, 4, dev)
    if tuple(q.shape[:2]) != (ks, ks) or (cin is not None and q.shape[2] != cin):
        raise ValueError(f"{name}: kernel {tuple(q.shape)}, expected ({ks}, {ks}, {cin}, Cout)")
    cout = q.shape[3]
    for key in ("ws", "b"):
        _build.check_input(layer[key], f"{name}.{key}", torch.float32, 1, dev)
        if layer[key].shape[0] != cout:
            raise ValueError(f"{name}.{key}: expected ({cout},), got {tuple(layer[key].shape)}")
    return q.shape[2], cout


def _check_scale(s: torch.Tensor, name: str, cout: int, dev) -> None:
    _build.check_input(s, name, torch.float32, 1, dev)
    if s.shape[0] != cout:
        raise ValueError(f"{name}: expected ({cout},), got {tuple(s.shape)}")


def _r4(n: int) -> int:
    return -(-n // 4) * 4


def pad_channels(x: torch.Tensor, c: int) -> torch.Tensor:
    """NHWC ``x`` with zero channels appended up to ``c`` (the tensor
    itself when it has them)."""
    n = x.shape[-1]
    if n == c:
        return x
    return torch.cat([x, x.new_zeros(x.shape[:-1] + (c - n,))], dim=-1)


def pad_layer(layer: dict, cin: int, cout: int) -> dict:
    """A quantized layer padded to ``cin`` input and ``cout`` output
    channels, as the kernels take a count that is not a multiple of 4: zero
    int8 weights on both axes, and for the padded outputs ws = 1, b = 0, so
    that with ``pad_scale``'s s_out = 1 they hold exact zeros (acc 0 ->
    y 0 -> int8 0), which the next layer's zero weights then ignore."""
    q = layer["q"]
    if q.shape[2] == cin and q.shape[3] == cout:
        return layer
    qp = q.new_zeros(q.shape[:2] + (cin, cout))
    qp[:, :, : q.shape[2], : q.shape[3]] = q
    n = cout - q.shape[3]
    return dict(q=qp, ws=torch.cat([layer["ws"], layer["ws"].new_ones(n)]),
                b=torch.cat([layer["b"], layer["b"].new_zeros(n)]))


def pad_scale(s: torch.Tensor, c: int) -> torch.Tensor:
    """A requantization scale padded with 1 up to ``c`` channels."""
    return s if s.shape[0] == c else torch.cat([s, s.new_ones(c - s.shape[0])])


_PLAN_CHECKED: set = set()  # libraries whose struct Plan matches PLAN_FIELDS


def _launch(lib_name: str, funcs: dict, fn: str, dev, plan: TilePlan, *ptrs) -> None:
    lib = _build.load(lib_name, funcs)
    arr = plan.ints
    if lib_name not in _PLAN_CHECKED:
        if lib.qconv_plan_ints() != arr.size:
            raise RuntimeError(f"{lib_name}: the kernel reads {lib.qconv_plan_ints()} plan ints, "
                               f"the plan has {arr.size}")
        _PLAN_CHECKED.add(lib_name)
    if plan.smem > SHARED_MEMORY_LIMIT:
        raise NotImplementedError(f"{fn}: a block needs {plan.smem} B of shared memory, more "
                                  f"than the card's {SHARED_MEMORY_LIMIT}")
    _build.launch(lib, fn, dev, *ptrs, arr.ctypes.data, arr.size)


def qconv(x: torch.Tensor, layer: dict, s_out: torch.Tensor, dil: int) -> torch.Tensor:
    """One context layer of the int8 trunk: int8 (B, H, W, Cin) -> the 3x3
    stride-1 ``layer`` with dilation ``dil`` ({q: HWIO int8 (3, 3, Cin,
    Cout), ws, b: f32 (Cout,)}), requantized by ``s_out`` -> int8 (B, H, W,
    Cout), on the tensor cores.  A CPU tensor takes ``qconv_reference``."""
    if x.device.type == "cpu":
        return qconv_reference(x, layer, s_out, 1, dil)
    dev = x.device
    _build.check_input(x, "x", torch.int8, 4)
    cin, cout = _check_layer(layer, "layer", dev, 3, x.shape[-1])
    _check_scale(s_out, "s_out", cout, dev)
    ci, co = _r4(cin), _r4(cout)
    x, layer, s_out = pad_channels(x, ci), pad_layer(layer, ci, co), pad_scale(s_out, co)
    B, H, W = x.shape[:3]
    plan = tile_plan("conv", B, H, W, ci, co, dil=dil)
    out = torch.empty((B, H, W, co), dtype=torch.int8, device=dev)
    _launch("qconv_kernel", _FUNCS_CONV, "qconv_tc", dev, plan, x.data_ptr(), layer["q"].data_ptr(),
            layer["ws"].data_ptr(), layer["b"].data_ptr(), s_out.data_ptr(), None, None, None,
            out.data_ptr())
    qconv.launches += 1
    return out if co == cout else out[..., :cout].contiguous()


qconv.launches = 0


def qconv_head(x: torch.Tensor, layer: dict, s_out: torch.Tensor, dil: int,
               head: dict, packed: bool = False) -> torch.Tensor:
    """The last context layer and the head in one launch: int8 (B, H, W,
    Cin) -> the 3x3 stride-1 layer with dilation ``dil``, requantized by
    ``s_out`` -> the 1x1 ``head`` -> f32 logits (B, H, W, O), or with
    ``packed`` (H, W even) the phase-major (B, H/2, W/2, 4 O) that the
    packed int8 route hands to its postprocessing: the same epilogue, the
    store's addresses only.  The requantized tile is the head's A operand
    in shared memory and never reaches device memory.  A CPU tensor takes
    ``qconv_head_reference``.  ``launches_packed`` counts the packed
    launches (also counted in ``launches``)."""
    if x.device.type == "cpu":
        return qconv_head_reference(x, layer, s_out, dil, head, packed)
    dev = x.device
    _build.check_input(x, "x", torch.int8, 4)
    cin, cout = _check_layer(layer, "layer", dev, 3, x.shape[-1])
    c_h, nh = _check_layer(head, "head", dev, 1, cout)
    _check_scale(s_out, "s_out", cout, dev)
    ci, co = _r4(cin), _r4(cout)
    x, layer, s_out = pad_channels(x, ci), pad_layer(layer, ci, co), pad_scale(s_out, co)
    head = pad_layer(head, co, nh)
    B, H, W = x.shape[:3]
    plan = tile_plan("conv", B, H, W, ci, co, dil=dil, nh=nh, packed=packed)
    shape = (B, H // 2, W // 2, 4 * nh) if packed else (B, H, W, nh)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    _launch("qconv_kernel", _FUNCS_CONV, "qconv_tc", dev, plan, x.data_ptr(), layer["q"].data_ptr(),
            layer["ws"].data_ptr(), layer["b"].data_ptr(), s_out.data_ptr(), head["q"].data_ptr(),
            head["ws"].data_ptr(), head["b"].data_ptr(), out.data_ptr())
    qconv_head.launches += 1
    qconv_head.launches_packed += int(packed)
    return out


qconv_head.launches = 0
qconv_head.launches_packed = 0


def qstem(x: torch.Tensor, layer0: dict, s1: torch.Tensor, layer1: dict, s2: torch.Tensor,
          raw_gray: bool = False) -> torch.Tensor:
    """Layers 0 and 1 of the int8 trunk in one launch: the image — raw
    grayscale (B, H, W) uint8 or f32 with ``raw_gray``, else normalized f32
    (B, H, W[, 1]) — quantized, layer 0 (3x3 stride 2, requantized by
    ``s1``), layer 1 (3x3 stride 2, by ``s2``) -> int8 (B, H/4, W/4, C1).
    Layer 0's map never reaches device memory.  A CPU tensor takes
    ``qstem_reference``."""
    if x.device.type == "cpu":
        return qstem_reference(x, layer0, s1, layer1, s2, raw_gray)
    dev = x.device
    if x.ndim == 4 and x.shape[-1] == 1:
        x = x[..., 0]
    if x.dtype == torch.uint8 and not raw_gray:
        raise ValueError("a uint8 image is raw grayscale: pass raw_gray=True")
    _build.check_input(x, "x", x.dtype if x.dtype == torch.uint8 else torch.float32, 3)
    _, c0 = _check_layer(layer0, "layer0", dev, 3, 1)
    _, cout = _check_layer(layer1, "layer1", dev, 3, c0)
    _check_scale(s1, "s1", c0, dev)
    _check_scale(s2, "s2", cout, dev)
    c0, c1 = _r4(c0), _r4(cout)
    layer0, s1 = pad_layer(layer0, 1, c0), pad_scale(s1, c0)
    layer1, s2 = pad_layer(layer1, c0, c1), pad_scale(s2, c1)
    kind = IN_U8_RAW if x.dtype == torch.uint8 else (IN_F32_RAW if raw_gray else IN_F32_NORM)
    B, H, W = x.shape
    plan = tile_plan("stem", B, H, W, 1, c1, c0=c0, in_kind=kind)
    out = torch.empty((B, plan.Ho, plan.Wo, c1), dtype=torch.int8, device=dev)
    _launch("qstem_kernel", _FUNCS_STEM, "qstem_tc", dev, plan, x.data_ptr(),
            layer0["q"].data_ptr(), layer0["ws"].data_ptr(), layer0["b"].data_ptr(), s1.data_ptr(),
            layer1["q"].data_ptr(), layer1["ws"].data_ptr(), layer1["b"].data_ptr(), s2.data_ptr(),
            out.data_ptr())
    qstem.launches += 1
    return out if c1 == cout else out[..., :cout].contiguous()


qstem.launches = 0


_FUNCS_CONV_F32 = {"qconv_tc_f32": [_build.P] * 6 + [_PLAN, _build.I, _build.P],
                   "qrequant": [_build.P] * 5 + [_build.L, _build.I, _build.P],
                   "qconv_plan_ints": []}
_FUNCS_LAYER0 = {"qlayer0_tc": [_build.P] * 6 + [_PLAN, _build.I, _build.P],
                 "qconv_plan_ints": []}


def qconv_layer_f32(x: torch.Tensor, layer: dict, stride: int, dil: int,
                    with_acc: bool = True) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One layer of the int8 trunk alone, as the bias correction reads it:
    ``x`` int8 NHWC activations, or for layer 0 the normalized f32 image
    (B, H, W[, 1]); a 3x3 kernel with ``stride`` and ``dil``, or the 1x1
    head.  Returns the f32 pre-activation ``acc * ws + b`` (one rounding)
    and, with ``with_acc``, the exact accumulator as f32 (else None), both
    (B, Ho, Wo, Cout), from one pass over the input: on the card one
    launch (``qlayer0_tc`` for layer 0, ``qconv_tc_f32`` for the others),
    on the CPU ``qconv_acc_reference`` and ``requantize_reference``.
    ``launches_layer0`` counts layer 0's launches (also counted in
    ``launches``)."""
    if x.device.type == "cpu":
        acc = qconv_acc_reference(x, layer, stride, dil)
        y = requantize_reference(acc, layer["ws"], layer["b"], None)
        return y, acc if with_acc else None
    dev = x.device
    _build.check_input(layer["q"], "layer.q", torch.int8, 4, dev)
    ks, _, cin, cout = layer["q"].shape
    if ks not in (1, 3):
        raise ValueError(f"kernel {tuple(layer['q'].shape)}: expected 3x3 or 1x1")
    if x.dtype == torch.int8:
        _build.check_input(x, "x", torch.int8, 4)
        _check_layer(layer, "layer", dev, ks, x.shape[-1])
        cin = _r4(cin)  # f32 outputs: any count
        x, layer = pad_channels(x, cin), pad_layer(layer, cin, cout)
        B, H, W = x.shape[:3]
        plan = tile_plan("layer", B, H, W, cin, cout, dil=dil, stride=stride, ks=ks)
        lib, funcs, fn = "qconv_kernel", _FUNCS_CONV_F32, "qconv_tc_f32"
    else:
        if x.ndim == 4 and x.shape[-1] == 1:
            x = x[..., 0]
        _build.check_input(x, "x", torch.float32, 3)
        if ks != 3 or stride != 2 or dil != 1:
            raise ValueError(f"layer 0 is 3x3 stride 2, got a kernel {tuple(layer['q'].shape)}, "
                             f"stride {stride}, dilation {dil}")
        _check_layer(layer, "layer", dev, 3, 1)
        B, H, W = x.shape
        plan = tile_plan("layer0", B, H, W, 1, cout, in_kind=IN_F32_NORM)
        lib, funcs, fn = "qstem_kernel", _FUNCS_LAYER0, "qlayer0_tc"
    y = torch.empty((B, plan.Ho, plan.Wo, cout), dtype=torch.float32, device=dev)
    acc = torch.empty_like(y) if with_acc else None
    _launch(lib, funcs, fn, dev, plan, x.data_ptr(), layer["q"].data_ptr(), layer["ws"].data_ptr(),
            layer["b"].data_ptr(), y.data_ptr(), None if acc is None else acc.data_ptr())
    qconv_layer_f32.launches += 1
    qconv_layer_f32.launches_layer0 += int(fn == "qlayer0_tc")
    return y, acc


qconv_layer_f32.launches = 0
qconv_layer_f32.launches_layer0 = 0


def requantize(acc: torch.Tensor, ws: torch.Tensor, b: torch.Tensor,
               s_out: torch.Tensor) -> torch.Tensor:
    """A layer's exact accumulators (f32 (..., C), ``qconv_layer_f32``)
    requantized: ``clamp(round(ReLU(acc * ws + b) * s_out), -127, 127)`` as
    int8, the product and sum rounded once.  On the card ``qrequant``; on
    the CPU ``requantize_reference``."""
    if acc.device.type == "cpu":
        return requantize_reference(acc, ws, b, s_out)
    dev = acc.device
    C = acc.shape[-1]
    _build.check_input(acc, "acc", torch.float32, acc.ndim, dev)
    for name, v in (("ws", ws), ("b", b), ("s_out", s_out)):
        _check_scale(v, name, C, dev)
    out = torch.empty(acc.shape, dtype=torch.int8, device=dev)
    n_pix = acc.numel() // C
    if n_pix:
        lib = _build.load("qconv_kernel", _FUNCS_CONV_F32)
        _build.launch(lib, "qrequant", dev, acc.data_ptr(), ws.data_ptr(), b.data_ptr(),
                      s_out.data_ptr(), out.data_ptr(), n_pix, C)
        requantize.launches += 1
    return out


requantize.launches = 0
