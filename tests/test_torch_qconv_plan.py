"""PyTorch port: the int8 trunk's launch plan (``ops/cuda/qconv_kernel.py``
``tile_plan``) and the plain versions of its fused launches, on the CPU.

The kernels (``csrc/qstem_kernel.cu``, ``csrc/qconv_kernel.cu``) take
every index from the plan: tiles and halos, the row phases of a dilated
layer, the (tap, channel word) order of the MMA's K dimension with its
zero padding, the shared-memory regions.  Held here:

  * every output pixel of every layer of the asset's config is written by
    exactly one block, at the main path's, the stream's, the scans' and
    odd map sizes, one image or a few;
  * each block's shared memory fits the H100's 227 KB;
  * the K order, unpacked from the fragments the kernels pack, gives back
    the HWIO weights, and each K word's A offset names the same tap and
    channel word as its B word;
  * a numpy walk of the plans as the kernels walk them (halo, A gather by
    offset, B fragments, the MMA row maps, the epilogue's 1.5 * 2^23
    rounding, the staged runs) equals the plain versions bit for bit, and
    the epilogue's conversion-free read is used only inside its window
    (saturated 32-channel layers convert);
  * the plain versions of ``qstem`` and ``qconv_head`` equal the jitted
    JAX chains (``_quantize_input`` -> ``_qconv`` x2; ``_qconv`` -> the
    head) bit for bit;
  * the calibration's kinds — a layer alone with the f32 epilogue
    ("layer": 3x3 at stride 1 or 2, the 1x1 head) and layer 0 alone
    ("layer0") — get the same checks: coverage, shared memory, K order, and
    a walk whose pre-activations and accumulators equal ``qconv_layer_f32``'s
    plain version bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ubdvss_tpu.ops import quant as jq
from ubdvss_tpu_torch.ops.cuda import qconv_kernel as qk

torch.set_num_threads(1)

DILATIONS = (1, 1, 2, 4, 8, 16, 1)  # the asset's config (assets/pretrained_synthetic.npz)
MAPS = {"qvga-60x80": (60, 80), "main-128": (128, 128), "scan-512": (512, 512),
        "scan-1024": (1024, 1024), "odd-19x26": (19, 26)}
IMAGES = {"qvga-240x320": (240, 320), "main-512": (512, 512), "scan-2048": (2048, 2048),
          "scan-4096": (4096, 4096), "odd-75x101": (75, 101)}


def _coverage(plan):
    seen = np.zeros((plan.B, plan.Ho, plan.Wo), np.int32)
    for tile in range(plan.n_tiles):
        b, rows, cols = plan.tile_outputs(tile)
        seen[b, rows[:, None], cols[None, :]] += 1
    return seen


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("name", sorted(MAPS))
def test_conv_plan_covers_each_output_once(name, B):
    H, W = MAPS[name]
    for d in sorted(set(DILATIONS)):
        for nh in (0, 17):
            plan = qk.tile_plan("conv", B, H, W, 24, 24, dil=d, nh=nh)
            assert (_coverage(plan) == 1).all(), (d, nh)
            assert plan.phases == min(d, H) and plan.halo_h == plan.th + 2


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("name", sorted(IMAGES))
def test_stem_plan_covers_each_output_once(name, B):
    H, W = IMAGES[name]
    plan = qk.tile_plan("stem", B, H, W, 1, 24, c0=24, in_kind=qk.IN_U8_RAW)
    assert (plan.Ho, plan.Wo) == (-(-(-(-H // 2)) // 2), -(-(-(-W // 2)) // 2))
    assert (_coverage(plan) == 1).all()
    # the layer-0 tile is what layer 1's tile reads, the input window what layer 0's reads
    assert (plan.l0h, plan.l0w) == (2 * plan.th + 1, 2 * plan.tw + 1)
    assert (plan.inh, plan.inw) == (2 * plan.l0h + 1, 2 * plan.l0w + 1)


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("name", sorted(MAPS))
def test_layer_plans_cover_each_output_once(name, B):
    """The calibration's kinds: every context dilation, the stride-2 layer 1
    (on the map as layer 0's output) and the 1x1 head; layer 0 on the
    image twice the map's size."""
    H, W = MAPS[name]
    for d in sorted(set(DILATIONS)):
        plan = qk.tile_plan("layer", B, H, W, 24, 24, dil=d)
        assert (_coverage(plan) == 1).all(), d
        assert plan.halo_h == plan.th + 2 and plan.pad_t == plan.pad_l == d and plan.f32 == 1
    plan = qk.tile_plan("layer", B, H, W, 24, 24, stride=2)
    assert (plan.Ho, plan.Wo) == (-(-H // 2), -(-W // 2)) and (_coverage(plan) == 1).all()
    assert (plan.halo_h, plan.halo_w) == (2 * plan.th + 1, 2 * plan.tw + 1)
    plan = qk.tile_plan("layer", B, H, W, 24, 17, ks=1)
    assert (_coverage(plan) == 1).all() and plan.nsteps == 1
    plan = qk.tile_plan("layer0", B, 2 * H - 1, 2 * W, 1, 24, in_kind=qk.IN_F32_NORM)
    assert (plan.Ho, plan.Wo) == (H, W) and (_coverage(plan) == 1).all()
    assert (plan.inh, plan.inw) == (2 * plan.th + 1, 2 * plan.tw + 1)
    p = np.arange(plan.th * plan.tw + 16)
    np.testing.assert_array_equal((p * plan.l0w_magic) >> 20, p // plan.tw)


def test_layer_plan_refuses_what_no_kernel_runs():
    for kw in ({"stride": 3}, {"ks": 5}, {"stride": 2, "dil": 2}, {"ks": 1, "dil": 2},
               {"ks": 1, "stride": 2}):
        with pytest.raises(ValueError):
            qk.tile_plan("layer", 1, 16, 16, 24, 24, **kw)


@pytest.mark.parametrize("cin,cout,nh", [(24, 24, 17), (32, 32, 32), (4, 4, 1), (8, 8, 5)])
def test_plans_fit_shared_memory(cin, cout, nh):
    for H, W in list(MAPS.values()) + [(1, 4096), (4096, 1), (33, 47)]:
        for d in (1, 2, 16, 64):
            for h in (0, nh):
                plan = qk.tile_plan("conv", 2, H, W, cin, cout, dil=d, nh=h)
                assert plan.smem <= qk.SHARED_MEMORY_LIMIT, (H, W, d, h, plan.smem)
                assert all(plan.fields[k] % 16 == 0 for k in qk.PLAN_FIELDS if k.startswith("off_"))
    for H, W in list(IMAGES.values()) + [(3, 3), (1, 9000)]:
        plan = qk.tile_plan("stem", 2, H, W, 1, cout, c0=cin, in_kind=qk.IN_F32_RAW)
        assert plan.smem <= qk.SHARED_MEMORY_LIMIT, (H, W, plan.smem)
        plan = qk.tile_plan("layer0", 2, H, W, 1, cout, in_kind=qk.IN_F32_NORM)
        assert plan.smem <= qk.SHARED_MEMORY_LIMIT, (H, W, plan.smem)
    for H, W in list(MAPS.values()) + [(1, 4096), (4096, 1), (33, 47)]:
        for kw in ({"dil": 1}, {"dil": 16}, {"dil": 64}, {"stride": 2}, {"ks": 1}):
            plan = qk.tile_plan("layer", 2, H, W, cin, nh if kw.get("ks") == 1 else cout, **kw)
            assert plan.smem <= qk.SHARED_MEMORY_LIMIT, (H, W, kw, plan.smem)


def test_plan_fields_match_the_kernels_struct():
    """The kernels read the plan's ints through struct Plan (csrc/qconv.cuh):
    the same fields in the same order, then the four K-order arrays."""
    import re
    from pathlib import Path

    src = (Path(qk.__file__).resolve().parents[2] / "csrc" / "qconv.cuh").read_text()
    body = re.search(r"struct Plan \{(.*?)\};", src, re.S).group(1)
    names = [n.strip() for line in body.splitlines()
             for n in re.sub(r"//.*", "", line).replace("int ", "").replace(";", "").split(",")
             if n.strip()]
    assert names[: len(qk.PLAN_FIELDS)] == list(qk.PLAN_FIELDS)
    assert names[len(qk.PLAN_FIELDS):] == ["a_off[kMaxKWords]", "b_src[kMaxKWords]",
                                           "k0_off[16]", "k0_src[16]"]
    plan = qk.tile_plan("stem", 1, 20, 20, 1, 8, c0=8, in_kind=qk.IN_U8_RAW)
    assert plan.ints.size == len(qk.PLAN_FIELDS) + 2 * qk.MAX_K_WORDS + 32


def _k_words(nw):
    """K word -> (tap, channel word), as the plan documents the order: with
    nw even, lane t's words t and 4+t of step s are channel words 2c, 2c+1
    of one tap (pair 4 s + t); with nw odd, word j is (j // nw, j % nw)."""
    if nw % 2:
        return {j: divmod(j, nw) for j in range(9 * nw)}
    out = {}
    for q in range(9 * nw // 2):
        s, t = divmod(q, 4)
        tap, cp = divmod(q, nw // 2)
        out[8 * s + t], out[8 * s + 4 + t] = (tap, 2 * cp), (tap, 2 * cp + 1)
    return out


def _unpack(frags, plan, cin, cout):
    """HWIO weights back from the kernels' B fragments and the K order; the
    padding's words must be zero."""
    q = np.zeros((3, 3, cin, cout), np.int8)
    words = _k_words(cin // 4)
    raw = frags.view(np.uint32)
    for s, n, lane, r in np.ndindex(raw.shape):
        j, co = 8 * s + 4 * r + lane % 4, 8 * n + lane // 4
        word = raw[s, n, lane, r]
        if j not in words or co >= cout:
            assert word == 0 and (co >= cout or plan.b_src[j] == -1)
            continue
        tap, cw = words[j]
        for k in range(4):
            q[tap // 3, tap % 3, 4 * cw + k, co] = np.uint8((word >> (8 * k)) & 0xFF).view(np.int8)
    return q


@pytest.mark.parametrize("kind", ["conv", "stem"])
@pytest.mark.parametrize("cin,cout", [(24, 24), (8, 8), (4, 8), (32, 32), (16, 12), (12, 4)])
def test_k_order_unpacks_to_the_hwio_weights(kind, cin, cout):
    rng = np.random.default_rng(cin * 33 + cout)
    q = rng.integers(-127, 128, (3, 3, cin, cout)).astype(np.int8)
    if kind == "conv":
        plan = qk.tile_plan("conv", 2, 40, 50, cin, cout, dil=3)
        width, d = plan.halo_w, plan.d
    else:
        plan = qk.tile_plan("stem", 2, 40, 50, 1, cout, c0=cin, in_kind=qk.IN_F32_NORM)
        width, d = plan.l0w, 1
    nw = cin // 4
    assert plan.nsteps == -(-9 * nw // 8) and plan.nw == nw
    frags = qk.pack_fragments(q, plan)
    assert frags.shape == (plan.nsteps, -(-cout // 8), 32, 2)
    np.testing.assert_array_equal(_unpack(frags, plan, cin, cout), q)
    # A and B name the same (tap, channel word) for every K word; paired
    # words are adjacent, so one 8-byte load (8-byte aligned) fetches both
    words = _k_words(nw)
    for j in range(8 * plan.nsteps):
        if j not in words:
            assert plan.b_src[j] == -1 and plan.a_off[j] == 0
            continue
        tap, cw = words[j]
        assert plan.b_src[j] == (tap * cin + 4 * cw) * cout
        row = plan.row_words if kind == "conv" else width * nw
        assert plan.a_off[j] == (tap // 3) * row + (tap % 3) * d * nw + cw
        if nw % 2 == 0 and j % 8 < 4:
            assert plan.a_off[j] % 2 == 0 and plan.a_off[j + 4] == plan.a_off[j] + 1


@pytest.mark.parametrize("cin,cout", [(24, 17), (8, 8), (4, 1), (32, 32), (12, 5)])
def test_1x1_k_order_is_the_window_centre(cin, cout):
    """The head alone ("layer", ks=1): K is one tap's words, read at the
    centre of a 3x3 window (pad 1), in ceil(nw/8) steps; unpacked from the
    fragments, the 1x1 HWIO weights come back."""
    rng = np.random.default_rng(cin + 7 * cout)
    q = rng.integers(-127, 128, (1, 1, cin, cout)).astype(np.int8)
    plan = qk.tile_plan("layer", 2, 30, 40, cin, cout, ks=1)
    nw = cin // 4
    assert plan.nsteps == -(-nw // 8) and plan.pad_t == plan.pad_l == 1 and plan.d == 1
    bmat = _bmatrix(qk.pack_fragments(q, plan), plan.nsteps)
    for j in range(8 * plan.nsteps):
        if plan.b_src[j] == -1:
            assert plan.a_off[j] == 0 and not bmat[j].any()
            continue
        cw = (plan.a_off[j] - plan.row_words - nw) % nw
        assert plan.a_off[j] == plan.row_words + nw + cw  # window row 1, column 1
        assert plan.b_src[j] == 4 * cw * cout
        np.testing.assert_array_equal(bmat[j, :, :cout], q[0, 0, 4 * cw : 4 * cw + 4])


def test_layer0_k_order_is_window_rows():
    """Layer 0's K byte 4 ty + tx is window row ty, column tx: a lane's A word
    is four bytes of one row, the fourth (and the fourth row) zero-weighted."""
    plan = qk.tile_plan("stem", 1, 75, 101, 1, 24, c0=24, in_kind=qk.IN_U8_RAW)
    assert plan.in_row % 4 == 0 and plan.in_row >= plan.inw
    for k in range(16):
        ty, tx = divmod(k, 4)
        if ty < 3 and tx < 3:
            assert plan.k0_src[k] == (3 * ty + tx) * 24 and plan.k0_off[k] == ty * plan.in_row + tx
        else:
            assert plan.k0_src[k] == -1
    # the magic division the kernel uses for a layer-0 pixel's row
    p = np.arange(plan.l0h * plan.l0w + 16)
    np.testing.assert_array_equal((p * plan.l0w_magic) >> 20, p // plan.l0w)


# --- a numpy walk of the plans, as the kernels walk them ---------------------

_MAGIC = np.float32(12582912.0)


def _fma32(a, b, c):
    """fmaf: the exact f64 product plus c, rounded once to f32."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64) + np.asarray(c, np.float64)).astype(np.float32)


def _acc_float(acc, wide=0):
    """The kernels' (float)acc: the MMA's sum started at the bits of
    1.5 * 2^23, read as a float, minus 1.5 * 2^23; with ``wide`` (the
    plan's acc_wide) converted as an integer instead."""
    if wide:
        return acc.astype(np.float32)
    return (acc.astype(np.int64) + 0x4B400000).astype(np.int32).view(np.float32) - _MAGIC


def _round_int8(v):
    """clamp to +-127, then v + 1.5 * 2^23 in f32: the low byte."""
    v = np.minimum(np.maximum(v, np.float32(-127)), np.float32(127)).astype(np.float32)
    return ((v + _MAGIC).view(np.int32) & 0xFF).astype(np.uint8).view(np.int8)


def _requant(acc, ws, b, s, wide=0):
    y = _fma32(_acc_float(acc, wide), ws, b)
    return _round_int8(np.maximum(y, np.float32(0)) * s)


def _bmatrix(frags, nsteps):
    """The K x N matrix the MMA sees: (K word, byte, column)."""
    nt = frags.shape[1]
    m = np.zeros((8 * nsteps, 4, 8 * nt), np.int64)
    raw = frags.view(np.uint32)
    for s, n, lane, r in np.ndindex(raw.shape):
        w = int(raw[s, n, lane, r])
        m[8 * s + 4 * r + lane % 4, :, 8 * n + lane // 4] = [
            np.int8(np.uint8((w >> (8 * k)) & 0xFF)) for k in range(4)]
    return m


def _row_map(plan):
    """MMA row -> pixel of a 16-pixel run."""
    if plan.row_step == 2:
        return np.array([2 * g for g in range(8)] + [2 * g + 1 for g in range(8)])
    return np.arange(16)


def _runs_mma(words, bases, a_off, bmat):
    """acc (16, N) of one run: A word j of row m is words[bases[m] + a_off[j]]."""
    a = words[bases[:, None] + np.asarray(a_off[: bmat.shape[0]])[None, :]]
    a = a.astype(np.int32).view(np.int8).reshape(len(bases), bmat.shape[0], 4).astype(np.int64)
    return np.einsum("mjk,jkn->mn", a, bmat)


def _emulate_conv(x, layer, s_out, dil, head=None, acc_wide=None):
    """The conv kernels' walk in numpy; ``acc_wide`` overrides the plan's."""
    B, H, W, cin = x.shape
    q, ws, b = (layer[k].numpy() for k in ("q", "ws", "b"))
    cout = q.shape[-1]
    nh = 0 if head is None else head["q"].shape[-1]
    plan = qk.tile_plan("conv", B, H, W, cin, cout, dil=dil, nh=nh)
    wide = plan.acc_wide if acc_wide is None else acc_wide
    bmat = _bmatrix(qk.pack_fragments(q, plan), plan.nsteps)
    xw = np.ascontiguousarray(x.numpy()).view(np.int32)  # (B, H, W, nw) channel words
    nw, hw, d = plan.nw, plan.halo_w, plan.d
    out = np.zeros((B, H, W, nh or cout), np.float32 if nh else np.int8)
    pixels = _row_map(plan)
    s_o = s_out.numpy()
    kh = -(-cout // 32)  # the head's k steps (one below 33 channels)
    if nh:  # the head's B: word w of channel co, zero past cout/4 words and nh channels
        qh = head["q"].numpy()[0, 0]
        hb = np.zeros((8 * kh, 4, 8 * -(-nh // 8)), np.int64)
        for w in range(cout // 4):
            hb[w, :, :nh] = qh[4 * w : 4 * w + 4]
    for tile in range(plan.n_tiles):
        bi, r0, x0, ph = plan.decode(tile)
        halo = np.zeros((plan.halo_h, hw, nw), np.int32)
        for hr in range(plan.halo_h):
            y = ph + d * (r0 + hr - 1)
            if 0 <= y < H:
                cols = x0 - d + np.arange(hw)
                ok = (cols >= 0) & (cols < W)
                halo[hr, ok] = xw[bi, y, cols[ok]]
        rows = np.zeros((plan.halo_h, plan.row_words), np.int32)  # the kernels' row stride
        rows[:, : hw * nw] = halo.reshape(plan.halo_h, -1)
        flat = rows.reshape(-1)
        for i in range(plan.th):
            y = ph + d * (r0 + i)
            for jx in range(0, plan.tw, 16):
                xs = x0 + jx
                if y >= H or xs >= W:
                    continue
                acc = _runs_mma(flat, i * plan.row_words + (jx + pixels) * nw, plan.a_off, bmat)[:, :cout]
                q8 = _requant(acc, ws, b, s_o, wide)  # (16, cout), row m -> pixel rows[m]
                stage = np.zeros((16, cout), np.int8)
                stage[pixels] = q8
                if nh:
                    st_words = np.ascontiguousarray(stage).view(np.int32).reshape(-1)
                    wsel = np.array([w if w < cout // 4 else 0 for w in range(8 * kh)])  # padding reads word 0
                    hacc = _runs_mma(st_words, pixels * (cout // 4), wsel, hb)[:, :nh]
                    res = np.zeros((16, nh), np.float32)
                    res[pixels] = _fma32(_acc_float(hacc), head["ws"].numpy(), head["b"].numpy())
                else:
                    res = stage
                n = min(16, W - xs)
                if plan.generic and not nh:
                    # the any-width kernel's staged store: the run at its
                    # destination's address mod 16 in the warp's buffer,
                    # then warp_store's words and 16-byte chunks
                    pix = (bi * H + y) * W + xs
                    dst, buf = 256 + pix * cout, np.zeros(plan.stage_bytes, np.int8)
                    buf[dst % 16 : dst % 16 + 16 * cout] = stage.reshape(-1)
                    out_bytes = out.reshape(-1)
                    for o, size in _warp_store_chunks(dst, n * cout):
                        out_bytes[pix * cout + o : pix * cout + o + size] = buf[dst % 16 + o :][:size]
                    continue
                out[bi, y, xs : xs + n] = res[:n]
    return torch.from_numpy(out)


def _emulate_stem(x, layer0, s1, layer1, s2, raw_gray, acc_wide=None):
    """The stem kernel's walk in numpy; ``acc_wide`` overrides the plan's."""
    x = x.numpy()
    if x.ndim == 4:
        x = x[..., 0]
    B, H, W = x.shape
    kind = qk.IN_U8_RAW if x.dtype == np.uint8 else (qk.IN_F32_RAW if raw_gray else qk.IN_F32_NORM)
    q0, q1 = layer0["q"].numpy(), layer1["q"].numpy()
    c0, c1 = q0.shape[-1], q1.shape[-1]
    plan = qk.tile_plan("stem", B, H, W, 1, c1, c0=c0, in_kind=kind)
    wide = plan.acc_wide if acc_wide is None else acc_wide
    b1mat = _bmatrix(qk.pack_fragments(q1, plan), plan.nsteps)
    b0mat = np.zeros((16, c0), np.int64)
    for k in range(16):
        if plan.k0_src[k] >= 0:
            b0mat[k] = q0.reshape(-1)[plan.k0_src[k] : plan.k0_src[k] + c0]
    xf = x.astype(np.float32)
    if kind == qk.IN_F32_NORM:
        v = xf * np.float32(127)
    else:
        v = _fma32(xf, np.float32(127 / 127.5), np.float32(-127))
    xq = _round_int8(v)
    out = np.zeros((B, plan.Ho, plan.Wo, c1), np.int8)
    out_bytes, written = out.reshape(-1), np.zeros(out.size, np.int32)
    rows = _row_map(plan)
    for tile in range(plan.n_tiles):
        bi, Y1, X1, _ = plan.decode(tile)
        R0, C0 = 2 * Y1 - plan.pt1, 2 * X1 - plan.pl1
        IR, IC = 2 * R0 - plan.pt0, 2 * C0 - plan.pl0
        # the quantized window at the kernels' row stride, and the word past it
        win = np.zeros((plan.inh, plan.in_row), np.int64)
        yy, xx = IR + np.arange(plan.inh), IC + np.arange(plan.inw)
        oy, ox = (yy >= 0) & (yy < H), (xx >= 0) & (xx < W)
        sub = np.zeros((plan.inh, plan.inw), np.int64)
        sub[np.ix_(oy, ox)] = xq[bi][np.ix_(yy[oy], xx[ox])]
        win[:, : plan.inw] = sub
        win = np.concatenate([win.reshape(-1), np.zeros(4, np.int64)])
        n0 = plan.l0h * plan.l0w
        p = np.arange(n0)
        r = (p * plan.l0w_magic) >> 20
        c = p - r * plan.l0w
        np.testing.assert_array_equal(r, p // plan.l0w)
        a0 = win[(2 * r * plan.in_row + 2 * c)[:, None] + np.asarray(plan.k0_off)[None, :]]
        l0 = _requant(a0 @ b0mat, layer0["ws"].numpy(), layer0["b"].numpy(), s1.numpy())
        inside = (R0 + r >= 0) & (R0 + r < plan.H0) & (C0 + c >= 0) & (C0 + c < plan.W0)
        l0[~inside] = 0
        words = np.ascontiguousarray(l0).view(np.int32).reshape(-1)
        for i in range(plan.th):
            for jx in range(0, plan.tw, 16):
                y, xs = Y1 + i, X1 + jx
                if y >= plan.Ho or xs >= plan.Wo:
                    continue
                bases = (2 * i * plan.l0w + 2 * (jx + rows)) * plan.nw
                acc = _runs_mma(words, bases, plan.a_off, b1mat)[:, :c1]
                res = np.zeros((16, c1), np.int8)
                res[rows] = _requant(acc, layer1["ws"].numpy(), layer1["b"].numpy(), s2.numpy(),
                                     wide)
                n = min(16, plan.Wo - xs)
                if plan.generic and plan.stage_bytes:
                    # the any-width kernel's staged store: the whole run at
                    # its destination's address mod 16 in the warp's buffer,
                    # then warp_store's words and 16-byte chunks
                    pix = (bi * plan.Ho + y) * plan.Wo + xs
                    dst, buf = 256 + pix * c1, np.zeros(plan.stage_bytes, np.int8)
                    assert dst % 16 + 16 * c1 <= plan.stage_bytes
                    buf[dst % 16 : dst % 16 + 16 * c1] = res.reshape(-1)
                    for o, size in _warp_store_chunks(dst, n * c1):
                        assert (dst % 16 + o) % size == 0
                        out_bytes[pix * c1 + o : pix * c1 + o + size] = buf[dst % 16 + o :][:size]
                        written[pix * c1 + o : pix * c1 + o + size] += 1
                    continue
                out[bi, y, xs : xs + n] = res[:n]
    if plan.generic and plan.stage_bytes:
        assert (written == 1).all()  # every output byte stored once
    return torch.from_numpy(out)


def _layer(rng, ks, cin, cout, sat=False):
    if sat:
        q = np.full((ks, ks, cin, cout), 127, np.int8)
    else:
        q = rng.integers(-127, 128, (ks, ks, cin, cout)).astype(np.int8)
    return {"q": torch.from_numpy(q),
            "ws": torch.from_numpy(rng.uniform(1e-4, 2e-3, cout).astype(np.float32)),
            "b": torch.from_numpy(rng.normal(0, 0.5, cout).astype(np.float32))}


def _scale(rng, c):
    return torch.from_numpy(rng.uniform(5, 60, c).astype(np.float32))


# (B, H, W, Cin, Cout, dilation, head outputs or 0)
CONV_CASES = {
    "context-d1-ragged": (2, 33, 47, 24, 24, 1, 0),
    "context-d16-qvga": (1, 12, 20, 24, 24, 16, 0),
    "context-d4-odd": (2, 19, 26, 8, 8, 4, 0),
    "widths-4-to-8": (1, 10, 30, 4, 8, 3, 0),
    "widths-16-to-12": (1, 9, 17, 16, 12, 2, 0),
    "head-17": (2, 16, 20, 24, 24, 1, 17),
    "head-narrow-5": (1, 19, 26, 8, 8, 2, 5),
    "head-32-d16": (1, 17, 18, 32, 32, 16, 32),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv_plan_walk_equals_the_plain_version(case):
    B, H, W, cin, cout, d, nh = CONV_CASES[case]
    rng = np.random.default_rng(len(case) + cout)
    x = torch.from_numpy(rng.integers(-127, 128, (B, H, W, cin)).astype(np.int8))
    layer, s_out = _layer(rng, 3, cin, cout), _scale(rng, cout)
    if nh:
        head = _layer(rng, 1, cout, nh)
        ref = qk.qconv_head(x, layer, s_out, d, head)  # CPU: the plain version
        np.testing.assert_array_equal(ref.numpy(), qk.qconv_head_reference(x, layer, s_out, d, head).numpy())
    else:
        head, ref = None, qk.qconv(x, layer, s_out, d)
    np.testing.assert_array_equal(_emulate_conv(x, layer, s_out, d, head).numpy(), ref.numpy())


# (B, H, W, input kind, C0, C1)
STEM_CASES = {
    "u8-odd-75x101": (1, 75, 101, "u8", 24, 24),
    "f32raw-odd-37x53": (2, 37, 53, "f32raw", 8, 8),
    "norm-64x48": (1, 64, 48, "norm", 8, 12),
    "widths-32": (1, 20, 30, "u8", 32, 32),
    "widths-4": (1, 13, 9, "norm", 4, 4),
}


def _stem_input(rng, B, H, W, kind):
    if kind == "u8":
        return torch.from_numpy(rng.integers(0, 256, (B, H, W)).astype(np.uint8)), True
    if kind == "f32raw":
        return torch.from_numpy(rng.uniform(0, 255, (B, H, W)).astype(np.float32)), True
    return torch.from_numpy(rng.uniform(-1.05, 1.05, (B, H, W, 1)).astype(np.float32)), False


@pytest.mark.parametrize("case", sorted(STEM_CASES))
def test_stem_plan_walk_equals_the_plain_version(case):
    B, H, W, kind, c0, c1 = STEM_CASES[case]
    rng = np.random.default_rng(len(case) + c0)
    x, raw = _stem_input(rng, B, H, W, kind)
    l0, l1 = _layer(rng, 3, 1, c0), _layer(rng, 3, c0, c1)
    s1, s2 = _scale(rng, c0), _scale(rng, c1)
    ref = qk.qstem(x, l0, s1, l1, s2, raw_gray=raw)  # CPU: the plain version
    np.testing.assert_array_equal(ref.numpy(), qk.qstem_reference(x, l0, s1, l1, s2, raw).numpy())
    np.testing.assert_array_equal(_emulate_stem(x, l0, s1, l1, s2, raw).numpy(), ref.numpy())


def test_saturated_accumulators_round_exactly():
    """|acc| = 9 * 24 * 127^2 = 3,483,864 through the biased accumulator
    and the f32 epilogue: the walk equals the plain version."""
    rng = np.random.default_rng(3)
    x = np.full((2, 12, 12, 24), 127, np.int8)
    x[1] = -127
    layer = _layer(rng, 3, 24, 24, sat=True)
    layer["ws"] = torch.full((24,), np.float32(40.0 / 3_483_864), dtype=torch.float32)
    s_out = torch.full((24,), 1.0)
    x = torch.from_numpy(x)
    ref = qk.qconv(x, layer, s_out, 1)
    assert int(ref[0, 5, 5, 0]) == int(np.round(40 + layer["b"][0].item()))
    np.testing.assert_array_equal(_emulate_conv(x, layer, s_out, 1).numpy(), ref.numpy())


@pytest.mark.parametrize("nw", range(1, 9))
def test_conversion_free_epilogue_only_inside_its_window(nw):
    """The epilogue reads an accumulator started at the bits of 1.5 * 2^23
    as a float, exact only for -2^22 <= acc < 2^22.  Where a plan keeps that
    read (acc_wide 0: up to 28 input channels) it is exact at the extremes
    of any int8 inputs and weights; at 32 channels a saturated layer
    (9 * 32 * 127^2 = 4,645,152) leaves the window, and the plan converts
    (acc_wide 1)."""
    plan = qk.tile_plan("conv", 1, 16, 16, 4 * nw, 8)
    stem = qk.tile_plan("stem", 1, 64, 64, 1, 8, c0=4 * nw, in_kind=qk.IN_U8_RAW)
    assert stem.acc_wide == plan.acc_wide == int(nw == 8)
    k = 36 * nw  # int8 products an accumulator sums
    extremes = np.array([k * 128 * 128, -k * 128 * 127, k * 127 * 127, -k * 127 * 127], np.int64)
    magic_read_exact = _acc_float(extremes) == extremes.astype(np.float32)
    if plan.acc_wide:
        assert not magic_read_exact.any()
    else:
        assert magic_read_exact.all()
    np.testing.assert_array_equal(_acc_float(extremes, wide=1), extremes.astype(np.float32))


def _saturating_layer(cin, cout):
    """Every weight +-127, the sign alternating by output channel, and ws of
    the same sign mapping the full 3x3 accumulator 9 Cin 127^2 to 40: on
    inputs of 127 every interior output is 40, with the accumulators of
    both signs at their extremes."""
    sign = np.where(np.arange(cout) % 2 == 0, 1, -1)
    q = np.broadcast_to((127 * sign).astype(np.int8), (3, 3, cin, cout)).copy()
    ws = (np.float32(40.0 / (9 * cin * 127**2)) * sign).astype(np.float32)
    return {"q": torch.from_numpy(q), "ws": torch.from_numpy(ws), "b": torch.zeros(cout)}


@pytest.mark.parametrize("kernel", ["qconv", "qconv_head", "qstem"])
def test_saturated_wide_accumulators_round_exactly(kernel):
    """32 input channels at saturation, |acc| = 4,645,152 past the
    conversion-free window: the walk with the plan's conversion equals the
    plain version (interior outputs 40), and the magic read alone would
    not."""
    rng = np.random.default_rng(9)
    ones = torch.ones(32)
    if kernel == "qstem":
        x = torch.full((1, 44, 52), 255, dtype=torch.uint8)  # raw 255 quantizes to 127
        l0 = {"q": torch.full((3, 3, 1, 32), 127, dtype=torch.int8),
              "ws": torch.full((32,), np.float32(1 / 127)), "b": torch.zeros(32)}
        args = (x, l0, ones, _saturating_layer(32, 32), ones, True)
        ref = qk.qstem(*args)
        walk = functools.partial(_emulate_stem, *args)
    else:
        x = torch.full((2, 12, 20, 32), 127, dtype=torch.int8)
        x[1] = -127
        layer = _saturating_layer(32, 32)
        if kernel == "qconv":
            ref, head = qk.qconv(x, layer, ones, 1), None
        else:
            head = _layer(rng, 1, 32, 17)
            ref = qk.qconv_head(x, layer, ones, 1, head)
            assert (qk.qconv_reference(x, layer, ones, 1, 1)[0, 1:-1, 1:-1] == 40).all()
        walk = functools.partial(_emulate_conv, x, layer, ones, 1, head)
    if kernel != "qconv_head":
        assert (ref[0, 1:-1, 1:-1] == 40).all()
    np.testing.assert_array_equal(walk().numpy(), ref.numpy())
    assert not np.array_equal(walk(acc_wide=0).numpy(), ref.numpy())


def _emulate_layer(x, layer, stride, dil):
    """The f32 conv kernel's walk ("layer" plans) in numpy: (y, acc)."""
    B, H, W, cin = x.shape
    q, ws, b = (layer[k].numpy() for k in ("q", "ws", "b"))
    ks, cout = q.shape[0], q.shape[-1]
    plan = qk.tile_plan("layer", B, H, W, cin, cout, dil=dil, stride=stride, ks=ks)
    bmat = _bmatrix(qk.pack_fragments(q, plan), plan.nsteps)
    xw = np.ascontiguousarray(x.numpy()).view(np.int32)
    nw, hw, d = plan.nw, plan.halo_w, plan.d
    y_out = np.zeros((B, plan.Ho, plan.Wo, cout), np.float32)
    a_out = np.zeros_like(y_out)
    pixels = _row_map(plan)
    for tile in range(plan.n_tiles):
        bi, r0, x0, ph = plan.decode(tile)
        halo = np.zeros((plan.halo_h, hw, nw), np.int32)
        for hr in range(plan.halo_h):
            y = ph + stride * d * r0 + d * hr - plan.pad_t
            if 0 <= y < H:
                cols = stride * x0 - plan.pad_l + np.arange(hw)
                ok = (cols >= 0) & (cols < W)
                halo[hr, ok] = xw[bi, y, cols[ok]]
        rows = np.zeros((plan.halo_h, plan.row_words), np.int32)
        rows[:, : hw * nw] = halo.reshape(plan.halo_h, -1)
        flat = rows.reshape(-1)
        for i in range(plan.th):
            y = ph + d * (r0 + i)
            for jx in range(0, plan.tw, 16):
                xs = x0 + jx
                if y >= plan.Ho or xs >= plan.Wo:
                    continue
                bases = stride * (i * plan.row_words + (jx + pixels) * nw)
                acc = _runs_mma(flat, bases, plan.a_off, bmat)[:, :cout]
                af = np.zeros((16, cout), np.float32)
                af[pixels] = _acc_float(acc, plan.acc_wide)
                n = min(16, plan.Wo - xs)
                a_out[bi, y, xs : xs + n] = af[:n]
                y_out[bi, y, xs : xs + n] = _fma32(af[:n], ws, b)
    return y_out, a_out


def _emulate_layer0(x, layer0):
    """The layer-0 kernel's walk ("layer0" plans) in numpy: (y, acc)."""
    x = x.numpy()[..., 0]
    B, H, W = x.shape
    q0 = layer0["q"].numpy()
    c0 = q0.shape[-1]
    plan = qk.tile_plan("layer0", B, H, W, 1, c0, in_kind=qk.IN_F32_NORM)
    b0mat = np.zeros((16, c0), np.int64)
    for k in range(16):
        if plan.k0_src[k] >= 0:
            b0mat[k] = q0.reshape(-1)[plan.k0_src[k] : plan.k0_src[k] + c0]
    xq = _round_int8(x.astype(np.float32) * np.float32(127))
    y_out = np.zeros((B, plan.Ho, plan.Wo, c0), np.float32)
    a_out = np.zeros_like(y_out)
    y_bytes, a_bytes = y_out.reshape(-1).view(np.uint8), a_out.reshape(-1).view(np.uint8)
    written = np.zeros((2, y_bytes.size), np.int32)
    for tile in range(plan.n_tiles):
        bi, R0, C0, _ = plan.decode(tile)
        IR, IC = 2 * R0 - plan.pt0, 2 * C0 - plan.pl0
        win = np.zeros((plan.inh, plan.in_row), np.int64)
        yy, xx = IR + np.arange(plan.inh), IC + np.arange(plan.inw)
        oy, ox = (yy >= 0) & (yy < H), (xx >= 0) & (xx < W)
        sub = np.zeros((plan.inh, plan.inw), np.int64)
        sub[np.ix_(oy, ox)] = xq[bi][np.ix_(yy[oy], xx[ox])]
        win[:, : plan.inw] = sub
        win = np.concatenate([win.reshape(-1), np.zeros(4, np.int64)])
        p = np.arange(plan.l0h * plan.l0w)
        r = (p * plan.l0w_magic) >> 20
        c = p - r * plan.l0w
        a0 = win[(2 * r * plan.in_row + 2 * c)[:, None] + np.asarray(plan.k0_off)[None, :]]
        af = _acc_float(a0 @ b0mat)
        yf = _fma32(af, layer0["ws"].numpy(), layer0["b"].numpy())
        # each 16-pixel run inside the map: y, then the accumulator, staged at
        # the destination's address mod 16 in the warp's buffer and stored by
        # warp_store's words and 16-byte chunks
        for pix in range(0, len(p), 16):
            if R0 + r[pix] >= plan.H0 or C0 + c[pix] >= plan.W0:
                continue
            n = min(16, plan.W0 - (C0 + c[pix]))
            o = ((bi * plan.H0 + R0 + r[pix]) * plan.W0 + C0 + c[pix]) * c0 * 4
            for out_b, vals in ((y_bytes, yf), (a_bytes, af)):
                dst, buf = 256 + o, np.zeros(plan.stage_bytes, np.uint8)
                assert dst % 16 + 64 * c0 <= plan.stage_bytes
                buf[dst % 16 : dst % 16 + 64 * c0] = vals[pix : pix + 16].astype(np.float32).view(np.uint8).reshape(-1)
                for off, size in _warp_store_chunks(dst, n * c0 * 4):
                    assert (dst % 16 + off) % size == 0
                    out_b[o + off : o + off + size] = buf[dst % 16 + off :][:size]
                    written[int(out_b is a_bytes), o + off : o + off + size] += 1
    assert (written == 1).all()  # every output byte stored once
    return y_out, a_out


# (B, H, W, Cin, Cout, kernel size, stride, dilation)
LAYER_CASES = {
    "layer1-stride2-odd": (2, 38, 51, 24, 24, 3, 2, 1),
    "layer1-stride2-even": (1, 64, 64, 24, 24, 3, 2, 1),
    "context-d1-ragged": (2, 33, 47, 24, 24, 3, 1, 1),
    "context-d16": (1, 40, 36, 24, 24, 3, 1, 16),
    "widths-4-to-8-d3": (1, 10, 30, 4, 8, 3, 1, 3),
    "widths-12-stride2": (1, 21, 35, 12, 12, 3, 2, 1),
    "head-17": (2, 16, 20, 24, 17, 1, 1, 1),
    "head-narrow-5": (1, 19, 26, 8, 5, 1, 1, 1),
    "head-32": (1, 17, 18, 32, 32, 1, 1, 1),
}


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_layer_plan_walk_equals_the_plain_version(case):
    """The f32 conv kernel's walk == qconv_layer_f32's plain version (the
    accumulator exact, acc * ws + b rounded once), bit for bit."""
    B, H, W, cin, cout, ks, stride, d = LAYER_CASES[case]
    rng = np.random.default_rng(len(case) + 11 * cout)
    x = torch.from_numpy(rng.integers(-127, 128, (B, H, W, cin)).astype(np.int8))
    layer = _layer(rng, ks, cin, cout)
    y, acc = qk.qconv_layer_f32(x, layer, stride, d)  # CPU: the plain version
    np.testing.assert_array_equal(y.numpy(), qk.qconv_reference(x, layer, None, stride, d).numpy())
    ey, ea = _emulate_layer(x, layer, stride, d)
    np.testing.assert_array_equal(ea, acc.numpy())
    np.testing.assert_array_equal(ey, y.numpy())


@pytest.mark.parametrize("shape,c0", [((1, 75, 101), 24), ((2, 64, 48), 8), ((1, 13, 9), 4),
                                      ((1, 150, 70), 32), ((1, 75, 101), 36), ((2, 37, 53), 33)])
def test_layer0_plan_walk_equals_the_plain_version(shape, c0):
    """The layer-0 kernel's walk (its runs staged and stored contiguous,
    every output byte once; past 32 channels the any-width kernel's) ==
    qconv_layer_f32's plain version bit for bit."""
    rng = np.random.default_rng(shape[1] + c0)
    x = torch.from_numpy(rng.uniform(-1.05, 1.05, shape + (1,)).astype(np.float32))
    l0 = _layer(rng, 3, 1, c0)
    y, acc = qk.qconv_layer_f32(x, l0, 2, 1)
    np.testing.assert_array_equal(y.numpy(), qk.qconv_reference(x, l0, None, 2, 1).numpy())
    ey, ea = _emulate_layer0(x, l0)
    np.testing.assert_array_equal(ea, acc.numpy())
    np.testing.assert_array_equal(ey, y.numpy())


def test_saturated_wide_layer_alone_rounds_exactly():
    """The 32-channel layer at saturation (|acc| = 4,645,152, acc_wide) with
    the f32 epilogue: the walk's accumulators and pre-activations equal the
    plain version, the interior pre-activations 40 within an ulp of f32,
    and the requantized outputs from them equal qconv_reference's."""
    x = torch.full((2, 12, 20, 32), 127, dtype=torch.int8)
    x[1] = -127
    layer = _saturating_layer(32, 32)
    y, acc = qk.qconv_layer_f32(x, layer, 1, 1)
    assert float(acc.abs().max()) == 9 * 32 * 127**2
    ey, ea = _emulate_layer(x, layer, 1, 1)
    np.testing.assert_array_equal(ea, acc.numpy())
    np.testing.assert_array_equal(ey, y.numpy())
    ones = torch.ones(32)
    np.testing.assert_array_equal(qk.requantize(acc, layer["ws"], layer["b"], ones).numpy(),
                                  qk.qconv_reference(x, layer, ones, 1, 1).numpy())


# --- the plain versions against the jitted JAX chains ------------------------


def _jax_layer(layer):
    return {k: jnp.asarray(v.numpy()) for k, v in layer.items()}


@pytest.mark.parametrize("case", sorted(STEM_CASES))
def test_qstem_plain_matches_jitted_jax_chain(case):
    """qstem's plain version == _quantize_input -> _qconv (stride 2) x2."""
    B, H, W, kind, c0, c1 = STEM_CASES[case]
    rng = np.random.default_rng(len(case) + 5 * c1)
    x, raw = _stem_input(rng, B, H, W, kind)
    l0, l1 = _layer(rng, 3, 1, c0), _layer(rng, 3, c0, c1)
    s1, s2 = _scale(rng, c0), _scale(rng, c1)
    conv = jax.jit(jq._qconv, static_argnums=(3, 4))
    jx = jax.jit(jq._quantize_input, static_argnums=1)(jnp.asarray(x.numpy(), jnp.float32), raw)
    jx = conv(jx, _jax_layer(l0), jnp.asarray(s1.numpy()), (2, 2), (1, 1))
    ref = np.asarray(conv(jx, _jax_layer(l1), jnp.asarray(s2.numpy()), (2, 2), (1, 1)))
    out = qk.qstem(x, l0, s1, l1, s2, raw_gray=raw)
    assert out.dtype == torch.int8 and out.shape == ref.shape
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("case", ["head-17", "head-narrow-5", "head-32-d16"])
def test_qconv_head_plain_matches_jitted_jax_chain(case):
    """qconv_head's plain version == _qconv (3x3, dilation d) -> _qconv (the
    1x1 head, f32 logits)."""
    B, H, W, cin, cout, d, nh = CONV_CASES[case]
    rng = np.random.default_rng(len(case) + 3 * nh)
    x = torch.from_numpy(rng.integers(-127, 128, (B, H, W, cin)).astype(np.int8))
    layer, s_out, head = _layer(rng, 3, cin, cout), _scale(rng, cout), _layer(rng, 1, cout, nh)
    conv = jax.jit(jq._qconv, static_argnums=(3, 4))
    jx = conv(jnp.asarray(x.numpy()), _jax_layer(layer), jnp.asarray(s_out.numpy()), (1, 1), (d, d))
    ref = np.asarray(conv(jx, _jax_layer(head), None, (1, 1), (1, 1)))
    out = qk.qconv_head(x, layer, s_out, d, head)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_array_equal(out.numpy(), ref)


# --- any width: the plans of the any-width kernels (the plan's generic) -----

_ANY_WIDTHS = (6, 10, 36, 48, 64, 128)


def _r4(n):
    return -(-n // 4) * 4


def test_acc_mode_follows_the_accumulator_bound():
    """The epilogue's reading of the accumulator, by 9 Cin 127^2 against
    2^22 (the conversion-free window) and 2^24 (past it the conversion
    rounds to nearest even, as XLA's s32 -> f32 convert)."""
    for cin in range(4, 257, 4):
        bound = 9 * cin * 127**2
        assert qk.acc_mode(cin) == (0 if bound < 2**22 else 1 if bound < 2**24 else 2), cin
    assert [qk.acc_mode(c) for c in (28, 32, 112, 116, 128)] == [0, 1, 1, 2, 2]
    big = np.array([2**24 + 1, 2**24 + 3, -(2**24) - 1, 18_580_481], np.int64)
    np.testing.assert_array_equal(_acc_float(big, wide=2), big.astype(np.float32))
    assert _acc_float(big, wide=2)[0] == np.float32(2**24)  # a tie to even


@pytest.mark.parametrize("cout", _ANY_WIDTHS)
@pytest.mark.parametrize("cin", _ANY_WIDTHS)
def test_any_width_plans_fit_shared_memory(cin, cout):
    """Every kind's plan at Cin/Cout in {6, 10, 36, 48, 64, 128} (counts
    the wrappers pad to a multiple of 4), with heads of 33 and 41 logits:
    the any-width kernels wherever a width passes 32, each block within
    the H100's shared memory at the asset's dilations, regions 16-byte
    aligned, and the accumulator's mode that of 9 Cin 127^2; the any-width
    conv's and stem's staging regions, and two of their blocks an SM up to
    64 channels (their launch bounds)."""
    ci, co = _r4(cin), _r4(cout)

    def check(plan, generic, acc_cin):
        assert plan.smem <= qk.SHARED_MEMORY_LIMIT, (plan.kind, plan.fields)
        assert all(plan.fields[k] % 16 == 0 for k in qk.PLAN_FIELDS if k.startswith("off_"))
        assert plan.generic == int(generic)
        if acc_cin:
            assert plan.acc_wide == qk.acc_mode(acc_cin)
        if generic and plan.kind != "layer0":
            assert plan.nsteps * 8 >= (1 if plan.ks == 1 else 9) * plan.nw
        if generic and plan.kind in ("conv", "layer"):
            # the warp's staging: two runs of 16 pixels of cout bytes, each
            # with 16 bytes to spare for its destination's alignment (a
            # head's runs are its A operand, f32 outputs are not staged),
            # 16-byte aligned for every warp; two blocks an SM up to 64
            # channels (and at the heads' 41 logits)
            r16 = -(-16 * plan.cout // 16) * 16
            stage = 0 if plan.f32 else (2 * r16 if plan.nh else 2 * r16 + 32)
            assert plan.stage_bytes == stage and plan.stage_bytes % 16 == 0
            assert plan.off_tile - plan.off_stage >= qk.WARPS * stage
            if max(plan.cin, plan.cout) <= 64:
                assert plan.smem <= qk.SMEM_TWO_BLOCKS, (plan.kind, plan.fields)
        if generic and plan.kind == "stem":
            # a warp stages one run of layer 1's outputs (16 pixels of cout
            # bytes and 16 to spare for its destination's alignment) where
            # one pass of n8 tiles holds every channel, 16-byte aligned for
            # every warp; two blocks an SM up to 64 channels
            r16 = -(-16 * plan.cout // 16) * 16
            stage = r16 + 16 if plan.cout <= 8 * qk.PASS_TILES else 0
            assert plan.stage_bytes == stage and plan.stage_bytes % 16 == 0
            assert plan.off_tile - plan.off_stage >= qk.WARPS * stage
            if max(plan.c0, plan.cout) <= 64:
                assert plan.smem <= qk.SMEM_TWO_BLOCKS, plan.fields

    for H, W in ((128, 128), (60, 80), (512, 512), (33, 47), (1, 4096)):
        for d in (1, 2, 16):
            for nh in (0, 33, 41):
                check(qk.tile_plan("conv", 2, H, W, ci, co, dil=d, nh=nh), max(ci, co, nh) > 32, ci)
            check(qk.tile_plan("layer", 2, H, W, ci, cout, dil=d), max(ci, cout) > 32, ci)
        check(qk.tile_plan("layer", 2, H, W, ci, cout, stride=2), max(ci, cout) > 32, ci)
        for nh in (33, 41):
            check(qk.tile_plan("layer", 2, H, W, ci, nh, ks=1), True, ci)
    for H, W in ((512, 512), (240, 320), (75, 101), (2048, 2048)):
        check(qk.tile_plan("stem", 2, H, W, 1, co, c0=ci, in_kind=qk.IN_U8_RAW), max(ci, co) > 32,
              ci)
        plan0 = qk.tile_plan("layer0", 2, H, W, 1, cout, in_kind=qk.IN_F32_NORM)
        check(plan0, cout > 32, 0)
        # a warp stages a run of 16 pixels of cout floats, 16 bytes to spare
        assert plan0.stage_bytes == -(-(64 * cout + 16) // 16) * 16
        assert plan0.off_tile - plan0.off_stage >= qk.WARPS * plan0.stage_bytes


def _warp_store_chunks(dst, n):
    """(offset, bytes) of every store of csrc/qconv.cuh ``warp_store`` of n
    bytes to address ``dst``, for the 32 lanes: 4-byte words up to dst's
    first 16-byte boundary, 16-byte chunks, the 4-byte tail."""
    head = min(n, (16 - dst % 16) % 16)
    chunks = [(4 * lane, 4) for lane in range(32) if 4 * lane < head]
    body_end = head + ((n - head) & ~15)
    for lane in range(32):
        chunks += [(o, 16) for o in range(head + 16 * lane, body_end, 512)]
        if body_end + 4 * lane < n:
            chunks.append((body_end + 4 * lane, 4))
    return chunks


def _staged_walk(plan, base=0):
    """The any-width conv kernel's runs over a plan, as its warps take them
    (runs m and m + 8 of a tile, the second only inside the tile), each
    staged at its destination's address mod 16 in the warp's buffer (at the
    buffer's start with a head) and stored by ``warp_store``: returns how
    often each output byte (int8) or each pixel (head) is written, after
    checking that each run's staging lies inside its half of the buffer and
    every store's bytes come from the same address mod 16."""
    f = plan.fields
    cout, half = f["cout"], (f["stage_bytes"] // 2) & ~15
    seen = np.zeros(f["B"] * f["Ho"] * f["Wo"] * (1 if f["nh"] else cout), np.int32)
    runs = f["tw"] // 16
    n_mt = f["th"] * runs
    for tile in range(f["n_tiles"]):
        b, r0, x0, ph = plan.decode(tile)
        for warp in range(qk.WARPS):
            for m in range(warp, n_mt, 2 * qk.WARPS):
                for h in range(2):
                    mm = m + h * qk.WARPS
                    if mm >= n_mt:
                        continue
                    i, jx = divmod(mm, runs)
                    y, x = ph + f["d"] * (r0 + i), x0 + 16 * jx
                    if y >= f["Ho"] or x >= f["Wo"]:
                        continue
                    nvalid = min(16, f["Wo"] - x)
                    pix = (b * f["Ho"] + y) * f["Wo"] + x
                    if f["nh"]:
                        assert 16 * cout <= half
                        seen[pix : pix + nvalid] += 1
                        continue
                    dst = base + pix * cout
                    st = h * half + dst % 16
                    assert st + 16 * cout <= (half if h == 0 else f["stage_bytes"])
                    for o, size in _warp_store_chunks(dst, nvalid * cout):
                        assert (st + o) % size == 0 and (st + o) % 16 == (dst + o) % 16
                        seen[pix * cout + o : pix * cout + o + size] += 1
    return seen


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("cin,cout,nh", [(36, 40, 0), (48, 48, 41), (12, 12, 41), (128, 8, 0),
                                         (48, 48, 0), (64, 64, 0)])
def test_any_width_plans_cover_each_output_once(B, cin, cout, nh):
    """Each output pixel of an any-width plan in exactly one tile, and the
    kernel's staged stores (each run staged at its destination's address
    mod 16, stored 4 and 16 bytes a lane) write each output byte once."""
    for name in ("qvga-60x80", "odd-19x26", "main-128"):
        for d in (1, 4, 16):
            plan = qk.tile_plan("conv", B, *MAPS[name], cin, cout, dil=d, nh=nh)
            assert plan.generic and (_coverage(plan) == 1).all(), (name, d)
            if name != "main-128" or B == 1:
                assert (_staged_walk(plan, base=256) == 1).all(), (name, d)


@pytest.mark.parametrize("cin,cout", [(48, 48), (36, 12), (12, 64), (128, 8)])
def test_any_width_k_order_unpacks_to_the_hwio_weights(cin, cout):
    """An any-width plan's K order is the plain one (K word j = tap j // nw,
    channel word j % nw, the order csrc/qconv.cuh k_offsets_any computes):
    the fragments unpack to the HWIO weights, zero past 9 nw, and each K
    word's A offset names its tap and channel word."""
    for kind in ("conv", "stem"):
        rng = np.random.default_rng(cin + cout)
        q = rng.integers(-127, 128, (3, 3, cin, cout)).astype(np.int8)
        if kind == "conv":
            plan = qk.tile_plan("conv", 1, 30, 40, cin, cout, dil=2)
        else:
            plan = qk.tile_plan("stem", 1, 64, 64, 1, cout, c0=cin, in_kind=qk.IN_U8_RAW)
        assert plan.generic
        nw = cin // 4
        frags = qk.pack_fragments(q, plan)
        raw = frags.view(np.uint32)
        back = np.zeros_like(q)
        for s_, n, lane, r in np.ndindex(raw.shape):
            j, co = 8 * s_ + 4 * r + lane % 4, 8 * n + lane // 4
            word = raw[s_, n, lane, r]
            if j >= 9 * nw or co >= cout:
                assert word == 0
                continue
            tap, cw = divmod(j, nw)
            ty, tx = divmod(tap, 3)
            for k in range(4):
                back[ty, tx, 4 * cw + k, co] = np.uint8((word >> (8 * k)) & 0xFF).view(np.int8)
            if kind == "conv":
                assert plan.a_off[j] == ty * plan.row_words + tx * plan.d * nw + cw
            else:
                assert plan.a_off[j] == (ty * plan.l0w + tx) * nw + cw
        np.testing.assert_array_equal(back, q)


# (B, H, W, Cin, Cout, dilation, head outputs or 0): every one generic
ANY_CONV_CASES = {
    "any-36-to-40-d2": (1, 19, 26, 36, 40, 2, 0),
    "any-48-d16": (2, 17, 33, 48, 48, 16, 0),
    "any-12-to-64": (1, 12, 20, 12, 64, 1, 0),
    "any-48-head-41": (1, 17, 20, 48, 48, 1, 41),
    "any-12-head-41": (1, 12, 20, 12, 12, 4, 41),
    "any-40-head-33": (2, 9, 36, 40, 40, 2, 33),
}


@pytest.mark.parametrize("case", sorted(ANY_CONV_CASES))
def test_any_width_conv_walk_equals_the_plain_version(case):
    """The numpy walk of an any-width plan (the plain K order, groups of
    n8 tiles, the int8 runs staged and stored as contiguous spans, the
    head's k steps over Cout past 32 channels) == the plain version bit
    for bit."""
    B, H, W, cin, cout, d, nh = ANY_CONV_CASES[case]
    rng = np.random.default_rng(len(case) + cout + nh)
    x = torch.from_numpy(rng.integers(-127, 128, (B, H, W, cin)).astype(np.int8))
    layer, s_out = _layer(rng, 3, cin, cout), _scale(rng, cout)
    if nh:
        head = _layer(rng, 1, cout, nh)
        ref = qk.qconv_head_reference(x, layer, s_out, d, head)
        np.testing.assert_array_equal(_emulate_conv(x, layer, s_out, d, head).numpy(), ref.numpy())
    else:
        ref = qk.qconv_reference(x, layer, s_out, 1, d)
        np.testing.assert_array_equal(_emulate_conv(x, layer, s_out, d).numpy(), ref.numpy())


@pytest.mark.parametrize("c0,c1", [(36, 36), (12, 48), (48, 8), (40, 40), (64, 64), (36, 68)])
def test_any_width_stem_walk_equals_the_plain_version(c0, c1):
    """The numpy walk of an any-width stem plan (layer 1 a pass of up to
    eight n8 tiles, each run staged and stored as one contiguous span where
    one pass holds its channels, every output byte stored once; past 64
    channels from the registers) == the plain version bit for bit."""
    rng = np.random.default_rng(c0 + c1)
    x = torch.from_numpy(rng.integers(0, 256, (1, 75, 101)).astype(np.uint8))
    l0, l1 = _layer(rng, 3, 1, c0), _layer(rng, 3, c0, c1)
    s1, s2 = _scale(rng, c0), _scale(rng, c1)
    ref = qk.qstem_reference(x, l0, s1, l1, s2, True)
    np.testing.assert_array_equal(_emulate_stem(x, l0, s1, l1, s2, True).numpy(), ref.numpy())


def test_padding_keeps_the_layer():
    """pad_layer / pad_scale: the padded input channels carry zero weights,
    the padded outputs zero weights, ws = 1, b = 0 and s_out = 1, so the
    padded layer's outputs are the layer's, then exact zeros."""
    rng = np.random.default_rng(0)
    layer, s_out = _layer(rng, 3, 10, 10), _scale(rng, 10)
    padded, s_p = qk.pad_layer(layer, 12, 12), qk.pad_scale(s_out, 12)
    assert qk.pad_layer(padded, 12, 12) is padded and qk.pad_scale(s_p, 12) is s_p
    x = torch.from_numpy(rng.integers(-127, 128, (1, 9, 11, 10)).astype(np.int8))
    out = qk.qconv_reference(qk.pad_channels(x, 12), padded, s_p, 1, 2)
    assert torch.equal(out[..., :10], qk.qconv_reference(x, layer, s_out, 1, 2))
    assert not out[..., 10:].any()
