"""Procedural barcode-like dataset generator (numpy only).

A copy of ``ubdvss_tpu/synthetic.py`` so that the port makes the same
scenes from the same seeds as the JAX package and ``bench.py`` without
importing it.  The original module docstring follows.

Procedural barcode-like dataset generator.

The stand-in for the reference's ZVZ-real/ZVZ-synth datasets (paper §4.1),
which are not available offline (SURVEY.md §0).  Produces document-like
grayscale scenes with rotated barcode rectangles: 1D codes render as
alternating stripes, 2D codes as random module grids, postal codes as short
bar runs — enough texture for the FCN to learn the detection/classification
task end-to-end in integration tests (SURVEY.md §4.4: synthetic-overfit
must reach F1=1.0) and for benchmarks.

Ground truth is exact by construction: each object's 4-corner polygon in
input coords plus its class name, exposed through the standard markup
``Sample`` interface.
"""

from __future__ import annotations

import numpy as np

from ubdvss_tpu_torch.markup import BarcodeObject, MarkupReader, Sample
from ubdvss_tpu_torch.net_config import CLASS_GROUPS, DEFAULT_CLASS_NAMES


def _class_rng(name: str) -> np.random.Generator:
    """Deterministic per-class generator: every instance of a class shares
    its signature pattern, making barcode-type classification learnable
    (real symbologies are visually distinctive; paper §4 reports per-type
    accuracy)."""
    seed = int.from_bytes(name.encode(), "little") % (2**31)
    return np.random.default_rng(seed)


# Per-class 1D rendering styles.  Round-2 diagnosis: group accuracy
# (1D/2D/postal) was 1.0 but within-1D accuracy ~0.15 — the old renderer
# drew every 1D class as stripes whose widths were *normalized to the
# instance width*, so the class signature was a relative-width sequence at
# unknown scale/phase, invisible to stride-4 features.  Each class now gets
# an orthogonal combination of LOW-FREQUENCY, SCALE-STABLE cues (mirroring
# how real symbologies actually differ to the eye):
#   module: narrow-bar width in ABSOLUTE pixels (2px stripes alias to
#     uniform gray at stride 4; 6px stripes resolve as black/white bands);
#   duty: dark fraction (mean-gray cue, survives contrast jitter as a
#     relative ordering);
#   structural mark: bottom text band w/ descending guards (EAN13), text
#     band + wide quiet zones (UPCA), inter-character gaps (Code39), none
#     (Code93), solid stop block right (Code128), stop blocks both ends
#     (Codabar), bearer bars top+bottom (ITF).
_1D_STYLE: dict[str, dict] = {
    "EAN13": dict(module=2, duty=0.50, band=True, guards=True),
    "UPCA": dict(module=2, duty=0.65, band=True, quiet=True),
    "Code39": dict(module=6, duty=0.35, gaps=True),
    "Code93": dict(module=6, duty=0.70),
    "Code128": dict(module=2, duty=0.45, stop_right=True),
    "Codabar": dict(module=5, duty=0.35, stop_both=True),
    "ITF": dict(module=4, duty=0.50, bearer=True),
}


def _render_1d(
    img: np.ndarray, rng: np.random.Generator, crng: np.random.Generator, style: dict
) -> None:
    """Draw a 1D symbology into ``img`` (in place) per its style dict."""
    h, w = img.shape
    module = float(style["module"]) * float(rng.uniform(0.9, 1.15))
    duty = float(style["duty"])
    wfactor = (1.0 - duty) / duty  # white-run multiplier hitting the duty
    # fixed per-class run-length sequence (in modules); instance: phase
    dark_seq = crng.integers(1, 3, 96)
    white_seq = crng.integers(1, 3, 96)
    phase = int(rng.integers(0, 96))
    # horizontal extent of the stripe field
    x0, x1 = 1, w - 1
    if style.get("quiet"):  # UPCA: wide white quiet zones both ends
        qz = max(3, int(0.12 * w))
        x0, x1 = qz, w - qz
    if style.get("stop_right"):  # Code128: solid stop block at right
        sw = max(6, int(0.10 * w))
        img[1 : h - 1, w - 1 - sw : w - 1] = 0
        x1 = w - 1 - sw - max(2, int(module))
    if style.get("stop_both"):  # Codabar: stop blocks at both ends
        sw = max(5, int(0.08 * w))
        img[1 : h - 1, 1 : 1 + sw] = 0
        img[1 : h - 1, w - 1 - sw : w - 1] = 0
        x0, x1 = 1 + sw + max(2, int(module)), w - 1 - sw - max(2, int(module))
    # vertical extent: text band reserves a white strip at the bottom
    y0, y1 = 1, h - 1
    band_h = 0
    if style.get("band"):
        band_h = max(3, int(0.28 * h))
        img[h - band_h :, :] = 255
        y1 = h - band_h
    # stripe field: alternate dark/white runs of the class's sequence
    x = float(x0)
    i = phase
    n_dark = 0
    while x < x1:
        dw = max(1.0, dark_seq[i % 96] * module)
        sw_ = max(1.0, white_seq[i % 96] * module * wfactor)
        xe = min(int(round(x + dw)), x1)
        if xe > int(x):
            img[y0:y1, int(x) : xe] = 0
        n_dark += 1
        x += dw + sw_
        if style.get("gaps") and n_dark % 4 == 0:  # Code39 inter-char gap
            x += 3.0 * module * wfactor
        i += 1
    if style.get("guards"):  # EAN13: guard pairs descend through the band
        for gx in (x0, (x0 + x1) // 2, x1 - 2 - int(module)):
            gx = int(np.clip(gx, 1, w - 3 - int(module)))
            img[y0 : h - 1, gx : gx + max(1, int(module))] = 0
            g2 = gx + 2 * max(1, int(module))
            img[y0 : h - 1, g2 : g2 + max(1, int(module))] = 0
    if style.get("bearer"):  # ITF: bearer bars along top and bottom
        t = max(2, int(0.12 * h))
        img[0:t, :] = 0
        img[h - t :, :] = 0


def _render_barcode(
    rng: np.random.Generator, w: int, h: int, group: str, name: str = ""
) -> np.ndarray:
    """A (h, w) uint8 barcode texture, dark modules on light quiet zone.

    Texture combines a fixed per-class signature (bar-width sequence /
    module layout / finder marks) with per-instance randomness.
    """
    img = np.full((h, w), 255, np.uint8)
    crng = _class_rng(name or group)
    if group == "1D":
        style = _1D_STYLE.get(name)
        if style is None:  # unknown 1D class: neutral medium stripes
            style = dict(module=3, duty=0.5)
        _render_1d(img, rng, crng, style)
    elif group == "postal":
        # per-class signature: bar pitch (px) + height levels + vertical
        # alignment (bottom-aligned / centered / 4-state), scale-stable
        # low-frequency cues like the _1D_STYLE table
        pstyle = {
            "Postnet": dict(pitch=4, levels=(0.45, 1.0), align="bottom"),
            "IntelligentMail": dict(pitch=5, levels=(0.4, 0.7, 1.0), align="4state"),
            "JapanPost": dict(pitch=7, levels=(0.5, 0.75, 1.0), align="center"),
            "RoyalMail": dict(pitch=3, levels=(0.4, 0.7, 1.0), align="4state"),
        }.get(name, dict(pitch=4, levels=(0.45, 0.7, 1.0), align="center"))
        pattern = crng.choice(pstyle["levels"], 48)
        updown = crng.integers(0, 2, 48)  # 4-state: ascender vs descender
        phase = int(rng.integers(0, 48))
        xs = np.arange(1, w - 2, pstyle["pitch"])
        for i, x in enumerate(xs):
            frac = pattern[(i + phase) % 48]
            bh = max(2, int(h * frac * 0.85))
            if pstyle["align"] == "bottom":
                r0, r1 = h - 1 - bh, h - 1
            elif pstyle["align"] == "center":
                r0, r1 = (h - bh) // 2, (h + bh) // 2
            else:  # 4-state: grow from center line up or down
                mid = h // 2
                if updown[(i + phase) % 48]:
                    r0, r1 = mid - bh, mid + max(1, int(0.2 * h))
                else:
                    r0, r1 = mid - max(1, int(0.2 * h)), mid + bh
            img[max(0, r0) : min(h, r1), x : x + 2] = 0
    else:  # 2D: class-specific module size + finder-mark style
        mod = max(2, min(w, h) // int(crng.integers(8, 16)))
        gh, gw = max(1, (h - 2) // mod), max(1, (w - 2) // mod)
        grid = rng.random((gh, gw)) < 0.5
        # finder style per class (cycled deterministically)
        style = int(crng.integers(0, 4))
        fs = max(2, min(gh, gw) // 4)
        if style == 0 and gh > fs and gw > fs:  # QR-like corner squares
            for (r0, c0) in [(0, 0), (0, gw - fs), (gh - fs, 0)]:
                grid[r0 : r0 + fs, c0 : c0 + fs] = True
                if fs > 2:
                    grid[r0 + 1 : r0 + fs - 1, c0 + 1 : c0 + fs - 1] = False
        elif style == 1:  # Aztec-like center bullseye
            cy, cx = gh // 2, gw // 2
            for ring in range(min(gh, gw) // 2):
                val = ring % 2 == 0
                r0, r1 = max(0, cy - ring), min(gh, cy + ring + 1)
                c0, c1 = max(0, cx - ring), min(gw, cx + ring + 1)
                grid[r0:r1, c0] = val
                grid[r0:r1, c1 - 1] = val
                grid[r0, c0:c1] = val
                grid[r1 - 1, c0:c1] = val
                if ring >= 3:
                    break
        elif style == 2:  # DataMatrix-like solid L border + dashed top/right
            grid[:, 0] = True
            grid[-1, :] = True
            grid[0, ::2] = True
            grid[::2, -1] = True
        else:  # PDF417-like row bands with start/stop bars
            grid[:, :2] = True
            grid[:, -2:] = True
            for r in range(0, gh, 2):
                grid[r, 2:-2] = rng.random(max(gw - 4, 0)) < 0.7
        tex = np.kron(grid, np.ones((mod, mod), bool))[: h - 2, : w - 2]
        img[1 : 1 + tex.shape[0], 1 : 1 + tex.shape[1]][tex] = 0
    return img


def _group_of(name: str) -> str:
    for g, names in CLASS_GROUPS.items():
        if name in names:
            return g
    return "2D"


def generate_sample(
    rng: np.random.Generator,
    hw: tuple[int, int] = (256, 256),
    n_objects: tuple[int, int] = (1, 4),
    class_names: tuple[str, ...] = DEFAULT_CLASS_NAMES,
    margin: int = 8,
) -> Sample:
    """One synthetic scene: background + rotated barcode rects + exact GT."""
    H, W = hw
    # paper-ish document background: light gray with smooth noise
    base = rng.uniform(170, 240)
    img = np.full((H, W), base, np.float32)
    img += rng.normal(0, 6, (H, W))
    objects: list[BarcodeObject] = []
    placed_aabbs: list[tuple[float, float, float, float]] = []
    n = int(rng.integers(n_objects[0], n_objects[1] + 1))
    for _ in range(n):
        name = str(rng.choice(class_names))
        group = _group_of(name)
        # absolute size ranges (clamped to the scene) so a model trained at
        # one scene resolution sees the same object scales at another —
        # r2's proportional sizes (bw ~ W/3) made 256px eval out-of-dist
        # for a 128px-trained model
        bw = int(rng.integers(40, max(41, min(108, W // 2))))
        bh = int(rng.integers(24, max(25, min(60, H // 3))))
        if group == "postal":
            bh = max(12, bh // 2)
        tex = _render_barcode(rng, bw, bh, group, name)
        ang = float(rng.uniform(-30, 30)) if rng.random() < 0.5 else 0.0
        c, s = np.cos(np.radians(ang)), np.sin(np.radians(ang))
        rot = np.array([[c, -s], [s, c]], np.float32)
        half = np.array([bw / 2, bh / 2], np.float32)
        ext = np.abs(rot) @ half  # rotated half-extent
        # rejection-sample a non-overlapping placement (objects must stay
        # separable components; the paper's scenes have disjoint barcodes)
        cx = cy = None
        for _try in range(20):
            tx = float(rng.uniform(margin + ext[0], W - margin - ext[0])) if W > 2 * (margin + ext[0]) else W / 2
            ty = float(rng.uniform(margin + ext[1], H - margin - ext[1])) if H > 2 * (margin + ext[1]) else H / 2
            aabb = (tx - ext[0] - 6, ty - ext[1] - 6, tx + ext[0] + 6, ty + ext[1] + 6)
            if all(
                aabb[2] < o[0] or o[2] < aabb[0] or aabb[3] < o[1] or o[3] < aabb[1]
                for o in placed_aabbs
            ):
                cx, cy = tx, ty
                placed_aabbs.append(aabb)
                break
        if cx is None:
            continue  # no room left; fewer objects in this scene
        corners = (
            np.array(
                [[-1, -1], [1, -1], [1, 1], [-1, 1]], np.float32
            )
            * half
        ) @ rot.T + [cx, cy]
        # paste with nearest-neighbor inverse mapping (host-side, tiny)
        y0, y1 = max(0, int(cy - ext[1]) - 1), min(H, int(cy + ext[1]) + 2)
        x0, x1 = max(0, int(cx - ext[0]) - 1), min(W, int(cx + ext[0]) + 2)
        yy, xx = np.mgrid[y0:y1, x0:x1]
        rel = np.stack([xx - cx, yy - cy], -1) @ rot  # inverse rotate
        u = rel[..., 0] + bw / 2
        v = rel[..., 1] + bh / 2
        inside = (u >= 0) & (u < bw) & (v >= 0) & (v < bh)
        ui = np.clip(u.astype(int), 0, bw - 1)
        vi = np.clip(v.astype(int), 0, bh - 1)
        patch = img[y0:y1, x0:x1]
        patch[inside] = tex[vi[inside], ui[inside]].astype(np.float32)
        img[y0:y1, x0:x1] = patch
        objects.append(BarcodeObject(points=corners.astype(np.float32), type_name=name))
    img = np.clip(img, 0, 255).astype(np.uint8)
    return Sample(image_path="<synthetic>", objects=objects, image=img)


class SyntheticMarkupReader(MarkupReader):
    """Deterministic synthetic dataset behind the MarkupReader interface.

    ``root`` is accepted (and ignored) for factory-signature compatibility.
    """

    def __init__(
        self,
        root=None,
        n_samples: int = 64,
        image_hw: tuple[int, int] = (256, 256),
        seed: int = 0,
        class_names: tuple[str, ...] = DEFAULT_CLASS_NAMES,
        n_objects: tuple[int, int] = (1, 4),
    ):
        self.n_samples = n_samples
        self.image_hw = image_hw
        self.seed = seed
        self.class_names = class_names
        self.n_objects = n_objects
        self._cache: dict[int, Sample] = {}

    def sample_at(self, i: int) -> Sample:
        if i not in self._cache:
            rng = np.random.default_rng(self.seed * 1_000_003 + i)
            self._cache[i] = generate_sample(
                rng, self.image_hw, self.n_objects, self.class_names
            )
        return self._cache[i]

    def samples(self) -> list[Sample]:
        return [self.sample_at(i) for i in range(self.n_samples)]

    def __len__(self) -> int:
        return self.n_samples
