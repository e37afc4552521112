"""Input pipeline, evaluation half: markup samples -> batched device tensors.

Counterpart of ``ubdvss_tpu/data.py``.  The host only loads bytes (image
decode) and pads the polygons; grayscale, resize to ``train_hw``,
normalize and polygon rasterization into the GT segmaps run on the device
(the card unless ``device="cpu"``), with the JAX package's numerics:

  * the resize is ``ops/preproc.resize_bilinear`` (rows, then columns);
  * the batch normalize is ``ops/quant.normalize_fma`` — ``x / 127.5 - 1``
    rounded once, as XLA fuses it inside the JAX package's jitted
    ``device_batch_step``;
  * polygons go to the grid by ``ops/rasterize.polygons_to_grid`` and are
    filled by ``ops/rasterize.rasterize_polygons``.

Batch contract (static shapes, cfg-bounded):
  images:   (B, H, W, 1) f32 normalized [-1, 1]
  segmap:   (B, H/scale, W/scale) int32, 0 bg / 1+class_idx
  polys:    (B, max_polys, max_verts, 2) f32 at train_hw, with n_verts and
            class_ids (B, max_polys) int32

Training batches (``train=True``) run ``ops/augment.augment_batch`` first,
from a ``torch.Generator`` on the batch's device seeded by
``batch_seed(dc.seed * 7919 + epoch, batch_index)``, the counterpart of the
JAX package's ``fold_in(key(dc.seed * 7919 + epoch), batch_index)``; the
shuffle is the JAX package's, ``np.random.default_rng(dc.seed + epoch)``.
The device-fed pipelines (``DeviceCachedBatches``, the on-device synthesis
and its ``raster_window``) and ``GrainBatches`` are the next slice of
training (ROADMAP.md §1 item 10b): ``raster_window`` raises
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Iterator

import numpy as np
import torch

from ubdvss_tpu_torch.inference import resolve_device
from ubdvss_tpu_torch.markup import MarkupReader, Sample
from ubdvss_tpu_torch.net_config import NetConfig
from ubdvss_tpu_torch.ops.augment import AugmentConfig, augment_batch
from ubdvss_tpu_torch.ops.preproc import resize_bilinear, rgb_to_grayscale
from ubdvss_tpu_torch.ops.quant import normalize_fma
from ubdvss_tpu_torch.ops.rasterize import polygons_to_grid, rasterize_polygons


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch_size: int = 8
    train_hw: tuple[int, int] = (256, 256)
    max_polys: int = 8
    max_verts: int = 8
    augment: AugmentConfig | None = AugmentConfig()
    shuffle: bool = True
    seed: int = 0
    drop_remainder: bool = True
    # GT-size bound for object-windowed rasterization (grid px), set by the
    # on-device synthesis: not ported (ROADMAP.md §1 item 10b)
    raster_window: int | None = None


def load_image(sample: Sample) -> np.ndarray:
    """Host-side byte loading only (decode). Returns (H, W) or (H, W, 3)."""
    if sample.image is not None:
        return sample.image
    import cv2

    img = cv2.imread(sample.image_path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(sample.image_path)
    if img.ndim == 3:
        img = img[..., ::-1]  # BGR -> RGB
    return img


def pad_polygons(sample: Sample, net_cfg: NetConfig, max_polys: int, max_verts: int):
    """(P, V, 2) f32 polys (input coords), (P,) counts, (P,) 1+class ids."""
    if len(sample.objects) > max_polys:
        # silent GT truncation corrupts both training targets and eval FN
        # counts — surface it; raise DataConfig.max_polys
        warnings.warn(
            f"sample has {len(sample.objects)} objects but max_polys="
            f"{max_polys}; excess ground truth is DROPPED — raise "
            "DataConfig.max_polys",
            stacklevel=2,
        )
    polys = np.zeros((max_polys, max_verts, 2), np.float32)
    n_verts = np.zeros(max_polys, np.int32)
    class_ids = np.zeros(max_polys, np.int32)
    for i, obj in enumerate(sample.objects[:max_polys]):
        pts = obj.points[:max_verts]
        polys[i, : len(pts)] = pts
        n_verts[i] = len(pts)
        if net_cfg.classification:
            class_ids[i] = 1 + net_cfg.class_index(obj.type_name)
        else:
            class_ids[i] = 1
    return polys, n_verts, class_ids


def _to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Host array -> ``dev``.  On the card: one copy from pinned memory on
    the current stream (the prefetch worker's own stream when the batches
    are prefetched, ``utils/prefetch.py``)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type == "cpu":
        return t
    return t.pin_memory().to(dev, non_blocking=True)


def _resize_with_polys(x: torch.Tensor, polys: torch.Tensor, out_hw: tuple[int, int]):
    h, w = x.shape[-2:]
    scale = torch.tensor([out_hw[1] / w, out_hw[0] / h], dtype=torch.float32, device=polys.device)
    return resize_bilinear(x, out_hw), polys * scale


def _to_train_shape(img: torch.Tensor, polys: torch.Tensor, out_hw: tuple[int, int]):
    """Grayscale + resize one (H, W[, 3]) image to the common train shape;
    scale its (P, V, 2) polys to match."""
    x = img.to(torch.float32)
    if x.ndim == 3:
        x = rgb_to_grayscale(x, "rgb")
    return _resize_with_polys(x, polys, out_hw)


def _batch_to_train_shape(imgs: torch.Tensor, polys: torch.Tensor, out_hw: tuple[int, int]):
    """Batched ``_to_train_shape``: (B, H, W[, 3]) uint8 -> (B, H', W') f32,
    one batched resize instead of B per-sample ones."""
    x = imgs.to(torch.float32)
    if x.ndim == 4:
        x = rgb_to_grayscale(x, "rgb")
    return _resize_with_polys(x, polys, out_hw)


def _collate_on_device(imgs_np: list, polys_np: list, out_hw: tuple[int, int], dev: torch.device):
    """Host lists -> device (B, H', W') f32 images + scaled polys.

    Same-shaped batches take one stacked uint8 copy to the device and one
    batched resize; a batch of mixed shapes goes per sample."""
    if len({a.shape for a in imgs_np}) == 1:
        return _batch_to_train_shape(
            _to_device(np.stack(imgs_np), dev),
            _to_device(np.stack(polys_np).astype(np.float32), dev),
            out_hw,
        )
    xs, ps = [], []
    for a, p in zip(imgs_np, polys_np):
        x, pp = _to_train_shape(_to_device(a, dev), _to_device(p, dev), out_hw)
        xs.append(x)
        ps.append(pp)
    return torch.stack(xs), torch.stack(ps)


def finalize_batch(
    imgs: torch.Tensor,
    polys: torch.Tensor,
    n_verts: torch.Tensor,
    class_ids: torch.Tensor,
    net_cfg: NetConfig,
    data_cfg: DataConfig,
) -> dict:
    """Normalize + rasterize tail of the batch pipeline: (B, H, W) f32
    [0, 255] images at ``train_hw`` -> the batch contract."""
    if data_cfg.raster_window is not None:
        raise NotImplementedError(
            "DataConfig.raster_window (rasterize_polygons_windowed): ROADMAP.md §1 item 10b"
        )
    ho = data_cfg.train_hw[0] // net_cfg.scale
    wo = data_cfg.train_hw[1] // net_cfg.scale
    segmap = rasterize_polygons(polygons_to_grid(polys, net_cfg.scale), n_verts, class_ids, (ho, wo))
    return {"images": normalize_fma(imgs)[..., None], "segmap": segmap, "polys": polys,
            "n_verts": n_verts, "class_ids": class_ids}


def batch_seed(epoch_seed: int, batch_index: int) -> int:
    """The seed of one batch's augmentation generator, from the epoch's
    seed and the batch index (the JAX package folds the index into the
    epoch's key)."""
    return int(np.random.SeedSequence([epoch_seed, batch_index]).generate_state(1, np.uint64)[0])


def device_batch_step(
    imgs: torch.Tensor,
    polys: torch.Tensor,
    n_verts: torch.Tensor,
    class_ids: torch.Tensor,
    net_cfg: NetConfig,
    data_cfg: DataConfig,
    train: bool,
    generator: torch.Generator | None = None,
) -> dict:
    """All on-device batch processing: augment -> normalize -> rasterize.

    imgs: (B, H, W) f32 [0, 255] at train_hw.  Returns the batch contract.
    ``train`` with ``data_cfg.augment`` set augments first, drawing from
    ``generator`` (on the images' device; the JAX signature's PRNG key)."""
    if train and data_cfg.augment is not None:
        if generator is None:
            raise ValueError("an augmented training batch needs a generator")
        imgs, polys = augment_batch(generator, imgs, polys, data_cfg.augment)
    return finalize_batch(imgs, polys, n_verts, class_ids, net_cfg, data_cfg)


class Batches:
    """Iterable over device-ready batches (the reference's generator role).

    Runs on ``device`` (the card unless ``device="cpu"``).  Training batches
    are shuffled and, with ``data_cfg.augment``, augmented (module
    docstring)."""

    def __init__(
        self,
        reader: MarkupReader,
        net_cfg: NetConfig,
        data_cfg: DataConfig,
        train: bool = True,
        device=None,
    ):
        self.reader = reader
        self.net_cfg = net_cfg
        self.data_cfg = data_cfg
        self.train = train
        self.device = resolve_device(device)
        self._samples = reader.samples()
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self._samples)
        b = self.data_cfg.batch_size
        return n // b if self.data_cfg.drop_remainder else -(-n // b)

    def _host_collate(self, samples: list[Sample]):
        cfg, dc = self.net_cfg, self.data_cfg
        imgs, polys, nvs, cids = [], [], [], []
        for s in samples:
            imgs.append(np.asarray(load_image(s)))
            p, nv, ci = pad_polygons(s, cfg, dc.max_polys, dc.max_verts)
            polys.append(p)
            nvs.append(nv)
            cids.append(ci)
        x, p = _collate_on_device(imgs, polys, dc.train_hw, self.device)
        return x, p, _to_device(np.stack(nvs), self.device), _to_device(np.stack(cids), self.device)

    def epoch(self, epoch: int | None = None) -> Iterator[dict]:
        dc = self.data_cfg
        if epoch is None:
            epoch = self._epoch
            self._epoch += 1
        order = np.arange(len(self._samples))
        rng = np.random.default_rng(dc.seed + epoch)
        if dc.shuffle and self.train:
            rng.shuffle(order)
        b = dc.batch_size
        for bi in range(len(self)):
            idx = order[bi * b : (bi + 1) * b]
            if len(idx) < b and dc.drop_remainder:
                break
            imgs, polys, nvs, cids = self._host_collate([self._samples[i] for i in idx])
            g = None
            if self.train and dc.augment is not None:
                g = torch.Generator(self.device).manual_seed(batch_seed(dc.seed * 7919 + epoch, bi))
            yield device_batch_step(imgs, polys, nvs, cids, self.net_cfg, dc, self.train, g)

    def __iter__(self):
        return self.epoch()
