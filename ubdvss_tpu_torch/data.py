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

Three more sources keep that contract and that sample stream:
``DeviceCachedBatches`` holds the whole corpus on the device and builds
each batch there (no host collate, no copy a step); ``GrainBatches``
decodes and pads in a pool of worker processes; the on-device scene
synthesis (``synthgen.DeviceSyntheticBatches``) sets ``raster_window``,
which rasterizes each polygon on a window of that size
(``ops/rasterize.rasterize_polygons_windowed``).
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
from ubdvss_tpu_torch.ops.rasterize import (
    polygons_to_grid,
    rasterize_polygons,
    rasterize_polygons_windowed,
)


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
    # on-device synthesis (synthgen.synth_batch_step)
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
    ho = data_cfg.train_hw[0] // net_cfg.scale
    wo = data_cfg.train_hw[1] // net_cfg.scale
    grid_polys = polygons_to_grid(polys, net_cfg.scale)
    if data_cfg.raster_window is not None:
        segmap = rasterize_polygons_windowed(grid_polys, n_verts, class_ids, (ho, wo), data_cfg.raster_window)
    else:
        segmap = rasterize_polygons(grid_polys, n_verts, class_ids, (ho, wo))
    return {"images": normalize_fma(imgs)[..., None], "segmap": segmap, "polys": polys,
            "n_verts": n_verts, "class_ids": class_ids}


def batch_seed(epoch_seed: int, batch_index: int, *more: int) -> int:
    """The seed of one batch's generator, from the epoch's seed and the
    batch index (the JAX package folds the index into the epoch's key);
    the on-device synthesis passes (seed, epoch, step)."""
    return int(np.random.SeedSequence([epoch_seed, batch_index, *more]).generate_state(1, np.uint64)[0])


def device_batch_step(
    imgs: torch.Tensor,
    polys: torch.Tensor,
    n_verts: torch.Tensor,
    class_ids: torch.Tensor,
    net_cfg: NetConfig,
    data_cfg: DataConfig,
    train: bool,
    generator: torch.Generator | None = None,
    n_draws: int | None = None,
    rows: slice | None = None,
) -> dict:
    """All on-device batch processing: augment -> normalize -> rasterize.

    imgs: (B, H, W) f32 [0, 255] at train_hw.  Returns the batch contract.
    ``train`` with ``data_cfg.augment`` set augments first, drawing from
    ``generator`` (on the images' device; the JAX signature's PRNG key);
    ``n_draws`` and ``rows``: the images are those rows of a batch of
    ``n_draws`` (``ops.augment.augment_batch``)."""
    if train and data_cfg.augment is not None:
        if generator is None:
            raise ValueError("an augmented training batch needs a generator")
        imgs, polys = augment_batch(generator, imgs, polys, data_cfg.augment, n_draws, rows)
    return finalize_batch(imgs, polys, n_verts, class_ids, net_cfg, data_cfg)


def _epoch_order(n: int, dc: DataConfig, train: bool, epoch: int) -> np.ndarray:
    """The sample order of one epoch: shuffled for training by
    ``np.random.default_rng(dc.seed + epoch)``, as the JAX package."""
    order = np.arange(n)
    rng = np.random.default_rng(dc.seed + epoch)
    if dc.shuffle and train:
        rng.shuffle(order)
    return order


def _batch_generator(dc: DataConfig, train: bool, epoch: int, bi: int, dev: torch.device):
    """The augmentation generator of batch ``bi`` of ``epoch`` (None when
    the batch is not augmented)."""
    if not (train and dc.augment is not None):
        return None
    return torch.Generator(dev).manual_seed(batch_seed(dc.seed * 7919 + epoch, bi))


def _host_records(samples: list[Sample], net_cfg: NetConfig, dc: DataConfig):
    """Decoded images and padded polygons, vertex counts and class ids."""
    imgs, polys, nvs, cids = [], [], [], []
    for s in samples:
        imgs.append(np.asarray(load_image(s)))
        p, nv, ci = pad_polygons(s, net_cfg, dc.max_polys, dc.max_verts)
        polys.append(p)
        nvs.append(nv)
        cids.append(ci)
    return imgs, polys, nvs, cids


def _collate_records(imgs, polys, nvs, cids, dc: DataConfig, dev: torch.device):
    """Host records -> device (B, H, W) f32 images at ``train_hw``, scaled
    polys, vertex counts and class ids."""
    x, p = _collate_on_device(imgs, polys, dc.train_hw, dev)
    return x, p, _to_device(np.stack(nvs), dev), _to_device(np.stack(cids), dev)


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

    def epoch(self, epoch: int | None = None) -> Iterator[dict]:
        dc = self.data_cfg
        if epoch is None:
            epoch = self._epoch
            self._epoch += 1
        order = _epoch_order(len(self._samples), dc, self.train, epoch)
        b = dc.batch_size
        for bi in range(len(self)):
            idx = order[bi * b : (bi + 1) * b]
            records = _host_records([self._samples[i] for i in idx], self.net_cfg, dc)
            imgs, polys, nvs, cids = _collate_records(*records, dc, self.device)
            g = _batch_generator(dc, self.train, epoch, bi, self.device)
            yield device_batch_step(imgs, polys, nvs, cids, self.net_cfg, dc, self.train, g)

    def __iter__(self):
        return self.epoch()


class DeviceCachedBatches:
    """The corpus held on the device: decoded and collated once, as f32
    (N, H, W) images at ``train_hw`` plus the polygon arrays; every batch
    is then device work alone (gather, augment, normalize, rasterize), with
    no host collate and no copy a step.

    The order and each batch's generator are ``Batches``', so the sample
    stream is the same as streaming the reader through ``Batches``.
    ``max_bytes`` (8 GB, the JAX package's default) bounds the images'
    device footprint: a larger corpus raises ``ValueError`` before anything
    is loaded (use ``Batches`` or ``GrainBatches`` for it).

    ``mesh`` (or ``place_on_mesh``): the corpus is sharded over the mesh's
    data axis, its sample axis padded with zero rows to a multiple of the
    axis's N entries and entry i holding rows [i n_pad/N, (i+1) n_pad/N);
    the pad rows are never referenced.  ``shards_at`` builds each entry's
    shard of a batch from the rows the entries own, with the whole batch's
    draws (the unsharded stream).  On a mesh of several processes every
    process holds the whole corpus over its own entries."""

    def __init__(
        self,
        reader: MarkupReader,
        net_cfg: NetConfig,
        data_cfg: DataConfig,
        train: bool = True,
        max_bytes: int = 8 << 30,
        mesh=None,
        device=None,
    ):
        self.net_cfg = net_cfg
        self.data_cfg = data_cfg
        self.train = train
        if mesh is not None and device is None:
            device = mesh.axis_devices("data")[0]
        self.device = resolve_device(device)
        samples = reader.samples()
        n = len(samples)
        est = n * data_cfg.train_hw[0] * data_cfg.train_hw[1] * 4
        if est > max_bytes:
            raise ValueError(
                f"DeviceCachedBatches: corpus ~{est / 1e9:.1f} GB exceeds max_bytes="
                f"{max_bytes / 1e9:.1f} GB; stream it with Batches or GrainBatches")
        self._imgs, self._polys, self._nv, self._ci = _collate_records(
            *_host_records(samples, net_cfg, data_cfg), data_cfg, self.device)
        self._n = n
        self._mesh = None
        self._shards: list | None = None  # a (imgs, polys, n_verts, class_ids) an entry
        self._per_entry = 0
        if mesh is not None:
            self.place_on_mesh(mesh)

    def _corpus(self) -> tuple:
        """The four corpus arrays, whole, on ``self.device``."""
        if self._shards is None:
            return self._imgs, self._polys, self._nv, self._ci
        return tuple(torch.cat([sh[j].to(self.device) for sh in self._shards])[: self._n] for j in range(4))

    def place_on_mesh(self, mesh) -> None:
        """Shard the corpus over ``mesh``'s data axis (class docstring); a
        second call with the same mesh does nothing."""
        if mesh is self._mesh:
            return
        devs = mesh.axis_devices("data")
        pad = -self._n % len(devs)
        corpus = [torch.cat([a, a.new_zeros((pad, *a.shape[1:]))]) for a in self._corpus()]
        per = (self._n + pad) // len(devs)
        self._shards = [tuple(a[i * per:(i + 1) * per].to(d) for a in corpus) for i, d in enumerate(devs)]
        self._per_entry = per
        self._imgs = self._polys = self._nv = self._ci = None
        self._mesh = mesh

    def __len__(self) -> int:
        b = self.data_cfg.batch_size
        return self._n // b if self.data_cfg.drop_remainder else -(-self._n // b)

    def host_order(self, epoch: int) -> np.ndarray:
        """The epoch's sample order on the host."""
        return _epoch_order(self._n, self.data_cfg, self.train, epoch)

    def order(self, epoch: int) -> torch.Tensor:
        """The epoch's sample order on the device (one copy an epoch)."""
        return _to_device(self.host_order(epoch), self.device)

    def _gather(self, rows: np.ndarray, dev: torch.device) -> list:
        """The corpus rows ``rows`` (host indices), on ``dev``: each row
        gathered on the entry that owns it, then copied to ``dev``."""
        owner = rows // self._per_entry
        owners = np.unique(owner)
        out = None
        for j in owners:
            pos = np.nonzero(owner == j)[0]
            src = self._shards[j]
            loc = torch.from_numpy(rows[pos] - j * self._per_entry).to(src[0].device)
            got = [a[loc].to(dev) for a in src]
            if len(owners) == 1:
                return got
            if out is None:
                out = [a.new_empty((len(rows), *a.shape[1:])) for a in got]
            p = torch.from_numpy(pos).to(dev)
            for o, a in zip(out, got):
                o[p] = a
        return out

    def batch_at(self, order, epoch: int, bi: int) -> dict:
        """Batch ``bi`` of the epoch whose ``order`` is given: the rows of
        its slice of the order, gathered on the device, then
        ``device_batch_step``."""
        dc = self.data_cfg
        if self._shards is not None:
            return self._rows_batch(np.asarray(order.cpu() if torch.is_tensor(order) else order),
                                    epoch, bi, slice(None), self.device)
        idx = order[bi * dc.batch_size : (bi + 1) * dc.batch_size]
        g = _batch_generator(dc, self.train, epoch, bi, self.device)
        return device_batch_step(self._imgs[idx], self._polys[idx], self._nv[idx], self._ci[idx],
                                 self.net_cfg, dc, self.train, g)

    def _rows_batch(self, order: np.ndarray, epoch: int, bi: int, rows: slice, dev) -> dict:
        """The ``rows`` of batch ``bi`` on ``dev``, from the sharded corpus,
        with the whole batch's draws."""
        dc = self.data_cfg
        batch_rows = order[bi * dc.batch_size : (bi + 1) * dc.batch_size]
        g = _batch_generator(dc, self.train, epoch, bi, dev)
        return device_batch_step(*self._gather(batch_rows[rows], dev), self.net_cfg, dc, self.train, g,
                                 n_draws=len(batch_rows), rows=rows)

    def shards_at(self, order: np.ndarray, epoch: int, bi: int, mesh) -> list[dict]:
        """Batch ``bi`` of the epoch whose host ``order`` is given, as the
        shards of ``mesh``'s data axis (``parallel.mesh.entry_rows``; the
        corpus placed on ``mesh`` first): shard i on entry i, its rows
        equal to those rows of ``batch_at``'s batch."""
        from ubdvss_tpu_torch.parallel.mesh import entry_rows

        self.place_on_mesh(mesh)
        b = len(order[bi * self.data_cfg.batch_size : (bi + 1) * self.data_cfg.batch_size])
        return [self._rows_batch(order, epoch, bi, entry_rows(b, mesh, i), d)
                for i, d in enumerate(mesh.axis_devices("data"))]

    def epoch(self, epoch: int | None = None) -> Iterator[dict]:
        epoch = 0 if epoch is None else epoch
        order = self.order(epoch) if self._shards is None else self.host_order(epoch)
        for bi in range(len(self)):
            yield self.batch_at(order, epoch, bi)

    def __iter__(self):
        return self.epoch(0)


class _ReaderSource(torch.utils.data.Dataset):
    """One sample's decoded image and padded polygons, for a worker."""

    def __init__(self, samples, net_cfg: NetConfig, data_cfg: DataConfig):
        self._samples = samples
        self._net_cfg = net_cfg
        self._data_cfg = data_cfg

    def __len__(self) -> int:
        return len(self._samples)

    def __getitem__(self, i):
        return [r[0] for r in _host_records([self._samples[int(i)]], self._net_cfg, self._data_cfg)]


def _as_list(records):
    """The worker's batch as a list of records (a module-level function:
    the spawned workers unpickle it by name)."""
    return records


class GrainBatches:
    """Host loading in a pool of ``worker_count`` worker processes (the
    JAX package's grain loader; grain is not used here): a
    ``torch.utils.data.DataLoader`` whose spawned workers decode and pad a
    batch each, then the same device batch step as ``Batches``.

    The order is ``Batches``' (grain's own permutation is not reproduced),
    and so is each batch's generator: the batches equal ``Batches``'.
    ``worker_count=0`` loads in the calling process."""

    def __init__(
        self,
        reader: MarkupReader,
        net_cfg: NetConfig,
        data_cfg: DataConfig,
        train: bool = True,
        worker_count: int = 4,
        device=None,
    ):
        self.net_cfg = net_cfg
        self.data_cfg = data_cfg
        self.train = train
        self.worker_count = worker_count
        self.device = resolve_device(device)
        self._source = _ReaderSource(reader.samples(), net_cfg, data_cfg)

    def __len__(self) -> int:
        n = len(self._source)
        b = self.data_cfg.batch_size
        return n // b if self.data_cfg.drop_remainder else -(-n // b)

    def epoch(self, epoch: int | None = None) -> Iterator[dict]:
        dc = self.data_cfg
        epoch = 0 if epoch is None else epoch
        loader = torch.utils.data.DataLoader(
            self._source, batch_size=dc.batch_size,
            sampler=_epoch_order(len(self._source), dc, self.train, epoch).tolist(),
            drop_last=dc.drop_remainder, collate_fn=_as_list, num_workers=self.worker_count,
            multiprocessing_context="spawn" if self.worker_count else None)
        for bi, records in enumerate(loader):
            imgs, polys, nvs, cids = _collate_records(*zip(*records), dc, self.device)
            g = _batch_generator(dc, self.train, epoch, bi, self.device)
            yield device_batch_step(imgs, polys, nvs, cids, self.net_cfg, dc, self.train, g)

    def __iter__(self):
        return self.epoch(0)
