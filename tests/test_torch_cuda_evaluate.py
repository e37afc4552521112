"""PyTorch port: evaluation on the card against the same calls on the host
CPU — ``run_evaluation`` (resized and native, f32 and int8), the eval
batch pipeline, and the prefetch thread's stream-and-event hand-over.

Marked ``cuda``; every test skips without a card.  On the H100 (no jax
there, so without the JAX-importing conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_evaluate.py -q

"Equal" for two reports: the same tp, fp, fn, n_pred, n_gt and per-class
counts, and the same F1.  Batches: the card's images, polygons, counts and
segmaps equal the host CPU's bit for bit where the resize is exact in any
order (grid-aligned and dyadic-ratio sources, ``tests/test_torch_data.py``).
"""

import dataclasses
import functools
from pathlib import Path

import pytest
import torch

from ubdvss_tpu_torch import load_net_config, load_params_npz, params_from_flat
from ubdvss_tpu_torch.data import Batches, DataConfig
from ubdvss_tpu_torch.evaluate import run_evaluation
from ubdvss_tpu_torch.ops.quant import qparams_to, quantize_trunk
from ubdvss_tpu_torch.synthetic import SyntheticMarkupReader
from ubdvss_tpu_torch.utils.prefetch import prefetched

pytestmark = pytest.mark.cuda

ASSET = Path(__file__).resolve().parent.parent / "assets" / "pretrained_synthetic.npz"


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def _asset():
    return load_net_config(ASSET), params_from_flat(load_params_npz(ASSET))


def _counts(r):
    return dict(tp=r.tp, fp=r.fp, fn=r.fn, n_pred=r.n_pred, n_gt=r.n_gt, f1=r.f1,
                per_class={n: (c["tp"], c["fp"], c["fn"]) for n, c in (r.per_class or {}).items()})


class _TwoSizes:
    def __init__(self):
        self.parts = [SyntheticMarkupReader(n_samples=5, image_hw=(256, 256), seed=2),
                      SyntheticMarkupReader(n_samples=3, image_hw=(192, 256), seed=3)]

    def samples(self):
        return [s for r in self.parts for s in r.samples()]


@pytest.mark.parametrize("native", [False, True], ids=["resized", "native"])
@pytest.mark.parametrize("mode", ["f32", "int8"])
def test_run_evaluation_card_equals_cpu(dev, mode, native):
    """20 synthetic 256² scenes at batch 8 (a remainder of 4), or native
    mode on two source sizes at batch 4; int8 on qparams calibrated on the
    card and carried to the host CPU."""
    cfg, params = _asset()
    reader = _TwoSizes() if native else SyntheticMarkupReader(n_samples=20, image_hw=(256, 256))
    dc = DataConfig(batch_size=4 if native else 8, train_hw=(256, 256), max_polys=32)
    q = None
    if mode == "int8":
        cal = torch.cat([b["images"] for b in Batches(
            SyntheticMarkupReader(n_samples=16, image_hw=(256, 256)), cfg,
            dataclasses.replace(dc, augment=None), train=False, device=dev)])
        q = quantize_trunk({k: v.to(dev) for k, v in params.items()}, cfg, cal)
    card = run_evaluation(params, reader, cfg, dc, native=native, qparams=q, device=dev)
    host = run_evaluation(params, reader, cfg, dc, native=native,
                          qparams=None if q is None else qparams_to(q, "cpu"), device="cpu")
    assert _counts(card) == _counts(host)
    assert card.tp > 0 and card.n_images == (8 if native else 20)


def _dyadic_samples():
    """Mixed source shapes whose resizes to 64x48 are exact in any order."""
    return [SyntheticMarkupReader(n_samples=1, image_hw=shape, seed=i).sample_at(0)
            for i, shape in enumerate([(48, 60), (64, 72), (40, 36), (64, 48)] * 2 + [(48, 60)])]


class _List:
    def __init__(self, samples):
        self._samples = samples

    def samples(self):
        return self._samples


@pytest.mark.parametrize("shapes", ["uniform", "mixed"])
def test_prefetched_batches_equal_synchronous(dev, shapes):
    """Batches through the prefetch thread (its own stream, an event a
    batch, record_stream) equal the synchronous batches and the host CPU's,
    bit for bit, in both collate routes."""
    cfg, _ = _asset()
    if shapes == "uniform":
        reader, hw = SyntheticMarkupReader(n_samples=19, image_hw=(256, 256)), (256, 256)
    else:
        reader, hw = _List(_dyadic_samples()), (64, 48)
    dc = DataConfig(batch_size=4, train_hw=hw, max_polys=32, augment=None, shuffle=False,
                    drop_remainder=False)
    sync = list(Batches(reader, cfg, dc, train=False, device=dev).epoch(0))
    for depth in (1, 3):
        got = list(prefetched(Batches(reader, cfg, dc, train=False, device=dev).epoch(0),
                              depth=depth, device=dev))
        # consume on the default stream while the worker may still copy
        got = [{k: v.clone() for k, v in b.items()} for b in got]
        assert len(got) == len(sync)
        for g, s in zip(got, sync):
            for k in s:
                assert g[k].device.type == dev.type and torch.equal(g[k], s[k]), k
    host = list(Batches(reader, cfg, dc, train=False, device="cpu").epoch(0))
    for s, h in zip(sync, host):
        for k in h:
            assert torch.equal(s[k].cpu(), h[k]), k
