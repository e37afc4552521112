"""PyTorch port: the mined loss and the pixel metrics (``losses.py``,
``metrics.py``) against the jitted JAX functions on the CPU.

Tolerances: 1e-6 absolute on the losses (f32 sums of a few hundred terms,
taken in another order), the metrics exact; the bisection's selection and
its gradient equal the stable-sort formulation's exactly, as in the JAX
package (``tests/test_losses.py``), and the gradients equal JAX's within
1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ubdvss_tpu import losses as jl
from ubdvss_tpu import metrics as jm
from ubdvss_tpu.net_config import NetConfig as JaxNetConfig
from ubdvss_tpu_torch import losses as pl
from ubdvss_tpu_torch.metrics import pixel_detection_metrics
from ubdvss_tpu_torch.net_config import NetConfig

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _bce(logit, label):
    p = 1 / (1 + np.exp(-logit))
    return -(label * np.log(p) + (1 - label) * np.log(1 - p))


def test_bce_matches_definition_and_jax():
    logits = np.array([-3.0, -0.5, 0.0, 2.0, 30.0, -30.0], np.float32)
    labels = np.array([0.0, 1.0, 1.0, 0.0, 1.0, 0.0], np.float32)
    ours = pl.sigmoid_bce_from_logits(_t(logits), _t(labels)).numpy()
    np.testing.assert_allclose(ours, _bce(logits.astype(np.float64), labels), atol=1e-6)
    want = np.asarray(jax.jit(jl.sigmoid_bce_from_logits)(logits, labels))
    np.testing.assert_array_equal(ours, want)


@pytest.mark.parametrize("case", ["hard_negatives", "no_positives", "k_capped"])
def test_detection_loss_cases(case):
    """The JAX package's hand-computed mining cases, on the port and on the
    jitted JAX function."""
    if case == "hard_negatives":  # 1 positive, ratio 2: the 2 hardest negatives
        logits = np.array([[2.0, -1.0, 0.5], [-3.0, 1.5, -0.2]], np.float32)
        pos = np.zeros((2, 3), bool)
        pos[0, 0] = True
        ratio = 2.0
        neg = sorted((_bce(v, 0.0) for v in [-1.0, 0.5, -3.0, 1.5, -0.2]), reverse=True)
        expect = (_bce(2.0, 1.0) + neg[0] + neg[1]) / 3.0
    elif case == "no_positives":  # k = ratio hardest negatives
        logits = np.array([[5.0, -5.0], [-6.0, -7.0]], np.float32)
        pos = np.zeros((2, 2), bool)
        ratio = 3.0
        expect = sum(sorted((_bce(v, 0.0) for v in [5.0, -5.0, -6.0, -7.0]), reverse=True)[:3]) / 3.0
    else:  # k capped by the negatives available
        logits = np.array([[1.0, 2.0]], np.float32)
        pos = np.array([[True, False]])
        ratio = 5.0
        expect = (_bce(1.0, 1.0) + _bce(2.0, 0.0)) / 2.0
    for use_sort in (False, True):
        ours = float(pl.detection_loss_single(_t(logits), _t(pos), ratio, use_sort=use_sort))
        want = float(jax.jit(jl.detection_loss_single, static_argnums=(2, 3))(logits, pos, ratio, use_sort))
        assert abs(ours - expect) < 1e-6
        assert abs(ours - want) < 1e-6


def test_classification_loss_masked():
    logits = np.zeros((2, 2, 3), np.float32)
    logits[0, 0] = [5.0, 0.0, 0.0]
    logits[0, 1] = [0.0, 5.0, 0.0]
    segmap = np.array([[1, 2], [0, 0]], np.int32)
    ours = float(pl.classification_loss_single(_t(logits), _t(segmap)))
    p = np.exp(5.0) / (np.exp(5.0) + 2)
    assert abs(ours - -np.log(p)) < 1e-6
    assert abs(ours - float(jax.jit(jl.classification_loss_single)(logits, segmap))) < 1e-6
    # all background: zero, no NaN
    assert float(pl.classification_loss_single(_t(logits), torch.zeros((2, 2), dtype=torch.int32))) == 0.0


@pytest.mark.parametrize("classification", [True, False])
def test_total_loss_matches_jax(classification):
    """The batched loss, its aux keys and the cls-weight override against
    the jitted JAX ``total_loss``, and the composition per image."""
    kw = dict(class_names=("a", "b"), hard_negative_ratio=2, classification=classification)
    cfg, jcfg = NetConfig(**kw), JaxNetConfig(**kw)
    rng = np.random.default_rng(0)
    B, H, W = 3, 8, 8
    C = cfg.n_output_channels
    logits = rng.normal(0, 2, (B, H, W, C)).astype(np.float32)
    segmap = (rng.integers(0, 3, (B, H, W)) * (rng.random((B, H, W)) < 0.4)).astype(np.int32)
    segmap[2] = 0  # an empty page
    for w in (None, 0.25):
        loss, aux = pl.total_loss(_t(logits), _t(segmap), cfg, cls_weight=w)
        jloss, jaux = jax.jit(jl.total_loss, static_argnums=(2,))(logits, segmap, jcfg, w)
        assert sorted(aux) == sorted(jaux)
        for k in jaux:
            assert abs(float(aux[k]) - float(jaux[k])) < 1e-6, k
        assert abs(float(loss) - float(jloss)) < 1e-6
    det = np.mean([float(pl.detection_loss_single(_t(logits[i, ..., 0]), _t(segmap[i] > 0), 2.0))
                   for i in range(B)])
    assert abs(float(aux["detection_loss"]) - det) < 1e-6


@pytest.mark.parametrize("threshold", [0.5, 0.7])
def test_pixel_metrics_match_jax(threshold):
    logits = np.array([[10.0, -10.0], [10.0, -10.0]], np.float32)[None]
    segmap = np.array([[1, 0], [0, 2]], np.int32)[None]
    m = {k: float(v) for k, v in pixel_detection_metrics(_t(logits), _t(segmap)).items()}
    assert m == {"pixel_precision": 0.5, "pixel_recall": 0.5, "pixel_f1": 0.5, "pixel_accuracy": 0.5}
    rng = np.random.default_rng(1)
    logits = rng.normal(0, 1, (2, 16, 16)).astype(np.float32)
    # logits at the threshold's own f32 logit sit exactly on the boundary
    logits[0, 0, :4] = np.float32(np.log(np.float32(threshold / (1 - threshold))))
    segmap = rng.integers(0, 3, (2, 16, 16)).astype(np.int32)
    got = pixel_detection_metrics(_t(logits), _t(segmap), threshold)
    want = jax.jit(jm.pixel_detection_metrics, static_argnums=(2,))(logits, segmap, threshold)
    assert {k: float(v) for k, v in got.items()} == {k: float(v) for k, v in want.items()}


def _bisect_cases():
    rng = np.random.default_rng(0)
    cases = []
    for _ in range(5):
        cases.append((rng.normal(0, 3, (24, 24)).astype(np.float32), rng.random((24, 24)) < 0.1))
    q = rng.choice(np.array([-2.0, -0.5, 0.5, 2.0], np.float32), (24, 24))  # ties
    cases.append((q, rng.random((24, 24)) < 0.2))
    cases.append((q, np.zeros((24, 24), bool)))  # no positives
    cases.append((q, np.ones((24, 24), bool)))  # no negatives (k = 0)
    return cases


def test_bisect_matches_sort_mining():
    """The bisection equals the stable-sort top-k (random and tie-heavy
    fields, no-positive and all-positive images), per image and batched,
    and both equal the JAX package's."""
    cases = _bisect_cases()
    for logits, pos in cases:
        a = float(pl.detection_loss_single(_t(logits), _t(pos), 3.0, use_sort=True))
        b = float(pl.detection_loss_single(_t(logits), _t(pos), 3.0))
        assert abs(a - b) < 1e-5, (a, b)
        want = float(jax.jit(jl.detection_loss_single, static_argnums=(2, 3))(logits, pos, 3.0, False))
        assert abs(b - want) < 1e-6
    lg = torch.stack([_t(c[0]) for c in cases])
    ps = torch.stack([_t(c[1]) for c in cases])
    rows = pl._detection_loss_rows(lg, ps, 3.0)
    for i, (logits, pos) in enumerate(cases):
        assert float(rows[i]) == float(pl.detection_loss_single(_t(logits), _t(pos), 3.0))


def test_top_k_sum_bisect_zero_signs_and_k0():
    """Negative zeros read as negative int32 patterns, below every count
    threshold, as in the JAX bitcast; zeros and -0.0 mixed with ties; k = 0
    sums to 0.  Equal to the JAX package's ``_top_k_sum_bisect``."""
    x = np.array([0.0, -0.0, 0.5, 0.5, 0.0, -0.0, 2.0, 0.5, 0.0], np.float32)
    valid = np.array([1, 1, 1, 1, 1, 0, 1, 1, 1], bool)
    for k in range(0, 9):
        got = float(pl._top_k_sum_bisect(_t(x), _t(valid), torch.tensor(k, dtype=torch.int32)))
        want = float(jax.jit(jl._top_k_sum_bisect)(x, valid, jnp.int32(k)))
        assert got == want, (k, got, want)


def test_bisect_gradient_matches_sort():
    """The gradients of the bisection and of the stable sort are equal
    exactly, the k-th boundary pixel and exact ties included, and equal
    ``jax.grad`` of the JAX package's loss."""
    def grads(logits, pos, use_sort):
        lt = _t(logits).requires_grad_()
        pl.detection_loss_single(lt, _t(pos), 3.0, use_sort=use_sort).backward()
        return lt.grad.numpy()

    cases = []
    for seed in range(4):
        rng = np.random.default_rng(seed)
        cases.append((rng.normal(size=(12, 12)).astype(np.float32), rng.random((12, 12)) < 0.15))
    rng = np.random.default_rng(42)  # exact ties at the selection boundary
    tied = np.repeat(rng.normal(size=(9,)), 16).reshape(12, 12).astype(np.float32)
    pos = np.zeros((12, 12), bool)
    pos[0, 0] = True
    cases.append((tied, pos))
    for logits, pos in cases:
        g_sort, g_bis = grads(logits, pos, True), grads(logits, pos, False)
        np.testing.assert_array_equal(g_sort, g_bis)
        g_jax = jax.jit(jax.grad(lambda l: jl.detection_loss_single(l, pos, 3.0)))(logits)
        np.testing.assert_allclose(g_bis, np.asarray(g_jax), rtol=0, atol=1e-7)
