"""PyTorch port: the context module + head (K4) and the fused f32 trunk,
held against the JAX package's Pallas kernel (interpret mode) and flax
model on the same numpy inputs (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ubdvss_tpu.models.model import get_model as jax_get_model
from ubdvss_tpu.models.model import init_params
from ubdvss_tpu.net_config import NetConfig as JaxNetConfig
from ubdvss_tpu.ops.pallas.context_kernel import _pack_weights as jax_pack_weights
from ubdvss_tpu.ops.pallas.context_kernel import _pallas_context_head
from ubdvss_tpu.ops.pallas.context_kernel import fused_model_apply as jax_fused_model_apply
from ubdvss_tpu_torch import NetConfig, params_from_flat
from ubdvss_tpu_torch.ops.cuda.context_kernel import (
    _pack_weights,
    context_head_reference,
    fused_context_head,
    fused_model_apply,
)

torch.set_num_threads(1)


def flat_params(params) -> dict:
    """The flat "/"-keyed arrays save_params_npz writes for a flax tree."""
    return {
        "/".join(str(k.key) for k in kp): np.asarray(v)
        for kp, v in jax.tree_util.tree_flatten_with_path(params)[0]
    }


def test_pack_weights_match_jax():
    """The port packs the state_dict into exactly the JAX kernel's tensors."""
    cfg = JaxNetConfig()
    params = init_params(cfg, 4)
    ours = _pack_weights(params_from_flat(flat_params(params)), cfg.dilations)
    ref = jax_pack_weights(params, cfg.dilations)
    for o, r in zip(ours, ref):
        assert tuple(o.shape) == r.shape
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_context_reference_matches_pallas_interpret():
    """Plain K4 == the Pallas kernel in interpret mode, within 1e-5 (as
    tests/test_context_kernel.py holds the JAX reference to it)."""
    cfg = JaxNetConfig(dilations=(1, 2, 4))
    params = init_params(cfg, 5)
    rng = np.random.default_rng(1)
    xc = rng.normal(0, 1, (2, cfg.channels, 32, 32)).astype(np.float32)
    w = jax_pack_weights(params, cfg.dilations)
    ref = np.asarray(_pallas_context_head(jnp.asarray(xc), *w, cfg.dilations, True))
    tw = [torch.from_numpy(np.array(a)) for a in w]
    out = context_head_reference(torch.from_numpy(xc), *tw, cfg.dilations).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)
    # a CPU tensor takes the plain version through the kernel wrapper
    wrapped = fused_context_head(torch.from_numpy(xc), *tw, cfg.dilations)
    np.testing.assert_array_equal(wrapped.numpy(), out)


@pytest.mark.parametrize("raw_gray", [False, True])
def test_fused_model_apply_matches_jax(raw_gray):
    """stem (F.conv2d, TF SAME padding, the raw_gray fold of x/127.5 - 1)
    + context + head == the JAX fused trunk in interpret mode and the flax
    model, within 1e-5."""
    jcfg = JaxNetConfig()
    params = init_params(jcfg, 3)
    rng = np.random.default_rng(0)
    gray = rng.integers(0, 256, (2, 64, 64, 1)).astype(np.float32)
    x = gray if raw_gray else gray * np.float32(1 / 127.5) - 1.0
    ref = np.asarray(
        jax_fused_model_apply(params, jnp.asarray(x), jcfg, interpret=True, raw_gray=raw_gray)
    )
    flax = np.asarray(
        jax_get_model(jcfg).apply({"params": params}, jnp.asarray(gray / 127.5 - 1.0))
    )
    out = fused_model_apply(
        params_from_flat(flat_params(params)), torch.from_numpy(x), NetConfig(),
        raw_gray=raw_gray,
    ).numpy()
    assert out.shape == ref.shape == (2, 16, 16, jcfg.n_output_channels)
    np.testing.assert_allclose(out, ref, atol=1e-5)
    np.testing.assert_allclose(out, flax, atol=1e-5)
