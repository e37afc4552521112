"""Import weights from the Keras reference implementation.

Counterpart of ``ubdvss_tpu/utils/keras_import.py``: the reference trains
with Keras and checkpoints ``.h5`` files; this module loads such weights
into the port's ``BarcodeFCN`` state_dict, so reference-trained detectors
run on the card unchanged.  The Keras layers' kernels are HWIO, as the JAX
package's flax kernels, so they go through the flat flax-path keys and
``utils/checkpoint.params_from_flat``, the same route as an ``.npz``.

Keras is imported inside the functions: it is an interop dependency, never
on the compute path (the H100 machine has neither keras nor tensorflow).
"""

from __future__ import annotations

import numpy as np
import torch

from ubdvss_tpu_torch.net_config import NetConfig
from ubdvss_tpu_torch.utils.checkpoint import params_from_flat


def build_keras_model(cfg: NetConfig, input_hw=(None, None)):
    """The reference architecture in Keras (the JAX package's, layer for
    layer, with its layer names)."""
    import keras

    inp = keras.Input(shape=(*input_hw, 1))
    x = inp
    for i in range(2):
        x = keras.layers.Conv2D(
            cfg.channels, 3, strides=2, padding="same", activation="relu",
            name=f"downscale_{i}",
        )(x)
    for i, d in enumerate(cfg.dilations):
        if cfg.separable_context:
            x = keras.layers.DepthwiseConv2D(
                3, dilation_rate=d, padding="same", use_bias=False,
                name=f"context_{i}_dw",
            )(x)
            x = keras.layers.Conv2D(
                cfg.channels, 1, padding="same", name=f"context_{i}_pw"
            )(x)
        else:
            x = keras.layers.Conv2D(
                cfg.channels, 3, dilation_rate=d, padding="same",
                name=f"context_{i}",
            )(x)
        x = keras.layers.ReLU()(x)
    out = keras.layers.Conv2D(
        cfg.n_output_channels, 1, padding="same", name="head"
    )(x)
    return keras.Model(inp, out)


def params_from_keras_model(model, cfg: NetConfig) -> dict[str, torch.Tensor]:
    """Keras model (layer names as in build_keras_model) -> the port's
    state_dict."""
    flat: dict[str, np.ndarray] = {}

    def put(name, kernel, bias=None):
        flat[f"{name}/kernel"] = np.asarray(kernel)
        if bias is not None:
            flat[f"{name}/bias"] = np.asarray(bias)

    for i in range(2):
        put(f"downscale_{i}", *model.get_layer(f"downscale_{i}").get_weights())
    for i in range(len(cfg.dilations)):
        if cfg.separable_context:
            (dw,) = model.get_layer(f"context_{i}_dw").get_weights()
            # keras depthwise (3,3,C,1) -> flax grouped-conv (3,3,1,C)
            put(f"context_{i}/depthwise", np.asarray(dw).transpose(0, 1, 3, 2))
            put(f"context_{i}/pointwise", *model.get_layer(f"context_{i}_pw").get_weights())
        else:
            put(f"context_{i}", *model.get_layer(f"context_{i}").get_weights())
    put("head", *model.get_layer("head").get_weights())
    return params_from_flat(flat)


def load_keras_weights(path: str, cfg: NetConfig) -> dict[str, torch.Tensor]:
    """Load a Keras .h5/.weights.h5/.keras checkpoint into the port's
    state_dict."""
    model = build_keras_model(cfg)
    model.load_weights(path)
    return params_from_keras_model(model, cfg)
