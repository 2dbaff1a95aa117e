"""Inference-only neural-network potential nodes (reference: src/nn.cpp).

The reference hand-writes a conv-as-matmul forward and backward; in JAX the
convolution is one einsum and the backward pass is autodiff.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .base import register_node


def _backbone_featurizer(consts, params, inputs, extra):
    rama, hbond = inputs
    r = rama[consts["rama_idx"]]                  # (n, 2)
    don_idx = consts["donor_idx"]                 # -1 => no donor
    acc_idx = consts["acceptor_idx"]
    don_hb = jnp.where(don_idx >= 0, hbond[jnp.maximum(don_idx, 0), 6], 0.0)
    acc_hb = jnp.where(acc_idx >= 0, hbond[jnp.maximum(acc_idx, 0), 6], 0.0)
    return jnp.stack([jnp.sin(r[:, 0]), jnp.cos(r[:, 0]),
                      jnp.sin(r[:, 1]), jnp.cos(r[:, 1]),
                      don_hb, acc_hb], axis=-1)


backbone_featurizer = register_node("backbone_featurizer", False,
                                    _backbone_featurizer)


def _conv1d(consts, params, inputs, extra):
    x = inputs[0]                                  # (n_in, in_channels)
    w = params["weights"]                          # (width, in_c, out_c)
    b = params["bias"]                             # (out_c,)
    width = w.shape[0]
    n_out = x.shape[0] - width + 1
    # valid 1D convolution as a stacked einsum
    windows = jnp.stack([x[i:i + n_out] for i in range(width)], axis=1)
    y = jnp.einsum('nwc,wco->no', windows, w) + b
    act = consts["activation"]
    if act == "ReLU":
        y = jnp.maximum(y, 0.0)
    elif act == "Tanh":
        y = jnp.tanh(y)
    elif act != "Identity":
        raise ValueError(f"unknown activation {act}")
    return y


conv1d = register_node("conv1d", False, _conv1d)


def _scaled_sum(consts, params, inputs, extra):
    return consts["scale"] * jnp.sum(inputs[0][:, 0])


scaled_sum = register_node("scaled_sum", True, _scaled_sum)
