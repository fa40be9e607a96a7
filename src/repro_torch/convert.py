"""Carry the reference's parameters across: ``lm_init`` tree or CNN
``ParamStore.params`` -> port params.

For the LMs, the reference stacks the layers of each scanned unit position along a
leading axis (``unit_0/...`` leaves of shape ``(n_units, ...)``); the port
keeps a list of per-layer dicts.  Dense kernels are ``(K, N)`` on both
sides, so every other leaf maps one to one: attention blocks and Mamba-2
blocks (``in_proj``, ``conv_w``, ``conv_b``, ``a_log``, ``dt_bias``,
``d_skip``, ``norm``, ``out_proj``) alike.
"""

from __future__ import annotations

import numpy as np
import torch


def _to_torch(tree, device, index=None):
    if isinstance(tree, dict):
        return {k: _to_torch(v, device, index) for k, v in tree.items()}
    a = np.asarray(tree)
    if index is not None:
        a = a[index]
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)  # a writable copy


def params_from_jax(tree: dict, cfg, *, device="cpu") -> dict:
    """The JAX ``lm_init(key, cfg)`` tree, with numpy (or array-like)
    leaves, as the port's parameter dict on ``device``."""
    cfg.check_supported()
    params = {
        "embed": _to_torch(tree["embed"], device),
        "final_norm": _to_torch(tree["final_norm"], device),
        "layers": [_to_torch(tree[f"unit_{u}"], device, index=i)
                   for i, u in cfg.layer_kinds],
    }
    if "lm_head" in tree:
        params["lm_head"] = _to_torch(tree["lm_head"], device)
    return params


def cnn_params_from_jax(params: dict, *, device="cpu") -> dict:
    """The reference's CNN ``ParamStore.params`` (name -> array, conv
    weights HWIO) as the port's parameter dict on ``device``: the same
    names and layouts, so both packages compute the same thing."""
    return {name: _to_torch(a, device) for name, a in params.items()}
