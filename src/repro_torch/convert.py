"""Carry the reference's parameters and train state across: ``lm_init``
tree or CNN ``ParamStore.params`` -> port params; the reference's LM train
state (``TrainState`` / a checkpoint's flat names) -> the port's.

For the LMs, the reference stacks the layers of each scanned unit position along a
leading axis (``unit_0/...`` leaves of shape ``(n_units, ...)``) and keeps
unrolled ``prefix_i`` / ``suffix_i`` layers; the port keeps a list of
per-layer dicts in layer order (``LMConfig.layer_plan``).  Dense kernels
are ``(K, N)`` on both sides, so every other leaf maps one to one:
attention blocks (with qwen2's ``bias`` leaves), MLA blocks (``wq``,
``wdkv``, ``wkr``, ``wuk``, ``wuv``, ``wo``), Mamba-2 blocks
(``in_proj``, ``conv_w``, ``conv_b``, ``a_log``, ``dt_bias``, ``d_skip``,
``norm``, ``out_proj``), RG-LRU blocks (``wx``, ``wy``, ``conv_w``,
``conv_b``, ``w_r``, ``w_i``, ``lam``, ``wo``) and MoE FFNs (``router``,
the (E, d, f) / (E, f, d) ``w_gate`` / ``w_up`` / ``w_down`` and the
``shared`` SwiGLU) alike.  The encoder-decoder (whisper) stacks its
layers on both sides, so its tree maps leaf for leaf.
"""

from __future__ import annotations

import numpy as np
import torch


def _to_torch(tree, device, index=None):
    if isinstance(tree, dict):
        return {k: _to_torch(v, device, index) for k, v in tree.items()}
    a = np.asarray(tree)
    if index is not None and a.ndim:  # 0-d leaves (sgdm's v) are not stacked
        a = a[index]
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)  # a writable copy


def params_from_jax(tree: dict, cfg, *, device="cpu") -> dict:
    """The JAX ``lm_init(key, cfg)`` tree, with numpy (or array-like)
    leaves, as the port's parameter dict on ``device``."""
    cfg.check_supported()
    params = {
        "embed": _to_torch(tree["embed"], device),
        "final_norm": _to_torch(tree["final_norm"], device),
        "layers": [_to_torch(tree[key], device, index=i) for key, i, _ in cfg.layer_plan],
    }
    if "lm_head" in tree:
        params["lm_head"] = _to_torch(tree["lm_head"], device)
    return params


def encdec_params_from_jax(tree: dict, *, device="cpu") -> dict:
    """The JAX ``encdec_init(key, cfg)`` tree (whisper) as the port's
    parameters on ``device``: the same layout, the encoder and decoder
    layers stacked along a leading axis on both sides."""
    return _to_torch(tree, device)


def cnn_params_from_jax(params: dict, *, device="cpu") -> dict:
    """The reference's CNN ``ParamStore.params`` (name -> array, conv
    weights HWIO) as the port's parameter dict on ``device``: the same
    names and layouts, so both packages compute the same thing."""
    return {name: _to_torch(a, device) for name, a in params.items()}


# -- train state ------------------------------------------------------------------


def _like(tree, like):
    """``tree`` with its dicts in ``like``'s key order (the optimizer draws
    leaf i's SR seed by walk order, so a restored state walks as a fresh
    one does)."""
    if like is None:
        return tree
    if isinstance(like, dict):
        return {k: _like(tree[k], like[k]) for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_like(t, s) for t, s in zip(tree, like))
    return tree


def train_state_from_jax(params, opt_state, step, rng, cfg, *, device="cpu", like=None,
                         ef=None):
    """The reference's LM train state (numpy or array-like leaves) as the
    port's :class:`~repro_torch.runtime.train.TrainState` on ``device``:
    ``params``, the moments ``opt_state.m`` / ``.v`` and the error-feedback
    buffers ``ef`` (if any) in the ``lm_init`` layout through
    :func:`params_from_jax`, ``opt_state.step`` and ``step`` as ints, and
    the seed from ``rng`` = ``PRNGKey(seed)`` (``[0, seed]``).  ``like`` (a
    state or parameter tree of the port's) gives the dicts' key order."""
    from repro_torch.optim.optimizers import OptState
    from repro_torch.runtime.train import TrainState

    like_p = getattr(like, "params", like)
    tree = [None if t is None else _like(params_from_jax(t, cfg, device=device), like_p)
            for t in (params, opt_state.m, opt_state.v, ef)]
    return TrainState(tree[0], OptState(int(np.asarray(opt_state.step)), tree[1], tree[2]),
                      int(np.asarray(step)), int(np.asarray(rng)[1]), tree[3])


def _nest(flat: dict, prefix: str) -> dict:
    """The names under ``prefix/`` as a nested dict."""
    out: dict = {}
    for name, a in flat.items():
        if name.startswith(prefix + "/"):
            *path, leaf = name[len(prefix) + 1:].split("/")
            node = out
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = a
    return out


def train_state_from_flat(flat: dict, cfg, *, device="cpu", like=None):
    """A checkpoint's ``{name: array}`` (the reference's names:
    ``0/<param path>``, ``1/.step``, ``1/.m/...``, ``1/.v/...``, ``2``,
    ``3`` and the error-feedback buffers ``4/...`` where there are any) as
    the port's train state, through :func:`train_state_from_jax`."""
    from repro_torch.optim.optimizers import OptState

    opt = OptState(flat["1/.step"], _nest(flat, "1/.m"), _nest(flat, "1/.v"))
    return train_state_from_jax(_nest(flat, "0"), opt, flat["2"], flat["3"], cfg,
                                device=device, like=like, ef=_nest(flat, "4") or None)


def _jax_layout(params: dict, cfg) -> dict:
    """The port's parameter tree in the reference's ``lm_init`` layout:
    each unit position's layers stacked along a leading axis (0-d leaves,
    sgdm's v, are one scalar for the stack, as the reference keeps them),
    prefix / suffix layers under their own keys."""
    from repro_torch.optim.optimizers import tree_map

    tree = {k: v for k, v in params.items() if k != "layers"}
    units: dict = {}
    for (key, i, _), layer in zip(cfg.layer_plan, params["layers"]):
        if i is None:
            tree[key] = layer
        else:
            units.setdefault(key, []).append(layer)
    for key, layers in units.items():
        tree[key] = tree_map(lambda *xs: torch.stack(xs) if xs[0].ndim else xs[0], *layers)
    return tree


def train_state_to_flat(state, cfg) -> dict:
    """The port's LM train state as the reference's checkpoint names and
    dtypes (int32 steps, the uint32 ``PRNGKey(seed)``), numpy on the host."""
    from repro_torch.api.threefry import prng_key
    from repro_torch.checkpoint.manager import tree_to_flat

    def host(tree, prefix):
        return {k: v.detach().cpu().numpy()
                for k, v in tree_to_flat(_jax_layout(tree, cfg), prefix).items()}

    opt = state.opt_state
    return {**host(state.params, "0"), "1/.step": np.asarray(opt.step, np.int32),
            **host(opt.m, "1/.m"), **host(opt.v, "1/.v"),
            "2": np.asarray(state.step, np.int32), "3": prng_key(state.seed),
            **(host(state.ef, "4") if state.ef is not None else {})}
