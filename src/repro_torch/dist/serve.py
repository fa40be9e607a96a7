"""Sharded serving steps: rows over the data axis, logits packed on the
wire (port of ``repro/dist/serve.py``).

Rank r of the ``data`` axis prefills and decodes rows ``[r*B/D,
(r+1)*B/D)`` of the batch, as ``P("data")`` shards them, and keeps the
cache of those rows; per-row compute does not depend on the batch's
other rows, so its logits are the unsharded run's.  The per-rank logits
then cross the wire through ``packed_all_gather`` and every rank
reassembles the full ``(B, V)`` block in rank order.  The spec trees
(:func:`_row_specs`, :func:`_cache_specs`) come from the same
``logical_axes_for_path`` table, restricted to the ``data`` axis; the
steps slice their inputs by them.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.dist.collectives import packed_all_gather
from repro_torch.dist.mesh import data_axis_size
from repro_torch.runtime.sharding import DATA_ONLY_RULES, logical_to_spec, sharding_context
from repro_torch.runtime.tree_sharding import logical_axes_for_path, map_with_path
from repro_torch.serving.steps import make_decode_step, make_prefill_step

def _cache_specs(cache, mesh):
    """Spec tree for a cache tree: batch dim over 'data', everything else
    replicated (leading stacked-unit dims take the path table's None
    padding)."""
    with sharding_context(mesh, DATA_ONLY_RULES):
        return map_with_path(lambda p, leaf: logical_to_spec(
            logical_axes_for_path(p, leaf.shape), leaf.shape, mesh), cache)


def _row_specs(batch, mesh):
    """Spec tree sharding dim 0 of every leaf over 'data'."""
    with sharding_context(mesh, DATA_ONLY_RULES):
        return map_with_path(lambda p, leaf: logical_to_spec(
            ("batch",) + (None,) * (leaf.ndim - 1), leaf.shape, mesh), batch)


def _local_rows(batch: dict, mesh) -> dict:
    """This rank's rows of every leaf its spec shards over 'data'."""
    world, r = data_axis_size(mesh), mesh.axis_index("data")
    specs = _row_specs(batch, mesh)

    def local(leaf, spec):
        if not spec or spec[0] != "data":
            return leaf
        n = leaf.shape[0] // world
        return leaf[r * n:(r + 1) * n]

    return {k: local(v, specs[k]) for k, v in batch.items()}


def _gather_logits(logits: torch.Tensor, world: int, impl: Optional[str]) -> torch.Tensor:
    b_local, vocab = logits.shape
    flat = packed_all_gather(logits.reshape(-1), axis_name="data", impl=impl)
    return flat.reshape(world * b_local, vocab)


def make_sharded_prefill_step(cfg, spring, mesh, int8_cache: bool = False,
                              prune_ratio: float = 0.0, impl: Optional[str] = None):
    """``prefill(params, tokens, *, img_embeds=None) -> (logits (B, V),
    this rank's cache)`` for the whole batch's ``tokens``."""
    base = make_prefill_step(cfg, spring, int8_cache, prune_ratio)
    world = data_axis_size(mesh)

    def prefill(params, tokens, *, img_embeds=None):
        rows = _local_rows({"tokens": tokens, "img_embeds": img_embeds}
                           if img_embeds is not None else {"tokens": tokens}, mesh)
        with sharding_context(mesh, DATA_ONLY_RULES):
            logits, cache = base(params, rows["tokens"], img_embeds=rows.get("img_embeds"))
            return _gather_logits(logits, world, impl), cache

    return prefill


def make_sharded_decode_step(cfg, spring, mesh, int8_cache: bool = False,
                             prune_ratio: float = 0.0, impl: Optional[str] = None):
    """``decode(params, tokens (B,), cache) -> (logits (B, V), this rank's
    new cache)``: the rank decodes its rows of ``tokens`` on its cache."""
    base = make_decode_step(cfg, spring, int8_cache, prune_ratio)
    world = data_axis_size(mesh)

    def decode(params, tokens, cache):
        local = _local_rows({"tokens": tokens}, mesh)["tokens"]
        with sharding_context(mesh, DATA_ONLY_RULES):
            logits, new_cache = base(params, local, cache)
            return _gather_logits(logits, world, impl), new_cache

    return decode
