"""Logical sharding axes for whole trees (parameters, optimizer state,
caches) from leaf path names (port of ``repro/runtime/tree_sharding.py``).

A path is the sequence of dict keys and list indices from the root to a
leaf.  The port's parameter tree keeps one dict per layer in a
``layers`` list where the reference stacks each unit position's layers
along a leading axis, and its caches stack the unit repeats in front as
the reference's do; the rules read only the leaf's and its parent's names
and pad leading dims with ``None``, so a leaf gets the reference's axes
for its trailing dims either way.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.runtime.sharding import logical_to_spec, split_of

# (parent, leaf) -> logical axes for the trailing dims.  Leading unit-stack
# dims are padded with None automatically.
_KERNEL_RULES: dict[str, tuple] = {
    "wq": ("w_embed", "w_qkv"),
    "wk": ("w_embed", "w_qkv"),
    "wv": ("w_embed", "w_qkv"),
    "wo": ("w_qkv", "w_embed"),
    "wdkv": ("w_embed", None),
    "wkr": ("w_embed", None),
    "wuk": (None, "w_qkv"),
    "wuv": (None, "w_qkv"),
    "gate": ("w_embed", "w_mlp"),
    "up": ("w_embed", "w_mlp"),
    "down": ("w_mlp", "w_embed"),
    "fc1": ("w_embed", "w_mlp"),
    "fc2": ("w_mlp", "w_embed"),
    "in_proj": ("w_embed", "w_mlp"),
    "out_proj": ("w_mlp", "w_embed"),
    "wx": ("w_embed", "w_mlp"),
    "wy": ("w_embed", "w_mlp"),
    "w_r": (None, "w_mlp"),
    "w_i": (None, "w_mlp"),
    "router": ("w_embed", None),
    "lm_head": ("w_embed", "w_vocab"),
    "enc_in": ("w_embed", None),
}

_LEAF_RULES: dict[str, tuple] = {
    "embedding": ("w_vocab", "w_embed"),
    # experts: EP over model on dim0 + FSDP over data on the d_model dim
    "w_gate": ("w_experts", "w_embed", None),
    "w_up": ("w_experts", "w_embed", None),
    "w_down": ("w_experts", None, "w_embed"),
    # caches
    "k": ("cache_batch", "cache_seq", "cache_heads", "head_dim"),
    "v": ("cache_batch", "cache_seq", "cache_heads", "head_dim"),
    "k_ring": ("cache_batch", "cache_seq", "cache_heads", "head_dim"),
    "v_ring": ("cache_batch", "cache_seq", "cache_heads", "head_dim"),
    "k_q8": ("cache_batch", "cache_seq", "cache_heads", "head_dim"),
    "v_q8": ("cache_batch", "cache_seq", "cache_heads", "head_dim"),
    "k_sc": ("cache_batch", "cache_seq", "cache_heads"),
    "v_sc": ("cache_batch", "cache_seq", "cache_heads"),
    "ckv": ("cache_batch", "cache_seq", None),
    "krope": ("cache_batch", "cache_seq", None),
    "conv": ("cache_batch", None, "mlp_act"),
    "ssm": ("cache_batch", "heads", None, None),
    "h": ("cache_batch", "mlp_act"),
}


def logical_axes_for_path(path, shape) -> tuple:
    """Logical axes of the leaf at ``path`` (its keys and indices) with
    ``shape``."""
    names = [str(p) for p in path]
    leaf = names[-1] if names else ""
    parent = names[-2] if len(names) >= 2 else ""
    axes: Optional[tuple] = None
    if leaf == "kernel" and parent in _KERNEL_RULES:
        axes = _KERNEL_RULES[parent]
    elif leaf in _LEAF_RULES:
        axes = _LEAF_RULES[leaf]
    elif leaf == "bias":
        axes = (None,)
    if axes is None:
        axes = (None,) * len(shape)
    # pad for unit-stacked leading dims
    if len(axes) < len(shape):
        axes = (None,) * (len(shape) - len(axes)) + tuple(axes)
    elif len(axes) > len(shape):
        axes = tuple(axes[-len(shape):])
    return tuple(axes)


def map_with_path(fn, tree, path: tuple = ()):
    """``fn(path, leaf)`` over every leaf of a tree of dicts, lists and
    tuples (``None`` holes stay ``None``)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


def tree_shardings(tree, mesh):
    """The spec tree of a parameter / state / cache tree on ``mesh``."""
    return map_with_path(lambda path, leaf: logical_to_spec(
        logical_axes_for_path(path, leaf.shape), leaf.shape, mesh), tree)


def batch_shardings(batch, mesh):
    """Input batches shard over ('pod','data') on axis 0."""
    return map_with_path(lambda path, leaf: logical_to_spec(
        ("batch",) + (None,) * (len(leaf.shape) - 1), leaf.shape, mesh), batch)


def param_splits(cfg, mesh):
    """The :class:`~repro_torch.runtime.sharding.Split` (or None) of every
    leaf of ``lm_init(cfg)``'s parameters on ``mesh``, under the active
    rules (fallbacks not counted)."""
    from repro_torch.models.lm import lm_init

    return map_with_path(lambda path, leaf: split_of(logical_to_spec(
        logical_axes_for_path(path, leaf.shape), leaf.shape, mesh, count=False),
        tuple(leaf.shape), mesh), lm_init(cfg, device="meta"))


def leaf_splits(split_tree, tree) -> list:
    """The splits of ``tree``'s leaves in its own walk order, looked up by
    path in ``split_tree`` (:func:`param_splits`): a tree converted from the
    reference's keeps the reference's key order, not ``lm_init``'s."""
    out: list = []
    map_with_path(lambda path, leaf: out.append(_at(split_tree, path)), tree)
    return out


def shard_tree(tree, mesh, specs=None):
    """This rank's shard of every leaf of a whole parameter (or moment)
    tree: the slice along the dim its spec splits over ``model``
    (:func:`tree_shardings`, which counts the divisibility fallbacks), the
    leaf itself where nothing splits it.  A ``data`` entry of a spec (FSDP,
    not ported) leaves the dim whole.  The slices are copies: the whole
    tree can be freed."""
    specs = tree_shardings(tree, mesh) if specs is None else specs

    def shard(path, leaf):
        spec = _at(specs, path)
        split = split_of(spec, tuple(leaf.shape), mesh)
        return leaf if split is None else split.take(leaf).clone()

    return map_with_path(shard, tree)


def gather_tree(tree, mesh, splits):
    """The whole leaves of a sharded tree, on every rank: each split leaf's
    shards gathered over ``model`` in rank order (one collective a leaf,
    which every rank must join), the others as they are.  ``splits`` is
    the parameters' split tree (:func:`param_splits`); a 0-d leaf (SGD's
    ``v``) is whole."""

    def gather(path, leaf):
        split = _at(splits, path)
        if split is None or leaf.ndim != len(split.full):
            return leaf
        parts = mesh.all_gather(leaf.detach(), "model")
        return torch.cat(list(parts.unbind(0)), dim=split.dim)

    return map_with_path(gather, tree)


@dataclasses.dataclass(frozen=True)
class KVHeadSplit:
    """How a serving pool's attention leaves (the ``cache_heads`` axis, the
    second to last of a dense k / v leaf) split over ``model``: rank ``r``
    holds the whole pool's kv heads ``heads[r]``, in its cache's order
    (``models.attention.cache_heads``).  Where the kv heads divide, each
    rank holds ``n_heads / m`` of its own; where they do not, a rank keeps
    the heads its query heads read, so ranks (and a rank's query heads)
    may repeat one.  A head's *first holder* is the first rank, in rank
    order, that holds it: the whole pool's figures count each head once,
    there (:meth:`total`)."""

    mesh: object
    n_heads: int
    heads: tuple

    @property
    def rank(self) -> int:
        return self.mesh.axis_index("model")

    @property
    def mine(self) -> tuple:
        return self.heads[self.rank]

    def first_holder(self, head: int) -> int:
        return next(r for r, hs in enumerate(self.heads) if head in hs)

    @property
    def weight(self) -> float:
        """The share of this rank's leaves the whole pool counts: its heads
        first held here over the heads it holds (1 or 0 where every rank
        holds distinct heads)."""
        own = {j for j in self.mine if self.first_holder(j) == self.rank}
        return len(own) / len(self.mine)

    def total(self, values) -> list:
        """The whole pool's figures from every rank's ``values`` (counts
        over its leaves): each weighted by :attr:`weight` and summed over
        ``model`` in rank order, in float64, so every rank gets the same
        numbers and takes the same decisions from them (exact where the
        weights are 1 or 0)."""
        from repro_torch.dist.tensor import model_sum

        x = torch.tensor([float(v) * self.weight for v in values], dtype=torch.float64)
        return model_sum(x, self.mesh).tolist()

    def whole(self, x: torch.Tensor) -> torch.Tensor:
        """The whole leaf from every rank's ``x`` (heads at dim -2): the
        ranks' leaves gathered over ``model`` (a collective every rank
        joins; ranks holding fewer heads pad theirs), each whole head taken
        from its first holder."""
        pad = max(len(hs) for hs in self.heads) - x.shape[-2]
        if pad:
            x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        parts = self.mesh.all_gather(x.contiguous().to(self.mesh.device), "model").to(x.device)
        picks = []
        for j in range(self.n_heads):
            r = self.first_holder(j)
            picks.append(parts[r].select(-2, self.heads[r].index(j)))
        return torch.stack(picks, dim=-2)

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's heads of a whole leaf (heads at dim -2), in its order."""
        idx = torch.tensor(self.mine, dtype=torch.int64, device=x.device)
        return x.index_select(x.ndim - 2, idx)


def kv_head_split(cfg, mesh) -> Optional[KVHeadSplit]:
    """The pool's :class:`KVHeadSplit` of a run of ``cfg`` on ``mesh`` under
    the active rules (None: every rank holds the whole pool), from its
    attention layers' spec (every full-attention layer shares one; an arch
    with windowed layers alone, recurrentgemma, takes its rings').  An
    MLA arch's latent pool (``ckv``, ``krope``) is whole on every rank:
    None."""
    from repro_torch.models.attention import cache_heads
    from repro_torch.models.lm import tensor_parallel

    spec = cfg.attn if cfg.attn is not None else cfg.local_attn
    if (not tensor_parallel(cfg, mesh) or spec is None
            or cache_heads(spec, cfg.d_model) is None):
        return None
    n = int(mesh.shape["model"])
    return KVHeadSplit(mesh, spec.n_kv_heads,
                       tuple(cache_heads(spec, cfg.d_model, rank=r) for r in range(n)))


#: cache leaves whose dim -2 (of the dense form) holds the kv heads
HEAD_LEAVES = ("k", "v", "k_ring", "v_ring")


@dataclasses.dataclass(frozen=True)
class PoolSplit:
    """How a serving pool splits over ``model``: its attention leaves
    (:data:`HEAD_LEAVES`) by kv head (``heads``, a :class:`KVHeadSplit`, or
    None), and its recurrent state leaves in equal parts in rank order
    along a dim (``states``: ``{(cache key, leaf name): dim}``, the dim
    from the end: the SSM's ``ssm`` by head, the RG-LRU's ``conv`` and
    ``h`` by channel).  Every other leaf is whole on every rank (mamba2's
    ``conv``, an MLA latent)."""

    mesh: object
    heads: Optional[KVHeadSplit]
    states: dict

    def whole(self, key: str, name: str, x: torch.Tensor) -> torch.Tensor:
        """The whole leaf ``name`` of the cache subtree ``key`` from every
        rank's ``x`` (a collective every rank joins where ``x`` is split)."""
        if name in HEAD_LEAVES:
            return x if self.heads is None else self.heads.whole(x)
        dim = self.states.get((key, name))
        if dim is None:
            return x
        parts = self.mesh.all_gather(x.contiguous().to(self.mesh.device), "model").to(x.device)
        return torch.cat(list(parts.unbind(0)), dim=dim)

    def local(self, key: str, name: str, x: torch.Tensor) -> torch.Tensor:
        """This rank's part of a whole leaf."""
        if name in HEAD_LEAVES:
            return x if self.heads is None else self.heads.local(x)
        dim = self.states.get((key, name))
        if dim is None:
            return x
        size = x.shape[dim] // int(self.mesh.shape["model"])
        return x.narrow(dim, self.mesh.axis_index("model") * size, size)


def pool_split(cfg, mesh) -> Optional[PoolSplit]:
    """The serving pool's :class:`PoolSplit` of a run of ``cfg`` on ``mesh``
    under the active rules, or None where every rank holds the whole pool
    (no split over ``model``, or an MLA arch's latent pool)."""
    from repro_torch.models import recurrent as rec_mod
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models.lm import tensor_parallel

    if not tensor_parallel(cfg, mesh):
        return None
    states: dict = {}
    for key, _, (mixer, _) in cfg.layer_plan:
        if mixer == "ssm" and ssm_mod._splits(cfg.ssm, cfg.d_model)[1] is not None:
            states[key, "ssm"] = -3  # (..., B, H, N, P)
        elif mixer == "rglru" and rec_mod._splits(cfg.rglru, cfg.d_model)[0] is not None:
            states[key, "conv"] = states[key, "h"] = -1
    heads = kv_head_split(cfg, mesh)
    if heads is None and not states:
        return None
    return PoolSplit(mesh, heads, states)


def _at(tree, path):
    for p in path:
        tree = tree[p]
    return tree
