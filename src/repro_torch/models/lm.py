"""Decoder-LM stack (port of ``repro/models/lm.py``): serving's prefill
and decode, and training's :func:`lm_hidden` / :func:`lm_loss`.

Covers the block kinds of :data:`SUPPORTED_KINDS`: ``("attn", "swiglu")``
(the llama family, qwen2's qkv bias included), ``("ssm", "none")``
(Mamba-2, no FFN), recurrentgemma's ``("rglru", "swiglu")`` and
``("local", "swiglu")`` (sliding-window attention, ``cfg.local_attn``),
olmoe's ``("attn", "moe")`` and deepseek's ``("mla", "moe")`` with its
dense ``("mla", "swiglu")`` first layer (``models/moe.py``, MLA in
``attention.py``); the other mixers and FFNs (``gelu``, layer norm) raise
``NotImplementedError``.  A VLM (internvl2-26b, ``vlm_prefix_len``) takes
its (B, P, d) image embeddings ahead of the token embeddings, in the
activation dtype, in :func:`lm_hidden` and :func:`lm_prefill`; positions run
over prefix and text, and :func:`lm_loss` reads the text positions only.
With ``SpringContext.int8_cache`` the full-attention caches are int8 lines
and bf16 scales (``k_q8``, ``k_sc``, ``v_q8``, ``v_sc``), which
:func:`pad_cache` grows like k/v.  ``block_apply`` returns the MoE FFN's
load-balancing loss, which :func:`lm_hidden` sums.  The reference scans
a stacked ``unit_u`` parameter tree per position of its repeating unit,
plus unrolled ``prefix_i`` / ``suffix_i`` layers; here the layers are a
Python list of per-layer dicts, walked in order (:attr:`LMConfig.layer_plan`:
the prefix, then units 0, 1, ... of each repeat, then the suffix).
Caches keep the reference's layout, ``{"pos", "unit_u": {...},
"suffix_i": {...}}``: unit leaves stack the repeats in front,
``(n_units, B, ...)`` (attention ``{"k", "v"}`` of ``(n_units, B, S, KV,
D)``, MLA ``{"ckv", "krope"}`` of ``(n_units, B, S, width)``, window rings
``{"k_ring", "v_ring"}``, SSM ``{"conv", "ssm"}`` and RG-LRU ``{"conv",
"h"}`` states), prefix and suffix leaves have none, so
the packed slot pool is laid out exactly as the reference's.

Training recomputes a unit of layers in the backward pass under
``remat_policy``, as the reference's scan does: ``"full"`` checkpoints
each unit (``torch.utils.checkpoint``), ``"block_io"`` each block, and
``"stash"`` stores the unit's residual-stream input binary-mask compressed
(``memstash.stash_apply``, stash point ``"lm/residual"``; the stashed unit
returns its MoE aux loss beside its output) unless the
``MemstashConfig`` resolves that point to "remat" or "none"; prefix and
suffix layers run plain, as in the reference.  A recompute re-draws its
SR (the ``KeyGen`` moves on), as the reference's re-traced keys do.  The
loss is the chunked cross-entropy of ``models/losses.py``.

The tied-embedding logits product stays ``torch.matmul`` in fp32: the
reference computes it outside any kernel too (``lm.py:412-415``).  The
decode's plain reductions that are not batch-invariant on the card (this
product, RMSNorm's mean, decode attention's score and value products, MLA's
absorbed products, the MoE router, the SSM state readout, the RG-LRU's conv
sum and gate products) run in fixed row blocks (``layers.fixed_rows``), so
a request's tokens do not depend on how many slots the pool has.

Under a mesh that splits weights over ``model`` (tensor parallelism,
:func:`tensor_parallel`: the dense family, olmoe, deepseek, mamba2 and
recurrentgemma; ``dist.tensor``) every rank runs the whole stack on its
shards: attention (GQA, windowed or MLA) on its heads, the SSM on its
heads, the RG-LRU on its channels, the MLP (dense or shared experts) on
its columns, the MoE FFN on its experts, the embedding on its vocabulary
rows; the head's logits are the rank's vocabulary columns,
gathered in rank order for serving (:func:`_logits`) and reduced with the
cross-rank max, sum-exp and gold logit for the loss
(``losses.chunked_softmax_xent``).  The replicated activations are the
same bits on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.utils.checkpoint

from repro_torch.memstash.config import MemstashConfig
from repro_torch.memstash.stash import stash_apply
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import recurrent as rec_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import AttnSpec, MLASpec
from repro_torch.dist.tensor import copy_to_model, gather_from_model
from repro_torch.models.layers import (
    SpringContext,
    dense_init,
    draw_hook,
    embed_apply,
    embed_init,
    fixed_rows,
    rmsnorm_apply,
    rmsnorm_init,
    swiglu_apply,
    swiglu_init,
)
from repro_torch.models.losses import chunked_softmax_xent
from repro_torch.models.moe import MoESpec
from repro_torch.models.recurrent import RGLRUSpec
from repro_torch.models.ssm import SSMSpec
from repro_torch.optim.optimizers import tree_leaves, tree_map
from repro_torch.runtime.sharding import in_context, weight_split

SUPPORTED_KINDS = (("attn", "swiglu"), ("ssm", "none"), ("local", "swiglu"),
                   ("rglru", "swiglu"), ("attn", "moe"), ("mla", "moe"), ("mla", "swiglu"))
REMAT_POLICIES = ("full", "block_io", "stash")


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    d_model: int
    vocab: int
    n_layers: int
    pattern_unit: tuple  # ((mixer, ffn), ...)
    n_units: int
    prefix: tuple = ()
    suffix: tuple = ()
    attn: Optional[AttnSpec] = None
    local_attn: Optional[AttnSpec] = None  # the "local" mixer's (windowed) spec
    mla: Optional[MLASpec] = None
    ssm: Optional[SSMSpec] = None
    rglru: Optional[RGLRUSpec] = None
    moe: Optional[MoESpec] = None
    d_ff: int = 0
    norm: str = "rms"
    tie_embeddings: bool = False
    vlm_prefix_len: int = 0  # internvl2's image positions, ahead of the text
    remat: bool = True  # recompute each unit in the backward pass (training)
    # bf16 loss-head product (the log-sum-exp stays fp32)
    bf16_logits: bool = False
    # "full" | "block_io" | "stash" (the module docstring)
    remat_policy: str = "full"
    # set by configs: families where 500k-token full attention is intractable
    supports_long_context: bool = False

    def __post_init__(self):
        n = len(self.prefix) + len(self.pattern_unit) * self.n_units + len(self.suffix)
        if n != self.n_layers:
            raise ValueError(f"{self.name}: pattern covers {n} != {self.n_layers} layers")
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"{self.name}: remat_policy {self.remat_policy!r} not in "
                             f"{REMAT_POLICIES}")

    def check_supported(self) -> None:
        kinds = set(self.pattern_unit) | set(self.prefix) | set(self.suffix)
        if not kinds <= set(SUPPORTED_KINDS) or self.norm != "rms" or self.n_units < 1:
            raise NotImplementedError(
                f"{self.name}: only a repeated unit (with prefix / suffix layers) of "
                f"{SUPPORTED_KINDS} blocks with rms norm is ported (got pattern "
                f"{self.pattern_unit}, prefix {self.prefix}, suffix {self.suffix}, "
                f"norm {self.norm})")

    @property
    def layer_plan(self) -> list:
        """(cache key, index in that key's stack or None, kind) of every layer,
        in order: ``prefix_i``, then ``unit_u`` of each repeat i, then
        ``suffix_i``."""
        return ([(f"prefix_{i}", None, kind) for i, kind in enumerate(self.prefix)]
                + [(f"unit_{u}", i, kind) for i in range(self.n_units)
                   for u, kind in enumerate(self.pattern_unit)]
                + [(f"suffix_{i}", None, kind) for i, kind in enumerate(self.suffix)])


#: the layer kinds whose weights split over ``model``
TP_KINDS = frozenset({("attn", "swiglu"), ("attn", "moe"), ("mla", "swiglu"), ("mla", "moe"),
                      ("ssm", "none"), ("rglru", "swiglu"), ("local", "swiglu")})


def tensor_parallel(cfg, mesh) -> bool:
    """Does a run of ``cfg`` on ``mesh`` split its weights over ``model``?
    It does where the mesh's ``model`` extent is > 1 and its ``data``
    extent 1, and every layer of ``cfg`` is of :data:`TP_KINDS` (the dense
    family, olmoe's, deepseek's, mamba2's and recurrentgemma's layers), with
    no image prefix, where the split falls on whole units: MLA's heads, the
    SSM's heads (of one state group), the RG-LRU's ``d_rnn`` and the local
    attention's query heads each a multiple of the extent.  A ``data > 1`` run keeps ``model`` replicated, as the
    reference builds its data-parallel base step without a mesh; the other
    archs and the encoder-decoder run replicated on every rank of the axis
    (ROADMAP §1)."""
    shape = dict(getattr(mesh, "shape", None) or {})
    m = shape.get("model", 1)
    if not (m > 1 and shape.get("data", 1) == 1 and isinstance(cfg, LMConfig)
            and not cfg.vlm_prefix_len
            and set(cfg.pattern_unit) | set(cfg.prefix) | set(cfg.suffix) <= TP_KINDS):
        return False
    ssm = cfg.ssm
    return ((cfg.mla is None or cfg.mla.n_heads % m == 0)
            and (ssm is None or (ssm.n_heads % m == 0 and ssm.n_groups == 1))
            and (cfg.rglru is None or cfg.rglru.d_rnn % m == 0)
            and (cfg.local_attn is None or cfg.local_attn.n_heads % m == 0))


def _attn_spec(cfg: LMConfig, mixer: str) -> AttnSpec:
    return cfg.attn if mixer == "attn" else cfg.local_attn


def block_init(gen: torch.Generator, cfg: LMConfig, kind: tuple, *, device=None) -> dict:
    mixer, ffn = kind
    p = {"norm1": rmsnorm_init(cfg.d_model, device=device)}
    if mixer in ("attn", "local"):
        p["mixer"] = attn_mod.gqa_init(gen, cfg.d_model, _attn_spec(cfg, mixer), device=device)
    elif mixer == "mla":
        p["mixer"] = attn_mod.mla_init(gen, cfg.d_model, cfg.mla, device=device)
    elif mixer == "rglru":
        p["mixer"] = rec_mod.rglru_block_init(gen, cfg.d_model, cfg.rglru, device=device)
    else:
        p["mixer"] = ssm_mod.ssm_init(gen, cfg.d_model, cfg.ssm, device=device)
    if ffn != "none":
        p["norm2"] = rmsnorm_init(cfg.d_model, device=device)
        p["ffn"] = (moe_mod.moe_init(gen, cfg.d_model, cfg.moe, device=device) if ffn == "moe"
                    else swiglu_init(gen, cfg.d_model, cfg.d_ff, device=device))
    return p


def block_apply(params: dict, x: torch.Tensor, ctx: SpringContext, cfg: LMConfig,
                kind: tuple, positions: torch.Tensor, cache: Optional[dict] = None, pos=None,
                return_cache: bool = False):
    """Pre-norm residual block.  Returns (x, new_cache, aux): aux is the
    MoE FFN's load-balancing loss, else 0."""
    mixer, ffn = kind
    h = rmsnorm_apply(params["norm1"], x)
    if mixer in ("attn", "local"):
        out, new_cache = attn_mod.gqa_apply(params["mixer"], h, ctx, _attn_spec(cfg, mixer),
                                            positions, cache, pos, return_cache)
    elif mixer == "mla":
        out, new_cache = attn_mod.mla_apply(params["mixer"], h, ctx, cfg.mla, positions, cache,
                                            pos, return_cache)
    elif mixer == "rglru":
        out, new_cache = rec_mod.rglru_block_apply(params["mixer"], h, ctx, cfg.rglru, cache,
                                                   return_cache)
    else:
        out, new_cache = ssm_mod.ssm_apply(params["mixer"], h, ctx, cfg.ssm, cache)
    # the reference's jitted program normalizes the unrounded fp32 sum (XLA
    # drops the bf16 round trip between the add and rmsnorm's upcast); the
    # residual stream itself is rounded
    xf = x.to(torch.float32) + out.to(torch.float32)
    x = xf.to(x.dtype)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if ffn != "none":
        h = rmsnorm_apply(params["norm2"], xf).to(x.dtype)
        if ffn == "moe":
            out, aux = moe_mod.moe_apply(params["ffn"], h, ctx, cfg.moe)
        else:
            out = swiglu_apply(params["ffn"], h, ctx, cfg.d_ff)
        x = (x + out).to(x.dtype)
    return x, new_cache, aux


def block_init_cache(cfg: LMConfig, kind: tuple, batch: int, max_len: int,
                     dtype=torch.bfloat16, *, device=None) -> dict:
    mixer = kind[0]
    if mixer in ("attn", "local"):
        return attn_mod.gqa_init_cache(batch, _attn_spec(cfg, mixer), max_len, dtype,
                                       device=device, d_model=cfg.d_model)
    if dtype == "int8":  # only full attention keeps int8 lines
        dtype = torch.bfloat16
    if mixer == "mla":
        return attn_mod.mla_init_cache(batch, cfg.mla, max_len, dtype, device=device)
    if mixer == "rglru":
        return rec_mod.rglru_init_cache(batch, cfg.rglru, dtype, device=device,
                                        d_model=cfg.d_model)
    return ssm_mod.ssm_init_cache(batch, cfg.ssm, dtype, device=device, d_model=cfg.d_model)


def lm_init(cfg: LMConfig, seed: int = 0, *, device="cuda", mesh=None) -> dict:
    """Random parameters from ``seed`` on ``device`` (a ``torch.Generator``
    there; the values differ from the reference's ``jax.random`` ones — use
    :func:`repro_torch.convert.params_from_jax` to carry a JAX init across).
    On the ``meta`` device the tree has the shapes and no values (the
    sharding specs are read off it).  Given a ``mesh`` on which
    :func:`tensor_parallel` holds, this rank's shards: each leaf is drawn
    whole, with the generator's draws in the unsharded order, and cut to
    the rank's slice at once, so the shards are the whole init's slices
    bit for bit and the rank never holds more than its shards and one
    whole leaf."""
    if mesh is not None and tensor_parallel(cfg, mesh):
        return _init_shards(cfg, seed, device, mesh)
    cfg.check_supported()
    device = torch.device(device)
    gen = None if device.type == "meta" else torch.Generator(device=device).manual_seed(seed)
    params: dict = {
        "embed": embed_init(gen, cfg.vocab, cfg.d_model, device=device),
        "final_norm": rmsnorm_init(cfg.d_model, device=device),
        "layers": [block_init(gen, cfg, kind, device=device) for _, _, kind in cfg.layer_plan],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab, device=device)
    return params


def _init_shards(cfg: LMConfig, seed: int, device, mesh) -> dict:
    """:func:`lm_init`'s shards on ``mesh``: the drawn leaves' paths in
    draw order come from a ``meta`` build, and each drawn leaf is cut to
    its split (``tree_sharding.param_splits``) as it is drawn.  The leaves
    drawn from no generator (norm scales, biases) and the SSM's and
    RG-LRU's ``conv_w`` (drawn outside the hook, split by no rule) are
    whole on every rank."""
    from repro_torch.runtime.sharding import sharding_context
    from repro_torch.runtime.tree_sharding import _at, map_with_path, param_splits

    with sharding_context(mesh):
        splits = param_splits(cfg, mesh)
    drawn: list = []
    with draw_hook(lambda t: drawn.append(t) or t):
        meta = lm_init(cfg, device="meta")
    paths: dict = {}
    map_with_path(lambda path, leaf: paths.setdefault(id(leaf), path), meta)
    todo = iter([_at(splits, paths[id(t)]) for t in drawn])

    def keep(t):
        split = next(todo)
        return t if split is None else split.take(t).clone()

    with draw_hook(keep):
        return lm_init(cfg, seed, device=device)


def _vocab_split(cfg: LMConfig):
    """The head's split over ``model``: the vocabulary columns of the
    (d, V) head this rank holds (the tied table's rows), or None."""
    if cfg.tie_embeddings:
        return weight_split(("w_vocab", "w_embed"), (cfg.vocab, cfg.d_model))
    return weight_split(("w_embed", "w_vocab"), (cfg.d_model, cfg.vocab))


def _logits(params: dict, cfg: LMConfig, h: torch.Tensor) -> torch.Tensor:
    """fp32 logits of (B, d) rows in fixed row blocks (``fixed_rows``:
    cuBLAS picks its GEMM by the row count); under a vocabulary split each
    rank's columns, gathered over ``model`` in rank order."""
    w = _logits_kernel(params, cfg).to(torch.float32)
    split = _vocab_split(cfg)
    if split is not None:
        h = copy_to_model(h)
    logits = fixed_rows(lambda r: torch.matmul(r, w), h.to(torch.float32))
    return logits if split is None else gather_from_model(logits, -1)


def lm_hidden(params: dict, cfg: LMConfig, tokens: torch.Tensor, ctx: SpringContext,
              img_embeds: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Token ids (B, S) -> the final hidden states (B, S, d) and the
    auxiliary loss (the MoE layers' load-balancing losses summed; 0
    without MoE), each unit recomputed in the backward pass under
    ``cfg.remat`` / ``cfg.remat_policy``."""
    cfg.check_supported()
    x = _embed_inputs(params, cfg, tokens, ctx, img_embeds)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    # remat_policy="stash" nominates the residual stream; the
    # MemstashConfig has the last word (per_layer, min_elems, "none")
    scfg = ctx.memstash if ctx.memstash is not None else MemstashConfig(policy="stash")
    stash_policy = (scfg.policy_for("lm/residual", int(x.numel()))
                    if cfg.remat_policy == "stash" else "none")
    width, n_pre = len(cfg.pattern_unit), len(cfg.prefix)

    def block(h, p, u):
        return block_apply(p, h, ctx, cfg, cfg.pattern_unit[u], positions)[::2]

    def checkpointed(fn, *args):
        # the recompute keeps the forward's sharding context (in_context)
        return torch.utils.checkpoint.checkpoint(in_context(fn), *args, use_reentrant=False)

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p, kind in zip(params["layers"], cfg.prefix):
        x, _, a = block_apply(p, x, ctx, cfg, kind, positions)
        aux = aux + a
    for i in range(cfg.n_units):
        unit = params["layers"][n_pre + i * width:n_pre + (i + 1) * width]

        def run(h, unit=unit):
            aux_u = torch.zeros((), dtype=torch.float32, device=h.device)
            for u, p in enumerate(unit):
                h, a = block(h, p, u)
                aux_u = aux_u + a
            return h, aux_u

        if cfg.remat and cfg.remat_policy == "block_io":
            for u, p in enumerate(unit):
                x, a = checkpointed(block, x, p, u)
                aux = aux + a
        elif stash_policy == "stash":
            # the unit's input is kept compressed; its parameters ride along
            # as the stash's dense aux tensors, so their gradients flow, the
            # router's through the unit's MoE aux loss too
            def run_aux(h, leaves, unit=unit):
                leaves = iter(leaves)
                return run(h, tree_map(lambda _: next(leaves), unit))

            x, a = stash_apply(in_context(run_aux), scfg, "lm/residual", x,
                               tuple(tree_leaves(unit)))
            aux = aux + a
        else:
            x, a = (checkpointed(run, x) if cfg.remat or stash_policy == "remat" else run(x))
            aux = aux + a
    for p, kind in zip(params["layers"][n_pre + cfg.n_units * width:], cfg.suffix):
        x, _, a = block_apply(p, x, ctx, cfg, kind, positions)
        aux = aux + a
    x = rmsnorm_apply(params["final_norm"], x)
    return x, aux


def _embed_inputs(params: dict, cfg: LMConfig, tokens: torch.Tensor, ctx: SpringContext,
                  img_embeds: Optional[torch.Tensor]) -> torch.Tensor:
    """The token embeddings, with a VLM's (B, P, d) image embeddings ahead
    of them in the activation dtype (positions run over both)."""
    x = embed_apply(params["embed"], tokens, ctx, cfg.vocab)
    if cfg.vlm_prefix_len:
        if img_embeds is None:
            raise ValueError(f"{cfg.name} takes a ({cfg.vlm_prefix_len}, d) image prefix")
        x = torch.cat([img_embeds.to(x.device, x.dtype), x], dim=1)
    return x


def _logits_kernel(params: dict, cfg: LMConfig) -> torch.Tensor:
    """The (d, V) head: the tied embedding's transpose, or ``lm_head``."""
    if cfg.tie_embeddings:
        return params["embed"]["embedding"].t()
    return params["lm_head"]["kernel"]


def lm_loss(params: dict, cfg: LMConfig, tokens: torch.Tensor, ctx: SpringContext,
            img_embeds: Optional[torch.Tensor] = None,
            aux_weight: float = 0.01) -> tuple[torch.Tensor, dict]:
    """Next-token cross-entropy, chunked over the sequence so the (tokens x
    vocab) logits never materialize whole; returns (loss, {"ce", "aux"})."""
    h, aux = lm_hidden(params, cfg, tokens, ctx, img_embeds)
    h = h[:, cfg.vlm_prefix_len:]  # the loss reads the text positions only
    b, s, _ = h.shape
    total = chunked_softmax_xent(
        h[:, :-1], tokens[:, 1:], _logits_kernel(params, cfg),
        logits_dtype=torch.bfloat16 if cfg.bf16_logits else torch.float32,
        split=_vocab_split(cfg))
    ce = total / (b * (s - 1))
    loss = ce + aux_weight * aux
    return loss, {"ce": ce, "aux": aux}


def lm_init_cache(cfg: LMConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                  *, device=None) -> dict:
    cfg.check_supported()
    cache: dict = {"pos": torch.zeros((), dtype=torch.int64, device=device)}
    for i, kind in enumerate(cfg.prefix):
        cache[f"prefix_{i}"] = block_init_cache(cfg, kind, batch, max_len, dtype, device=device)
    for i, kind in enumerate(cfg.suffix):
        cache[f"suffix_{i}"] = block_init_cache(cfg, kind, batch, max_len, dtype, device=device)
    for u, kind in enumerate(cfg.pattern_unit):
        one = block_init_cache(cfg, kind, batch, max_len, dtype, device=device)
        cache[f"unit_{u}"] = {name: leaf[None].repeat(cfg.n_units, *([1] * leaf.ndim))
                              for name, leaf in one.items()}
    return cache


#: seq axis (from the end) of each cache leaf that :func:`pad_cache` grows
_CACHE_SEQ_AXIS = {"k": -3, "v": -3, "ckv": -2, "krope": -2,
                   "k_q8": -3, "v_q8": -3, "k_sc": -2, "v_sc": -2}


def pad_cache(cache: dict, extra: int) -> dict:
    """Grow the k/v (bf16, or int8 lines and their scales) and MLA latent
    caches by ``extra`` decode positions (prefill builds caches sized to
    the prompt; decoding needs headroom).  Window rings keep their fixed
    size and the O(1) SSM / RG-LRU state leaves pass through."""
    if extra <= 0:
        return cache
    out = dict(cache)
    for key in (k for k, v in cache.items() if isinstance(v, dict)):
        out[key] = {name: (torch.nn.functional.pad(
                        leaf, (0, 0) * (-_CACHE_SEQ_AXIS[name] - 1) + (0, extra))
                           if name in _CACHE_SEQ_AXIS else leaf)
                    for name, leaf in cache[key].items()}
    return out


def _gather_caches(plan: list, caches: list) -> dict:
    """Per-layer caches in ``layer_plan`` order as the cache tree: a unit's
    layers stacked along a leading axis, prefix / suffix layers as they are."""
    tree: dict = {}
    per_unit: dict = {}
    for (key, i, _), c in zip(plan, caches):
        if i is None:
            tree[key] = c
        else:
            per_unit.setdefault(key, []).append(c)
    for key, cs in per_unit.items():
        tree[key] = {name: torch.stack([c[name] for c in cs]) for name in cs[0]}
    return tree


def lm_prefill(params: dict, cfg: LMConfig, tokens: torch.Tensor, ctx: SpringContext,
               img_embeds: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, dict]:
    """Full forward over (B, S) tokens (behind a VLM's image prefix):
    last-position logits (B, V) and the serving cache (``pos`` = the rows)."""
    cfg.check_supported()
    x = _embed_inputs(params, cfg, tokens, ctx, img_embeds)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    plan, caches = cfg.layer_plan, []
    for (_, _, kind), p in zip(plan, params["layers"]):
        x, c, _ = block_apply(p, x, ctx, cfg, kind, positions, return_cache=True)
        caches.append(c)
    cache: dict = {"pos": torch.tensor(s, dtype=torch.int64, device=x.device)}
    cache.update(_gather_caches(plan, caches))
    x = rmsnorm_apply(params["final_norm"], x)
    return _logits(params, cfg, x[:, -1]), cache


def lm_decode_step(params: dict, cfg: LMConfig, tokens: torch.Tensor, cache: dict,
                   ctx: SpringContext) -> tuple[torch.Tensor, dict]:
    """One decode step over (B,) tokens.  ``cache["pos"]`` is a scalar or a
    per-row (B,) vector; returns (logits (B, V), updated cache)."""
    cfg.check_supported()
    pos = cache["pos"]
    x = embed_apply(params["embed"], tokens[:, None], ctx, cfg.vocab)
    b = x.shape[0]
    positions = (pos.reshape(-1, 1) if pos.ndim else pos).expand(b, 1)
    plan, caches = cfg.layer_plan, []
    for (key, i, kind), p in zip(plan, params["layers"]):
        layer_cache = (cache[key] if i is None
                       else {name: leaf[i] for name, leaf in cache[key].items()})
        x, c, _ = block_apply(p, x, ctx, cfg, kind, positions, layer_cache, pos)
        caches.append(c)
    new_cache: dict = {"pos": pos + 1}
    new_cache.update(_gather_caches(plan, caches))
    x = rmsnorm_apply(params["final_norm"], x)
    return _logits(params, cfg, x[:, 0]), new_cache
