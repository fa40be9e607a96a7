"""Tensor parallelism over ``model`` (``repro_torch.dist.tensor``) against
the reference's partitioned runs, the port's unsharded runs and the
slices of whole tensors.

The reference's partitioned results come from one subprocess
(``_torch_tp_reference.py``, 4 forced host devices, an Auto-typed ``(1,
1, m)`` mesh handed to its own sessions: its sessions' Explicit axes fail
under jax 0.9, ROADMAP §3), kept in a module fixture.  The port runs in
two gloo spawns, at model 2 and model 4 (``_torch_tp_ranks.tp_ranks``),
each with a time limit and a FileStore under ``tmp_path``.  The exact
cases run in this process, the ranks of a ``model`` axis as threads
(``_torch_tp_ranks.on_threads``).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import _torch_mesh_ranks as R  # noqa: E402
import _torch_tp_ranks as T  # noqa: E402
from repro.api.sessions import TrainSession as JTrainSession  # noqa: E402
from repro.api.spec import build_spec as jbuild  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.runtime import sharding as jsharding  # noqa: E402
from repro.runtime import tree_sharding as jtree  # noqa: E402

from repro_torch.api.sessions import ServeSession, TrainSession  # noqa: E402
from repro_torch.api.spec import build_spec as tbuild  # noqa: E402
from repro_torch.configs import get_arch as tget_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.spring_ops import MODES  # noqa: E402
from repro_torch.dist import launch  # noqa: E402
from repro_torch.kernels.stochastic_round.ops import shard_counter, stochastic_round  # noqa: E402
from repro_torch.models.layers import SpringContext, dense_apply, embed_apply  # noqa: E402
from repro_torch.models.losses import _chunk_ce, chunked_softmax_xent  # noqa: E402
from repro_torch.runtime import sharding as tsharding  # noqa: E402
from repro_torch.runtime import tree_sharding as ttree  # noqa: E402

pytestmark = pytest.mark.mesh

SPAWN_TIMEOUT_S = 240
REF_TIMEOUT_S = 300
#: the reduced dense archs and the extents their specs are held at
DENSE_ARCHS = ("llama3.2-1b", "minitron-4b", "qwen2-7b", "mistral-nemo-12b")
EXTENTS = (2, 4)
#: losses against the reference's partitioned run at the same extent
LOSS_RTOL = {"quant_sparse": 1e-5, "dense": 2e-4}


def _np_params(seed: int = 0) -> dict:
    cfg = jbuild("train", sets=R.TRAIN_SETS, use_env=False).resolve().config
    return jax.tree_util.tree_map(np.asarray, jlm.lm_init(jax.random.PRNGKey(seed), cfg))


def _cfg():
    return tget_arch("llama3.2-1b").resolve(reduced=True)


@pytest.fixture(scope="module")
def params() -> dict:
    return _np_params()


@pytest.fixture(scope="module")
def reference() -> dict:
    """The reference's losses and static tokens at model 1, 2 and 4."""
    here = os.path.dirname(__file__)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.join(here, "..", "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    done = subprocess.run([sys.executable, os.path.join(here, "_torch_tp_reference.py")],
                          env=env, capture_output=True, text=True, timeout=REF_TIMEOUT_S)
    assert done.returncode == 0, done.stderr[-4000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def ref_ckpt(tmp_path_factory) -> str:
    """A step-1 checkpoint of TRAIN_SETS the reference's session wrote."""
    path = tmp_path_factory.mktemp("ref_ckpt")
    sets = [s for s in R.TRAIN_SETS if not s.startswith("train.")]
    JTrainSession(jbuild("train", sets=sets + ["train.steps=1", f"train.ckpt_dir={path}"],
                         use_env=False)).run()
    return str(path)


def _spawn(world, params, ref_ckpt, factory):
    base = factory.mktemp(f"model{world}")
    ckpt, ref = base / "ckpt", base / "ref_ckpt"
    shutil.copytree(ref_ckpt, ref)  # the resumed run writes its last step there
    return {"ckpt_dir": str(ckpt),
            "ranks": launch.run(T.tp_ranks, world, (params, str(ckpt), str(ref)),
                                timeout_s=SPAWN_TIMEOUT_S, store_dir=str(base))}


@pytest.fixture(scope="module")
def spawns(params, ref_ckpt, tmp_path_factory) -> dict:
    return {m: _spawn(m, params, ref_ckpt, tmp_path_factory) for m in EXTENTS}


@pytest.fixture(scope="module")
def unsharded(params) -> dict:
    """The port's unsharded runs, on one thread as the ranks run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        train = {mode: TrainSession(tbuild("train", sets=R.TRAIN_SETS + [f"numerics.mode={mode}"],
                                           use_env=False), device="cpu",
                                    params=params_from_jax(params, _cfg())).run()["losses"]
                 for mode in T.TRAIN_MODES}
        serve = {mode: ServeSession(tbuild("serve", sets=R.SERVE_SETS + [f"numerics.mode={mode}"],
                                           use_env=False), device="cpu",
                                    params=params_from_jax(params, _cfg())).run()
                 ["generated"].tolist() for mode in R.SERVE_MODES}
        three = TrainSession(tbuild("train", sets=[s for s in R.TRAIN_SETS
                                                   if not s.startswith("train.steps")]
                                    + ["train.steps=3"], use_env=False), device="cpu",
                             params=params_from_jax(params, _cfg())).run()["losses"]
    finally:
        torch.set_num_threads(n)
    return {"train": train, "serve": serve, "three": three}


@pytest.fixture(scope="module")
def uneven(tmp_path_factory) -> dict:
    """Reduced minitron-4b trained at model 3 (q columns split, kv columns
    whole) in three gloo ranks, and unsharded on one thread."""
    base = tmp_path_factory.mktemp("uneven")
    ranks = launch.run(T.uneven_ranks, 3, timeout_s=SPAWN_TIMEOUT_S, store_dir=str(base))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tr = TrainSession(tbuild("train", sets=T.UNEVEN_SETS, use_env=False), device="cpu").run()
    finally:
        torch.set_num_threads(n)
    return {"ranks": ranks, "losses": tr["losses"], **T.replicated_leaves(tr["state"].params)}


class _Stub:
    """A mesh of ``model`` extent n seen from rank r (no collectives)."""

    def __init__(self, n, r=0, data=1):
        self.shape = {"pod": 1, "data": data, "model": n}
        self.r = r

    def axis_index(self, axis):
        return self.r if axis == "model" else 0


# -- the layout: specs and shards --------------------------------------------------------------

class _JMesh:
    """What the reference's ``logical_to_spec`` reads of a mesh."""

    def __init__(self, n):
        self.shape = {"pod": 1, "data": 1, "model": n}


def _spec_leaves(specs) -> list:
    """The specs of a spec tree in leaf order (a spec is a tuple, which a
    tree walk would take apart)."""
    if isinstance(specs, dict):
        return [s for v in specs.values() for s in _spec_leaves(v)]
    if isinstance(specs, list):
        return [s for v in specs for s in _spec_leaves(v)]
    return [specs]


def _ref_specs(cfg, n) -> dict:
    """{(unit or layer key, leaf path): spec} of the reference's stacked
    lm_init tree, the stacked dim dropped."""
    tree = jax.eval_shape(lambda: jlm.lm_init(jax.random.PRNGKey(0), cfg))
    out = {}

    def one(path, leaf):
        names = tuple(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        spec = tuple(jsharding.logical_to_spec(jtree.logical_axes_for_path(path, leaf.shape),
                                               leaf.shape, _JMesh(n)))
        stacked = names[0].startswith("unit_")
        out[names] = spec[1:] if stacked else spec

    jax.tree_util.tree_map_with_path(one, tree)
    return out


@pytest.mark.parametrize("n", (2, 3, 4))
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_every_leafs_spec_and_fallbacks_are_the_references(arch, n):
    """Every leaf of the port's tree gets the spec of its leaf in the
    reference's stacked tree (its trailing dims), and the reference's
    ``logical_to_spec`` on the port's leaves counts the same fallbacks as
    the port's (extent 3 makes them: 128 q columns do not split in 3)."""
    from repro.telemetry.metrics import default_registry as jreg

    from repro_torch.models.lm import lm_init
    from repro_torch.telemetry.metrics import default_registry as treg

    cfg = tget_arch(arch).resolve(reduced=True)
    ref = _ref_specs(jget_arch(arch).reduced(), n)
    tree = lm_init(cfg, device="meta")
    treg().reset()
    got = ttree.tree_shardings(tree, _Stub(n))
    for (key, _, _), layer in zip(cfg.layer_plan, got["layers"]):
        for path, spec in _flat_specs(layer):
            assert spec == ref[(key,) + path], (key, path)
    for key in ("embed", "final_norm", "lm_head"):
        for path, spec in _flat_specs(got.get(key, {})):
            assert spec == ref[(key,) + path], (key, path)
    jreg().reset()
    ttree.map_with_path(lambda path, leaf: jsharding.logical_to_spec(
        jtree.logical_axes_for_path([jax.tree_util.DictKey(str(p)) for p in path], leaf.shape),
        leaf.shape, _JMesh(n)), tree)
    assert tsharding.mesh_fallback_counts() == jsharding.mesh_fallback_counts()
    assert (n == 3) == bool(tsharding.mesh_fallback_counts())


def _flat_specs(specs, path=()):
    if isinstance(specs, dict):
        return [kv for k, v in specs.items() for kv in _flat_specs(v, path + (k,))]
    return [(path, specs)]


@pytest.mark.parametrize("n", EXTENTS)
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_every_shard_is_the_slice_its_spec_names(arch, n):
    """shard_tree hands rank r the slice of each whole leaf along the dim
    its spec splits over model (norms and qwen2's biases whole), and the
    shards of all ranks gathered back are the whole leaf."""
    from repro_torch.models.lm import lm_init
    from repro_torch.optim.optimizers import tree_leaves

    cfg = tget_arch(arch).resolve(reduced=True)
    whole = lm_init(cfg, 0, device="cpu")
    specs = _spec_leaves(ttree.tree_shardings(whole, _Stub(n)))
    shards = [tree_leaves(ttree.shard_tree(whole, _Stub(n, r))) for r in range(n)]
    for i, (leaf, spec) in enumerate(zip(tree_leaves(whole), specs)):
        dims = [d for d, e in enumerate(spec) if e == "model"]
        if not dims:
            assert all(torch.equal(s[i], leaf) for s in shards)
            continue
        size = leaf.shape[dims[0]] // n
        for r in range(n):
            assert torch.equal(shards[r][i], leaf.narrow(dims[0], r * size, size))
        assert torch.equal(torch.cat([s[i] for s in shards], dims[0]), leaf)


def test_param_splits_name_the_column_row_and_vocabulary_splits():
    """llama3.2-1b at full width, model 4 (specs read off the meta tree):
    wq / wk / wv / gate / up by columns, wo / down by rows, the tied
    embedding by its vocabulary rows, the norms whole; the per-rank
    shapes are the issue's (wq 2048x512, wk 2048x128, gate 2048x2048)."""
    cfg = tget_arch("llama3.2-1b").resolve(reduced=False)
    with tsharding.sharding_context(_Stub(4, 1)):
        splits = ttree.param_splits(cfg, _Stub(4, 1))
    layer = splits["layers"][0]
    kinds = {name: layer["mixer"][name]["kernel"].kind for name in ("wq", "wk", "wv", "wo")}
    kinds.update({name: layer["ffn"][name]["kernel"].kind for name in ("gate", "up", "down")})
    assert kinds == {"wq": "col", "wk": "col", "wv": "col", "wo": "row", "gate": "col",
                     "up": "col", "down": "row"}
    wq, wk = layer["mixer"]["wq"]["kernel"], layer["mixer"]["wk"]["kernel"]
    assert (wq.lo, wq.hi, wk.lo, wk.hi) == (512, 1024, 128, 256)
    emb = splits["embed"]["embedding"]
    assert (emb.kind, emb.dim, emb.hi - emb.lo) == ("row", 0, 128256 // 4)
    assert layer["norm1"]["scale"] is None and splits["final_norm"]["scale"] is None


# -- the exact cases, in this process ------------------------------------------------------------

@pytest.mark.parametrize("mode", ["dense", "quant", "quant_sparse"])
@pytest.mark.parametrize("n", EXTENTS)
def test_a_column_split_dense_apply_is_the_slice_of_the_whole(mode, n):
    """A column shard's output (qwen2's bias included) is the slice of the
    unsharded output, bit for bit, on every rank."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 5, 64, generator=gen) * 0.5
    whole = {"kernel": torch.randn(64, 96, generator=gen) / 8,
             "bias": torch.randn(96, generator=gen) * 0.1}
    ctx = SpringContext(cfg=MODES[mode])
    want = dense_apply(whole, x, ctx)
    for r in range(n):
        with tsharding.sharding_context(_Stub(n, r)):
            split = tsharding.weight_split(("w_embed", "w_qkv"), (64, 96))
            got = dense_apply({"kernel": split.take(whole["kernel"]), "bias": whole["bias"]},
                              x, ctx, split)
        assert split.kind == "col" and torch.equal(got, split.take(want, -1))


@pytest.mark.parametrize("mode", ["dense", "quant_sparse"])
def test_a_row_split_dense_apply_sums_to_the_whole_on_every_rank(mode):
    """Row shards' partial sums, summed over model in rank order before the
    output's rounding: every rank holds the same bits, within the fp32
    sum-order bound of the unsharded product (dense: one bf16 ulp)."""
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(3, 4, 128, generator=gen) * 0.5
    w = torch.randn(128, 48, generator=gen) / 11
    ctx = SpringContext(cfg=MODES[mode])
    want = dense_apply({"kernel": w}, x, ctx)

    def rank(mesh):
        split = tsharding.weight_split(("w_mlp", "w_embed"), (128, 48))
        return dense_apply({"kernel": split.take(w)}, split.take(x, -1), ctx, split)

    got = T.on_threads(4, rank)
    assert all(torch.equal(g, got[0]) for g in got)
    tol = 2e-2 if mode == "dense" else 2 * 2.0**-16
    torch.testing.assert_close(got[0].float(), want.float(), rtol=0, atol=tol)


@pytest.mark.parametrize("mode", ["dense", "quant"])
@pytest.mark.parametrize("n", EXTENTS)
def test_the_vocabulary_split_lookup_is_the_whole_lookup(mode, n):
    """Each rank looks its vocabulary rows up, zero elsewhere, and the sum
    over model is the whole table's lookup bit for bit."""
    gen = torch.Generator().manual_seed(5)
    table = {"embedding": torch.randn(64, 24, generator=gen)}
    tokens = torch.randint(0, 64, (3, 7), generator=gen)
    ctx = SpringContext(cfg=MODES[mode])
    want = embed_apply(table, tokens, ctx)

    def rank(mesh):
        split = tsharding.weight_split(("w_vocab", "w_embed"), (64, 24))
        return embed_apply({"embedding": split.take(table["embedding"])}, tokens, ctx, 64)

    for got in T.on_threads(n, rank):
        assert torch.equal(got, want)


@pytest.mark.parametrize("n", EXTENTS)
@pytest.mark.parametrize("dim", [0, 1])
def test_a_shards_stochastic_rounding_is_the_slice_of_the_wholes(dim, n):
    """The strided counter: a column or row shard of a (96, 160) leaf
    rounds to the slice of the whole leaf's rounding, bit for bit (the
    kernel's plain version; the card's kernel is held to it in
    test_torch_cuda.py and chip_smoke.py)."""
    gen = torch.Generator().manual_seed(6)
    whole = torch.randn(96, 160, generator=gen)
    want = stochastic_round(whole, 1234)
    size = whole.shape[dim] // n
    for r in range(n):
        base, stride = shard_counter(whole.shape, dim, r * size)
        got = stochastic_round(whole.narrow(dim, r * size, size).contiguous(), 1234,
                               base=base, row_stride=stride)
        assert torch.equal(got, want.narrow(dim, r * size, size))
    assert torch.equal(stochastic_round(whole, 1234, base=0, row_stride=160), want)


@pytest.mark.parametrize("n", EXTENTS)
def test_the_vocabulary_parallel_cross_entropy_is_chunk_ce(n):
    """The cross-rank max, sum-exp and gold logit give _chunk_ce's loss and
    its gradients (hidden states and each rank's head columns) at rtol
    1e-6, the same on every rank; the chunked loss too."""
    gen = torch.Generator().manual_seed(7)
    h = torch.randn(2, 9, 32, generator=gen)
    w = torch.randn(32, 80, generator=gen) / 4
    y = torch.randint(0, 80, (2, 9), generator=gen)
    hw, ww = h.clone().requires_grad_(True), w.clone().requires_grad_(True)
    want = _chunk_ce(hw, y, ww, torch.float32)
    want.backward()

    def rank(mesh):
        split = tsharding.weight_split(("w_embed", "w_vocab"), (32, 80))
        hr, wr = h.clone().requires_grad_(True), split.take(w).clone().requires_grad_(True)
        loss = chunked_softmax_xent(hr, y, wr, chunk=4, split=split)
        loss.backward()
        return loss.detach(), hr.grad, wr.grad, split

    got = T.on_threads(n, rank)
    for loss, gh, gw, split in got:
        assert torch.equal(loss, got[0][0]) and torch.equal(gh, got[0][1])
        torch.testing.assert_close(loss, want.detach(), rtol=1e-6, atol=0)
        torch.testing.assert_close(gh, hw.grad, rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(gw, split.take(ww.grad), rtol=1e-6, atol=1e-7)


def test_a_recompute_in_another_thread_keeps_its_splits():
    """On the card autograd runs the backward, and so a checkpointed unit's
    recompute, in its own device thread, where the forward's thread-local
    sharding context is not installed: every rank's gradients from a
    backward run on a fresh thread (remat on, as llama3.2-1b at full width
    trains) equal those of a backward on the forward's thread."""
    import dataclasses
    import threading

    from repro_torch.models.lm import lm_init, lm_loss
    from repro_torch.optim.optimizers import tree_leaves, tree_map

    cfg = dataclasses.replace(_cfg(), remat=True)
    whole = lm_init(cfg, 0, device="cpu")
    tokens = torch.arange(24).reshape(2, 12) * 5 % cfg.vocab

    def grads(mesh, elsewhere):
        p = tree_map(lambda t: t.detach().requires_grad_(True), ttree.shard_tree(whole, mesh))
        loss, _ = lm_loss(p, cfg, tokens, SpringContext(cfg=MODES["quant_sparse"],
                                                        attention="chunked"))
        if elsewhere:
            t = threading.Thread(target=loss.backward)
            t.start()
            t.join()
        else:
            loss.backward()
        return [q.grad for q in tree_leaves(p)]

    same = T.on_threads(2, lambda mesh: grads(mesh, False))
    other = T.on_threads(2, lambda mesh: grads(mesh, True))
    for a, b in zip(same, other):
        assert all(x is not None and torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("arch,n", [("minitron-4b", 3), ("qwen2-7b", 7)])
def test_whole_kv_weights_beside_split_queries_get_the_whole_gradient(arch, n):
    """Where the q columns split over model and the kv columns do not
    (minitron's 32 at 3, qwen2's 16 at 7), wk / wv (and qwen2's biases)
    are whole on every rank and each rank reads its kv heads' columns:
    their gradient is summed over model, the same bits on every rank; every
    leaf's gradient, or its slice for a split leaf, is the unsharded one
    within 5e-4 of the leaf's largest (the sums' order differs; a rank's
    share alone would miss most of it)."""
    from repro_torch.models.lm import lm_init, lm_loss
    from repro_torch.optim.optimizers import tree_leaves, tree_map

    cfg = tget_arch(arch).resolve(reduced=True)
    whole = lm_init(cfg, 0, device="cpu")
    tokens = torch.arange(24).reshape(2, 12) * 5 % cfg.vocab
    ctx = SpringContext(cfg=MODES["quant_sparse"], attention="chunked")

    def grads(params):
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        lm_loss(p, cfg, tokens, ctx)[0].backward()
        return [q.grad for q in tree_leaves(p)]

    want = grads(whole)

    def rank(mesh):
        splits = ttree.leaf_splits(ttree.param_splits(cfg, mesh), whole)
        return grads(ttree.shard_tree(whole, mesh)), splits

    got = T.on_threads(n, rank)
    kv = [i for i, path in enumerate(_leaf_paths(whole)) if path[-2] in ("wk", "wv")]
    assert kv and all(got[0][1][i] is None for i in kv)
    for g, splits in got:
        for i, (a, b, split) in enumerate(zip(g, want, splits)):
            if split is None:
                assert torch.equal(a, got[0][0][i]), i
            b = b if split is None else split.take(b)
            assert (a - b).abs().max() <= 5e-4 * b.abs().max(), i


def _leaf_paths(tree) -> list:
    out: list = []
    ttree.map_with_path(lambda path, leaf: out.append(path), tree)
    return out


# -- the ranks: against the reference's partitioned runs and the unsharded runs -------------------

@pytest.mark.parametrize("mode", T.TRAIN_MODES)
@pytest.mark.parametrize("n", EXTENTS)
def test_tensor_parallel_losses_match_the_references_partitioned_run(spawns, reference,
                                                                      unsharded, mode, n):
    """Every rank's losses are the same bits, within rel 1e-5 (quant_sparse,
    nearest) / 2e-4 (dense) of the reference's run at the same extent and
    of the port's unsharded run."""
    ranks = spawns[n]["ranks"]
    got = ranks[0]["train"][mode]["losses"]
    for r in ranks:
        assert r["train"][mode]["losses"] == got
        assert r["train"][mode]["mesh"] == f"pod1.data1.model{n}"
    np.testing.assert_allclose(got, reference["train"][str(n)][mode], rtol=LOSS_RTOL[mode])
    np.testing.assert_allclose(got, unsharded["train"][mode], rtol=LOSS_RTOL[mode])


@pytest.mark.parametrize("mode", R.SERVE_MODES)
@pytest.mark.parametrize("n", EXTENTS)
def test_tensor_parallel_static_tokens_are_the_references(spawns, reference, unsharded, mode, n):
    """Every rank's greedy tokens are the reference's at the same extent and
    the port's unsharded run's."""
    for r in spawns[n]["ranks"]:
        assert r["serve"][mode]["generated"] == reference["serve"][str(n)][mode]
        assert r["serve"][mode]["generated"] == unsharded["serve"][mode]


@pytest.mark.parametrize("n", EXTENTS)
def test_every_rank_holds_the_same_replicated_activations(spawns, n):
    """The hidden states and the loss of one forward, and the replicated
    norm scales after training, are the same bits on every rank; the
    ranks' shards differ."""
    ranks = spawns[n]["ranks"]
    f0 = ranks[0]["forward"]
    for r in ranks[1:]:
        assert torch.equal(r["forward"]["hidden"], f0["hidden"])
        assert torch.equal(r["forward"]["loss"], f0["loss"])
        for mode in T.TRAIN_MODES:
            assert torch.equal(r["train"][mode]["norms"], ranks[0]["train"][mode]["norms"])
    assert not torch.equal(ranks[1]["forward"]["shard"][0], f0["shard"][0])


@pytest.mark.parametrize("n", EXTENTS)
def test_each_rank_holds_its_shards_and_reports_its_hops(spawns, n):
    """Each rank's parameter bytes are the sum of its shards' (a 1/n part of
    every split leaf), it joined the same number of model collectives as
    every other rank, and none was staged (CPU tensors)."""
    from repro_torch.models.lm import lm_init
    from repro_torch.optim.optimizers import tree_leaves

    whole = lm_init(_cfg(), device="meta")
    specs = _spec_leaves(ttree.tree_shardings(whole, _Stub(n)))
    want = sum(p.numel() * 4 // (n if "model" in spec else 1)
               for p, spec in zip(tree_leaves(whole), specs))
    reports = [r["train"]["quant_sparse"]["report"] for r in spawns[n]["ranks"]]
    for rep in reports:
        assert rep["model"] == n and rep["param_bytes"] == want and rep["staged_hops"] == 0
        assert rep["model_hops"] == reports[0]["model_hops"] > 0
    assert [rep["rank"] for rep in reports] == list(range(n))


def test_data_and_model_together_keep_model_replicated(spawns, unsharded):
    """data=2 x model=2: the data-parallel run, bit-equal to the unsharded
    losses and tokens as before, no weight split."""
    for r in spawns[4]["ranks"]:
        dm = r["data_and_model"]
        assert dm["losses"] == unsharded["train"]["quant_sparse"]
        assert dm["generated"] == unsharded["serve"]["dense"]
        assert not dm["tp"]


def test_training_with_whole_kv_weights_beside_split_queries_is_the_unsharded_run(uneven):
    """Reduced minitron-4b at model 3 (its 96 q columns split, its 32 kv
    columns, MLP and vocabulary whole): every rank's losses, wk / wv and
    norm scales after two steps are the same bits, the losses within rel
    1e-5 of the unsharded run's and wk / wv within 1e-4 of its (a rank's
    share of their gradient alone drifts the ranks apart)."""
    ranks = uneven["ranks"]
    for r in ranks:
        assert r["losses"] == ranks[0]["losses"]
        for key in ("wk", "wv", "norms"):
            assert torch.equal(r[key], ranks[0][key]), key
    assert [r["report"]["rank"] for r in ranks] == [0, 1, 2]
    np.testing.assert_allclose(ranks[0]["losses"], uneven["losses"], rtol=1e-5)
    for key in ("wk", "wv"):
        torch.testing.assert_close(ranks[0][key], uneven[key], rtol=0, atol=1e-4)


@pytest.mark.parametrize("n", EXTENTS)
def test_a_tensor_parallel_checkpoint_is_whole_and_resumes_unsharded(spawns, unsharded, n):
    """The model-n run writes whole leaves under the reference's names (rank
    0 alone); an unsharded session resumes it and takes the third step
    within rel 1e-5 of the uninterrupted unsharded run."""
    from repro_torch.checkpoint.manager import load_checkpoint

    ckpt = spawns[n]["ckpt_dir"]
    step, flat = load_checkpoint(ckpt)
    assert step == 2
    assert flat["0/embed/embedding"].shape == (512, 128)
    assert flat["0/unit_0/mixer/wq/kernel"].shape == (3, 128, 128)
    assert flat["1/.m/unit_0/ffn/down/kernel"].shape == (3, 384, 128)
    got = TrainSession(tbuild("train", sets=[s for s in R.TRAIN_SETS
                                             if not s.startswith("train.")]
                              + ["train.steps=3", f"train.ckpt_dir={ckpt}"], use_env=False),
                       device="cpu").run()["losses"]
    np.testing.assert_allclose(got, unsharded["three"][2:], rtol=1e-5)
    np.testing.assert_allclose(spawns[n]["ranks"][0]["ckpt_losses"], unsharded["three"][:2],
                               rtol=1e-5)


@pytest.mark.parametrize("n", EXTENTS)
def test_a_reference_checkpoint_resumes_tensor_parallel(spawns, reference, n):
    """The reference's step-1 checkpoint, resumed at model n by slicing:
    the second step's loss is the reference's uninterrupted run's within
    rel 1e-5, on every rank."""
    want = reference["train"]["1"]["quant_sparse"][1:]
    for r in spawns[n]["ranks"]:
        np.testing.assert_allclose(r["resumed_losses"], want, rtol=1e-5)
