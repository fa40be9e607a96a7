"""Expert parallelism over ``model``: reduced olmoe-1b-7b (GQA, 8 experts
top-2) and deepseek-v2-lite-16b (MLA, a dense first layer, 8 routed
experts top-2 and 2 shared) with their experts, heads and vocabulary split
over ``model``, held against the reference's partitioned run, the port's
unsharded run and the slices of whole tensors.

The reference's partitioned results come from one subprocess at model 4
(``_torch_ep_reference.py``: 4 forced host devices, an Auto-typed ``(1,
1, 4)`` mesh handed to its sessions; its model-1 runs are held by
``test_torch_moe.py`` / ``test_torch_train_moe.py``), started first so
that it runs beside the port's two gloo spawns at model 4 and 2
(``_torch_ep_ranks.ep_ranks``).  The same runs unsharded run in this
process on one thread, as the ranks run.  The exact cases run in this
process, the ranks of a ``model`` axis as threads
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

import _torch_ep_ranks as P  # noqa: E402
import _torch_tp_ranks as T  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.runtime import sharding as jsharding  # noqa: E402
from repro.runtime import tree_sharding as jtree  # noqa: E402

from repro_torch.api.sessions import TrainSession  # noqa: E402
from repro_torch.configs import get_arch as tget_arch  # noqa: E402
from repro_torch.core.fixedpoint import quantize_stochastic  # noqa: E402
from repro_torch.core.spring_ops import MODES, KeyGen  # noqa: E402
from repro_torch.dist import launch  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.layers import SpringContext  # noqa: E402
from repro_torch.models.lm import lm_init, tensor_parallel  # noqa: E402
from repro_torch.optim.optimizers import tree_leaves, tree_map  # noqa: E402
from repro_torch.runtime import sharding as tsharding  # noqa: E402
from repro_torch.runtime import tree_sharding as ttree  # noqa: E402

pytestmark = pytest.mark.mesh

SPAWN_TIMEOUT_S = 240
REF_TIMEOUT_S = 300
EXTENTS = (4, 2)
#: a row split's partial sums, summed over model in rank order: within two
#: steps of the Q4.16 grid of the unsharded product (test_torch_tensor_parallel)
ROW_TOL = 2 * 2.0**-16


class _Stub:
    """A mesh of ``model`` extent n seen from rank r (no collectives)."""

    def __init__(self, n, r=0, data=1):
        self.shape = {"pod": 1, "data": data, "model": n}
        self.r = r

    def axis_index(self, axis):
        return self.r if axis == "model" else 0


class _JMesh:
    def __init__(self, n):
        self.shape = {"pod": 1, "data": 1, "model": n}


def _cfg(arch):
    return tget_arch(arch).resolve(reduced=True)


# -- the runs ------------------------------------------------------------------------------------

def _reference_proc(stderr) -> subprocess.Popen:
    here = os.path.dirname(__file__)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.join(here, "..", "src"), here,
                                           os.environ.get("PYTHONPATH", "")]))
    return subprocess.Popen([sys.executable, os.path.join(here, "_torch_ep_reference.py")],
                            env=env, stdout=subprocess.PIPE, stderr=stderr, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory) -> dict:
    """The reference's subprocess, the port unsharded (its checkpoints
    written: 3 steps, and 1 step to resume at model n), the two spawns,
    and an unsharded session resuming each spawn's checkpoint."""
    base = tmp_path_factory.mktemp("ep")
    err = open(base / "reference.err", "w+")
    proc = _reference_proc(err)
    try:
        np_params = {a: jax.tree_util.tree_map(
            np.asarray, jlm.lm_init(jax.random.PRNGKey(0), jget_arch(a).reduced()))
            for a in P.ARCHS}
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            out: dict = {1: P.runs(np_params, 1, {"write": str(base / "m1")})}
            first = base / "first"
            TrainSession(P.spec("train", P.CKPT_ARCH,
                                [s for s in P.TRAIN_SETS if not s.startswith("train.")]
                                + ["train.steps=1", f"train.ckpt_dir={first}"]),
                         device="cpu").run()
        finally:
            torch.set_num_threads(n)
        for world in EXTENTS:
            resume = base / f"resume{world}"
            shutil.copytree(first, resume)  # the resumed run writes its last step there
            out[world] = launch.run(P.ep_ranks, world, (np_params, {
                "write": str(base / f"m{world}"), "resume": str(resume)}),
                timeout_s=SPAWN_TIMEOUT_S, store_dir=str(base))
            out[f"resumed_unsharded_{world}"] = TrainSession(P.spec(
                "train", P.CKPT_ARCH, [s for s in P.TRAIN_SETS if not s.startswith("train.")]
                + ["train.steps=3", f"train.ckpt_dir={base / f'm{world}'}"]),
                device="cpu").run()["losses"]
        out["dirs"] = {world: str(base / f"m{world}") for world in EXTENTS}
        stdout, _ = proc.communicate(timeout=REF_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
        err.seek(0)
        stderr = err.read()
        err.close()
    assert proc.returncode == 0, stderr[-4000:]
    out["reference"] = json.loads(stdout.strip().splitlines()[-1])
    return out


# -- the layout ----------------------------------------------------------------------------------

def _ref_specs(cfg, n) -> dict:
    """{(unit or layer key, leaf path): spec} of the reference's stacked
    lm_init tree, the stacked dim dropped."""
    tree = jax.eval_shape(lambda: jlm.lm_init(jax.random.PRNGKey(0), cfg))
    out = {}

    def one(path, leaf):
        names = tuple(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        spec = tuple(jsharding.logical_to_spec(jtree.logical_axes_for_path(path, leaf.shape),
                                               leaf.shape, _JMesh(n)))
        out[names] = spec[1:] if names[0].startswith("unit_") else spec

    jax.tree_util.tree_map_with_path(one, tree)
    return out


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in _flat(v, path + (k,))]
    return [(path, tree)]


@pytest.mark.parametrize("n", EXTENTS)
@pytest.mark.parametrize("arch", P.ARCHS)
def test_param_splits_are_the_references_table(arch, n):
    """Every leaf's spec is its leaf's in the reference's stacked tree;
    the experts split on dim 0 (row kind), MLA's wq / wuk / wuv by columns
    and wo by rows, the shared experts and deepseek's dense MLP as a SwiGLU
    MLP; wdkv, wkr, the router and the norms stay whole."""
    cfg = _cfg(arch)
    ref = _ref_specs(jget_arch(arch).reduced(), n)
    got = ttree.tree_shardings(lm_init(cfg, device="meta"), _Stub(n))
    for (key, _, _), layer in zip(cfg.layer_plan, got["layers"]):
        for path, spec in _flat(layer):
            assert spec == ref[(key,) + path], (key, path)
    with tsharding.sharding_context(_Stub(n, 1)):
        splits = ttree.param_splits(cfg, _Stub(n, 1))
    layer = splits["layers"][-1]
    for name in ("w_gate", "w_up", "w_down"):
        s = layer["ffn"][name]
        assert (s.kind, s.dim, s.lo, s.hi) == ("row", 0, 8 // n, 16 // n), name
    assert layer["ffn"]["router"]["kernel"] is None and layer["norm2"]["scale"] is None
    mixer = layer["mixer"]
    if arch.startswith("deepseek"):
        kinds = {k: mixer[k]["kernel"] and mixer[k]["kernel"].kind for k in mixer}
        assert kinds == {"wq": "col", "wuk": "col", "wuv": "col", "wo": "row", "wdkv": None,
                         "wkr": None}
        assert {k: layer["ffn"]["shared"][k]["kernel"].kind for k in ("gate", "up", "down")} \
            == {"gate": "col", "up": "col", "down": "row"}
        assert splits["layers"][0]["ffn"]["down"]["kernel"].kind == "row"


@pytest.mark.parametrize("arch", P.ARCHS)
def test_a_full_width_rank_holds_a_quarter_of_the_experts(arch):
    """At full width and model 4 a rank holds 16 of the 64 experts and
    about a quarter of the parameters (olmoe 1.73 B of 6.92 B, deepseek
    3.95 B of 15.71 B: the router, the norms and MLA's wdkv / wkr whole)."""
    cfg = tget_arch(arch).resolve(reduced=False)
    meta = lm_init(cfg, device="meta")
    whole = sum(p.numel() for p in tree_leaves(meta))
    with tsharding.sharding_context(_Stub(4, 3)):
        splits = ttree.leaf_splits(ttree.param_splits(cfg, _Stub(4, 3)), meta)
    mine = sum(p.numel() // (1 if s is None else 4) for p, s in zip(tree_leaves(meta), splits))
    w_gate = ttree.param_splits(cfg, _Stub(4, 3))["layers"][-1]["ffn"]["w_gate"]
    assert (w_gate.lo, w_gate.hi) == (48, 64)
    want = {"olmoe-1b-7b": (6.919e9, 1.73e9), "deepseek-v2-lite-16b": (15.706e9, 3.95e9)}[arch]
    assert abs(whole - want[0]) < 1e6 and abs(mine - want[1]) < 0.01e9
    assert 0.25 < mine / whole < 0.252


@pytest.mark.parametrize("n", EXTENTS)
@pytest.mark.parametrize("arch", P.ARCHS)
def test_leaf_by_leaf_shards_are_the_whole_inits_slices(arch, n):
    """lm_init(mesh=) draws each leaf whole and keeps the rank's slice: on
    every rank the shards equal shard_tree's slices of lm_init's whole
    tree bit for bit, and no shard keeps the whole leaf's storage."""
    cfg = _cfg(arch)
    whole = lm_init(cfg, 0, device="cpu")

    def rank(mesh):
        got = lm_init(cfg, 0, device="cpu", mesh=mesh)
        return tree_leaves(got), tree_leaves(ttree.shard_tree(whole, mesh))

    for got, want in T.on_threads(n, rank):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
            assert a.untyped_storage().nbytes() == a.numel() * 4


@pytest.mark.parametrize("arch,tp", [("olmoe-1b-7b", True), ("deepseek-v2-lite-16b", True),
                                     ("llama3.2-1b", True), ("mamba2-780m", True),
                                     ("recurrentgemma-9b", True), ("whisper-medium", False),
                                     ("internvl2-26b", False)])
def test_tensor_parallel_covers_the_moe_family_and_no_more(arch, tp):
    """tensor_parallel holds for the dense family, olmoe and deepseek at
    model 4 (data 1), and for mamba2 and recurrentgemma since their SSM and
    RG-LRU blocks split (test_torch_ssm_parallel.py), not at data 2 x
    model 2, and never for whisper or internvl2 (replicated)."""
    cfg = _cfg(arch)
    assert tensor_parallel(cfg, _Stub(4)) is tp
    assert tensor_parallel(cfg, _Stub(2, data=2)) is False


def test_mla_heads_that_do_not_divide_keep_the_arch_replicated():
    """deepseek's 4 reduced MLA heads split at model 2 and 4, not at 3;
    mla_apply refuses a split of its columns that does not fall on whole
    heads (6 heads of 24 columns at model 4: 36 columns a rank)."""
    import dataclasses

    cfg = _cfg("deepseek-v2-lite-16b")
    assert [tensor_parallel(cfg, _Stub(n)) for n in (2, 3, 4)] == [True, False, True]
    spec = dataclasses.replace(cfg.mla, n_heads=6)
    params = attn_mod.mla_init(torch.Generator().manual_seed(0), 64, spec)
    with tsharding.sharding_context(_Stub(4)), pytest.raises(NotImplementedError):
        attn_mod.mla_apply(params, torch.zeros(1, 2, 64), SpringContext(), spec,
                           torch.arange(2)[None])


def test_the_pools_split_olmoe_by_kv_head_and_keeps_mla_whole():
    """olmoe-1b-7b's 16 kv heads split 4 a rank at model 4; deepseek's
    latent pool is whole on every rank (no KVHeadSplit)."""
    olmoe = tget_arch("olmoe-1b-7b").resolve(reduced=False)
    with tsharding.sharding_context(_Stub(4, 2)):
        heads = ttree.kv_head_split(olmoe, _Stub(4, 2))
        deep = ttree.kv_head_split(tget_arch("deepseek-v2-lite-16b").resolve(reduced=False),
                                   _Stub(4, 2))
    assert heads.mine == (8, 9, 10, 11) and heads.n_heads == 16
    assert deep is None


@pytest.mark.parametrize("n", EXTENTS)
def test_an_expert_shards_stochastic_rounding_is_the_slice_of_the_wholes(n):
    """Split.counter() of a dim-0 expert shard is the whole leaf's element
    counter: the optimizer's SR of the (E/n, d, f) shard is the slice of
    the whole (E, d, f) leaf's, bit for bit."""
    cfg = _cfg("olmoe-1b-7b")
    whole = torch.randn(8, 64, 48, generator=torch.Generator().manual_seed(2))
    want = quantize_stochastic(torch.Generator().manual_seed(9), whole)
    for r in range(n):
        with tsharding.sharding_context(_Stub(n, r)):
            split = ttree.param_splits(cfg, _Stub(n, r))["layers"][0]["ffn"]["w_up"]
        assert split.counter() == (r * (8 // n) * 64 * 48, 48)
        got = quantize_stochastic(torch.Generator().manual_seed(9), split.take(whole).clone(),
                                  counter=split.counter())
        assert torch.equal(got, split.take(want))


# -- the exact cases, in this process ------------------------------------------------------------

def _moe_shards(params: dict, n: int, r: int) -> dict:
    e = params["w_gate"].shape[0] // n
    out = {"router": params["router"],
           **{k: params[k][r * e:(r + 1) * e].clone() for k in ("w_gate", "w_up", "w_down")}}
    if "shared" in params:
        sh = params["shared"]
        f = sh["gate"]["kernel"].shape[1] // n
        out["shared"] = {"gate": {"kernel": sh["gate"]["kernel"][:, r * f:(r + 1) * f]},
                         "up": {"kernel": sh["up"]["kernel"][:, r * f:(r + 1) * f]},
                         "down": {"kernel": sh["down"]["kernel"][r * f:(r + 1) * f]}}
    return out


def _moe_run(params, x, spec, mode, sr):
    ctx = SpringContext(cfg=MODES[mode], keys=KeyGen(5) if sr else None)
    p = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
    xx = x.clone().requires_grad_(True)
    y, aux = moe_mod.moe_apply(p, xx, ctx, spec)
    (y.float().square().sum() + aux).backward()
    return {"y": y.detach(), "aux": aux.detach(), "dx": xx.grad,
            "grads": tree_map(lambda t: t.grad, p), "draws": ctx.keys._counter if sr else 0}


@pytest.mark.parametrize("mode,sr", [("quant_sparse", False), ("quant", True), ("dense", False)])
@pytest.mark.parametrize("n", EXTENTS)
def test_moe_apply_over_expert_shards_is_the_unsharded_bit_for_bit(n, mode, sr):
    """olmoe's routed FFN (8 experts, top-2, drops at capacity factor 1):
    on every rank the output, the aux loss, x's and the router's gradients
    are the unsharded run's bits and each expert shard's gradient is the
    slice of the unsharded gradient (a gather whose backward summed over
    model would multiply them by n); under SR the KeyGen ends where the
    unsharded one does, every site drawing its unsharded key."""
    import dataclasses

    spec = dataclasses.replace(_cfg("olmoe-1b-7b").moe, capacity_factor=1.0)
    gen = torch.Generator().manual_seed(0)
    params = moe_mod.moe_init(gen, 64, spec)
    x = torch.randn(2, 24, 64, generator=gen)
    want = _moe_run(params, x, spec, mode, sr)

    def rank(mesh):
        return _moe_run(_moe_shards(params, n, mesh.axis_index("model")), x, spec, mode, sr)

    for r, got in enumerate(T.on_threads(n, rank)):
        for key in ("y", "aux", "dx", "draws"):
            assert (torch.equal(got[key], want[key]) if key != "draws"
                    else got[key] == want[key]), key
        assert torch.equal(got["grads"]["router"]["kernel"], want["grads"]["router"]["kernel"])
        for k in ("w_gate", "w_up", "w_down"):
            assert torch.equal(got["grads"][k], want["grads"][k].chunk(n)[r]), k


@pytest.mark.parametrize("mode,sr", [("quant_sparse", False), ("quant", True)])
@pytest.mark.parametrize("top_k", (4, 6))
@pytest.mark.parametrize("n", EXTENTS)
def test_moe_apply_at_full_width_top_k_over_expert_shards(n, top_k, mode, sr):
    """At the full archs' top-k (olmoe 8, deepseek 6), a token's k slots
    spread over several ranks.  Its dx is each rank's sum of its own
    slots' gradients, summed over model in rank order, where the
    unsharded run sums the k slots in one: another association, so dx is
    within two ulps of its largest value, and the same bits on every
    rank.  The output, the aux loss, the router's gradient (which reads
    the combine, not the dispatch) and each expert shard's gradient stay
    the unsharded bits."""
    import dataclasses

    spec = dataclasses.replace(_cfg("olmoe-1b-7b").moe, capacity_factor=1.0, top_k=top_k)
    gen = torch.Generator().manual_seed(0)
    params = moe_mod.moe_init(gen, 64, spec)
    x = torch.randn(2, 24, 64, generator=gen)
    want = _moe_run(params, x, spec, mode, sr)
    got = T.on_threads(n, lambda mesh: _moe_run(_moe_shards(params, n, mesh.axis_index("model")),
                                                x, spec, mode, sr))
    ulp = torch.finfo(torch.float32).eps * want["dx"].abs().max()
    for r, g in enumerate(got):
        for key in ("y", "aux"):
            assert torch.equal(g[key], want[key]), key
        assert g["draws"] == want["draws"]
        assert torch.equal(g["dx"], got[0]["dx"])
        assert (g["dx"] - want["dx"]).abs().max() <= 2 * ulp
        assert torch.equal(g["grads"]["router"]["kernel"], want["grads"]["router"]["kernel"])
        for k in ("w_gate", "w_up", "w_down"):
            assert torch.equal(g["grads"][k], want["grads"][k].chunk(n)[r]), k


@pytest.mark.parametrize("n", EXTENTS)
def test_deepseeks_moe_with_shared_experts_over_shards(n):
    """deepseek's FFN: the routed experts as above; the shared experts'
    row-split down product sums over model in rank order, so the output
    is within two Q4.16 steps of the unsharded one and the same bits on
    every rank, as are x's and the router's gradients."""
    spec = _cfg("deepseek-v2-lite-16b").moe
    gen = torch.Generator().manual_seed(1)
    params = moe_mod.moe_init(gen, 64, spec)
    x = torch.randn(2, 24, 64, generator=gen)
    want = _moe_run(params, x, spec, "quant_sparse", False)
    got = T.on_threads(n, lambda mesh: _moe_run(_moe_shards(params, n, mesh.axis_index("model")),
                                                x, spec, "quant_sparse", False))
    for r, g in enumerate(got):
        for key in ("y", "dx"):
            assert torch.equal(g[key], got[0][key])
            torch.testing.assert_close(g[key], want[key], rtol=0, atol=ROW_TOL)
        assert torch.equal(g["aux"], want["aux"])
        rg, rw = g["grads"]["router"]["kernel"], want["grads"]["router"]["kernel"]
        assert torch.equal(rg, got[0]["grads"]["router"]["kernel"])
        assert (rg - rw).abs().max() <= 1e-4 * rw.abs().max()
        for k in ("w_gate", "w_up", "w_down"):
            w = want["grads"][k].chunk(n)[r]
            assert (g["grads"][k] - w).abs().max() <= 1e-4 * w.abs().max(), k


def _mla_shards(params: dict, spec, n: int, r: int) -> dict:
    def cols(t, width):
        return t.reshape(t.shape[0], spec.n_heads, width).chunk(n, 1)[r].reshape(t.shape[0], -1)

    dq = spec.qk_nope_dim + spec.qk_rope_dim
    return {"wq": {"kernel": cols(params["wq"]["kernel"], dq)},
            "wdkv": params["wdkv"], "wkr": params["wkr"],
            "wuk": {"kernel": cols(params["wuk"]["kernel"], spec.qk_nope_dim)},
            "wuv": {"kernel": cols(params["wuv"]["kernel"], spec.v_head_dim)},
            "wo": {"kernel": params["wo"]["kernel"].chunk(n, 0)[r]}}


def _mla_run(params, x, spec):
    """Prefill forward and backward, the cache, then one absorbed decode
    step against it."""
    ctx = SpringContext(cfg=MODES["quant_sparse"], attention="chunked")
    p = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
    xx = x.clone().requires_grad_(True)
    b, s, _ = x.shape
    pos = torch.arange(s).expand(b, s)
    y, cache = attn_mod.mla_apply(p, xx, ctx, spec, pos, return_cache=True)
    y.float().square().sum().backward()
    cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 1)) for k, v in cache.items()}
    with torch.no_grad():
        dec, _ = attn_mod.mla_apply(params, x[:, :1] * 0.5, ctx, spec,
                                    torch.full((b, 1), s), cache, torch.tensor(s))
    return {"y": y.detach(), "dx": xx.grad, "grads": tree_map(lambda t: t.grad, p),
            "cache": cache, "decode": dec}


@pytest.mark.parametrize("n", EXTENTS)
def test_mla_apply_over_head_shards(n):
    """deepseek's MLA split by head: the prefill output, x's gradient and
    the decode step are the same bits on every rank and within two Q4.16
    steps of the unsharded run (wo's rows sum over model); the latent cache
    is the unsharded one bit for bit; wdkv's and wkr's gradients (summed
    over model where their outputs enter the rank's heads) are the same
    bits on every rank and the unsharded gradient within rel 1e-5 of its
    largest (one rank's share alone would miss most of it), and wq / wuk
    / wuv / wo's are the unsharded gradients' slices likewise."""
    spec = _cfg("deepseek-v2-lite-16b").mla
    gen = torch.Generator().manual_seed(4)
    params = attn_mod.mla_init(gen, 64, spec)
    x = torch.randn(2, 12, 64, generator=gen)
    want = _mla_run(params, x, spec)

    def rank(mesh):
        return _mla_run(_mla_shards(params, spec, n, mesh.axis_index("model")), x, spec)

    got = T.on_threads(n, rank)
    for r, g in enumerate(got):
        for key in ("y", "dx", "decode"):
            assert torch.equal(g[key], got[0][key]), key
            torch.testing.assert_close(g[key], want[key], rtol=0, atol=ROW_TOL)
        for key in ("ckv", "krope"):
            assert torch.equal(g["cache"][key], want["cache"][key])
        shard = _mla_shards(want["grads"], spec, n, r)
        for name in ("wq", "wdkv", "wkr", "wuk", "wuv", "wo"):
            a, b = g["grads"][name]["kernel"], shard[name]["kernel"]
            if name in ("wdkv", "wkr"):
                assert torch.equal(a, got[0]["grads"][name]["kernel"]), name
            assert (a - b).abs().max() <= 1e-5 * b.abs().max(), name


# -- the ranks: against the reference's partitioned runs and the unsharded port ----------------

@pytest.mark.parametrize("n", EXTENTS)
@pytest.mark.parametrize("arch", P.ARCHS)
def test_losses_match_the_references_partitioned_run(runs, arch, n):
    """Every rank's losses are the same bits, within rel 1e-5 of the
    reference's run at model 4 (quant_sparse, nearest) and of the port's
    unsharded run."""
    ranks = runs[n]
    got = ranks[0][arch]["losses"]
    for r in ranks:
        assert r[arch]["losses"] == got
    np.testing.assert_allclose(got, runs["reference"][arch]["losses"], rtol=1e-5)
    np.testing.assert_allclose(got, runs[1][arch]["losses"], rtol=1e-5)


@pytest.mark.parametrize("n", EXTENTS)
@pytest.mark.parametrize("arch", P.ARCHS)
def test_replicated_leaves_stay_the_same_bits_on_every_rank(runs, arch, n):
    """After two steps the routers, the norm scales and MLA's wdkv / wkr
    (whole on every rank) are the same bits on every rank and within 1e-4
    of the unsharded run's."""
    ranks = runs[n]
    for r in ranks[1:]:
        assert torch.equal(r[arch]["replicated"], ranks[0][arch]["replicated"])
    torch.testing.assert_close(ranks[0][arch]["replicated"], runs[1][arch]["replicated"],
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("n", EXTENTS)
@pytest.mark.parametrize("arch", P.ARCHS)
def test_static_tokens_are_the_references(runs, arch, n):
    """The static path's greedy tokens on every rank are the reference's
    partitioned run's and the port's unsharded run's."""
    for r in runs[n]:
        assert r[arch]["static"] == runs["reference"][arch]["static"] == runs[1][arch]["static"]


@pytest.mark.parametrize("paged", (False, True))
@pytest.mark.parametrize("n", EXTENTS)
@pytest.mark.parametrize("arch", P.ARCHS)
def test_engine_tokens_are_the_references(runs, arch, n, paged):
    """The engine session (a queue of 3 over 2 slots), monolithic and
    paged: every rank's tokens are the reference's partitioned engine's and
    the port's unsharded engine's."""
    key = f"engine_{paged}"
    for r in runs[n]:
        assert r[arch][key] == runs["reference"][arch][key] == runs[1][arch][key]


@pytest.mark.parametrize("n", EXTENTS)
@pytest.mark.parametrize("arch", P.ARCHS)
def test_each_rank_holds_its_shards_and_its_pool(runs, arch, n):
    """Each rank's parameter bytes are its shards' (a 1/n part of every
    split leaf), it joined as many model collectives as every other rank;
    olmoe's engine pool holds the rank's kv heads (4/n of 4), deepseek's
    latent pool is whole (no kv heads named) and as large on every rank."""
    meta = lm_init(_cfg(arch), device="meta")
    specs = [s for _, s in _flat_specs(ttree.tree_shardings(meta, _Stub(n)))]
    want = sum(p.numel() * 4 // (n if "model" in spec else 1)
               for p, spec in zip(tree_leaves(meta), specs))
    reps = [r[arch]["report"] for r in runs[n]]
    for i, rep in enumerate(reps):
        assert rep["model"] == n and rep["rank"] == i and rep["param_bytes"] == want
        assert rep["model_hops"] == reps[0]["model_hops"] > 0
        eng = runs[n][i][arch]["engine_report_False"]
        if arch.startswith("olmoe"):
            assert eng["kv_heads"] == list(range(i * 4 // n, (i + 1) * 4 // n))
        else:
            assert eng["kv_heads"] is None
            assert eng["pool_bytes"] == runs[n][0][arch]["engine_report_False"]["pool_bytes"]


def _flat_specs(specs, path=()):
    if isinstance(specs, dict):
        return [kv for k, v in specs.items() for kv in _flat_specs(v, path + (k,))]
    if isinstance(specs, list):
        return [kv for i, v in enumerate(specs) for kv in _flat_specs(v, path + (i,))]
    return [(path, specs)]


@pytest.mark.parametrize("n", EXTENTS)
def test_an_expert_parallel_checkpoint_is_whole_and_resumes_unsharded(runs, n):
    """olmoe's model-n run writes whole leaves (every expert) under the
    reference's names; an unsharded session resumes it and takes the third
    step within rel 1e-5 of the uninterrupted unsharded run."""
    from repro_torch.checkpoint.manager import load_checkpoint

    ranks, three = runs[n], runs[1]["ckpt_losses"]
    step, flat = load_checkpoint(runs["dirs"][n], step=2)
    assert step == 2
    assert flat["0/unit_0/ffn/w_gate"].shape == (3, 8, 64, 48)
    assert flat["1/.m/unit_0/ffn/w_down"].shape == (3, 8, 48, 64)
    np.testing.assert_allclose(ranks[0]["ckpt_losses"], three[:2], rtol=1e-5)
    np.testing.assert_allclose(runs[f"resumed_unsharded_{n}"], three[2:], rtol=1e-5)


@pytest.mark.parametrize("n", EXTENTS)
def test_an_unsharded_checkpoint_resumes_expert_parallel(runs, n):
    """The port's unsharded step-1 checkpoint of the seeded run, resumed
    at model n by slicing: the second step's loss is the uninterrupted
    unsharded seeded run's within rel 1e-5, on every rank."""
    for r in runs[n]:
        np.testing.assert_allclose(r["resumed_losses"], runs[1]["seeded"]["losses"][1:2],
                                   rtol=1e-5)


@pytest.mark.parametrize("n", EXTENTS)
def test_sessions_given_no_params_draw_their_shards_leaf_by_leaf(runs, n):
    """Given no parameters, the train, static and engine sessions at model
    n each draw the rank's shards leaf by leaf (three lm_init(mesh=) calls,
    no whole tree): the losses within rel 1e-5 and the tokens equal to the
    unsharded seeded runs', and every trained leaf is compact."""
    want = runs[1]["seeded"]
    assert runs[1]["shard_inits"] == 0
    for r in runs[n]:
        assert r["shard_inits"] == 3 and r["seeded"]["compact"]
        np.testing.assert_allclose(r["seeded"]["losses"], want["losses"], rtol=1e-5)
        assert r["seeded"]["static"] == want["static"]
        assert r["seeded"]["engine"] == want["engine"]
