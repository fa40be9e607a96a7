"""The SSM and RG-LRU blocks over ``model``: reduced mamba2-780m (4 SSM
heads, one state group, tied embeddings) and recurrentgemma-9b (RG-LRU
blocks and windowed attention of 4 query heads on 1 kv head) with their
heads, channels and vocabulary split over ``model``, held against the
reference's partitioned run, the port's unsharded run and the slices of
whole tensors.

The reference's partitioned results come from one subprocess
(``_torch_ssm_tp_reference.py``: 4 forced host devices, an Auto-typed
``(1, 1, m)`` mesh handed to its sessions; mamba2 at model 2 and 4,
recurrentgemma at model 4), started first so that it runs beside the
port's two gloo spawns at model 4 and 2 (``_torch_ssm_tp_ranks.ssm_ranks``).
The same runs unsharded run in this process on one thread, as the ranks
run.  The block cases run in this process, the ranks of a ``model`` axis
as threads (``_torch_tp_ranks.on_threads``).  Reduced mamba2's ``in_proj``
is 292 columns wide and splits at model 2 and 4; the block and layout
cases also take mamba2 with a d_state of 15 (290 columns), whose
``in_proj`` stays whole at model 4 (the divisibility fallback) while
``out_proj`` and the heads split.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import _torch_ssm_tp_ranks as P  # noqa: E402
import _torch_tp_ranks as T  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.runtime import sharding as jsharding  # noqa: E402
from repro.runtime import tree_sharding as jtree  # noqa: E402

from repro_torch.api.sessions import ServeSession, TrainSession  # noqa: E402
from repro_torch.api.spec import SpecError  # noqa: E402
from repro_torch.configs import get_arch as tget_arch  # noqa: E402
from repro_torch.core.spring_ops import MODES  # noqa: E402
from repro_torch.dist import launch  # noqa: E402
from repro_torch.launch.serve import serving_config  # noqa: E402
from repro_torch.models import recurrent as rec_mod  # noqa: E402
from repro_torch.models import ssm as ssm_mod  # noqa: E402
from repro_torch.models.layers import SpringContext  # noqa: E402
from repro_torch.models.lm import lm_init, lm_init_cache, tensor_parallel  # noqa: E402
from repro_torch.optim.optimizers import tree_leaves, tree_map  # noqa: E402
from repro_torch.runtime import sharding as tsharding  # noqa: E402
from repro_torch.runtime import tree_sharding as ttree  # noqa: E402
from repro_torch.serving.paging import PagedServingEngine  # noqa: E402

pytestmark = pytest.mark.mesh

SPAWN_TIMEOUT_S = 240
REF_TIMEOUT_S = 300
EXTENTS = (4, 2)
#: a row split's partial sums, summed over model in rank order: within two
#: steps of the Q4.16 grid of the unsharded product (test_torch_tensor_parallel)
ROW_TOL = 2 * 2.0**-16
#: the whole leaves' gradients, summed over model: the unsharded ones within
#: this share of their largest
GRAD_REL = 1e-5
#: the split kernels' gradients: the loss's cotangent 2 y carries y's
#: last-step differences (ROW_TOL) into them
KERNEL_REL = 1e-4
DECODE_STEPS = 8


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


def _cfg(arch, reduced=True):
    return tget_arch(arch).resolve(reduced=reduced)


def _run_id(run):
    return f"{run[0]}@{run[1]}"


# -- the runs ------------------------------------------------------------------------------------

def _reference_proc(stderr) -> subprocess.Popen:
    here = os.path.dirname(__file__)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.join(here, "..", "src"), here,
                                           os.environ.get("PYTHONPATH", "")]))
    return subprocess.Popen([sys.executable, os.path.join(here, "_torch_ssm_tp_reference.py")],
                            env=env, stdout=subprocess.PIPE, stderr=stderr, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory) -> dict:
    """The reference's subprocess; the port unsharded (its snapshots and
    3-step checkpoints written, and a 1-step checkpoint to resume at model
    n); the two spawns; unsharded sessions resuming each spawn's
    checkpoint and restoring its snapshot."""
    base = tmp_path_factory.mktemp("ssm")
    err = open(base / "reference.err", "w+")
    proc = _reference_proc(err)
    try:
        np_params = {a: jax.tree_util.tree_map(
            np.asarray, jlm.lm_init(jax.random.PRNGKey(0), jget_arch(a).reduced()))
            for a in P.ARCHS}
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            out: dict = {1: P.runs(np_params, 1, {"snap": str(base / "snap1"),
                                                  "ckpt": str(base / "ckpt1")})}
            base_sets = [s for s in P.TRAIN_SETS if not s.startswith("train.")]
            for arch in P.ARCHS:
                TrainSession(P.spec("train", arch, base_sets + [
                    "train.steps=1", f"train.ckpt_dir={base}/first/{arch}"]), device="cpu").run()
                out[f"seeded_{arch}"] = TrainSession(P.spec(
                    "train", arch, base_sets + ["train.steps=2", "train.ckpt_dir="]),
                    device="cpu").run()["losses"]
        finally:
            torch.set_num_threads(n)
        for world in EXTENTS:
            resume = base / f"resume{world}"
            shutil.copytree(base / "first", resume)  # the resumed runs write their last step
            out[world] = launch.run(P.ssm_ranks, world, (np_params, {
                "snap": str(base / f"snap{world}"), "ckpt": str(base / f"ckpt{world}"),
                "restore": str(base / "snap1"), "resume": str(resume)}),
                timeout_s=SPAWN_TIMEOUT_S, store_dir=str(base))
            for arch in P.archs_at(world):
                out[f"resumed_unsharded_{arch}@{world}"] = TrainSession(P.spec(
                    "train", arch, [s for s in P.TRAIN_SETS if not s.startswith("train.")]
                    + ["train.steps=3", f"train.ckpt_dir={base}/ckpt{world}/{arch}"]),
                    device="cpu").run()["losses"]
                out[f"restored_unsharded_{arch}@{world}"] = P._tokens(ServeSession(P.spec(
                    "serve", arch, P.ENGINE_SETS
                    + [f"serving.restore_path={base}/snap{world}-{arch}.npz"]),
                    device="cpu").run())
        out["dirs"] = {world: str(base / f"ckpt{world}") for world in EXTENTS}
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


def _kinds(tree) -> dict:
    """{leaf path: split kind or None} of one layer's split tree."""
    return {"/".join(p): None if s is None else s.kind for p, s in _flat(tree)}


#: mamba2 with a d_state of 15: in_proj 290 columns wide, which 2 divides
#: and 4 does not
FALLBACK = "mamba2-780m/d_state=15"


def _case(case: str, reduced: bool = True) -> tuple:
    """(the port's config, the reference's) of an arch or a FALLBACK-style
    variant of its SSM spec."""
    arch, _, field = case.partition("/")
    tcfg = _cfg(arch, reduced)
    jcfg = jget_arch(arch).reduced()
    if field:
        key, value = field.split("=")
        tcfg, jcfg = (dataclasses.replace(c, ssm=dataclasses.replace(c.ssm, **{key: int(value)}))
                      for c in (tcfg, jcfg))
    return tcfg, jcfg


@pytest.mark.parametrize("n", EXTENTS)
@pytest.mark.parametrize("case", P.ARCHS + (FALLBACK,))
def test_param_splits_are_the_references_table(case, n):
    """Every leaf's spec is its leaf's in the reference's stacked tree.
    mamba2's in_proj (292 columns) and out_proj split by column and by row
    at model 2 and 4; with a d_state of 15 (290 columns) in_proj stays
    whole at model 4 (the divisibility fallback) while out_proj splits; the
    RG-LRU's wx / wy / w_r / w_i split by column and wo by row; the local
    attention's wq, and the one kv head's wk / wv columns, by column and wo
    by row; the conv weights, a_log, dt_bias, d_skip, lam and the norms
    stay whole."""
    cfg, jcfg = _case(case)
    ref = _ref_specs(jcfg, n)
    got = ttree.tree_shardings(lm_init(cfg, device="meta"), _Stub(n))
    for (key, _, _), layer in zip(cfg.layer_plan, got["layers"]):
        for path, spec in _flat(layer):
            assert spec == ref[(key,) + path], (key, path)
    with tsharding.sharding_context(_Stub(n, 1)):
        splits = ttree.param_splits(cfg, _Stub(n, 1))
    whole = {"norm1/scale": None, "mixer/conv_w": None, "mixer/conv_b": None}
    if case.startswith("mamba2"):
        want = {**whole, "mixer/in_proj/kernel": None if case == FALLBACK and n == 4 else "col",
                "mixer/out_proj/kernel": "row", "mixer/a_log": None, "mixer/dt_bias": None,
                "mixer/d_skip": None, "mixer/norm/scale": None}
        assert _kinds(splits["layers"][0]) == want
        out = splits["layers"][0]["mixer"]["out_proj"]["kernel"]
        assert (out.dim, out.lo, out.hi) == (0, 128 // n, 256 // n)
        return
    rec = {**whole, "norm2/scale": None, "mixer/lam": None, "ffn/gate/kernel": "col",
           "ffn/up/kernel": "col", "ffn/down/kernel": "row",
           **{f"mixer/{k}/kernel": "col" for k in ("wx", "wy", "w_r", "w_i")},
           "mixer/wo/kernel": "row"}
    assert _kinds(splits["layers"][0]) == rec
    local = {k: v for k, v in rec.items() if not k.startswith("mixer/")}
    local.update({"mixer/wq/kernel": "col", "mixer/wk/kernel": "col", "mixer/wv/kernel": "col",
                  "mixer/wo/kernel": "row"})
    assert _kinds(splits["layers"][2]) == local
    wk = splits["layers"][2]["mixer"]["wk"]["kernel"]
    assert (wk.lo, wk.hi) == (16 // n, 32 // n)  # a part of the one kv head's 16 columns


@pytest.mark.parametrize("arch,whole,mine", [("mamba2-780m", 780_148_992, 195_808_512),
                                             ("recurrentgemma-9b", 10_444_771_328,
                                              2_611_908_608)])
def test_a_full_width_rank_holds_a_quarter_of_the_parameters(arch, whole, mine):
    """At full width tensor_parallel holds at model 4, and a rank holds
    about a quarter of the parameters: mamba2 195.8 M of 780.1 M (in_proj's
    6,448 columns split 1,612 a rank), recurrentgemma 2.61 B of 10.44 B; the
    leaves whole on every rank (conv weights, a_log / dt_bias / d_skip, lam,
    the norms) hold 1.03 M and 0.95 M."""
    cfg = _cfg(arch, reduced=False)
    assert tensor_parallel(cfg, _Stub(4))
    meta = lm_init(cfg, device="meta")
    with tsharding.sharding_context(_Stub(4, 3)):
        splits = ttree.leaf_splits(ttree.param_splits(cfg, _Stub(4, 3)), meta)
    leaves = tree_leaves(meta)
    assert sum(p.numel() for p in leaves) == whole
    assert sum(p.numel() // (1 if s is None else 4) for p, s in zip(leaves, splits)) == mine
    kept = sum(p.numel() for p, s in zip(leaves, splits) if s is None)
    assert kept == {"mamba2-780m": 1_028_352, "recurrentgemma-9b": 954_368}[arch]
    if arch.startswith("mamba2"):
        with tsharding.sharding_context(_Stub(4, 3)):
            s = ttree.param_splits(cfg, _Stub(4, 3))["layers"][0]["mixer"]["in_proj"]["kernel"]
        assert (s.kind, s.lo, s.hi) == ("col", 3 * 1612, 4 * 1612)


@pytest.mark.parametrize("n", EXTENTS)
@pytest.mark.parametrize("arch", P.ARCHS)
def test_leaf_by_leaf_shards_are_the_whole_inits_slices(arch, n):
    """lm_init(mesh=) draws each leaf whole and keeps the rank's slice: on
    every rank the shards equal shard_tree's slices of lm_init's whole
    tree bit for bit (the conv weights, drawn outside the hook, whole), and
    no shard keeps the whole leaf's storage."""
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


@pytest.mark.parametrize("arch,field,value", [
    ("mamba2-780m", "ssm", dict(n_heads=6, d_inner=6 * 32)),
    ("mamba2-780m", "ssm", dict(n_groups=2)),
    ("recurrentgemma-9b", "rglru", dict(d_rnn=66)),
    ("recurrentgemma-9b", "local_attn", dict(n_heads=6)),
])
def test_tensor_parallel_refuses_heads_or_channels_that_do_not_divide(arch, field, value):
    """tensor_parallel holds at model 4 only where the split falls on whole
    units: 6 SSM heads, or 2 state groups (B and C are read whole by every
    rank's heads, so one group), a d_rnn of 66 or 6 local query heads keep
    the arch replicated; the reduced archs split at 2 and 4, not at 3."""
    cfg = _cfg(arch)
    assert [tensor_parallel(cfg, _Stub(n)) for n in (2, 3, 4)] == [True, False, True]
    bad = dataclasses.replace(cfg, **{field: dataclasses.replace(getattr(cfg, field), **value)})
    assert not tensor_parallel(bad, _Stub(4))
    assert not tensor_parallel(cfg, _Stub(2, data=2))


def test_the_pool_splits_by_head_and_channel():
    """At full width and model 4: mamba2's pool splits each unit's ssm
    state by head (dim -3) and keeps its conv state whole, with no kv
    heads; recurrentgemma's rings hold the one kv head on every rank (rank
    0 its first holder) and its RG-LRU conv / h split by channel."""
    mamba, rec = _cfg("mamba2-780m", False), _cfg("recurrentgemma-9b", False)
    with tsharding.sharding_context(_Stub(4, 2)):
        ms, rs = ttree.pool_split(mamba, _Stub(4, 2)), ttree.pool_split(rec, _Stub(4, 2))
        cache = tree_map(lambda t: tuple(t.shape), lm_init_cache(rec, 2, 8, device="meta"))
    assert ms.heads is None and ms.states == {("unit_0", "ssm"): -3}
    assert rs.heads.heads == ((0,),) * 4 and rs.heads.weight == 0.0
    assert rs.states == {(k, n): -1 for k in ("unit_0", "unit_1", "suffix_0", "suffix_1")
                         for n in ("conv", "h")}
    assert cache["unit_0"]["h"] == (12, 2, 1024)
    assert cache["unit_2"]["k_ring"] == (12, 2, 2048, 1, 256)


# -- the blocks over shards, on thread ranks ----------------------------------------------------

def _grad(t):
    return t.clone().requires_grad_(True)


def _block_run(apply, params, x) -> dict:
    """The prefill's output, x's gradient, the parameters' gradients and
    the cache; then DECODE_STEPS decode steps from that cache: outputs and
    caches."""
    p = tree_map(_grad, params)
    xx = _grad(x)
    y, cache = apply(p, xx, None)
    y.float().square().sum().backward()
    outs, states = [], []
    with torch.no_grad():
        c = cache
        for t in range(DECODE_STEPS):
            o, c = apply(p, x[:, t:t + 1] * 0.5, c)
            outs.append(o)
            states.append(c)
    return {"y": y.detach(), "dx": xx.grad, "grads": tree_map(lambda t: t.grad, p),
            "cache": cache, "decode": torch.cat(outs, 1), "states": states}


def _check_block(got: list, want: dict, part, whole_leaves: tuple, split_leaves: dict):
    """Every rank: y, dx and the decode outputs the same bits as rank 0's
    and within ROW_TOL of the unsharded (out_proj's / wo's row sum); each
    cache and decode state the unsharded one's part bit for bit (``part(r,
    name, t)``); the whole leaves' gradients the same bits on every rank
    and within GRAD_REL of the unsharded; each split kernel's gradient the
    unsharded gradient's slice within KERNEL_REL (``split_leaves``: name ->
    dim)."""
    n = len(got)
    for r, g in enumerate(got):
        for key in ("y", "dx", "decode"):
            assert torch.equal(g[key], got[0][key]), key
        for key in ("y", "decode"):
            torch.testing.assert_close(g[key], want[key], rtol=0, atol=ROW_TOL)
        assert (g["dx"] - want["dx"]).abs().max() <= GRAD_REL * want["dx"].abs().max()
        for mine, whole in zip([g["cache"]] + g["states"], [want["cache"]] + want["states"]):
            for name, t in mine.items():
                assert torch.equal(t, part(r, name, whole[name])), name
        for name in whole_leaves:
            a, b = g["grads"][name], want["grads"][name]
            assert torch.equal(a, got[0]["grads"][name]), name
            assert (a - b).abs().max() <= GRAD_REL * b.abs().max(), name
        for name, dim in split_leaves.items():
            a, b = g["grads"][name]["kernel"], want["grads"][name]["kernel"]
            size = b.shape[dim] // n
            b = b.narrow(dim, r * size, size) if a.shape != b.shape else b
            assert (a - b).abs().max() <= KERNEL_REL * b.abs().max(), name


@pytest.mark.parametrize("n,case", [(4, "mamba2-780m"), (2, "mamba2-780m"), (4, FALLBACK),
                                    (2, FALLBACK)])
def test_ssm_apply_over_head_shards(n, case):
    """mamba2's block split by head, Q4.16 (in_proj's columns gathered
    whole, or in_proj whole on every rank under the fallback): the
    prefill's final ssm state and the 8 decode steps' states are the
    unsharded heads' bit for bit, the conv state whole on every rank;
    outputs within two Q4.16 steps of the unsharded (out_proj's rows summed
    over model); the whole leaves' gradients summed over model."""
    spec = _case(case)[0].ssm
    gen = torch.Generator().manual_seed(1)
    params = ssm_mod.ssm_init(gen, 64, spec)
    x = torch.randn(2, 12, 64, generator=gen)
    ctx = SpringContext(cfg=MODES["quant"])

    def apply(p, xx, cache):
        return ssm_mod.ssm_apply(p, xx, ctx, spec, cache)

    want = _block_run(apply, params, x)
    got = T.on_threads(n, lambda mesh: _block_run(apply, ttree.shard_tree(params, mesh), x))

    def part(r, name, t):
        size = t.shape[1] // n
        return t.narrow(1, r * size, size) if name == "ssm" else t

    _check_block(got, want, part, ("conv_w", "conv_b", "a_log", "dt_bias", "d_skip"),
                 {"in_proj": 1, "out_proj": 0})
    for g in got:
        assert torch.equal(g["grads"]["norm"]["scale"], got[0]["grads"]["norm"]["scale"])
        assert g["cache"]["ssm"].shape == (2, 4 // n, spec.d_state, 32)


@pytest.mark.parametrize("n", EXTENTS)
def test_rglru_block_apply_over_channel_shards(n):
    """recurrentgemma's RG-LRU block split by channel, Q4.16: the conv and
    h states of the prefill and of 8 decode steps are the unsharded
    channels' bit for bit; outputs within two Q4.16 steps (wo's rows summed
    over model); conv_w / conv_b / lam's gradients summed over model."""
    spec = _cfg("recurrentgemma-9b").rglru
    gen = torch.Generator().manual_seed(1)
    params = rec_mod.rglru_block_init(gen, 64, spec)
    x = torch.randn(2, 12, 64, generator=gen)
    ctx = SpringContext(cfg=MODES["quant"])

    def apply(p, xx, cache):
        return rec_mod.rglru_block_apply(p, xx, ctx, spec, cache, return_cache=cache is None)

    want = _block_run(apply, params, x)
    got = T.on_threads(n, lambda mesh: _block_run(apply, ttree.shard_tree(params, mesh), x))

    def part(r, name, t):
        size = t.shape[-1] // n
        return t.narrow(-1, r * size, size)

    _check_block(got, want, part, ("conv_w", "conv_b", "lam"),
                 {"wx": 1, "wy": 1, "w_r": 1, "w_i": 1, "wo": 0})
    for g in got:
        assert g["cache"]["h"].shape == (2, 64 // n)


@pytest.mark.parametrize("arch", P.ARCHS)
def test_the_paged_pool_is_still_refused(arch):
    """serving.pages=true stays refused for both archs at model 4, as
    unsharded (no pageable cache leaf): by the spec, and by the paged
    engine on thread ranks."""
    with pytest.raises(SpecError, match="no pageable cache leaf"):
        P.spec("serve", arch, P.ENGINE_SETS + ["serving.pages=true"], 4).resolve()
    cfg = _cfg(arch)

    def rank(mesh):
        with pytest.raises((ValueError, NotImplementedError)):
            PagedServingEngine(cfg, serving_config("quant"), device="cpu", mesh=mesh,
                               n_slots=2, max_len=24)
        return True

    assert T.on_threads(4, rank) == [True] * 4


# -- the ranks: against the reference's partitioned runs and the unsharded port ----------------

@pytest.mark.parametrize("run", P.RUNS, ids=_run_id)
def test_losses_match_the_references_partitioned_run(runs, run):
    """Every rank's losses are the same bits, within rel 1e-5 of the
    reference's run at that extent (quant_sparse, nearest) and of the
    port's unsharded run."""
    arch, n = run
    got = runs[n][0][arch]["losses"]
    for r in runs[n]:
        assert r[arch]["losses"] == got
    np.testing.assert_allclose(got, runs["reference"][_run_id(run)]["losses"], rtol=1e-5)
    np.testing.assert_allclose(got, runs[1][arch]["losses"], rtol=1e-5)


@pytest.mark.parametrize("run", P.RUNS, ids=_run_id)
def test_static_tokens_are_the_references(runs, run):
    """The static path's greedy tokens on every rank are the reference's
    partitioned run's and the port's unsharded run's."""
    arch, n = run
    for r in runs[n]:
        assert r[arch]["static"] == runs["reference"][_run_id(run)]["static"] \
            == runs[1][arch]["static"]


@pytest.mark.parametrize("run", P.RUNS, ids=_run_id)
def test_engine_tokens_are_the_references(runs, run):
    """The monolithic engine session (a queue of 3 over 2 slots): every
    rank's tokens are the reference's partitioned engine's and the port's
    unsharded engine's."""
    arch, n = run
    for r in runs[n]:
        assert r[arch]["engine"] == runs["reference"][_run_id(run)]["engine"] \
            == runs[1][arch]["engine"]


@pytest.mark.parametrize("run", P.RUNS, ids=_run_id)
def test_replicated_leaves_stay_the_same_bits_on_every_rank(runs, run):
    """After two steps the norm scales, the conv weights and biases, the
    SSM's a_log / dt_bias / d_skip and the RG-LRU's lam (whole on every
    rank) are the same bits on every rank and within 1e-4 of the unsharded
    run's."""
    arch, n = run
    ranks = runs[n]
    for r in ranks[1:]:
        assert torch.equal(r[arch]["replicated"], ranks[0][arch]["replicated"])
    torch.testing.assert_close(ranks[0][arch]["replicated"], runs[1][arch]["replicated"],
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("run", P.RUNS, ids=_run_id)
def test_each_rank_holds_its_shards_and_its_state(runs, run):
    """Each rank's parameter bytes are its shards'; it joined as many model
    collectives as every other rank; its engine pool holds its SSM heads
    (mamba2's conv state whole) or its RG-LRU channels and the one kv head
    of the rings, the same bytes on every rank; its reported state bytes
    are its state leaves'."""
    arch, n = run
    meta = lm_init(_cfg(arch), device="meta")
    specs = [s for _, s in _flat_specs(ttree.tree_shardings(meta, _Stub(n)))]
    want = sum(p.numel() * 4 // (n if "model" in spec else 1)
               for p, spec in zip(tree_leaves(meta), specs))
    whole = runs[1][arch]["pool"]
    ranks = runs[n]
    for i, r in enumerate(ranks):
        rep = r[arch]["report"]
        assert rep["model"] == n and rep["rank"] == i and rep["param_bytes"] == want
        assert rep["model_hops"] == ranks[0][arch]["report"]["model_hops"] > 0
        pool = r[arch]["pool"]
        assert pool.keys() == whole.keys()
        for key, shape in pool.items():
            name, w = key.split("/")[-1], list(whole[key])
            if name == "ssm":
                w[-3] //= n
            elif name in ("h", "conv") and arch.startswith("recurrentgemma"):
                w[-1] //= n
            assert shape == tuple(w), key
        assert r[arch]["pool_bytes"] == ranks[0][arch]["pool_bytes"]
        eng = r[arch]["engine_report"]
        assert eng["kv_heads"] == (None if arch.startswith("mamba2") else [0])
        state = sum(np.prod(s) * 2 for k, s in pool.items()
                    if k.split("/")[-1] in ("conv", "ssm", "h"))
        assert eng["state_bytes"] == state


def _flat_specs(specs, path=()):
    if isinstance(specs, dict):
        return [kv for k, v in specs.items() for kv in _flat_specs(v, path + (k,))]
    if isinstance(specs, list):
        return [kv for i, v in enumerate(specs) for kv in _flat_specs(v, path + (i,))]
    return [(path, specs)]


@pytest.mark.parametrize("run", P.RUNS, ids=_run_id)
def test_a_partitioned_snapshot_restores_unsharded(runs, run):
    """The engine session writing a snapshot every 2 ticks gives its
    uninterrupted tokens on every rank; its last snapshot (the whole pool:
    every rank's heads and channels gathered) restored in an unsharded
    session gives the unsharded engine's tokens."""
    arch, n = run
    for r in runs[n]:
        assert r[arch]["snapshot"] == r[arch]["engine"]
    assert runs[f"restored_unsharded_{arch}@{n}"] == runs[1][arch]["engine"]


@pytest.mark.parametrize("run", P.RUNS, ids=_run_id)
def test_an_unsharded_snapshot_restores_partitioned(runs, run):
    """The unsharded session's last snapshot, restored at model n (each
    rank slicing its heads and channels), gives the unsharded tokens on
    every rank."""
    arch, n = run
    for r in runs[n]:
        assert r[arch]["restored"] == runs[1][arch]["engine"]


@pytest.mark.parametrize("run", P.RUNS, ids=_run_id)
def test_a_partitioned_checkpoint_is_whole_and_resumes_unsharded(runs, run):
    """The model-n run writes whole leaves under the reference's names; an
    unsharded session resumes it and takes the third step within rel 1e-5
    of the uninterrupted unsharded run."""
    from repro_torch.checkpoint.manager import load_checkpoint

    arch, n = run
    three = runs[1][arch]["ckpt_losses"]
    step, flat = load_checkpoint(f"{runs['dirs'][n]}/{arch}", step=2)
    assert step == 2
    if arch.startswith("mamba2"):
        assert flat["0/unit_0/mixer/in_proj/kernel"].shape == (4, 64, 292)
        assert flat["1/.m/unit_0/mixer/out_proj/kernel"].shape == (4, 128, 64)
    else:
        assert flat["0/unit_0/mixer/w_r/kernel"].shape == (1, 64, 64)
        assert flat["0/suffix_0/mixer/wo/kernel"].shape == (64, 64)
    np.testing.assert_allclose(runs[n][0][arch]["ckpt_losses"], three[:2], rtol=1e-5)
    np.testing.assert_allclose(runs[f"resumed_unsharded_{arch}@{n}"], three[2:], rtol=1e-5)


@pytest.mark.parametrize("run", P.RUNS, ids=_run_id)
def test_an_unsharded_checkpoint_resumes_partitioned(runs, run):
    """The port's unsharded step-1 checkpoint of the seeded run, resumed
    at model n by slicing: the second step's loss is the uninterrupted
    unsharded seeded run's within rel 1e-5, on every rank."""
    arch, n = run
    for r in runs[n]:
        np.testing.assert_allclose(r[arch]["resumed_losses"], runs[f"seeded_{arch}"][1:2],
                                   rtol=1e-5)
