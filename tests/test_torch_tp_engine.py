"""The serving engines under tensor parallelism over ``model``: the dense
family served monolithic and paged with its weights split over ``model``
and its KV pool split by kv head, held against the reference's
partitioned engine runs, the port's unsharded engine and itself across
``model`` extents; and magnitude pruning wherever weights split over
``model``.

The reference's partitioned runs come from one subprocess
(``_torch_tp_engine_reference.py``: 4 forced host devices, an Auto-typed
``(1, 1, m)`` mesh handed to its engines), started first so that it runs
beside the port's spawns.  The port runs in two gloo spawns
(``_torch_tp_engine_ranks.engine_ranks``): reduced llama3.2-1b at model 4
and 2; the same runs unsharded run in this process on one thread, as the
ranks run, and so do reduced minitron-4b's at model 3, its ranks as
threads (``_torch_tp_ranks.on_threads``).  The reference's engine also
writes a snapshot here, which the model-4 ranks restore, and restores the
one they write.  The threshold cases run their ranks as threads too.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import _torch_tp_engine_ranks as E  # noqa: E402
import _torch_tp_ranks as T  # noqa: E402
from _torch_train_parity import assert_grads_close  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.launch.serve import serving_config as jserving_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim.optimizers import OptimizerConfig  # noqa: E402
from repro.runtime.train import StepConfig  # noqa: E402
from repro.serving import elastic as jelastic  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402

from repro_torch.configs import get_arch as tget_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.dist import launch  # noqa: E402
from repro_torch.models.layers import SpringContext  # noqa: E402
from repro_torch.runtime.sharding import weight_split  # noqa: E402
from repro_torch.serving import elastic as telastic  # noqa: E402
from repro_torch.serving.kvpool import as_tensor  # noqa: E402

pytestmark = pytest.mark.mesh

SPAWN_TIMEOUT_S = 240
REF_TIMEOUT_S = 300
EXTENTS = (2, 4)
#: the reference engine's snapshot schedule: E._snapshot_run's
REF_SNAPSHOT = "ref_mono.npz"


def _jview():
    return jget_arch("llama3.2-1b").view(reduced=True)


def _reference_proc(stderr) -> subprocess.Popen:
    """The reference's subprocess, its stderr (XLA's many warnings, which
    would fill a pipe and stall it) to the file ``stderr``."""
    here = os.path.dirname(__file__)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.join(here, "..", "src"), here,
                                           os.environ.get("PYTHONPATH", "")]))
    return subprocess.Popen([sys.executable, os.path.join(here, "_torch_tp_engine_reference.py")],
                            env=env, stdout=subprocess.PIPE, stderr=stderr, text=True)


def _reference_snapshot(jparams, path: str) -> list:
    """The reference engine through E._snapshot_run's schedule (the file
    at ``path``); its tokens."""
    view = _jview()
    step_cfg = StepConfig(spring=jserving_config(E.MODE), optimizer=OptimizerConfig())
    eng = JEngine(view, step_cfg, params=jparams, spec_hash=E.SPEC_HASH, **E.MONO)
    for i, p in enumerate(E.shared_prompts(view.config.vocab)):
        eng.submit_prompt(p, E.GEN, seed=100 + i)
    for _ in range(2):
        eng.step()
    eng.rescale(1)
    eng.step()
    jelastic.save_snapshot(eng.snapshot(), path)
    return [r["tokens"] for r in eng.run()["per_request"]]


def _reference_restore(jparams, path: str) -> list:
    view = _jview()
    step_cfg = StepConfig(spring=jserving_config(E.MODE), optimizer=OptimizerConfig())
    eng = JEngine(view, step_cfg, params=jparams, spec_hash=E.SPEC_HASH, **E.MONO)
    eng.restore_file(path)
    return [r["tokens"] for r in eng.run()["per_request"]]


@pytest.fixture(scope="module")
def runs(tmp_path_factory) -> dict:
    """Everything the file compares, from one pass: the reference's
    subprocess, its snapshot, the port unsharded, the three spawns, and the
    reference restoring the model-4 ranks' snapshot."""
    base = tmp_path_factory.mktemp("tp_engine")
    err = open(base / "reference.err", "w+")
    proc = _reference_proc(err)
    try:
        jparams = jlm.lm_init(jax.random.PRNGKey(0), _jview().config)
        np_params = jax.tree_util.tree_map(np.asarray, jparams)
        out: dict = {"ref_snapshot_tokens": _reference_snapshot(jparams,
                                                                str(base / REF_SNAPSHOT))}
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            files = {f"write_{p}": str(base / f"m1_{p}.npz") for p in (0, 1)}
            os.makedirs(base / "m1", exist_ok=True)
            out[1] = E.engine_runs(np_params, None, 1, files, str(base / "m1"))
            out["uneven_1"] = E.uneven_runs(None)
            out["uneven"] = T.on_threads(E.UNEVEN_WORLD, E.uneven_runs)
        finally:
            torch.set_num_threads(n)
        for world in (4, 2):
            files = {f"write_{p}": str(base / f"m{world}_{p}.npz") for p in (0, 1)}
            if world == 4:
                files.update(ref=str(base / REF_SNAPSHOT), unsharded=str(base / "m1_0.npz"),
                             unsharded_paged=str(base / "m1_1.npz"))
            out[world] = launch.run(E.engine_ranks, world, (np_params, files, str(base)),
                                    timeout_s=SPAWN_TIMEOUT_S, store_dir=str(base))
        out["ref_restores_m4"] = _reference_restore(jparams, str(base / "m4_0.npz"))
        out["files"] = {m: [str(base / f"m{m}_{p}.npz") for p in (0, 1)] for m in (1, 4)}
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


# -- tokens: the reference's partitioned engines and the unsharded port -------------------------

@pytest.mark.parametrize("paged", (False, True))
@pytest.mark.parametrize("n", EXTENTS)
def test_engine_session_tokens_are_the_references_partitioned_run(runs, paged, n):
    """ServeSession on the engine path at model n, monolithic and paged:
    every rank's greedy tokens are the reference engine's at model n (and
    at model 1) and the port's unsharded engine's."""
    ref = runs["reference"]["session"]
    assert ref[str(n)][str(paged)] == ref["1"][str(paged)]
    for r in runs[n]:
        assert r["session"][paged]["tokens"] == ref[str(n)][str(paged)]
        assert r["session"][paged]["tokens"] == runs[1]["session"][paged]["tokens"]


@pytest.mark.parametrize("n", EXTENTS)
def test_shared_prefix_paged_tokens_and_paging_are_the_references(runs, n):
    """The shared prompts on the paged pool (prefix sharing, copy on write,
    a spill) at model n: every rank's tokens are the reference's
    partitioned run's, and its paging summary (spills, resumes, prefix
    hits, COW copies, pages) is the reference's and the unsharded port's."""
    want = runs["reference"]["shared"][str(n)]
    assert want["tokens"] == runs["reference"]["shared"]["1"]["tokens"]
    keys = ("spills", "resumes", "prefix_hits", "cow_copies", "num_pages", "logical_frames",
            "allocated_frames", "peak_active")
    for r in runs[n]:
        assert r["paged"]["tokens"] == want["tokens"] == runs[1]["paged"]["tokens"]
        assert {k: r["paged"]["paging"][k] for k in keys} == {k: want["paging"][k] for k in keys}
        assert r["paged"]["paging"] == runs[1]["paged"]["paging"]
    assert want["paging"]["spills"] >= 1 and want["paging"]["prefix_hits"] >= 3


@pytest.mark.parametrize("paged", (False, True))
@pytest.mark.parametrize("n", EXTENTS)
def test_every_rank_takes_the_same_admit_spill_and_resume_decisions(runs, paged, n):
    """Each rank's (kind, tick, request) log of admissions, spills and
    resumes, whole, is every other rank's and the unsharded engine's (the
    paged pool's admission reads the whole pool's live nonzeros)."""
    key = "paged" if paged else "mono"
    logs = [r[key]["decisions"] for r in runs[n]]
    for log in logs:
        assert log == runs[1][key]["decisions"]
    kinds = {kind for kind, _, _ in logs[0]}
    assert kinds == ({"admit", "spill", "resume"} if paged else {"admit"})


@pytest.mark.parametrize("paged", (False, True))
@pytest.mark.parametrize("n", EXTENTS)
def test_wire_statistics_are_the_unsharded_engines(runs, paged, n):
    """kv_mean_wire_bytes, kv_mean_density, peak_kv_wire_bytes, the live
    nonzeros and elements: every rank reports the unsharded engine's
    figures, the whole pool's (at model 4 two ranks hold each of the
    reduced model's 2 kv heads, counted once)."""
    key = "paged" if paged else "mono"
    for r in runs[n]:
        assert r[key]["wire"] == runs[1][key]["wire"]


@pytest.mark.parametrize("n", EXTENTS)
def test_each_rank_holds_its_kv_heads_and_its_shards(runs, n):
    """The session's report: each rank holds the kv heads its query heads
    read (reduced llama3.2-1b: 2 kv heads, so 1 a rank), a pool of that
    share of the unsharded pool's bytes, its weight shards' bytes, and it
    joined as many model collectives as every other rank."""
    heads = [tuple(r["session"][False]["report"]["kv_heads"]) for r in runs[n]]
    assert heads == ([(0,), (1,)] if n == 2 else [(0,), (0,), (1,), (1,)])
    whole_pool = runs[1]["mono"]["pool_bytes"]
    for r in runs[n]:
        for paged in (False, True):
            rep = r["session"][paged]["report"]
            assert rep["model"] == n and rep["staged_hops"] == 0
            assert rep["model_hops"] == runs[n][0]["session"][paged]["report"]["model_hops"] > 0
        mono_pool = r["mono"]["pool_bytes"]
        # values and masks split by head; the per-block nnz counts do not
        assert mono_pool < whole_pool and abs(mono_pool * 2 - whole_pool) <= whole_pool // 8
        assert r["hops"]["model"] > 0
    assert len({r["session"][False]["report"]["param_bytes"] for r in runs[n]}) == 1


# -- elasticity: chaos, snapshots across extents and packages -----------------------------------

@pytest.mark.parametrize("paged", (False, True))
def test_chaos_at_model_2_gives_the_uninterrupted_tokens(runs, paged):
    """A snapshot, a rescale to one slot (spills), an .npz round trip, a
    rewind, a rescale to three and a kill into fresh engines, at model 2:
    every rank finishes with the uninterrupted unsharded run's tokens."""
    key = "paged" if paged else "mono"
    want = runs[1]["chaos"][paged]
    assert want["tokens"] == runs[1][key]["tokens"] and want["spills"] >= 1
    for r in runs[2]:
        assert r["chaos"][paged] == want


@pytest.mark.parametrize("paged", (False, True))
@pytest.mark.parametrize("n", (1, 2, 4))
def test_the_snapshot_run_finishes_with_the_uninterrupted_tokens(runs, paged, n):
    """Two ticks, a rescale to one slot, a tick and a snapshot at model n:
    the run goes on to the uninterrupted tokens on every rank."""
    key = "paged" if paged else "mono"
    ranks = [runs[1]] if n == 1 else runs[n]
    for r in ranks:
        assert r["snapshot"][paged] == runs[1][key]["tokens"]


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("paged", (False, True))
def test_a_model_4_snapshot_holds_the_whole_pools_layout(runs, paged):
    """The model-4 ranks' snapshot file against the unsharded engine's at
    the same tick: the same tree and shapes, the pool's mask words, nnz,
    positions, the scheduler and the spilled payloads' masks exactly; the
    bf16 K/V values where the ranks' row-split sums (another order than the
    whole product's) cross a rounding boundary, at most 1% of them, each
    within one bf16 ulp of its leaf's largest magnitude (a value near zero
    moves by more than its own ulps)."""
    got, want = (telastic.load_snapshot(runs["files"][m][int(paged)]) for m in (4, 1))
    assert got["signature"] == want["signature"]
    assert got["scheduler"]["active"] == want["scheduler"]["active"]
    assert len(got["scheduler"]["spilled"]) == len(want["scheduler"]["spilled"]) >= 1
    g_leaves = _leaves([got["backend"], got["scheduler"]["spilled"]])
    w_leaves = _leaves([want["backend"], want["scheduler"]["spilled"]])
    assert len(g_leaves) == len(w_leaves)
    differ = total = 0
    for g, w in zip(g_leaves, w_leaves):
        if not isinstance(w, torch.Tensor):
            assert g == w
            continue
        g, w = as_tensor(g), as_tensor(w)
        assert g.shape == w.shape and g.dtype == w.dtype
        if w.dtype != torch.bfloat16:
            assert torch.equal(g.view(torch.int32) if g.dtype == torch.uint32 else g,
                               w.view(torch.int32) if w.dtype == torch.uint32 else w)
            continue
        g, w = g.float(), w.float()
        differ += int((g != w).sum())
        total += g.numel()
        top = float(w.abs().max())
        if top:  # one bf16 ulp at the leaf's largest magnitude
            assert float((g - w).abs().max()) <= 2.0 ** (np.floor(np.log2(top)) - 7)
    assert differ <= 0.01 * total


@pytest.mark.parametrize("paged", (False, True))
def test_a_model_4_snapshot_restores_unsharded(runs, paged):
    """The model-4 ranks' snapshot restored into the port's unsharded
    engine finishes with the uninterrupted tokens."""
    cfg = tget_arch("llama3.2-1b").resolve(reduced=True)
    params = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jlm.lm_init(jax.random.PRNGKey(0), _jview().config)), cfg)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        eng = E.make_engine(cfg, params, None, paged)
        eng.restore_file(runs["files"][4][int(paged)])
        got = [r["tokens"] for r in eng.run()["per_request"]]
    finally:
        torch.set_num_threads(n)
    assert got == runs[1]["paged" if paged else "mono"]["tokens"]


def test_snapshots_cross_between_model_4_and_the_reference_engine(runs):
    """The reference engine restores the model-4 ranks' monolithic .npz and
    finishes with its own uninterrupted tokens; the ranks restore the
    reference's .npz and finish with them too."""
    want = runs["ref_snapshot_tokens"]
    assert want == runs[1]["mono"]["tokens"]
    assert runs["ref_restores_m4"] == want
    for r in runs[4]:
        assert r["restored"]["ref"] == want


@pytest.mark.parametrize("name", ("unsharded", "unsharded_paged"))
def test_an_unsharded_snapshot_restores_at_model_4(runs, name):
    """The port's model-1 snapshots, monolithic and paged, restored at model
    4: every rank finishes with the uninterrupted tokens."""
    want = runs[1]["paged" if name.endswith("paged") else "mono"]["tokens"]
    for r in runs[4]:
        assert r["restored"][name] == want


@pytest.mark.parametrize("paged", (False, True))
def test_uneven_kv_heads_serve_the_unsharded_tokens(runs, paged):
    """Reduced minitron-4b at model 3 (6 q heads, two a rank; its 2 kv
    heads do not divide, rank 1 reads both): each rank holds the kv heads
    its query heads read, and every rank's tokens are the unsharded
    engine's."""
    assert [tuple(r["heads"]) for r in runs["uneven"]] == [(0,), (0, 1), (1,)]
    for r in runs["uneven"]:
        assert r[paged] == runs["uneven_1"][paged]


# -- magnitude pruning over model ----------------------------------------------------------------

#: every dense projection of a block and its logical axes
_PROJ = {("mixer", "wq"): ("w_embed", "w_qkv"), ("mixer", "wk"): ("w_embed", "w_qkv"),
         ("mixer", "wv"): ("w_embed", "w_qkv"), ("mixer", "wo"): ("w_qkv", "w_embed"),
         ("ffn", "gate"): ("w_embed", "w_mlp"), ("ffn", "up"): ("w_embed", "w_mlp"),
         ("ffn", "down"): ("w_mlp", "w_embed")}


@pytest.mark.parametrize("n", EXTENTS)
def test_a_shards_prune_threshold_and_mask_are_the_whole_weights(n):
    """Every dense projection of the reduced llama3.2-1b, split over model n
    (threads): each rank's threshold is within rel 1e-6 of the whole
    weight's, its mask is its slice of the whole mask, and no weight lies
    between the two thresholds."""
    cfg = tget_arch("llama3.2-1b").resolve(reduced=True)
    params = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jlm.lm_init(jax.random.PRNGKey(0), _jview().config)), cfg)
    ctx = SpringContext(prune_ratio=E.PRUNE)
    weights = [(axes, layer[a][b]["kernel"]) for layer in params["layers"]
               for (a, b), axes in _PROJ.items()]

    def rank(mesh):
        out = []
        for axes, w in weights:
            split = weight_split(axes, tuple(w.shape))
            assert split is not None
            shard = split.take(w)
            out.append((split, ctx.prune_cut(shard, split), ctx.maybe_prune(shard, split) != 0))
        return out

    got = T.on_threads(n, rank)
    for i, (_, w) in enumerate(weights):
        cut = ctx.prune_cut(w)
        whole = ctx.maybe_prune(w) != 0
        assert float(whole.float().mean()) == pytest.approx(1 - E.PRUNE, abs=0.06)
        for r in range(n):
            split, c, mask = got[r][i]
            assert float(c) == pytest.approx(float(cut), rel=1e-6)
            assert torch.equal(mask, split.take(whole))
            a = split.take(w).abs()
            lo, hi = min(float(c), float(cut)), max(float(c), float(cut))
            assert int(((a >= lo) & (a < hi)).sum()) == 0


def test_a_pruned_train_step_at_model_2_is_the_unsharded_run(runs):
    """prune 0.5, quant_sparse, nearest: every rank's loss and two
    make_train_step losses within rel 1e-5 of the unsharded run's, and
    every whole gradient within the gradient contract (rtol 1e-5)."""
    want = runs[1]["train"]
    for r in runs[2]:
        got = r["train"]
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        assert len(got["grads"]) == len(want["grads"])
        for g, w in zip(got["grads"], want["grads"]):
            assert g.shape == w.shape
            assert_grads_close(g.numpy(), w.numpy())


@pytest.mark.parametrize("n", EXTENTS)
def test_pruned_engine_tokens_are_the_unsharded_ones(runs, n):
    """The monolithic engine at prune 0.5 and model n: every rank's tokens
    are the unsharded pruned engine's, which differ from the unpruned."""
    assert runs[1]["pruned"] != runs[1]["mono"]["tokens"]
    for r in runs[n]:
        assert r["pruned"] == runs[1]["pruned"]
