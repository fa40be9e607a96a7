"""The port's mesh over gloo CPU ranks (``repro_torch.dist.launch``), held
against simulation mode, the port's unsharded runs and the reference's.

Two spawns serve every test here (module fixtures): four ranks at
``shape.mesh.data=4`` (the collectives in collective mode, the sharded
TrainSession and static ServeSession, the indivisible batch, the
pipeline over ``pod``), and two ranks at ``pod=2`` (the int8 + EF pod
link).  The reference is the unsharded run: its own sharded runs are
bit-equal to it (DESIGN.md §14.3), so holding the port's sharded results
to it holds them to those too.  Each rank's rendezvous is a FileStore
under ``tmp_path`` and every spawn has a time limit, so a dead rank fails
the test instead of hanging it.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import _torch_mesh_ranks as R  # noqa: E402
from repro.api.sessions import ServeSession as JServeSession  # noqa: E402
from repro.api.sessions import TrainSession as JTrainSession  # noqa: E402
from repro.api.spec import build_spec as jbuild  # noqa: E402
from repro.models import lm as jlm  # noqa: E402

from repro_torch.api.sessions import ServeSession, TrainSession  # noqa: E402
from repro_torch.api.spec import build_spec as tbuild  # noqa: E402
from repro_torch.configs import get_arch as tget_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.dist import launch  # noqa: E402

pytestmark = pytest.mark.mesh

WORLD = 4
SPAWN_TIMEOUT_S = 240


def _np_params(seed: int = 0) -> dict:
    cfg = jbuild("train", sets=R.TRAIN_SETS, use_env=False).resolve().config
    return jax.tree_util.tree_map(np.asarray, jlm.lm_init(jax.random.PRNGKey(seed), cfg))


@pytest.fixture(scope="module")
def params() -> dict:
    return _np_params()


@pytest.fixture(scope="module")
def four(params, tmp_path_factory) -> list:
    return launch.run(R.four_ranks, WORLD, (params, params), timeout_s=SPAWN_TIMEOUT_S,
                      store_dir=str(tmp_path_factory.mktemp("four")))


@pytest.fixture(scope="module")
def pods_dir(tmp_path_factory):
    """The pods spawn's rendezvous and its engine's snapshot file."""
    return tmp_path_factory.mktemp("pods")


@pytest.fixture(scope="module")
def pods(pods_dir) -> list:
    return launch.run(R.two_pods, 2, (str(pods_dir / "snap.npz"),), timeout_s=SPAWN_TIMEOUT_S,
                      store_dir=str(pods_dir))


def _cfg():
    return tget_arch("llama3.2-1b").resolve(reduced=True)


@pytest.fixture
def one_thread():
    """The ranks' intra-op threads: a CPU product's summation order follows
    the thread count, so the unsharded run uses the ranks' one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", ["all_gather", "all_gather_bf16", "reduce_scatter",
                                  "dense_reduce_scatter"])
def test_collective_mode_equals_simulation_at_four_ranks(four, case):
    """The counterpart of ``test_axis_mode_matches_simulation``: each rank's
    collective-mode result is simulation mode's, bit for bit."""
    assert all(r["collectives"][case] for r in four)


def test_sharded_train_losses_equal_the_unsharded_runs(four, params, one_thread):
    """shape.mesh.data=4: every rank's losses are the port's unsharded
    losses bit for bit, and the reference's unsharded TrainSession's
    within the rel 1e-5 the port's training is held to."""
    port = TrainSession(tbuild("train", sets=R.TRAIN_SETS, use_env=False), device="cpu",
                        params=params_from_jax(params, _cfg())).run()
    ref = JTrainSession(jbuild("train", sets=R.TRAIN_SETS, use_env=False)).run()
    for r in four:
        assert r["train"]["mesh"] == "pod1.data4.model1"
        assert r["train"]["losses"] == port["losses"]
        probe = r["train"]["probe"]
        assert probe["world"] == WORLD and probe["exact"]
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=1e-5)


@pytest.mark.parametrize("mode", R.SERVE_MODES)
def test_sharded_static_tokens_equal_the_references(four, mode):
    """Rows over four ranks (one each), logits packed on the wire: every
    rank's greedy tokens are the reference's unsharded static tokens."""
    sets = R.SERVE_SETS + [f"numerics.mode={mode}"]
    ref = JServeSession(jbuild("serve", sets=sets, use_env=False)).run()
    want = np.asarray(ref["generated"]).tolist()
    for r in four:
        assert r["serve"][mode]["generated"] == want
        assert r["serve"][mode]["exact"]


def test_indivisible_batch_falls_back_and_counts_serve_batch(four, params, one_thread):
    """Batch 3 over data=4: replicated, no probe, serve_batch counted once
    on every rank, and the tokens are the unsharded run's."""
    sets = [s for s in R.FALLBACK_SETS if not s.startswith("shape.mesh")]
    want = ServeSession(tbuild("serve", sets=sets, use_env=False), device="cpu",
                        params=params_from_jax(params, _cfg())).run()["generated"].tolist()
    for r in four:
        fb = r["fallback"]
        assert fb["finite"] and not fb["probe"]
        assert fb["counts"].get("serve_batch") == 1
        assert fb["generated"] == want


def test_pipeline_equals_sequential_stages_at_four_ranks(four):
    """GPipe over 4 stages, 6 microbatches == the stages in sequence, within
    the reference's rtol 2e-5; every rank holds the result."""
    per_stage, xs = R.pipeline_inputs()
    want = xs
    for p in per_stage:
        want = R.stage_fn(want, p)
    for r in four:
        np.testing.assert_allclose(r["pipeline"].numpy(), want.numpy(), rtol=2e-5, atol=2e-5)


def test_pod_link_error_feedback_and_mean(pods):
    """At pod=2: each rank's new EF buffer is exactly ``local - dequant``,
    both ranks hold the same mean, the mean of the two pods' dequantized
    payloads, and it lies within one int8 step of each pod's scale of the
    true mean."""
    from repro_torch.runtime.compression import dequantize_int8

    for k in pods[0]["leaves"]:
        rows = [p["leaves"][k] for p in pods]
        for r in rows:
            assert torch.equal(r["ef"], r["local"] - dequantize_int8(r["q"], r["scale"]))
        assert torch.equal(rows[0]["out"], rows[1]["out"])
        deq = sum(dequantize_int8(r["q"], r["scale"]).double() for r in rows) / 2
        np.testing.assert_allclose(rows[0]["out"].double().numpy(), deq.numpy(),
                                   rtol=1e-6, atol=1e-7)
        true = sum(r["local"].double() for r in rows) / 2
        step = max(float(r["scale"]) for r in rows)
        assert float((rows[0]["out"].double() - true).abs().max()) <= step * (1 + 1e-6)


def test_compress_pod_grads_trains_and_keeps_ranks_in_step(pods):
    """make_train_step with compress_pod_grads at pod=2 (2 rows a pod):
    finite losses, an EF buffer per parameter, and both ranks' parameters
    the same bits after two steps (the exchanged mean is the same on both)."""
    for p in pods:
        assert np.isfinite(p["losses"]).all()
        assert p["ef_leaves"] > 0
    assert torch.equal(pods[0]["params"], pods[1]["params"])


def test_rank_zero_alone_writes_the_engines_snapshot(pods, pods_dir):
    """Both ranks of a data=2 mesh run the same engine with
    ``snapshot_every=1``; rank 0 alone writes, and its last snapshot,
    restored by an unsharded session, drains to the ranks' tokens."""
    assert pods[0]["served"]["n_snapshots"] >= 2
    assert pods[1]["served"]["n_snapshots"] == 0
    assert pods[0]["served"]["tokens"] == pods[1]["served"]["tokens"]
    path = pods_dir / "snap.npz"
    got = ServeSession(tbuild("serve", sets=R.SNAPSHOT_SETS + [f"serving.restore_path={path}"],
                              use_env=False), device="cpu").run()
    assert got["elastic"]["n_restores"] == 1
    assert [r["tokens"] for r in got["per_request"]] == pods[0]["served"]["tokens"]


def test_a_failing_rank_fails_the_run_with_its_traceback(tmp_path):
    """The launcher raises a rank's own error (no hang, no result list)."""
    with pytest.raises(launch.RankFailed, match=r"rank 1 failed(.|\n)*on purpose"):
        launch.run(R.fail_on_rank_one, 2, timeout_s=120, store_dir=str(tmp_path))
