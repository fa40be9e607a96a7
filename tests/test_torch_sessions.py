"""The port's serving session against the reference's, from one RunSpec.

* The synthetic traffic: ``repro_torch.api.threefry`` draws the
  reference's ``jax.random.randint`` prompts bit for bit (keys, ``fold_in``
  chunks, ``split``, vocab sizes that are not powers of two).
* ``ServeSession`` on the reduced llama3.2-1b, ``device="cpu"``, with the
  reference's ``lm_init`` parameters carried across by
  ``convert.params_from_jax``: the same spec (built in each package) gives
  the same greedy tokens, ``finished_by``, ``finish_tick`` and
  ``rejected`` in dense, quant and quant_sparse, on the monolithic and
  the paged pool, under load shedding and on the static path.  Greedy
  nearest-rounding decode on the CPU, so every comparison is exact.
* A launcher snapshot (``serving.snapshot_every`` / ``snapshot_path``,
  stamped with ``state_hash()``) written by either package restores in
  the other's session and ``--restore``, and drains the writer's tokens.
* Every spec field or ``kernels.policy`` / device pairing the port cannot
  honour raises ``SpecError`` naming it.
"""

import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.api import sessions as jsessions  # noqa: E402
from repro.api.spec import build_spec as jbuild  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.launch import serve as jlaunch  # noqa: E402
from repro.models import lm as jlm  # noqa: E402

from repro_torch.api import sessions as tsessions  # noqa: E402
from repro_torch.api import threefry  # noqa: E402
from repro_torch.api.spec import SpecError  # noqa: E402
from repro_torch.api.spec import build_spec as tbuild  # noqa: E402
from repro_torch.configs import get_arch as tget_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402

pytestmark = pytest.mark.serving

ARCH = "llama3.2-1b"
#: a small serve spec: 2 slots, 3 requests of 6 prompt tokens, 4 tokens each
BASE = [f"arch.id={ARCH}", "arch.reduced=true", "shape.batch=2", "shape.prompt_len=6",
        "shape.gen=4", "serving.queue=3"]
FIELDS = ("tokens", "finished_by", "finish_tick", "rejected")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the reduced model's ops gain nothing from more
    and the suite's other workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    """The reference's ``lm_init`` parameters, and the port's copy."""
    jp = jlm.lm_init(jax.random.PRNGKey(0), jget_arch(ARCH).reduced())
    return jp, params_from_jax(jp, tget_arch(ARCH).resolve(reduced=True))


def _specs(sets):
    return (jbuild("serve", sets=BASE + sets, use_env=False),
            tbuild("serve", sets=BASE + sets, use_env=False))


def _run_both(params, sets):
    jspec, tspec = _specs(sets)
    assert jspec.to_json() == tspec.to_json() and jspec.state_hash() == tspec.state_hash()
    jout = jsessions.ServeSession(jspec, params=params[0]).run()
    tout = tsessions.ServeSession(tspec, params=params[1], device="cpu").run()
    return jout, tout


def _per_request(out):
    return [{k: r[k] for k in FIELDS} for r in out["per_request"]]


# -- the synthetic traffic ----------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 7, 12345, 2**31 - 1, -3])
def test_prompt_keys_and_fold_ins_equal_jax(seed):
    key = jax.random.PRNGKey(seed)
    assert threefry.prng_key(seed).tolist() == np.asarray(key).tolist()
    for chunk in (1, 2, 9, 1000, 2**32 - 1):
        want = np.asarray(jax.random.fold_in(key, chunk))
        assert threefry.fold_in(threefry.prng_key(seed), chunk).tolist() == want.tolist()
    for num in (2, 3, 5):
        want = np.asarray(jax.random.split(key, num))
        assert threefry.split(threefry.prng_key(seed), num).tolist() == want.tolist()


@pytest.mark.parametrize("vocab", [512, 50280, 128256, 131072, 256000, 1, 2**31 - 1])
@pytest.mark.parametrize("shape", [(4, 32), (2, 5), (1, 33), (3, 1)])
def test_synthetic_batch_is_bit_equal_to_jax(vocab, shape):
    """The reference's ``synthetic_batch`` and the port's under the same
    seed and under folded keys: every token, and the dtype."""
    arch = types.SimpleNamespace(is_encdec=False)
    cfg = types.SimpleNamespace(vocab=vocab, vlm_prefix_len=0)
    for seed, chunk in ((0, 0), (7, 1), (3, 4)):
        jkey = jax.random.PRNGKey(seed)
        tkey = threefry.prng_key(seed)
        if chunk:
            jkey, tkey = jax.random.fold_in(jkey, chunk), threefry.fold_in(tkey, chunk)
        want = np.asarray(jsessions.synthetic_batch(arch, cfg, *shape, jkey)["tokens"])
        got = tsessions.synthetic_batch(arch, cfg, *shape, tkey)["tokens"]
        assert got.dtype == want.dtype == np.int32
        assert np.array_equal(got, want)


def test_queued_prompts_follow_the_reference_chunks():
    """Requests past the first batch come from ``fold_in(key, chunk)``, as
    in the reference's ``_engine`` (7 requests in batches of 3)."""
    key = jax.random.PRNGKey(5)
    want = []
    for chunk in range(3):
        k = jax.random.fold_in(key, chunk) if chunk else key
        want += np.asarray(jax.random.randint(k, (3, 9), 0, 128256)).tolist()
    assert tsessions.synthetic_prompts(7, 3, 9, 128256, 5) == want[:7]


# -- the session against the reference's ------------------------------------------------


@pytest.mark.parametrize("pages", [False, True], ids=["monolithic", "paged"])
@pytest.mark.parametrize("mode", ["dense", "quant", "quant_sparse"])
def test_serve_session_matches_the_reference(params, mode, pages):
    jout, tout = _run_both(params, [f"numerics.mode={mode}", f"serving.pages={pages}".lower()])
    assert _per_request(tout) == _per_request(jout)
    assert np.array_equal(tout["generated"], np.asarray(jout["generated"]))
    assert tout["spec"] == jout["spec"] and tout["spec_hash"] == jout["spec_hash"]
    assert tout["provenance"] == jout["provenance"]
    assert tout["engine"] and tout["slots"] == jout["slots"] == 2
    assert tout["mode"] == mode and tout["finite"]
    assert bool(tout.get("paging")) == pages


def test_serve_session_sheds_as_the_reference(params):
    """A queue-depth cap, an admission deadline and EDF admission over one
    slot: the same requests are shed with the same reasons at the same
    ticks, and the rest finish alike."""
    sets = ["numerics.mode=quant_sparse", "serving.slots=1", "serving.queue=5",
            "serving.max_queue_depth=3", "serving.deadline_ticks=5",
            "serving.deadline_aware=true"]
    jout, tout = _run_both(params, sets)
    got = _per_request(tout)
    assert got == _per_request(jout)
    reasons = {r["rejected"] for r in got}
    assert {"queue_full", "deadline"} <= reasons, reasons
    assert isinstance(tout["generated"], list)  # ragged: shed requests have none
    assert tout["elastic"]["rejected"] == jout["elastic"]["rejected"]


@pytest.mark.parametrize("mode", ["dense", "quant_sparse"])
def test_static_path_matches_the_reference_and_the_engine(params, mode):
    jout, tout = _run_both(params, [f"numerics.mode={mode}", "serving.static=true"])
    assert not tout["engine"] and tout["mesh"] == "single" and tout["finite"]
    assert tout["generated"].shape == (2, 4)
    assert np.array_equal(tout["generated"], np.asarray(jout["generated"]))
    engine = tsessions.ServeSession(_specs([f"numerics.mode={mode}",
                                            "serving.queue=2"])[1],
                                    params=params[1], device="cpu").run()
    assert np.array_equal(engine["generated"], tout["generated"])


def test_sampled_static_path_draws_the_ports_own_stream(params):
    """Sampled static decode uses the engine's per-request draws: a pure
    function of (seed + row, step), so two runs agree."""
    spec = _specs(["numerics.mode=quant_sparse", "serving.static=true",
                   "serving.greedy=false"])[1]
    a = tsessions.ServeSession(spec, params=params[1], device="cpu").run()
    b = tsessions.ServeSession(spec, params=params[1], device="cpu").run()
    assert np.array_equal(a["generated"], b["generated"])
    assert a["generated"].min() >= 0 and a["generated"].max() < 512


# -- launcher snapshots cross packages ------------------------------------------------


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_a_launcher_snapshot_restores_in_the_other_package(params, writer, tmp_path):
    """The writer serves with ``snapshot_every=3``; its last snapshot,
    restored under the same spec (plus ``restore_path``) by the other
    package, drains to the writer's tokens."""
    path = str(tmp_path / "snap.npz")
    sets = ["numerics.mode=quant_sparse", "serving.queue=5", "serving.snapshot_every=3",
            f"serving.snapshot_path={path}"]
    jspec, tspec = _specs(sets)
    if writer == "ref":
        want = jsessions.ServeSession(jspec, params=params[0]).run()
    else:
        want = tsessions.ServeSession(tspec, params=params[1], device="cpu").run()
    assert want["elastic"]["n_snapshots"] >= 2
    restore = ["numerics.mode=quant_sparse", "serving.queue=5",
               f"serving.restore_path={path}"]
    jspec, tspec = _specs(restore)
    if writer == "ref":
        got = tsessions.ServeSession(tspec, params=params[1], device="cpu").run()
    else:
        got = jsessions.ServeSession(jspec, params=params[0]).run()
    assert got["elastic"]["n_restores"] == 1
    assert [r["tokens"] for r in got["per_request"]] == \
        [r["tokens"] for r in want["per_request"]]


def test_the_launchers_restore_each_others_files(tmp_path, capsys):
    """Through the two ``main()``s, legacy flags and all: the reference's
    launcher writes, the port's ``--restore`` drains (and back).  The
    launchers make their own random weights, so only the request count
    and the restore are held here; the tokens are held above."""
    spec_file = tmp_path / "spec.json"
    spec_file.write_text(json.dumps({"run": "serve", "arch": {"id": ARCH, "reduced": True},
                                     "shape": {"batch": 2, "prompt_len": 6, "gen": 4},
                                     "numerics": {"mode": "quant_sparse"},
                                     "serving": {"queue": 3}}))
    a, b, out = (str(tmp_path / n) for n in ("a.npz", "b.npz", "out.json"))
    jlaunch.main(["--spec", str(spec_file), "--set", "serving.snapshot_every=2",
                  "--set", f"serving.snapshot_path={a}"])
    res = tlaunch.main(["--spec", str(spec_file), "--restore", a, "--device", "cpu",
                        "--json", out])
    assert res["elastic"]["n_restores"] == 1 and len(res["per_request"]) == 3
    written = json.load(open(out))
    assert written["spec_hash"] == tbuild("serve", spec_file=str(spec_file),
                                          data={"shape": {"batch": 4}}, use_env=False,
                                          sets=[f"serving.restore_path={a}"]).spec_hash()
    tlaunch.main(["--spec", str(spec_file), "--snapshot-every", "2", "--snapshot-path", b,
                  "--device", "cpu"])
    jlaunch.main(["--spec", str(spec_file), "--set", f"serving.restore_path={b}",
                  "--json", out])
    assert json.load(open(out))["elastic"]["n_restores"] == 1
    assert "spec " in capsys.readouterr().out


# -- what the port refuses -----------------------------------------------------------

REFUSED_FIELDS = [
    (["numerics.weights_pre_quantized=true", "numerics.mode=quant"],
     "numerics.weights_pre_quantized"),
    (["serving.int8_cache=true"], "serving.int8_cache"),
    (["arch.id=whisper-medium", "serving.pages=true"], "serving.pages"),
    (["numerics.stochastic=on", "numerics.mode=quant_sparse"], "numerics.stochastic"),
]


@pytest.mark.parametrize("sets,field", REFUSED_FIELDS, ids=[f for _, f in REFUSED_FIELDS])
def test_fields_the_port_cannot_honour_raise_naming_them(sets, field):
    spec = tbuild("serve", sets=sets, use_env=False)
    with pytest.raises(SpecError, match=field.replace(".", r"\.")):
        spec.resolve()
    with pytest.raises(SpecError, match=field.replace(".", r"\.")):
        tsessions.ServeSession(spec, device="cpu")


POLICY_PAIRINGS = [
    ("interpret", "cpu"), ("interpret", "cuda"), ("pallas", "cpu"), ("ref", "cuda"),
    ("jnp", "cuda"), ("ssd_scan=pallas", "cpu"), ("ref,kv_pack=interpret", "cpu"),
    ("flash_attention=ref", "cuda"),
]


@pytest.mark.parametrize("policy,device", POLICY_PAIRINGS)
def test_policy_device_pairings_the_port_cannot_honour_raise(policy, device):
    """Checked before the device itself, so the card-side refusals show
    here too."""
    spec = tbuild("serve", sets=[f"kernels.policy={policy}"], use_env=False)
    with pytest.raises(SpecError, match="kernels.policy"):
        tsessions.ServeSession(spec, device=device)


@pytest.mark.parametrize("policy", ["auto", "ref", "jnp", "ref,ssd_scan=jnp", "kv_pack=jnp"])
def test_policies_the_cpu_honours(policy):
    spec = tbuild("serve", sets=[f"kernels.policy={policy}"], use_env=False)
    tsessions.check_policy(spec.resolve().kernel_policy, "cpu")


KV_IMPL_NAMES = [
    (None, "cpu", ("jnp", "jnp")), (None, "cuda", ("pallas", "pallas")),
    ("auto", "cpu", ("jnp", "jnp")), ("ref", "cpu", ("ref", "ref")),
    ("kv_pack=ref", "cpu", ("ref", "jnp")), ("pallas", "cuda", ("pallas", "pallas")),
]


@pytest.mark.parametrize("policy,device,names", KV_IMPL_NAMES)
def test_engines_name_their_pool_impls_in_the_references_terms(policy, device, names):
    """One naming, whether an engine is built directly (no policy) or from
    a spec: the names the reference's engine stamps in a snapshot."""
    from repro_torch.serving.engine import kv_impl_names

    pol = None if policy is None else tbuild(
        "serve", sets=[f"kernels.policy={policy}"], use_env=False).resolve().kernel_policy
    assert kv_impl_names(pol, torch.device(device)) == names


def test_an_engine_refuses_a_policy_its_device_cannot_honour():
    from repro_torch.launch.serve import serving_config
    from repro_torch.serving.engine import ServingEngine

    pol = tbuild("serve", sets=["kernels.policy=pallas"], use_env=False).resolve()
    with pytest.raises(SpecError, match="kernels.policy"):
        ServingEngine(tget_arch(ARCH).resolve(reduced=True), serving_config("dense"),
                      kernel_policy=pol.kernel_policy, device="cpu")


def test_train_and_dryrun_sessions_name_their_slices():
    """A train spec now resolves and its session builds (LM training is
    ported); the run-mode check stays, and the dry run still names its
    missing twin."""
    with pytest.raises(SpecError, match="run='train'"):
        tsessions.TrainSession(tsessions.serve_spec(ARCH))
    session = tsessions.session_for(tsessions.train_spec(ARCH), device="cpu")
    assert isinstance(session, tsessions.TrainSession)
    assert session.resolved.step.attention == "chunked"
    assert session.resolved.view.config == session.resolved.config
    with pytest.raises(SpecError, match="item 5"):
        tsessions.session_for(tsessions.dryrun_spec(ARCH, "decode_32k"))


@pytest.mark.parametrize("sets,device,match", [
    (["kernels.policy=flash_attention=pallas"], "cuda", r"kernels\.policy"),
    (["kernels.policy=pallas"], "cuda", r"kernels\.policy"),
    (["kernels.policy=ref"], "cuda", r"kernels\.policy"),
    (["kernels.policy=pallas"], "cpu", r"kernels\.policy"),
    (["sparsity.backward=pallas"], "cpu", r"sparsity\.backward"),
    (["sparsity.backward=interpret"], "cuda", r"sparsity\.backward"),
    # a mesh spec's other fields are checked before any mesh is built
    (["arch.id=olmoe-1b-7b", "shape.mesh.model=2", "kernels.policy=pallas"], "cpu",
     r"kernels\.policy"),
    (["arch.id=whisper-medium"], "cpu",
     r"arch\.id: 'whisper-medium'.*reference's TrainSession.*KeyError 'frames'.*"
     r"src/repro/runtime/train\.py:118"),
    (["arch.id=internvl2-26b"], "cpu",
     r"arch\.id: 'internvl2-26b'.*reference's TrainSession.*img_embeds is not None.*"
     r"src/repro/models/lm\.py:239"),
    (["shape.mesh.data=2", "sparsity.backward=pallas"], "cpu", r"sparsity\.backward"),
    (["shape.batch=6", "shape.microbatch=4"], "cpu", r"shape\.microbatch"),
    (["shape.microbatch=0"], "cpu", r"shape\.microbatch"),
    (["shape.microbatch=3"], "cpu", r"shape\.microbatch"),
])
def test_train_session_refuses_what_it_cannot_honour(sets, device, match):
    """Each field the port cannot honour in training raises the SpecError
    naming it, before anything is built; a policy pinning flash_attention
    is refused on the card, whose kernel has no gradient; whisper-medium
    and internvl2-26b are refused with the reference session's own failure
    on them."""
    spec = tbuild("train", sets=sets, use_env=False)
    with pytest.raises(SpecError, match=match):
        tsessions.TrainSession(spec, device=device)


@pytest.mark.parametrize("sets", [
    ["arch.id=olmoe-1b-7b", "memstash.capacity=0.25"],
    ["memstash.capacity=0.5"],
    ["memstash.value_bits=16"],
])
def test_train_session_builds_the_lossy_stash(sets):
    """The lossy stash's capacity and value width, once refused, build a
    session whose step carries them, as the reference's resolve does."""
    from repro.api.spec import build_spec as jbuild

    session = tsessions.TrainSession(tbuild("train", sets=sets, use_env=False), device="cpu")
    want = jbuild("train", sets=sets, use_env=False).resolve().step.memstash
    got = session.resolved.step.memstash
    assert (got.capacity, got.value_bits) == (want.capacity, want.value_bits)


def test_train_session_takes_the_flash_route_where_pinned_on_the_cpu():
    for policy, route in (("ref", "flash"), ("flash_attention=ref", "flash"),
                          ("jnp", "chunked"), ("masked_matmul=ref", "chunked"),
                          ("auto", "chunked")):
        spec = tbuild("train", sets=[f"kernels.policy={policy}"], use_env=False)
        assert tsessions.TrainSession(spec, device="cpu").resolved.step.attention == route


def test_launcher_refusals_exit_with_the_spec_error(capsys):
    with pytest.raises(SystemExit, match="kernels.policy"):
        tlaunch.main(["--set", "kernels.policy=ref", "--device", "cuda"])
    with pytest.raises(SystemExit, match="int8_cache"):
        tlaunch.main(["--set", "serving.int8_cache=true", "--device", "cpu"])
    with pytest.raises(SystemExit, match="did you mean"):
        tlaunch.main(["--set", "serving.slotss=2", "--device", "cpu"])
