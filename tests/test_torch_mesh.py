"""The port's mesh modules in one process on the CPU, held against the
reference's on the same inputs: the packed collectives in simulation
mode, the tree sum, the wire accounting and the probe, the logical
sharding rules and their fallback counter, the path table over three
archs' parameters and caches, the serving spec trees, the elastic mesh
policy, the int8 pod link's quantizer and accounting, and the spec's
mesh fields.  Every comparison is exact unless its test says otherwise.
The ranks themselves run in ``test_torch_mesh_ranks.py``.
"""

from __future__ import annotations

import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.api.spec import build_spec as jbuild  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.dist import collectives as JC  # noqa: E402
from repro.dist import serve as jserve  # noqa: E402
from repro.kernels import registry as jreg  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.runtime import compression as jcomp  # noqa: E402
from repro.runtime import resilience as jres  # noqa: E402
from repro.runtime import sharding as jsh  # noqa: E402
from repro.runtime import tree_sharding as jts  # noqa: E402
from repro.telemetry.metrics import default_registry as jmetrics  # noqa: E402

from repro_torch.api import sessions as tsessions  # noqa: E402
from repro_torch.api.spec import build_spec as tbuild  # noqa: E402
from repro_torch.configs import get_arch as tget_arch  # noqa: E402
from repro_torch.convert import _jax_layout  # noqa: E402
from repro_torch.dist import collectives as TC  # noqa: E402
from repro_torch.dist import mesh as tmesh  # noqa: E402
from repro_torch.dist import serve as tserve  # noqa: E402
from repro_torch.kernels import registry as treg  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.runtime import compression as tcomp  # noqa: E402
from repro_torch.runtime import resilience as tres  # noqa: E402
from repro_torch.runtime import sharding as tsh  # noqa: E402
from repro_torch.runtime import tree_sharding as tts  # noqa: E402
from repro_torch.runtime.sharding import sharding_context  # noqa: E402
from repro_torch.telemetry.metrics import default_registry as tmetrics  # noqa: E402

pytestmark = pytest.mark.mesh

jreg.ensure_registered()

#: tests/test_mesh.py's stacked (D, n) payloads, one per numerics mode
PAYLOADS = {
    "dense": JC._shard_block(0, 4, 1024, 1.0),
    "quant": JC._shard_block(1, 4, 512, 0.5, jnp.bfloat16),
    "quant_sparse": JC._shard_block(2, 4, 500, 0.1),
}
OPS = ("packed_all_gather", "packed_reduce_scatter")
DENSE = {"packed_all_gather": (JC.dense_all_gather, TC.dense_all_gather),
         "packed_reduce_scatter": (JC.dense_reduce_scatter, TC.dense_reduce_scatter)}


def to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def assert_same_bits(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    if got.dtype == torch.bfloat16:
        got = got.view(torch.int16).numpy().view(np.uint16).view(jnp.bfloat16)
    else:
        got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8))


def _inputs() -> dict:
    cases = {f"example{i}": x for i, ((x,), _) in enumerate(JC._collective_examples())}
    cases.update(PAYLOADS)
    # -0.0 canonicalises to +0.0; a word-unaligned length
    cases["signed_zeros"] = jnp.asarray(np.tile(np.array([0.0, -0.0, 1.5, -2.0], np.float32),
                                                (2, 9)))
    return cases


INPUTS = _inputs()


# -- packed collectives, simulation mode -------------------------------------------------


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("case", sorted(INPUTS))
def test_simulation_mode_equals_the_reference(op, case):
    """The public op, its registry kernel and plain versions, and the dense
    reference, each bit-equal to the reference's on the same payload."""
    x = INPUTS[case]
    want = jreg.resolve(op, "ref").fn(x)
    tx = to_torch(x)
    assert_same_bits(getattr(TC, op)(tx), want)
    spec = treg.op_spec(op)
    assert_same_bits(spec.kernel(tx), want)
    assert_same_bits(spec.plain(tx), want)
    jd, td = DENSE[op]
    assert_same_bits(td(tx), jd(x))


def test_the_port_s_registry_examples_are_the_reference_s_shapes_and_zeros():
    """Same shapes, dtypes and zero patterns (the threefry keep mask); the
    live values are the port's own numpy normals."""
    for (tx,), (jx,) in zip([c[0] for c in TC.collective_examples()],
                            [c[0] for c in JC._collective_examples()]):
        jx = np.asarray(jx)
        assert tuple(tx.shape) == jx.shape and str(tx.dtype).split(".")[1] == str(jx.dtype)
        assert np.array_equal(tx.float().numpy() != 0, jx.astype(np.float32) != 0)


def test_tree_sum_is_exactly_d_times_g_and_refuses_three():
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(4096).astype(np.float32))
    total = TC._tree_sum(torch.stack([g, g, g, g]))
    assert torch.equal(total, g * 4.0) and torch.equal(total / 4, g)
    with pytest.raises(ValueError, match="power of two"):
        TC._tree_sum(torch.ones(3, 8))


@pytest.mark.parametrize("nnz,length,world", [(0, 64, 2), (1234, 4096, 4), (77, 500, 4),
                                              (2048, 1024, 2), (5, 33, 8)])
def test_collective_wire_bits_match(nnz, length, world):
    assert TC.collective_wire_bits(nnz, length, world) == JC.collective_wire_bits(
        nnz, length, world)


@pytest.mark.parametrize("density,world,length", [(0.5, 2, 1 << 14), (0.37, 4, 1 << 12),
                                                  (1.0, 2, 1000), (0.1, 8, 777), (0.0, 2, 64)])
def test_collective_probe_matches_field_by_field(density, world, length):
    want = JC.collective_probe(density, world=world, length=length)
    got = TC.collective_probe(density, world=world, length=length)
    assert set(got) == set(want)
    for k in want:
        if k != "impl":
            assert got[k] == want[k], k
    assert got["impl"] == want["impl"] == "jnp"


def test_collective_probe_emits_the_reference_s_telemetry():
    jmetrics().reset()
    tmetrics().reset()
    JC.collective_probe(0.5, world=2)
    TC.collective_probe(0.5, world=2)
    for fam in ("spring_mesh_collective_bytes_total", "spring_mesh_collective_density"):
        got, want = tmetrics().snapshot()[fam], jmetrics().snapshot()[fam]
        assert [c["labels"] for c in got["cells"]] == [c["labels"] for c in want["cells"]]
    assert (tmetrics().snapshot()["spring_mesh_collective_bytes_total"]["cells"][0]["value"]
            == jmetrics().snapshot()["spring_mesh_collective_bytes_total"]["cells"][0]["value"])


def test_impl_names_a_device_s_implementation():
    x = torch.ones(2, 64)
    for impl in (None, "auto", "ref", "jnp"):
        TC.packed_all_gather(x, impl=impl)
    with pytest.raises(ValueError, match="pallas"):
        TC.packed_all_gather(x, impl="pallas")


def test_collective_mode_needs_an_installed_mesh():
    with pytest.raises(ValueError, match="sharding_context"):
        TC.packed_all_gather(torch.ones(64), axis_name="data")


# -- logical rules and the fallback counter ------------------------------------------------

STUB_MESHES = [{"data": 3}, {"data": 4, "model": 2}, {"pod": 2, "data": 2, "model": 4}]
LOGICAL = [(("batch",), (4,)), (("batch",), (6,)), (("batch", "seq", "embed"), (8, 16, 32)),
           (("batch", "heads", "head_dim"), (6, 6, 64)), (("w_embed", "w_qkv"), (6, 10)),
           (("w_vocab", "w_embed"), (12, 8)), (("cache_batch", "cache_seq", "cache_heads",
                                                "head_dim"), (3, 16, 2, 8)),
           (("w_experts", "w_embed", None), (8, 4, 3)), (("mlp_act", "mlp_act"), (8, 8)),
           ((None, "vocab_act"), (2, 7)), (("experts_act", "capacity"), (4, 5)),
           (("unknown", "batch"), (4, 4))]


@pytest.mark.parametrize("shape", STUB_MESHES, ids=lambda s: ".".join(f"{k}{v}"
                                                                      for k, v in s.items()))
def test_logical_to_spec_and_fallbacks_match(shape):
    stub = types.SimpleNamespace(shape=shape)
    jmetrics().reset()
    tmetrics().reset()
    for axes, dims in LOGICAL:
        assert tsh.logical_to_spec(axes, dims, stub) == tuple(jsh.logical_to_spec(axes, dims,
                                                                                 stub))
    with tsh.sharding_context(stub, dict(tsh.DEFAULT_RULES, seq=(("model",), None))), \
            jsh.sharding_context(None, dict(jsh.DEFAULT_RULES, seq=(("model",), None))):
        for axes, dims in LOGICAL:
            assert tsh.logical_to_spec(axes, dims, stub) == tuple(
                jsh.logical_to_spec(axes, dims, stub))
    assert tsh.mesh_fallback_counts() == jsh.mesh_fallback_counts()


def test_fallback_counter_on_an_indivisible_axis():
    """tests/test_mesh.py's case: 4 rows over data=3 replicate and count."""
    tmetrics().reset()
    stub = types.SimpleNamespace(shape={"data": 3})
    assert tsh.logical_to_spec(("batch",), (4,), stub) == (None,)
    assert tsh.mesh_fallback_counts() == {"batch": 1}
    assert tsh.logical_to_spec(("batch",), (6,), stub) == ("data",)
    assert tsh.mesh_fallback_counts() == {"batch": 1}
    x = torch.ones(4)
    with tsh.sharding_context(stub):
        assert tsh.constrain(x, ("batch",)) is x


# -- the path table over parameters and caches -------------------------------------------

ARCHS = ("llama3.2-1b", "olmoe-1b-7b", "mamba2-780m")


def _ref_paths(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {tuple(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): leaf
            for path, leaf in flat}


def _spec_paths(tree, path=()) -> dict:
    """{path: spec} of a spec tree (dicts of spec tuples)."""
    if isinstance(tree, dict):
        return {q: s for k, v in tree.items() for q, s in _spec_paths(v, path + (str(k),)).items()}
    return {path: tree}


def _port_paths(tree) -> dict:
    out: dict = {}
    tts.map_with_path(lambda path, leaf: out.__setitem__(tuple(str(p) for p in path), leaf),
                      tree)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_logical_axes_for_every_parameter_match(arch):
    """Every parameter leaf of the reduced arch: the reference's axes on its
    stacked tree, the port's on its per-layer tree (the trailing dims of
    the stacked leaf its layer lies in) and on that tree in the
    reference's layout (the same paths and shapes)."""
    jcfg = jget_arch(arch).reduced()
    tcfg = tget_arch(arch).resolve(reduced=True)
    jtree = jax.eval_shape(lambda: jlm.lm_init(jax.random.PRNGKey(0), jcfg))
    want = {p: jts.logical_axes_for_path(
        [types.SimpleNamespace(key=k) for k in p], leaf.shape) for p, leaf in
        _ref_paths(jtree).items()}
    tparams = tlm.lm_init(tcfg, 0, device="cpu")
    jlayout = _port_paths(_jax_layout(tparams, tcfg))
    assert sorted(jlayout) == sorted(want)
    for p, leaf in jlayout.items():
        assert tts.logical_axes_for_path(p, leaf.shape) == want[p], p
    keys = [key for key, _, _ in tcfg.layer_plan]
    for p, leaf in _port_paths(tparams).items():
        ref_p = (keys[int(p[1])],) + p[2:] if p[0] == "layers" else p
        got = tts.logical_axes_for_path(p, leaf.shape)
        assert got == want[ref_p][len(want[ref_p]) - len(got):], p


@pytest.mark.parametrize("arch", ARCHS)
def test_logical_axes_for_every_cache_leaf_match(arch):
    jcfg = jget_arch(arch).reduced()
    tcfg = tget_arch(arch).resolve(reduced=True)
    jcache = _ref_paths(jax.eval_shape(lambda: jlm.lm_init_cache(jcfg, 4, 24)))
    tcache = _port_paths(tlm.lm_init_cache(tcfg, 4, 24, device="cpu"))
    assert sorted(tcache) == sorted(jcache)
    for p, leaf in tcache.items():
        assert tuple(leaf.shape) == jcache[p].shape, p
        assert tts.logical_axes_for_path(p, leaf.shape) == jts.logical_axes_for_path(
            [types.SimpleNamespace(key=k) for k in p], jcache[p].shape), p


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_spec_trees_match(arch):
    """``_cache_specs`` / ``_row_specs`` at data=4 on the reduced cache and
    a (4, 8) prompt batch (``tree_shardings`` / ``batch_shardings`` too)."""
    stub = types.SimpleNamespace(shape={"pod": 1, "data": 4, "model": 1})
    jcfg = jget_arch(arch).reduced()
    tcfg = tget_arch(arch).resolve(reduced=True)
    jcache = jax.eval_shape(lambda: jlm.lm_init_cache(jcfg, 4, 24))
    tcache = tlm.lm_init_cache(tcfg, 4, 24, device="cpu")
    want = jax.tree_util.tree_flatten_with_path(
        jserve._cache_specs(jcache, stub), is_leaf=lambda s: isinstance(s, jsh.P))[0]
    want = {tuple(str(k.key) for k in path): tuple(s) for path, s in want}
    assert _spec_paths(tserve._cache_specs(tcache, stub)) == want
    # tree_shardings under the default rules: the reference's NamedSharding
    # specs, built from the same two functions over the stub
    assert _spec_paths(tts.tree_shardings(tcache, stub)) == {
        p: tuple(jsh.logical_to_spec(jts.logical_axes_for_path(
            [types.SimpleNamespace(key=k) for k in p], leaf.shape), leaf.shape, stub))
        for p, leaf in _ref_paths(jcache).items()}
    batch = {"tokens": jnp.zeros((4, 8), jnp.int32)}
    assert tserve._row_specs({"tokens": torch.zeros(4, 8)}, stub) == {
        "tokens": tuple(jserve._row_specs(batch, stub)["tokens"])}
    assert tts.batch_shardings({"tokens": torch.zeros(4, 8)}, stub)["tokens"] == (
        ("pod", "data"), None)


# -- the elastic policy ---------------------------------------------------------------------


@pytest.mark.parametrize("mp", [1, 2, 4, 16])
@pytest.mark.parametrize("pods", [1, 2])
def test_elastic_mesh_policy_matches(mp, pods):
    jp, tp = jres.ElasticMeshPolicy(mp, pods), tres.ElasticMeshPolicy(mp, pods)
    for n in range(1, 1025):
        got, want = tp.choose(n), jp.choose(n)
        assert (got.shape, got.axes) == (want.shape, want.axes), n


# -- the int8 pod link -----------------------------------------------------------------------


def test_compression_wire_bytes_match():
    shapes = {"a": (64, 48), "b": (300,), "c": (3, 5, 7)}
    jg = {k: jnp.zeros(s) for k, s in shapes.items()}
    tg = {k: torch.zeros(s) for k, s in shapes.items()}
    for pods in (1, 2, 4, 16):
        assert tcomp.compression_wire_bytes(tg, pods) == jcomp.compression_wire_bytes(jg, pods)


def test_sr_quantize_int8_is_unbiased_within_five_sigma():
    """E[q * scale] = x: the float64 sum of the rounding errors over 2**20
    values lies within 5 sigma of 0, sigma^2 = sum frac(1 - frac) scale^2,
    and no error passes one scale step."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(1 << 20).astype(np.float32))
    q, scale = tcomp.sr_quantize_int8(x, 12345)
    assert q.dtype == torch.int8 and int(q.abs().max()) <= 127
    err = (tcomp.dequantize_int8(q, scale).double() - x.double()).numpy()
    s = float(scale)
    assert np.abs(err).max() <= s * (1 + 1e-6)
    frac = (x.double() / s).numpy() % 1.0
    sigma = np.sqrt(np.sum(frac * (1 - frac)) * s * s)
    assert abs(err.sum()) <= 5 * sigma
    # other seeds draw otherwise; the same seed draws the same
    assert torch.equal(tcomp.sr_quantize_int8(x, 12345)[0], q)
    assert not torch.equal(tcomp.sr_quantize_int8(x, 54321)[0], q)


def test_one_pod_mean_is_the_dequantized_payload_and_ef_its_residual():
    """The reference's test_compressed_allreduce_int8_error_feedback, on a
    one-rank pod axis: out + ef = g (its tolerance), ef = local - dequant
    exactly, and the error within one int8 step."""
    g = {"w": torch.from_numpy(np.random.default_rng(0).standard_normal(64).astype(np.float32))}
    mesh = tmesh.Mesh(1, 1, 1)
    with sharding_context(mesh):
        out, ef = tcomp.compressed_allreduce_tree(g, "pod", 1)
    np.testing.assert_allclose((out["w"] + ef["w"]).numpy(), g["w"].numpy(), rtol=1e-5,
                               atol=1e-6)
    from repro_torch.kernels.prng import fold_in

    q, scale = tcomp.sr_quantize_int8(g["w"], fold_in(1, 0))
    assert torch.equal(ef["w"], g["w"] - tcomp.dequantize_int8(q, scale))
    assert float((g["w"] - tcomp.dequantize_int8(q, scale)).abs().max()) <= float(scale) + 1e-7


# -- the spec, the mesh and the sessions -----------------------------------------------------

MESH_SETS = [["shape.mesh.data=2"], ["shape.mesh.data=4", "shape.mesh.model=2"],
             ["shape.mesh.pod=2"], ["shape.mesh=debug"], ["shape.mesh=multi"]]


@pytest.mark.parametrize("run", ["serve", "train"])
@pytest.mark.parametrize("sets", MESH_SETS, ids=lambda s: ",".join(s))
def test_unsupported_no_longer_names_the_mesh(run, sets):
    spec = tbuild(run, sets=sets, use_env=False)
    assert not any("shape.mesh" in m for m in spec.unsupported())
    spec.resolve()
    jbuild(run, sets=sets, use_env=False).resolve()


def test_an_explicit_mesh_needs_a_process_group_and_names_torchrun():
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 4"):
        tmesh.make_explicit_mesh(1, 4, 1)
    with pytest.raises(RuntimeError, match="torchrun"):
        tsessions.TrainSession(tbuild("train", sets=["shape.mesh.data=2"], use_env=False),
                               device="cpu")


def test_a_named_kind_alone_builds_no_mesh():
    spec = tbuild("serve", sets=["shape.mesh=debug"], use_env=False)
    assert tsessions.build_mesh(spec.shape.mesh) is None
    assert tsessions.ServeSession(spec, device="cpu").mesh is None
    assert tsessions.TrainSession(tbuild("train", sets=["shape.mesh=multi"], use_env=False),
                                  device="cpu").mesh is None


def test_a_one_rank_mesh_and_its_local_collectives():
    mesh = tmesh.make_explicit_mesh(1, 1, 1)
    assert mesh.shape == {"pod": 1, "data": 1, "model": 1} and mesh.label() == \
        "pod1.data1.model1"
    assert tmesh.data_axis_size(mesh) == 1 and tmesh.data_axis_size(None) == 1
    x = TC._shard_block(4, 1, 96, 0.5)[0]
    with sharding_context(mesh):
        assert torch.equal(TC.packed_all_gather(x, axis_name="data"), x)
        assert torch.equal(TC.packed_reduce_scatter(x, axis_name="data"), x)
        assert torch.equal(TC.packed_all_reduce_mean(x, axis_name="data", world=1), x)
    assert mesh.staged_hops == 0


@pytest.mark.parametrize("device,ranks,want", [("cpu", 4, "gloo"), ("cpu", 1, "gloo")])
def test_the_backend_follows_the_device(device, ranks, want):
    assert tmesh.backend_for(device, ranks) == want
    assert tmesh.rank_device(device, 3) == torch.device("cpu")
