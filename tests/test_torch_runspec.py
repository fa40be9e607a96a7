"""The port's RunSpec against the reference's: one spec, one text.

For every example spec, every reference arch x run mode, and the
reference's own cases in ``tests/test_runspec.py`` (non-default round
trips, file / env / ``SPRING_SET`` / ``--set`` precedence, aliases, the
legacy-kwargs bridges), ``repro_torch.api`` and ``repro.api`` give the
same ``to_json()`` text, ``spec_hash()``, ``state_hash()``, ``describe()``
(provenance included) and, for bad input, the same ``SpecError`` text.
One error text differs by design: an unknown op in ``kernels.policy``
lists the registered ops, and the port registers its own
(``repro_torch.kernels.registry.ops()``, without the reference's two
packed collectives); the rest of that message is equal.

The serve launcher's legacy flags parse to the same spec through both
``build_parser()``s, and every option of the port's launcher is
operational or a RunSpec-backed shim (the twin of
``tests/test_cli_parity.py::test_launcher_options_all_backed_by_runspec_fields``).
"""

import json
import pathlib
import re
import warnings

import pytest

from repro.api import cli as jcli
from repro.api import sessions as jsessions
from repro.api import spec as jspec
from repro.configs import ARCHS as JARCHS
from repro.launch import serve as jlaunch

from repro_torch.api import cli as tcli
from repro_torch.api import sessions as tsessions
from repro_torch.api import spec as tspec
from repro_torch.launch import serve as tlaunch

pytestmark = pytest.mark.spec

EXAMPLES = sorted((pathlib.Path(__file__).parent.parent / "examples" / "specs").glob("*.json"))
RUNS = ("train", "serve", "dryrun")


def _same(j, t):
    """The two packages' specs agree in everything a spec shows."""
    assert t.to_json() == j.to_json()
    assert t.spec_hash() == j.spec_hash()
    assert t.state_hash() == j.state_hash()
    assert t.describe() == j.describe()
    assert t.payload() == j.payload()
    assert tspec.RunSpec.from_json(t.to_json()) == t


def _both(fn_name, *args, **kw):
    """Call ``fn_name`` in both spec modules; equal specs or equal errors."""
    errors = []
    out = []
    for mod in (jspec, tspec):
        try:
            out.append(getattr(mod, fn_name)(*args, **kw))
        except mod.SpecError as e:
            errors.append(str(e))
    if errors:
        assert len(errors) == 2, f"only one package raised: {errors}"
        return errors
    _same(*out)
    return out


# -- shapes of the spec ------------------------------------------------------------


def test_field_table_choices_and_constants_match():
    assert tspec.field_paths() == jspec.field_paths()
    assert tspec._CHOICES == jspec._CHOICES
    assert tspec._ALIASES == jspec._ALIASES
    assert tspec.ENV_FIELDS == jspec.ENV_FIELDS and tspec.ENV_SET == jspec.ENV_SET
    assert (tspec.RUN_MODES, tspec.MESH_KINDS, tspec.LAYOUTS) == \
        (jspec.RUN_MODES, jspec.MESH_KINDS, jspec.LAYOUTS)
    assert tspec.RunSpec().to_json() == jspec.RunSpec().to_json()


def test_shapes_table_and_memstash_defaults_are_the_references():
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import default_memstash as jdefault
    from repro.kernels.registry import IMPL_NAMES as JIMPLS

    from repro_torch.configs import SHAPES as TSHAPES
    from repro_torch.configs import default_memstash as tdefault
    from repro_torch.kernels.registry import IMPL_NAMES as TIMPLS

    assert {k: vars(v) for k, v in TSHAPES.items()} == {k: vars(v) for k, v in JSHAPES.items()}
    for family in ("cnn", "dense", "ssm", "moe", "vlm", "hybrid", "audio"):
        assert tdefault(family).policy == jdefault(family).policy
    assert TIMPLS == JIMPLS


@pytest.mark.parametrize("path", EXAMPLES, ids=[p.name for p in EXAMPLES])
def test_example_specs_read_alike(path):
    _both("build_spec", spec_file=str(path), use_env=False)
    j, t = jspec.RunSpec.from_file(str(path)), tspec.RunSpec.from_file(str(path))
    _same(j, t)


@pytest.mark.parametrize("arch_id", sorted(JARCHS))
@pytest.mark.parametrize("run", RUNS)
def test_every_arch_and_run_mode_reads_alike(arch_id, run):
    j, t = _both("build_spec", run, use_env=False, overrides=[("arch.id", arch_id, "test")])
    again = tspec.RunSpec.from_json(t.to_json())
    assert again == t and again.to_json() == j.to_json()


def test_non_default_round_trip_reads_alike():
    sets = ["serving.slots=2", "serving.queue=7", "numerics.mode=quant_sparse",
            "kernels.policy=ref,ssd_scan=jnp", "shape.microbatch=none",
            "sparsity.probe_density=0.25", "seeds.seed=11", "optimizer.lr=0.003",
            "serving.overcommit=2", "telemetry.sample_rate=0.5", "shape.mesh.model=4",
            "serving.num_pages=null", "arch.reduced=false", "memstash.capacity=0.5"]
    j, t = _both("build_spec", "serve", use_env=False, sets=sets)
    assert tspec.RunSpec.from_json(t.to_json()) == t


def test_layer_precedence_file_env_cli_reads_alike(tmp_path):
    p = tmp_path / "s.json"
    p.write_text(json.dumps({"numerics": {"mode": "quant"}, "shape": {"batch": 4},
                             "train": {"steps": 9}}))
    env = {"SPRING_MODE": "quant_sparse", "SPRING_SEED": "5",
           "SPRING_SET": "kernels.policy=ref,ssd_scan=jnp;shape.seq=999",
           "SPRING_ARCH": "", "SPRING_STASH": "stash"}
    j, t = _both("build_spec", "train", spec_file=str(p), environ=env,
                 sets=["numerics.mode=dense"], data={"seeds": {"seed": 2}},
                 data_label="preset", overrides=[("train.steps", 4, "call:train.steps")])
    assert t.numerics.mode == "dense" and t.seeds.seed == 5 and t.shape.seq == 999
    assert t.provenance["shape.batch"].startswith("file:")


def test_toml_spec_reads_alike(tmp_path):
    p = tmp_path / "s.toml"
    p.write_text('run = "serve"\n[arch]\nid = "mamba2-780m"\n[serving]\nslots = 3\n'
                 'pages = true\n[shape.mesh]\nkind = "single"\n')
    assert tspec.load_spec_data(str(p)) == jspec.load_spec_data(str(p))
    _both("build_spec", spec_file=str(p), use_env=False)


@pytest.mark.parametrize("alias", ["multi", "debug", "single"])
def test_mesh_alias_reads_alike(alias):
    _both("build_spec", "dryrun", use_env=False, sets=[f"shape.mesh={alias}"])
    _both("build_spec", data={"shape": {"mesh": alias}}, use_env=False)


def test_legacy_kwarg_bridges_read_alike():
    for j, t in (
        (jsessions.train_spec("qwen2-7b", mode="quant", lr=1e-2, fixed_point_weights=True,
                              kernel_impl="ref", backward_sparsity="jnp", stash="stash"),
         tsessions.train_spec("qwen2-7b", mode="quant", lr=1e-2, fixed_point_weights=True,
                              kernel_impl="ref", backward_sparsity="jnp", stash="stash")),
        (jsessions.serve_spec("mamba2-780m", mode="quant_sparse", slots=3, queue=0,
                              pages=True, page_tokens=4, overcommit=2.0, snapshot_every=2,
                              restore_path="r.npz", deadline_aware=True),
         tsessions.serve_spec("mamba2-780m", mode="quant_sparse", slots=3, queue=0,
                              pages=True, page_tokens=4, overcommit=2.0, snapshot_every=2,
                              restore_path="r.npz", deadline_aware=True)),
        (jsessions.dryrun_spec("qwen2-7b", "train_4k", "multi", "quant", microbatch=4,
                               layout="fsdp", remat_policy="block_io", cache_int8=True),
         tsessions.dryrun_spec("qwen2-7b", "train_4k", "multi", "quant", microbatch=4,
                               layout="fsdp", remat_policy="block_io", cache_int8=True)),
    ):
        _same(j, t)


TRAIN_RESOLVE_CASES = [
    ("call", None),
    ("file", []),
    ("file", ["numerics.operand_rounding=nearest", "numerics.weights_pre_quantized=true",
              "numerics.stochastic=off", "arch.remat_policy=block_io",
              "arch.bf16_logits=true", "shape.microbatch=2", "optimizer.kind=sgdm"]),
    ("file", ["memstash.policy=remat", "arch.reduced=false", "numerics.mode=dense"]),
    ("file", ["memstash.policy=none", "numerics.stochastic=on", "sparsity.backward=none"]),
]


@pytest.mark.parametrize("how,sets", TRAIN_RESOLVE_CASES,
                         ids=[f"{h}-{i}" for i, (h, _) in enumerate(TRAIN_RESOLVE_CASES)])
def test_train_resolve_gives_the_references_step_config(how, sets):
    """resolve() of a train spec gives the reference's StepConfig fields
    (tests/test_runspec.py:143's case, the example train spec and
    variations), and the arch config's remat and logits fields."""
    if how == "call":
        kw = dict(mode="quant", lr=1e-2, fixed_point_weights=True, kernel_impl="ref",
                  backward_sparsity="jnp", stash="stash")
        j = jsessions.train_spec("llama3.2-1b", **kw).resolve()
        t = tsessions.train_spec("llama3.2-1b", **kw).resolve()
    else:
        example = str(EXAMPLES[[p.name for p in EXAMPLES].index("train_quant_sparse.json")])
        j = jspec.build_spec("train", spec_file=example, sets=sets, use_env=False).resolve()
        t = tspec.build_spec("train", spec_file=example, sets=sets, use_env=False).resolve()
    for field in ("mode", "stochastic", "backward_sparsity", "weights_pre_quantized",
                  "operand_rounding"):
        assert getattr(t.spring, field) == getattr(j.spring, field), field
    assert (t.spring.fmt.il, t.spring.fmt.fl) == (j.spring.fmt.il, j.spring.fmt.fl)
    assert (t.step.backward_sparsity, t.step.microbatch, t.step.prune_ratio) == \
        (j.step.backward_sparsity, j.step.microbatch, j.step.prune_ratio)
    assert (t.step.memstash.policy, t.step.memstash.min_elems) == \
        (j.step.memstash.policy, j.step.memstash.min_elems)
    assert t.memstash_policy == j.memstash_policy
    to, jo = t.step.optimizer, j.step.optimizer
    for field in ("kind", "lr", "beta1", "beta2", "eps", "weight_decay", "momentum",
                  "grad_clip", "warmup_steps"):
        assert getattr(to, field) == getattr(jo, field), field
    assert (to.weight_format is None) == (jo.weight_format is None)
    if jo.weight_format is not None:
        assert (to.weight_format.il, to.weight_format.fl) == \
            (jo.weight_format.il, jo.weight_format.fl)
    for field in ("name", "d_model", "vocab", "n_layers", "remat", "remat_policy",
                  "bf16_logits", "tie_embeddings"):
        assert getattr(t.config, field) == getattr(j.config, field), field
    assert t.view.config == t.config and t.view.is_encdec == j.view.is_encdec
    assert t.step.attention == ("flash" if how == "call" else "chunked")  # "ref" pins it


def test_state_hash_ignores_what_a_restore_changes():
    a = tspec.build_spec("serve", use_env=False)
    b = tspec.build_spec("serve", use_env=False, sets=[
        "serving.snapshot_every=3", "serving.snapshot_path=x.npz",
        "serving.restore_path=y.npz", "shape.mesh.data=2"])
    assert a.state_hash() == b.state_hash() and a.spec_hash() != b.spec_hash()
    jb = jspec.build_spec("serve", use_env=False, sets=[
        "serving.snapshot_every=3", "serving.snapshot_path=x.npz",
        "serving.restore_path=y.npz", "shape.mesh.data=2"])
    assert jb.state_hash() == b.state_hash()


# -- errors -------------------------------------------------------------------------

ERROR_CASES = [
    ("data", {"numerics": {"mod": "quant"}}),
    ("data", {"numeric": {"mode": "quant"}}),
    ("data", {"shape": {"batch": "eight"}}),
    ("data", {"shape": 3}),
    ("data", [1, 2]),
    ("data", {"run": "serv"}),
    ("data", {"telemetry": {"sample_rate": True}}),
    ("data", {"serving": {"slots": 1.5}}),
    ("data", {"arch": {"id": 3}}),
    ("sets", ["serving.slotss=2"]),
    ("sets", ["numerics.mode=quant_spars"]),
    ("sets", ["memstash.policy=stashh"]),
    ("sets", ["arch.remat_policy=blockio"]),
    ("sets", ["arch.reduced=maybe"]),
    ("sets", ["shape.batch=four"]),
    ("sets", ["optimizer.lr=fast"]),
    ("sets", ["shape.cell=train_5k"]),
    ("sets", ["shape.mesh=mult"]),
    ("sets", ["shape.mesh.data=3"]),
    ("sets", ["shape.mesh.pod=0"]),
    ("sets", ["sparsity.probe_density=1.5"]),
    ("sets", ["telemetry.sample_rate=0"]),
    ("sets", ["serving.page_tokens=0"]),
    ("sets", ["serving.overcommit=0.5"]),
    ("sets", ["serving.num_pages=0"]),
    ("sets", ["serving.snapshot_every=-1"]),
    ("sets", ["serving.max_queue_depth=0"]),
    ("sets", ["serving.deadline_ticks=-2"]),
    ("sets", ["serving.snapshot_every=2", "serving.restore_path=spring_snapshot.npz"]),
    ("sets", ["memstash.capacity=0"]),
    ("sets", ["kernels.policy=bogus"]),
    ("sets", ["kernels.policy=ref,ssd_scan=bogus"]),
    ("sets", ["numerics.stochastic=maybe"]),
    ("sets", ["optimizer.kind=adam"]),
    ("sets", ["shape.layout=fsd"]),
    ("sets", ["sparsity.backward=dense"]),
    ("sets", ["serving.slots"]),
    ("environ", {"SPRING_SET": "shape.seq"}),
    ("environ", {"SPRING_MODE": "quantt"}),
    ("environ", {"SPRING_SEED": "x"}),
]


@pytest.mark.parametrize("kind,value", ERROR_CASES,
                         ids=[f"{k}-{i}" for i, (k, _) in enumerate(ERROR_CASES)])
def test_bad_input_raises_the_same_text(kind, value):
    kw = {"environ": value} if kind == "environ" else {kind: value, "use_env": False}
    errors = _both("build_spec", **kw)
    assert isinstance(errors[0], str) and errors[0] == errors[1]


def test_bad_json_and_files_raise_the_same_text(tmp_path):
    texts = []
    for mod in (jspec, tspec):
        with pytest.raises(mod.SpecError) as e:
            mod.RunSpec.from_json("{not json")
        texts.append(str(e.value))
    bad = tmp_path / "bad.json"
    bad.write_text("{,}")
    for mod in (jspec, tspec):
        with pytest.raises(mod.SpecError) as e:
            mod.RunSpec.from_file(str(bad))
        texts.append(str(e.value))
    assert texts[0] == texts[1] and texts[2] == texts[3]


def test_an_unknown_policy_op_raises_alike_but_for_the_op_list():
    """The registered-op list is each package's own."""
    errors = _both("build_spec", use_env=False, sets=["kernels.policy=ssd_scanx=jnp"])
    strip = [re.sub(r"registered ops: \[.*\]", "registered ops: [...]", e) for e in errors]
    assert strip[0] == strip[1]
    assert "ssd_scanx" in errors[1] and "'packed_all_gather'" in errors[1]


# -- the launcher's flags ------------------------------------------------------------

LEGACY_ARGV = [
    ["--arch", "mamba2-780m"], ["--reduced"], ["--batch", "3"], ["--prompt-len", "9"],
    ["--gen", "5"], ["--mode", "quant"], ["--kernel-impl", "ref,ssd_scan=jnp"],
    ["--slots", "2"], ["--queue", "6"], ["--greedy"], ["--sample"], ["--sample", "--greedy"],
    ["--seed", "3"], ["--static"], ["--pages"], ["--page-tokens", "4"],
    ["--prefix-cache", "off"], ["--prefix-cache", "1"], ["--snapshot-every", "2"],
    ["--snapshot-path", "a.npz"], ["--restore", "b.npz"], ["--max-queue-depth", "4"],
    ["--deadline-ticks", "7"],
    ["--spec", "examples/specs/serve_quant_sparse.json", "--slots", "1",
     "--set", "serving.queue=2"],
]


def test_legacy_flags_are_the_references():
    def table(flags):
        return [(f.option, f.path, f.const, f.dest, dict(f.kwargs).get("type") is not None)
                for f in flags]

    assert table(tlaunch.LEGACY_FLAGS) == table(jlaunch.LEGACY_FLAGS)
    assert tlaunch.CLI_BASE == jlaunch.CLI_BASE


@pytest.mark.parametrize("argv", LEGACY_ARGV, ids=[" ".join(a) for a in LEGACY_ARGV])
def test_each_legacy_flag_parses_alike(argv):
    root = pathlib.Path(__file__).parent.parent
    argv = [str(root / a) if a.endswith(".json") else a for a in argv]
    specs = []
    for mod, cli in ((jlaunch, jcli), (tlaunch, tcli)):
        args = mod.build_parser().parse_args(argv)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            specs.append(cli.spec_from_args("serve", args, mod.LEGACY_FLAGS, base=mod.CLI_BASE))
    _same(*specs)


def test_launcher_options_all_backed_by_runspec_fields():
    legacy_options = {lf.option for lf in tlaunch.LEGACY_FLAGS}
    for lf in tlaunch.LEGACY_FLAGS:
        assert lf.path in tspec.field_paths(), (lf.option, lf.path)
    for action in tlaunch.build_parser()._actions:
        for opt in action.option_strings:
            if opt.startswith("--"):
                assert opt in tcli.OPERATIONAL_OPTIONS or opt in legacy_options, opt
    assert tcli.OPERATIONAL_OPTIONS == jcli.OPERATIONAL_OPTIONS | {"--device"}
    assert "--telemetry" not in legacy_options and "--trace-path" not in legacy_options


def test_explain_prints_the_references_description(capsys):
    argv = ["--set", "arch.id=minitron-4b", "--slots", "3", "--explain"]
    for main in (jlaunch.main, tlaunch.main):
        with pytest.raises(SystemExit) as e, warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            main(argv)
        assert e.value.code == 0
    out = capsys.readouterr().out.strip().split("\n")
    half = len(out) // 2
    assert out[:half] == out[half:] and "arch.id = 'minitron-4b'  [set:arch.id]" in out


def test_serving_config_resolves_as_the_references():
    for mode in ("dense", "quant", "quant_sparse"):
        t = tlaunch.serving_config(mode)
        j = jlaunch.serving_config(mode)
        assert (t.mode, t.stochastic, t.fmt.il, t.fmt.fl) == \
            (j.mode, j.stochastic, j.fmt.il, j.fmt.fl)
        assert t.stochastic is False


def test_package_exports_and_the_validator(capsys):
    """``repro_torch.api`` exports the reference's names; the validator
    passes the example specs (serve ones resolved) and every ported arch x
    run mode, and ``--lower-all`` has no twin."""
    import repro.api as japi
    import repro_torch.api as tapi
    from repro_torch.api import validate

    assert tapi.__all__ == japi.__all__
    assert all(hasattr(tapi, name) for name in tapi.__all__)
    assert validate.main([str(p) for p in EXAMPLES] + ["--roundtrip-all"]) == 0
    assert validate.main(["--lower-all"]) == 1
    err = capsys.readouterr().err
    assert "no twin" in err and "FAIL" not in err.replace("FAIL --lower-all", "")
