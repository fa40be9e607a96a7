"""Port parity, the kernel parity table and its instrumentation:
``repro_torch.kernels.registry`` and ``repro_torch.benchmarks.bench_kernels``
against ``repro.kernels.registry`` and ``benchmarks/bench_kernels.py`` on
the CPU.

- The table lists every op of the reference that the port has ported, with
  as many examples, case for case of the same shapes, dtypes, kwargs and
  compare specs; the sparsities agree to within sampling noise (the port
  draws from numpy seeds, not ``jax.random`` keys).
- Each plain version, fed the reference's own example arrays, meets the
  reference's oracle under the reference's compare (``mask_pack`` and
  ``kv_pack`` pack along the last axis, so they get the flattened array).
- ``compare_outputs`` passes, returns and raises as the reference's does.
- The metric rows of the instrumented wrappers carry the reference's keys
  and values on the same inputs; tile-skip fractions are a float32 ratio
  in the reference and a float64 one here, so they are held at rel 1e-6.
- The CPU sweep exits 0, and exits 1 when a plain version breaks its
  compare.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import registry as jreg  # noqa: E402
from repro.kernels.kv_cache import ops as jkv  # noqa: E402
from repro.kernels.mask_compress import ops as jmc  # noqa: E402
from repro.kernels.masked_matmul import backward as jbwd  # noqa: E402
from repro.kernels.masked_matmul import ops as jmm  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.benchmarks import bench_kernels  # noqa: E402
from repro_torch.kernels import registry as treg  # noqa: E402
from repro_torch.kernels.kv_cache import ops as tkv  # noqa: E402
from repro_torch.kernels.mask_compress import ops as tmc  # noqa: E402
from repro_torch.kernels.masked_matmul import backward as tbwd  # noqa: E402
from repro_torch.kernels.masked_matmul import ops as tmm  # noqa: E402

#: the reference's ops the table does not list (every one is ported)
NOT_PORTED: set = set()
#: ops whose kernel is a pack that counts its launches as mask_pack's
PACKS = ("kv_pack", "packed_all_gather", "packed_reduce_scatter")
PORTED = sorted(treg.ops())


def to_torch(a) -> "torch.Tensor":
    """numpy / jax array -> torch tensor with the same bits (bf16 too)."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def to_numpy(t):
    if isinstance(t, dict):
        return {k: to_numpy(v) for k, v in t.items()}
    if isinstance(t, (tuple, list)):
        return type(t)(to_numpy(v) for v in t)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).view(jnp.bfloat16)
    return t.numpy()


@functools.cache
def ref_examples(op: str) -> list:
    spec = jreg.op_spec(op)
    return spec.examples() if spec.examples is not None else None


@functools.cache
def port_examples(op: str) -> list:
    spec = treg.op_spec(op)
    return spec.examples() if spec.examples is not None else None


def leaf_info(a):
    """(shape, dtype name) of an array leaf, or the python value of a scalar."""
    if isinstance(a, torch.Tensor):
        return tuple(a.shape), str(a.dtype).replace("torch.", "")
    a = np.asarray(a)
    if a.ndim == 0:
        return int(a)
    return tuple(a.shape), str(a.dtype)


def density(a) -> float:
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    return float((a != 0).mean())


def test_table_lists_every_ported_reference_op():
    assert set(jreg.ops()) - set(PORTED) == NOT_PORTED
    assert set(PORTED) <= set(jreg.ops())
    for op in PORTED:
        spec = treg.op_spec(op)
        assert spec.compare == jreg.op_spec(op).compare_spec(), op
        if spec.kernel is not None and op not in PACKS:  # the packs count as mask_pack
            assert spec.kernel in kernels.WRAPPERS.values(), op
    # the TPU aliases of the plain lowering: a plain version only
    assert treg.op_spec("mask_unpack").kernel is None and treg.op_spec("kv_unpack").kernel is None


@pytest.mark.parametrize("op", PORTED)
def test_examples_match_the_reference_case_for_case(op):
    ref, port = ref_examples(op), port_examples(op)
    if ref is None:
        assert port is None
        return
    assert len(port) == len(ref)
    for i, (r, p) in enumerate(zip(ref, port)):
        assert len(p) == len(r), (op, i)
        assert p[1] == r[1], (op, i)            # kwargs
        if len(r) > 2:
            assert p[2] == r[2], (op, i)        # per-case compare override
        r_args, p_args = r[0], p[0]
        assert len(p_args) == len(r_args)
        for ra, pa in zip(r_args, p_args):
            assert leaf_info(pa) == leaf_info(ra), (op, i)
            if not isinstance(pa, torch.Tensor):
                continue
            n = pa.numel()
            tol = 3.5 / np.sqrt(n) if n else 0.0  # ~5 sigma of the difference of two draws
            assert abs(density(pa) - density(ra)) <= tol, (op, i, density(pa), density(ra))
            if density(ra) == 0.0:
                assert density(pa) == 0.0       # the all-zero cases stay all zero


def _oracle_case(op, case):
    """(port plain output, reference oracle output) on the reference's arrays."""
    args, kwargs = case[0], case[1]
    t_args = [to_torch(a) if np.ndim(a) else int(a) for a in args]
    if op in ("mask_pack", "kv_pack"):  # packs along the last axis: flatten
        t_args[0] = t_args[0].reshape(-1)
    got = to_numpy(treg.op_spec(op).plain(*t_args, **kwargs))
    want = jreg.impls(op)[jreg.op_spec(op).oracle].fn(*args, **kwargs)
    if op == "mask_pack":  # the JAX op pads to whole (8, 1024) kernel blocks
        n_words = got.size
        assert not np.asarray(want)[n_words:].any()
        want = np.asarray(want)[:n_words]
    return got, want


@pytest.mark.parametrize("op", [op for op in PORTED if op != "mask_unpack"])
def test_plain_versions_meet_the_reference_oracles(op):
    for case in ref_examples(op):
        got, want = _oracle_case(op, case)
        jreg.compare_outputs(op, got, want, case[2] if len(case) > 2 else None)


CMP_CASES = [
    ("exact equal", "mask_pack", [1.0, 2.0], [1.0, 2.0], None),
    ("exact differ", "mask_pack", [1.0, 2.0], [1.0, 2.5], None),
    ("allclose within", "flash_attention", [1.0, 2.0], [1.0, 2.0 + 1e-5], None),
    ("allclose out", "flash_attention", [1.0, 2.0], [1.0, 2.0 + 1e-4], None),
    ("allclose rtol", "flash_attention", [1.0, 2.0], [1.0, 2.1],
     {"kind": "allclose", "atol": 0.0, "rtol": 0.1}),
    ("rel within", "ssd_scan", [10.0, 20.0], [10.0, 20.001], None),
    ("rel out", "ssd_scan", [10.0, 20.0], [10.0, 20.1], None),
    ("override", "mask_pack", [1.0, 2.0], [1.0, 2.01],
     {"kind": "allclose", "atol": 2e-2, "rtol": 0.0}),
    ("unknown kind", "mask_pack", [1.0], [1.0], {"kind": "close"}),
    ("tuple leaves", "dangling_filter", ([1.0], [0.0]), ([1.0], [0.0]), None),
    ("dict leaves", "kv_pack", {"values": [1.0], "mask": [3], "nnz": 1},
     {"values": [1.0], "mask": [3], "nnz": 1}, None),
]


@pytest.mark.parametrize("name,op,got,want,override", CMP_CASES, ids=[c[0] for c in CMP_CASES])
def test_compare_outputs_passes_and_raises_as_the_reference(name, op, got, want, override):
    def outcome(fn, wrap):
        try:
            return ("ok", fn(op, wrap(got), wrap(want), override))
        except (AssertionError, ValueError) as e:
            return (type(e).__name__, None)

    def as_torch(tree):
        if isinstance(tree, dict):
            return {k: as_torch(v) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(as_torch(v) for v in tree)
        return torch.tensor(tree)

    def as_jax(tree):
        if isinstance(tree, dict):
            return {k: as_jax(v) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(as_jax(v) for v in tree)
        return jnp.asarray(tree)

    assert outcome(treg.compare_outputs, as_torch) == outcome(jreg.compare_outputs, as_jax)


METRIC_CASES = [(op, i) for op, n in (("masked_matmul", 5), ("masked_matmul_dx", 5),
                                      ("masked_matmul_dw", 5), ("mask_pack", 3), ("kv_pack", 4))
                for i in range(n)]


@pytest.mark.parametrize("op,case", METRIC_CASES)
def test_metric_rows_match_the_reference(op, case):
    args, kwargs = ref_examples(op)[case][:2]
    ref_fn = {"masked_matmul": jmm.masked_matmul, "masked_matmul_dx": jbwd.masked_matmul_dx,
              "masked_matmul_dw": jbwd.masked_matmul_dw, "mask_pack": jmc.mask_pack,
              "kv_pack": jkv.kv_pack}[op]
    port_fn = {"masked_matmul": tmm.masked_matmul, "masked_matmul_dx": tbwd.masked_matmul_dx,
               "masked_matmul_dw": tbwd.masked_matmul_dw, "mask_pack": tmc.mask_pack,
               "kv_pack": tkv.kv_pack}[op]
    t_args = [to_torch(a).reshape(-1) if op in ("mask_pack", "kv_pack")
              else (to_torch(a) if np.ndim(a) else int(a)) for a in args]
    with jreg.record_kernel_metrics() as want:
        ref_fn(*args, **kwargs)
    assert not treg.metrics_active()
    with treg.record_kernel_metrics() as got:
        assert treg.metrics_active()
        port_fn(*t_args, **kwargs)
    assert not treg.metrics_active()
    assert len(got) == len(want) == 1
    assert set(got[0]) == set(want[0])
    for key in want[0]:
        if key == "op":
            assert got[0]["op"] == want[0]["op"] == op
        else:
            assert got[0][key] == pytest.approx(float(want[0][key]), rel=1e-6, abs=1e-7), key


def test_hooks_note_nothing_outside_a_recorder():
    x = torch.ones(4, 8)
    with treg.record_kernel_metrics() as rows:
        with treg.record_kernel_metrics() as inner:
            tmm.masked_matmul(x, torch.ones(8, 3), apply_sr=False)
        tmc.mask_pack(x)
    assert [r["op"] for r in inner] == ["masked_matmul"] and [r["op"] for r in rows] == [
        "mask_pack"]
    tmc.mask_pack(x)  # no recorder: nothing to note, nothing raised
    assert treg.metric_summary(rows + inner) == {"mask_pack": {"wire_bytes": 16.0},
                                                 "masked_matmul": {"tile_skip": 0.0}}


def test_sparsity_probe_keys_match_the_reference_and_its_hooks():
    from repro.kernels.masked_matmul.backward import sparsity_probe as jprobe

    got = tbwd.sparsity_probe(density=0.5, size=256, device="cpu")
    assert set(got) == set(jprobe(density=0.5, size=256))
    assert got["density"] == 0.5 and got["size"] == 256
    for key in ("forward_tile_skip", "backward_tile_skip_dx", "backward_tile_skip_dw"):
        assert 0.0 < got[key] < 1.0
    assert got["backward_tile_skip"] == pytest.approx(
        (got["backward_tile_skip_dx"] + got["backward_tile_skip_dw"]) / 2)
    full = tbwd.sparsity_probe(density=1.0, size=256, device="cpu")
    assert full["forward_tile_skip"] == 0.0


def test_bench_kernels_smoke_on_the_cpu_exits_0(capsys):
    with pytest.raises(SystemExit) as e:
        bench_kernels.main(["--smoke", "--device", "cpu"])
    assert e.value.code == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "name,us_per_case,worst,route,cases"
    rows = {ln.split(",")[0].split(".")[2]: ln.split(",") for ln in lines[1:]}
    assert sorted(rows) == PORTED
    for op, row in rows.items():
        assert row[3] == "plain" and int(row[4]) == len(port_examples(op) or [])


def test_bench_kernels_smoke_exits_1_when_a_compare_breaks(monkeypatch, capsys):
    spec = treg.op_spec("stochastic_round")

    def off_by_one_ulp(x, seed, **kw):
        return torch.nextafter(spec.plain(x, seed, **kw), torch.tensor(1e9))

    # the CPU wrapper runs the plain version: break it, against an oracle
    monkeypatch.setitem(treg._table(), "stochastic_round",
                        treg.OpSpec(spec.name, off_by_one_ulp, spec.plain, spec.examples,
                                    spec.compare, spec.plain))
    with pytest.raises(SystemExit) as e:
        bench_kernels.main(["--smoke", "--device", "cpu"])
    assert e.value.code == 1
    assert "PARITY FAILURE: stochastic_round.plain" in capsys.readouterr().err
