"""Port parity, the paper's evaluation path: ``repro_torch.perfmodel`` and
the ``bench_table1`` / ``bench_paper_figs`` / ``bench_compression`` twins
against ``repro.perfmodel`` and ``benchmarks/`` on the CPU.

The model is the same arithmetic on the same layer tables (the port's are
built on the ``meta`` device), so every row is held at rel 1e-12: Table 1
and Figs. 11-16 for all seven CNNs, training and inference, with the
analytic density product and with measured skip fractions; the
``measured_*`` bridges on the same instrumentation rows; and the Fig. 5
worked example at 2.29x.
"""

import functools

import pytest

torch = pytest.importorskip("torch")

from benchmarks import bench_paper_figs as jfigs  # noqa: E402
from benchmarks import bench_table1 as jt1  # noqa: E402
from repro.memstash import format as jfmt  # noqa: E402
from repro.models.cnn import PAPER_CNNS as J_CNNS  # noqa: E402
from repro.perfmodel import spring_model as jsm  # noqa: E402

from repro_torch.benchmarks import bench_compression as tbc  # noqa: E402
from repro_torch.benchmarks import bench_paper_figs as tfigs  # noqa: E402
from repro_torch.benchmarks import bench_table1 as tt1  # noqa: E402
from repro_torch.memstash import format as tfmt  # noqa: E402
from repro_torch.models.cnn import PAPER_CNNS as T_CNNS  # noqa: E402
from repro_torch.perfmodel import spring_model as tsm  # noqa: E402

REL = 1e-12
FIGS = sorted(set(jfigs._FIG.values()))


def assert_rows_equal(got, want) -> None:
    assert [r[0] for r in got] == [r[0] for r in want]
    for g, w in zip(got, want):
        assert g[1] == pytest.approx(w[1], rel=REL, abs=1e-300), g[0]
        assert g[2] == pytest.approx(w[2], rel=REL, abs=1e-300), g[0]


@functools.cache
def fig_rows():
    return tfigs.rows(), jfigs.rows()


def test_table1_rows_equal_the_reference():
    assert tt1.rows() == jt1.rows()
    assert vars(tsm.SPRING_DESIGN) == vars(jsm.SPRING_DESIGN)
    assert vars(tsm.GPU_1080TI) == vars(jsm.GPU_1080TI)
    assert tfigs.PAPER_GEOMEANS == jfigs.PAPER_GEOMEANS


@pytest.mark.parametrize("fig", FIGS)
def test_paper_figure_rows_equal_the_reference(fig):
    """All seven CNNs, the geomean and the paper's geomean of one figure."""
    got, want = fig_rows()
    got = [r for r in got if r[0].startswith(fig + ".")]
    want = [r for r in want if r[0].startswith(fig + ".")]
    assert len(want) == len(J_CNNS) + 2
    assert_rows_equal(got, want)


@pytest.mark.parametrize("training", [True, False])
def test_evaluate_cnn_with_measured_skips_equals_the_reference(training):
    """The fractions ``sparsity_probe`` measures at density 0.5 and size
    512 (they depend only on the tile pattern)."""
    skips = {"compute_skip_fraction": 0.78125, "backward_skip_fraction": 0.65625}
    assert sorted(T_CNNS) == sorted(J_CNNS)
    for name in J_CNNS:
        got = tsm.evaluate_cnn(T_CNNS[name], training=training, **skips)
        want = jsm.evaluate_cnn(J_CNNS[name], training=training, **skips)
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k] == (v if isinstance(v, str) else pytest.approx(v, rel=REL)), (name, k)
    got = tfigs.rows(**skips)
    assert [r[0] for r in got] == [r[0] for r in fig_rows()[1]]


@pytest.mark.parametrize("training", [True, False])
def test_spring_and_gpu_eval_with_a_link_term_equal_the_reference(training):
    import dataclasses

    from repro.models.cnn import cnn_layer_table as j_table

    from repro_torch.models.cnn import cnn_layer_table as t_table

    t_design = dataclasses.replace(tsm.SPRING_DESIGN, ici_bw=450e9)
    j_design = dataclasses.replace(jsm.SPRING_DESIGN, ici_bw=450e9)
    kw = dict(training=training, act_sparsity=0.3, w_sparsity=0.6, collective_bytes=3e8)
    t_rec, j_rec = t_table(T_CNNS["mobilenet_v2"]), j_table(J_CNNS["mobilenet_v2"])
    got = tsm.spring_eval(t_rec, 32, design=t_design, **kw)
    want = jsm.spring_eval(j_rec, 32, design=j_design, **kw)
    for g, w in zip(dataclasses.astuple(got), dataclasses.astuple(want)):
        assert g == pytest.approx(w, rel=REL)
    got = tsm.gpu_eval(t_rec, 32, training=training)
    want = jsm.gpu_eval(j_rec, 32, training=training)
    assert dataclasses.astuple(got) == pytest.approx(dataclasses.astuple(want), rel=REL)
    assert tsm.geomean([1.0, 4.0, 16.0]) == jsm.geomean([1.0, 4.0, 16.0])


ROWS = [
    {"op": "masked_matmul", "tile_skip": 0.25},
    {"op": "masked_matmul", "tile_skip": 0.5},
    {"op": "masked_matmul_dx", "tile_skip": 0.125},
    {"op": "masked_matmul_dw", "tile_skip": 0.75},
    {"op": "kv_pack", "wire_bytes": 1234.0, "density": 0.4},
    {"op": "kv_pack", "wire_bytes": 99.5, "density": 0.7},
    {"op": "mask_pack", "wire_bytes": 128.0},
    {"op": "packed_all_gather", "wire_bytes": 10.0},
    {"op": "packed_reduce_scatter", "wire_bytes": 32.0},
]
BRIDGES = ["measured_skip_fraction", "measured_backward_skip_fraction", "measured_kv_density",
           "measured_kv_wire_bytes", "measured_collective_wire_bytes"]


@pytest.mark.parametrize("bridge", BRIDGES)
@pytest.mark.parametrize("rows", [ROWS, ROWS[:1] + ROWS[4:5], ROWS[2:3], []],
                         ids=["all", "fwd+kv", "dx only", "none"])
def test_measured_bridges_equal_the_reference(bridge, rows):
    assert getattr(tsm, bridge)(rows) == getattr(jsm, bridge)(rows)


def test_measured_bridges_read_the_port_s_recorded_rows():
    from repro_torch.kernels import registry
    from repro_torch.kernels.kv_cache.ops import kv_pack
    from repro_torch.kernels.masked_matmul import backward as bwd
    from repro_torch.kernels.masked_matmul import ops as mm

    x, w = torch.zeros(256, 384), torch.zeros(384, 256)
    x[:128, :256], w[128:, :] = 1.0, 1.0  # block-pruned: whole 128-tiles empty
    x.requires_grad_(True), w.requires_grad_(True)
    blk = torch.zeros(1000)
    blk[:300] = 1.0
    with registry.record_kernel_metrics() as rows:
        mm.masked_matmul(x, w, apply_sr=False, backward="auto").sum().backward()
        kv_pack(blk)
    g = torch.ones(256, 256)
    assert tsm.measured_skip_fraction(rows) == mm.tile_skip_fraction(x, w) == 1 - 2 / 12
    assert tsm.measured_backward_skip_fraction(rows) == (
        bwd.backward_tile_skip(g, w.T) + bwd.backward_tile_skip(x.T, g)) / 2
    assert tsm.measured_kv_density(rows) == pytest.approx(0.3)
    assert tsm.measured_kv_wire_bytes(rows) == (300 * 20 + 32 * 32) / 8
    assert tsm.measured_collective_wire_bytes(rows) is None  # no collective ran
    from repro_torch.dist.collectives import collective_probe

    with registry.record_kernel_metrics() as rows:
        probe = collective_probe(0.5, world=2, length=1 << 12)
    assert tsm.measured_collective_wire_bytes(rows) == probe["wire_bytes"]


def test_fig5_worked_example_reads_2_29():
    """``bench_compression``'s first row: 16 elements, 6 non-zeros at the
    reference's positions, 16-bit values."""
    import jax.numpy as jnp

    from repro.core.masking import compression_ratio, mask_encode

    example = jnp.zeros((16,)).at[jnp.array([1, 3, 6, 9, 12, 15])].set(1.0)
    got = tbc.fig5_example()
    assert got == float(compression_ratio(mask_encode(example), 16))
    assert round(got, 2) == 2.29


@pytest.mark.parametrize("density", [0.0, 0.5, 1.0])
def test_formula_bits_per_elem_has_the_reference_signature(density):
    for value_bits in (16, 20, tsm.SPRING_DESIGN.value_bits):
        assert tfmt.formula_bits_per_elem(density, value_bits) == jfmt.formula_bits_per_elem(
            density, value_bits)
    assert tfmt.formula_bits_per_elem(density) == jfmt.formula_bits_per_elem(density)
