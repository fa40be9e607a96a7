"""The port's twins of the reference's examples (``repro_torch.examples``)
and of ``repro.memstash.report``, run on the CPU: each ``main`` completes
as ``tests/test_examples.py`` runs the reference's, with the reference's
printed lines; the report's JSON has the reference's keys, layer names and
element counts (the values differ: each package draws its own random
weights and inputs)."""

from __future__ import annotations

import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.memstash import report as jreport  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402

from repro_torch.examples import quickstart, serve_batched, train_lm  # noqa: E402
from repro_torch.memstash import report as treport  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402


def test_quickstart_main_runs(capsys):
    quickstart.main(steps=1, argv=["--device", "cpu"])
    out = capsys.readouterr().out
    assert "[P1]" in out and "[P2]" in out and "[train]" in out
    assert "bwd dX" in out and "decode exact: True" in out
    assert "zero-free dot == dense dot: True" in out


def test_train_lm_main_runs(tmp_path, capsys):
    res = train_lm.main(steps=1, argv=["--ckpt-dir", str(tmp_path / "ck"), "--device", "cpu"])
    assert res["last_loss"] is not None
    assert "final:" in capsys.readouterr().out
    assert (tmp_path / "ck").exists()


def test_train_lm_default_checkpoints_are_its_own(monkeypatch, tmp_path):
    """The default checkpoint directory lies under the temp directory and is
    not the reference's."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    res = train_lm.main(steps=1, argv=["--device", "cpu"])
    assert res["last_loss"] is not None
    assert (tmp_path / "repro_torch_train_lm").exists()


def test_serve_batched_main_plumbs_engine_flags(capsys):
    out = serve_batched.main(argv=[
        "--batch", "2", "--prompt-len", "6", "--gen", "3", "--slots", "2",
        "--queue", "3", "--mode", "quant_sparse", "--kernel-impl", "ref",
        "--greedy", "--seed", "3", "--device", "cpu",
    ])
    assert out["engine"] and out["finite"]
    assert len(out["per_request"]) == 3
    text = capsys.readouterr().out
    assert "tok/s" in text and "kv:" in text and "req   2" in text


def test_serve_batched_static_spec(capsys):
    out = serve_batched.main(argv=["--spec", "examples/specs/serve_quant_sparse.json",
                                   "--set", "serving.static=true", "--gen", "2",
                                   "--device", "cpu"])
    assert out["finite"] and not out["engine"]
    assert "sample:" in capsys.readouterr().out


@pytest.mark.parametrize("main", [quickstart.main, train_lm.main])
def test_example_twins_default_to_the_card(main):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(steps=1)


# -- memstash.report ----------------------------------------------------------------


def _tiny_cnn(store, ctx, x):
    m = tcnn if isinstance(store, tcnn.ParamStore) else jcnn
    x = m.conv(store, ctx, "c1", x, 16, k=3, stride=2)
    x = m.conv(store, ctx, "c2", x, 32, k=3, stride=2)
    x = m.conv(store, ctx, "c3", x, 32, k=3)
    return m.fc(store, ctx, "head", m.gap(x), 10)


@pytest.fixture
def tiny(monkeypatch):
    """A tiny CNN registered in both packages' PAPER_CNNS."""
    monkeypatch.setitem(jcnn.PAPER_CNNS, "tiny", jcnn.CNNDef("tiny", _tiny_cnn, 16))
    monkeypatch.setitem(tcnn.PAPER_CNNS, "tiny", tcnn.CNNDef("tiny", _tiny_cnn, 16))
    return "tiny"


def _same_layout(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    assert sorted(got["summary"]) == sorted(want["summary"])
    assert [sorted(r) for r in got["rows"]] == [sorted(r) for r in want["rows"]]
    for g, w in zip(got["rows"], want["rows"]):
        assert (g["layer"], g["elems"], g["dtype"]) == (w["layer"], w["elems"], w["dtype"])
    for k in ("model", "kind", "hw", "batch", "seq"):
        assert got.get(k) == want.get(k), k


def test_measure_cnn_stash_has_the_reference_layout(tiny):
    want = jreport.measure_cnn_stash(tiny, hw=16, batch=2)
    got = treport.measure_cnn_stash(tiny, hw=16, batch=2, device="cpu")
    _same_layout(got, want)
    assert got["summary"]["stash_points"] == want["summary"]["stash_points"] == 3


def test_measure_cnn_stash_at_capacity_counts_the_overflow(tiny):
    from repro.memstash.config import MemstashConfig as JMemstash
    from repro_torch.memstash.config import MemstashConfig

    want = jreport.measure_cnn_stash(tiny, hw=16, batch=2,
                                     scfg=JMemstash(policy="stash", capacity=0.5))
    got = treport.measure_cnn_stash(tiny, hw=16, batch=2, device="cpu",
                                    scfg=MemstashConfig(policy="stash", capacity=0.5))
    _same_layout(got, want)
    # the image (density 1) overflows half its buffer in both
    assert got["rows"][0]["overflow"] == want["rows"][0]["overflow"] > 0


def test_measure_lm_stash_has_the_reference_layout():
    want = jreport.measure_lm_stash("llama3.2-1b", batch=2, seq=16)
    got = treport.measure_lm_stash("llama3.2-1b", batch=2, seq=16, device="cpu")
    _same_layout(got, want)
    assert got["summary"]["mean_density"] > 0.99  # a residual stream is dense


def test_report_main_writes_the_reference_json(tiny, tmp_path, capsys):
    treport.main(["--cnn", tiny, "--hw", "200", "--batch", "1", "--out", str(tmp_path),
                  "--device", "cpu"])
    text = capsys.readouterr().out
    assert "clamped to 96" in text and "tiny: 3 points" in text
    data = json.loads((tmp_path / "tiny.json").read_text())
    assert data["hw"] == 96 and data["summary"]["stash_points"] == 3
    assert "wire/formula" in text
