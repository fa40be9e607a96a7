"""The port's architecture registry against the reference's: minitron-4b
and mistral-nemo-12b (attention + SwiGLU, RMS norm, head_dim 128 in the
published configs, untied ``lm_head``).

  * the full and reduced ``LMConfig``s equal the reference's field by
    field (the reference's extra fields at their defaults), with the
    same source strings, and ``check_supported`` takes them;
  * reduced, with the reference's parameters (``convert.params_from_jax``),
    3 slots, 4 requests of 8-11 tokens from ``default_rng(5)``, 6 tokens
    each in quant_sparse: the port's monolithic and paged engines serve
    the reference engine's greedy tokens, ``finished_by`` and
    ``finish_tick`` (exact: nearest-rounding decode on the CPU).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.launch.serve import serving_config as jserving_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim.optimizers import OptimizerConfig  # noqa: E402
from repro.runtime.train import StepConfig  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402

from repro_torch.configs import ARCHS, get_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch.serve import serving_config  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.paging import PagedServingEngine  # noqa: E402

NEW = ["minitron-4b", "mistral-nemo-12b"]
FIELDS = ("tokens", "finished_by", "finish_tick")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_config(port, ref) -> None:
    """Every field of the port's config (and of its AttnSpec) equals the
    reference's; the reference's other fields hold their defaults."""
    for f in dataclasses.fields(port):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(a):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), f.name
        else:
            assert a == b, f.name
    mine = {f.name for f in dataclasses.fields(port)}
    for f in dataclasses.fields(ref):
        if f.name not in mine:
            assert getattr(ref, f.name) == f.default, f.name


@pytest.mark.parametrize("arch", NEW)
def test_configs_equal_the_reference(arch):
    port, ref = get_arch(arch), jget_arch(arch)
    _same_config(port.config, ref.config)
    _same_config(port.reduced(), ref.reduced())
    assert (port.arch_id, port.family, port.source) == (ref.arch_id, ref.family, ref.source)
    port.config.check_supported()
    port.reduced().check_supported()
    assert port.config.attn.head_dim == 128


def test_registry():
    assert set(ARCHS) == {"llama3.2-1b", "mamba2-780m", "minitron-4b", "mistral-nemo-12b",
                          "qwen2-7b", "recurrentgemma-9b", "olmoe-1b-7b",
                          "deepseek-v2-lite-16b", "internvl2-26b", "whisper-medium"}
    assert get_arch("mistral-nemo-12b").source == "hf:mistralai/Mistral-Nemo-Base-2407"
    assert get_arch("minitron-4b").source == "arXiv:2407.14679"
    # head_dim is explicit: d_model / n_heads would give 160
    nemo = get_arch("mistral-nemo-12b").config
    assert nemo.d_model // nemo.attn.n_heads == 160 != nemo.attn.head_dim
    # all ten of the reference's archs, the image prefix and the encoder-decoder too
    assert get_arch("internvl2-26b").config.vlm_prefix_len == 256
    assert get_arch("whisper-medium").is_encdec and not get_arch("internvl2-26b").is_encdec


@pytest.mark.parametrize("arch", NEW)
def test_reduced_arch_serves_the_reference_tokens(arch):
    jview = jget_arch(arch).view(reduced=True)
    cfg = get_arch(arch).resolve(reduced=True)
    jparams = jlm.lm_init(jax.random.PRNGKey(0), jview.config)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    assert "lm_head" in params  # untied
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, 8 + i).tolist() for i in range(4)]
    kw = dict(n_slots=3, max_len=20)

    def serve(eng):
        for i, p in enumerate(prompts):
            eng.submit_prompt(p, 6, seed=100 + i)
        return eng.run()

    step_cfg = StepConfig(spring=jserving_config("quant_sparse"), optimizer=OptimizerConfig())
    want = serve(JEngine(jview, step_cfg, params=jparams, **kw))
    spring = serving_config("quant_sparse")
    mono = serve(ServingEngine(cfg, spring, params=params, device="cpu", **kw))
    paged = serve(PagedServingEngine(cfg, spring, params=params, device="cpu", page_tokens=8,
                                     **kw))
    for out in (mono, paged):
        assert out["finite"]
        for w, g in zip(want["per_request"], out["per_request"]):
            assert {f: g[f] for f in FIELDS} == {f: w[f] for f in FIELDS}, (arch, g["rid"])
