"""Load shedding in the port's serving engine against the reference engine.

The reduced llama3.2-1b in quant_sparse, 2 slots, pool length 64, 6
tokens per request, prompts of 8-12 tokens from ``default_rng(3)`` (the
fixture of ``tests/test_torch_model.py``).  Each case sets deadlines or a
:class:`ShedPolicy`; for every request the port must give the reference's
tokens, ``finished_by``, ``rejected`` and ``finish_tick``, and the same
``n_rejected``.  Both engines run greedy nearest-rounding decode on the CPU,
so the comparison is exact.
"""

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
from repro.serving.scheduler import ShedPolicy as JShedPolicy  # noqa: E402

from repro_torch.configs import get_arch as tget_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch.serve import serving_config as tserving_config  # noqa: E402
from repro_torch.serving.engine import ServingEngine as TEngine  # noqa: E402
from repro_torch.serving.scheduler import ShedPolicy as TShedPolicy  # noqa: E402

PROMPT, GEN, SLOTS, MAX_LEN = 8, 6, 2, 64
FIELDS = ("tokens", "finished_by", "rejected", "finish_tick")

#: case -> (ShedPolicy keywords or None, per-request deadline_ticks)
CASES = {
    "deadline_ticks=1": (None, [1, 1, 1, 1]),
    "max_queue_depth=1": ({"max_queue_depth": 1}, [None] * 5),
    "deadline_aware": ({"deadline_aware": True}, [None, 3, 1, None, 0]),
}


@pytest.fixture(scope="module")
def model():
    jview = jget_arch("llama3.2-1b").view(reduced=True)
    tcfg = tget_arch("llama3.2-1b").resolve(reduced=True)
    jparams = jlm.lm_init(jax.random.PRNGKey(0), jview.config)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tcfg)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, tcfg.vocab, PROMPT + i).tolist() for i in range(5)]
    return jview, tcfg, jparams, tparams, prompts


def _serve(engine, prompts, deadlines) -> dict:
    for i, dl in enumerate(deadlines):
        engine.submit_prompt(prompts[i], GEN, seed=100 + i, deadline_ticks=dl)
    return engine.run()


@pytest.mark.parametrize("case", list(CASES))
def test_port_sheds_as_the_reference_engine(model, case):
    jview, tcfg, jparams, tparams, prompts = model
    policy, deadlines = CASES[case]
    step_cfg = StepConfig(spring=jserving_config("quant_sparse"), optimizer=OptimizerConfig())
    jeng = JEngine(jview, step_cfg, params=jparams, n_slots=SLOTS, max_len=MAX_LEN,
                   shed=None if policy is None else JShedPolicy(**policy))
    teng = TEngine(tcfg, tserving_config("quant_sparse"), params=tparams, n_slots=SLOTS,
                   max_len=MAX_LEN, shed=None if policy is None else TShedPolicy(**policy),
                   device="cpu")
    want, got = _serve(jeng, prompts, deadlines), _serve(teng, prompts, deadlines)
    assert len(got["per_request"]) == len(deadlines)
    for w, g in zip(want["per_request"], got["per_request"]):
        assert {f: g[f] for f in FIELDS} == {f: w[f] for f in FIELDS}, g["rid"]
        if g["rejected"] is not None:
            assert g["tokens"] == [] and g["status"] == "rejected"
    assert got["elastic"]["n_rejected"] == want["elastic"]["n_rejected"] > 0
    assert got["elastic"]["rejected"] == want["elastic"]["rejected"]
    if case == "deadline_ticks=1":
        # requests 2 and 3 wait behind two 6-token requests past their deadline
        assert [r["rejected"] for r in got["per_request"]] == [None, None, "deadline", "deadline"]
        assert [r["finished_by"] for r in got["per_request"][2:]] == ["rejected"] * 2
