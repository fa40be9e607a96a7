"""Port parity, SSM and hybrid training: mamba2-780m (the SSD scan under
autograd, ``kernels.ssd_scan.SSDScan``) and recurrentgemma-9b (the RG-LRU
block's associative scan and the sliding-window chunked attention under
``torch.utils.checkpoint``) trained by ``repro_torch`` against ``repro`` on
the CPU, at the reduced configs.  The reference trains the SSD through its
chunked ``jnp`` form, as the port's CPU path does.

Tolerances (``tests/_torch_train_parity.py`` says why each is what it is):

  * fine (quant_sparse on Q16.60): loss and aux rel 1e-5, every gradient
    within DESIGN.md §8's contract (rtol 1e-5, floor 1e-5 x (max + 1));
  * q4.16 (quant_sparse on the default grid, nearest rounding): loss rel
    1e-5; gradients in the contract's form at rtol 1e-5 for mamba2
    (measured 5.5e-6) and 1e-3 for recurrentgemma (measured 1.97e-4: grid
    steps of 2**-16 that round the other way where an fp32 sum, the
    SSD's and RG-LRU's chunk and scan sums among them, sits within its
    last bit of a tie, amplified through the recurrence);
  * dense: gradients within 5e-2 x max|grad| (measured 3.7e-2 mamba2, 3.1e-2
    recurrentgemma); loss rel 1e-4 for mamba2 (measured 7.7e-5) and 2e-3
    for recurrentgemma (measured 6.3e-4: bf16 states through five layers of
    recurrence and windowed attention);
  * ``SSDScan`` on the CPU: its forward is ``ssd_scan``'s output bit for
    bit and its gradients are autograd's through ``ssd_scan_chunked`` bit
    for bit (the same ops on the same bits);
  * remat policies against no remat: exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_train_parity as tp  # noqa: E402

from repro_torch.kernels.ssd_scan.ops import (SSDScan, ssd_scan, ssd_scan_chunked,  # noqa: E402
                                              ssd_scan_trainable)

MAMBA, RG = "mamba2-780m", "recurrentgemma-9b"
ARCHS = (MAMBA, RG)
#: gradient rtol on the Q4.16 grid, loss rel in the dense mode (the
#: module docstring)
Q416_RTOL = {MAMBA: 1e-5, RG: 1e-3}
DENSE_LOSS_REL = {MAMBA: 1e-4, RG: 2e-3}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the suite's other workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("mode", ["fine", "quant_sparse", "dense"])
@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_lm_loss_and_every_gradient_match_the_reference(arch, mode):
    tp.check_loss_and_grads(arch, mode,
                            loss_rel=DENSE_LOSS_REL[arch] if mode == "dense" else 1e-5,
                            grad_rtol=Q416_RTOL[arch] if mode == "quant_sparse" else 1e-5)


@pytest.mark.parametrize("s,heads,groups,p,n", [(130, 4, 2, 16, 8), (64, 2, 1, 32, 16)])
def test_ssd_scan_function_is_ssd_scan_forward_and_the_chunked_vjp_backward(s, heads, groups,
                                                                           p, n):
    """``SSDScan`` on CPU tensors: y and the final state equal
    ``ssd_scan``'s, and the gradients of a weighted sum of both equal
    autograd's through ``ssd_scan_chunked``; without return_state the
    state's cotangent is absent and the gradients still flow."""
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, heads, p)).astype(np.float32)
    dt = (np.abs(rng.standard_normal((2, s, heads))) * 0.2).astype(np.float32)
    a = -np.linspace(0.5, 2.0, heads).astype(np.float32)
    b, c = (rng.standard_normal((2, s, groups, n)).astype(np.float32) for _ in range(2))
    gy = rng.standard_normal((2, s, heads, p)).astype(np.float32)
    gs = rng.standard_normal((2, heads, n, p)).astype(np.float32)

    def run(fn, with_state):
        ins = [torch.from_numpy(v).requires_grad_(True) for v in (x, dt, a, b, c)]
        y, state = fn(*ins, return_state=True)
        loss = (y * torch.from_numpy(gy)).sum()
        if with_state:
            loss = loss + (state * torch.from_numpy(gs)).sum()
        return y.detach(), state.detach(), torch.autograd.grad(loss, ins)

    for with_state in (True, False):
        y, state, grads = run(ssd_scan_trainable, with_state)
        want_y, want_state, want = run(ssd_scan_chunked, with_state)
        with torch.no_grad():
            plain_y, plain_state = ssd_scan(*(torch.from_numpy(v) for v in (x, dt, a, b, c)),
                                            return_state=True)
        assert torch.equal(y, plain_y) and torch.equal(state, plain_state)
        assert torch.equal(y, want_y) and torch.equal(state, want_state)
        for got, w in zip(grads, want):
            assert torch.equal(got, w)
    y = SSDScan.apply(*(torch.from_numpy(v) for v in (x, dt, a, b, c)))[0]
    assert not y.requires_grad


@pytest.mark.parametrize("policy", ["full", "block_io", "stash"])
@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_remat_policies_equal_no_remat(arch, policy):
    """The SSD scan, the RG-LRU associative scan and the windowed chunked
    attention recompute under ``torch.utils.checkpoint`` and the stash."""
    tp.check_remat_policy(arch, policy)


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_stashed_unit_matches_the_reference(arch):
    tp.check_stash_against_reference(arch)


@pytest.mark.parametrize("kind", ["adamw", "sgdm"])
@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_three_train_steps_match_the_reference(arch, kind):
    tp.check_three_train_steps(arch, kind)


def test_a_reference_checkpoint_of_mamba2_resumes_in_the_port(tmp_path):
    tp.check_reference_checkpoint_resumes(MAMBA, tmp_path)
