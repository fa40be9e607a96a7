"""The kernel parity table and the eager instrumentation (port of
``repro/kernels/registry.py``).

One table, :func:`op_spec` / :func:`ops`: op name -> the wrapper that
launches its CUDA kernel, its plain PyTorch version, its example inputs
and its compare spec.  ``benchmarks.bench_kernels --smoke`` walks it: on
the card each wrapper is held against its plain version on the same card
tensors, on the CPU each plain version against an independent oracle
(the numpy oracles of ``ref.py``, a float64 product, the sequential SSD)
where the op has one.  The examples are the reference's own, case for
case: the same shapes, sparsities, kwargs, block-pruned and all-zero
cases and per-case compare overrides, drawn from numpy seeds instead of
``jax.random`` keys.  :func:`compare_outputs` is the one interpreter of
the compare contract.

What the port decided against is not here: no availability-based
auto-pick, no ``KernelPolicy`` and no ``SPRING_KERNEL_IMPL`` (a wrapper
launches its kernel on a CUDA tensor or raises, and runs its plain
version on a CPU tensor).  ``mask_unpack`` and ``kv_unpack``, whose TPU
registrations aliased the plain lowering, have a plain version only.
The reference's ``packed_all_gather`` / ``packed_reduce_scatter`` wait
for the ``dist/`` port.

Eager instrumentation: inside :func:`record_kernel_metrics`, or inside
an active telemetry scope, the instrumented wrappers (``masked_matmul``,
``masked_matmul_dx`` / ``_dw``, ``mask_pack``, ``kv_pack``) note host-side
scalars with the reference's keys, which ``perfmodel`` reads; every noted
value also lands in the telemetry registry as a
``spring_kernel_<key>{op=...}`` histogram, as in the reference.  Outside
both they note nothing and cost nothing (no device read, no host sync).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import telemetry

# -- eager instrumentation ------------------------------------------------------


#: rows of the innermost active recorder; process-wide, not per thread as
#: in the reference, because the backward of a CUDA tensor runs on the
#: autograd engine's device thread, whose dx/dw rows belong to the block
_rows: Optional[list] = None


@contextlib.contextmanager
def record_kernel_metrics():
    """Collect the instrumentation rows of the calls made in the block."""
    global _rows
    prev, _rows = _rows, []
    try:
        yield _rows
    finally:
        _rows = prev


def metrics_active() -> bool:
    """Should the hooks compute their scalars?  Inside a recorder or an
    active telemetry scope: the scalars cost a device read."""
    return _rows is not None or telemetry.enabled()


#: prefix of the per-key histograms noted values feed (the reference's)
KERNEL_METRIC_PREFIX = "spring_kernel_"


def note_metric(op: str, **values: float) -> None:
    """Record one instrumentation row: in the active recorder, if any,
    and always in the telemetry registry as ``spring_kernel_<key>{op=...}``
    histograms."""
    if _rows is not None:
        _rows.append(dict(values, op=op))
    reg = telemetry.default_registry()
    for key, v in values.items():
        reg.observe(KERNEL_METRIC_PREFIX + key, float(v), op=op,
                    help=f"eager kernel instrumentation: {key} per op")


def metric_summary(rows: list) -> dict[str, dict[str, float]]:
    """Mean of each recorded metric key per op: {op: {key: mean}}."""
    acc: dict[str, dict[str, list]] = {}
    for row in rows:
        op = row["op"]
        for k, v in row.items():
            if k == "op":
                continue
            acc.setdefault(op, {}).setdefault(k, []).append(float(v))
    return {op: {k: sum(v) / len(v) for k, v in kv.items()}
            for op, kv in acc.items()}


# -- the compare contract -----------------------------------------------------------


def _leaves(tree) -> list:
    """Leaves in the order of ``jax.tree_util.tree_leaves`` (dict keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [tree]


def _float64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        x = x.to(torch.float64) if x.dtype.is_floating_point else x.to(torch.int64)
        return x.numpy().astype(np.float64)
    return np.asarray(x, dtype=np.float64)


def compare_outputs(op: str, got: Any, want: Any, case_compare: Optional[dict] = None) -> float:
    """Check ``got`` against ``want`` under the op's compare spec (or a
    per-case override), raising AssertionError on a violation.  Returns
    the measured deviation (0.0 for exact specs).  Specs:
    ``{"kind": "exact"}``, ``{"kind": "allclose", "atol", "rtol"}`` and
    ``{"kind": "rel", "tol"}`` (max-abs error over max-abs ``want``), all
    taken in float64."""
    spec = case_compare or op_spec(op).compare
    got_l, want_l = _leaves(got), _leaves(want)
    assert len(got_l) == len(want_l)
    worst = 0.0
    for g, w in zip(got_l, want_l):
        g, w = _float64(g), _float64(w)
        if spec["kind"] == "exact":
            assert (g == w).all(), f"{op}: impl must be bit-identical to oracle"
        elif spec["kind"] == "allclose":
            err = float(np.max(np.abs(g - w))) if g.size else 0.0
            assert err <= spec["atol"] + spec.get("rtol", 0.0) * float(np.max(np.abs(w))), \
                f"{op}: max err {err} > atol {spec['atol']}"
            worst = max(worst, err)
        elif spec["kind"] == "rel":
            denom = float(np.max(np.abs(w))) + 1e-12
            rel = float(np.max(np.abs(g - w))) / denom
            assert rel <= spec["tol"], f"{op}: rel err {rel} > {spec['tol']}"
            worst = max(worst, rel)
        else:
            raise ValueError(f"unknown compare kind {spec['kind']!r}")
    return worst


# -- examples: the reference's cases, from numpy seeds ----------------------------------


def _t(a: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dtype)


def _mm_operand(seed: int, shape, sparsity: float = 0.5, fl: int = 8) -> np.ndarray:
    rng = np.random.default_rng(seed)
    v = np.round(rng.standard_normal(shape) * 2**6) / 2**fl
    return (v * (rng.random(shape) > sparsity)).astype(np.float32)


def _sparse_mat(seed: int, shape, sparsity: float, scale: float = 0.1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(shape) * scale
    return (v * (rng.random(shape) > sparsity)).astype(np.float32)


def _mm_examples() -> list:
    """``masked_matmul/ops.py:52-71``."""
    cases = [((_t(_mm_operand(m * 7 + k, (m, k))), _t(_mm_operand(n * 13 + k, (k, n))), 5), {})
             for m, k, n in [(128, 128, 128), (100, 70, 50), (64, 512, 200)]]
    x = _mm_operand(0, (256, 384), 0.3)
    x[:128, :256] = 0.0
    w = _mm_operand(1, (384, 256), 0.3)
    w[256:, 128:] = 0.0
    cases.append(((_t(x), _t(w), 3), {}))
    cases.append(((_t(x), _t(w), 3), {"apply_sr": False},
                  {"kind": "allclose", "atol": 1e-6, "rtol": 0.0}))
    return cases


def _dx_examples() -> list:
    """``masked_matmul/backward.py:137-150``."""
    cases = [((_t(_sparse_mat(m + n, (m, n), s)), _t(_sparse_mat(k * 3 + n, (k, n), s))), {})
             for m, k, n, s in [(128, 128, 128, 0.5), (100, 70, 50, 0.3), (64, 200, 512, 0.7)]]
    g = _sparse_mat(0, (256, 256), 0.2)
    g[:128, :] = 0.0
    cases.append(((_t(g), _t(_sparse_mat(1, (256, 256), 0.2))), {}))
    cases.append(((torch.zeros(64, 64), _t(_sparse_mat(2, (64, 64), 0.5))), {}))
    return cases


def _dw_examples() -> list:
    """``masked_matmul/backward.py:153-163``."""
    cases = [((_t(_sparse_mat(m * 5 + k, (m, k), s)), _t(_sparse_mat(m + n * 7, (m, n), s))), {})
             for m, k, n, s in [(128, 128, 128, 0.5), (100, 70, 50, 0.3), (512, 64, 200, 0.7)]]
    x = _sparse_mat(3, (256, 384), 0.2)
    x[:, 256:] = 0.0
    cases.append(((_t(x), _t(_sparse_mat(4, (256, 256), 0.2))), {}))
    cases.append(((_t(_sparse_mat(5, (64, 64), 0.5)), torch.zeros(64, 64)), {}))
    return cases


def _sparse_vec(seed: int, n: int, sparsity: float) -> np.ndarray:
    return _sparse_mat(seed, (n,), sparsity, scale=1.0)


def _pack_examples() -> list:
    """``mask_compress/ops.py:67-70``."""
    return [((_t(_sparse_vec(5, 777, 0.4)),), {}),
            ((_t(_sparse_vec(6, 4096, 0.6)),), {}),
            ((_t(_sparse_vec(7, 1000, 0.5).reshape(10, 100)),), {})]


def _dangling_examples() -> list:
    """``mask_compress/ops.py:73-76``."""
    return [((_t(_sparse_vec(0, 5000, 0.5)), _t(_sparse_vec(2, 5000, 0.6))), {}),
            ((_t(_sparse_vec(3, 640, 0.3).reshape(32, 20)),
              _t(_sparse_vec(4, 640, 0.7).reshape(32, 20))), {})]


def _kv_block(seed: int, n: int, live_rows: int, total_rows: int,
              dtype=torch.bfloat16) -> torch.Tensor:
    """A slot-pool-shaped block: the first ``live_rows`` of ``total_rows``
    rows dense, the tail zero (``kv_cache/ops.py:143-152``)."""
    x = np.random.default_rng(seed).standard_normal((total_rows, n // total_rows))
    x[live_rows:] = 0.0
    return _t(x, dtype).reshape(-1)[:n]


def _kv_pack_examples() -> list:
    """``kv_cache/ops.py:155-161``."""
    return [((_kv_block(0, 4096, 9, 16),), {}),
            ((_kv_block(1, 4096, 16, 16, torch.float32),), {}),
            ((_kv_block(2, 1000, 3, 10, torch.float32),), {}),
            ((torch.zeros(640, dtype=torch.bfloat16),), {})]


def _kv_unpack_examples() -> list:
    """``kv_cache/ops.py:164-170``: the packed forms of the pack examples."""
    from repro_torch.kernels.kv_cache.ops import kv_pack_reference

    out = []
    for (x,), _ in _kv_pack_examples():
        packed = kv_pack_reference(x)
        out.append(((packed["values"], packed["mask"]), {"length": x.numel()}))
    return out


def _sr_examples() -> list:
    """``stochastic_round/ops.py:30-37``."""
    cases = [((_t(np.random.default_rng(42 + i).standard_normal(shape) * 3), 9), {})
             for i, shape in enumerate([(128,), (333, 17), (8, 1024), (3, 5, 9)])]
    x = _t(np.random.default_rng(4).standard_normal((256, 64)) * 3)
    cases.append(((x, 9), {"il": 2, "fl": 6}))
    return cases


def _fa_examples() -> list:
    """``flash_attention/ops.py:39-55``."""

    def qkv(seed, b, h, hkv, s, d, dtype=torch.float32):
        rng = np.random.default_rng(seed)
        return tuple(_t(rng.standard_normal(shape), dtype)
                     for shape in ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d)))

    return [
        (qkv(0, 2, 4, 2, 256, 64), {"causal": True}),
        (qkv(1, 1, 4, 1, 300, 64), {"causal": True}),     # ragged seq
        (qkv(2, 2, 2, 2, 256, 64), {"causal": True, "window": 128}),
        (qkv(3, 1, 8, 4, 384, 128), {"causal": False}),
        (qkv(4, 1, 2, 2, 128, 64, torch.bfloat16), {},
         {"kind": "allclose", "atol": 2e-2, "rtol": 0.0}),
    ]


def _ssd_examples() -> list:
    """``ssd_scan/ops.py:123-134``."""
    cases = []
    for i, (bsz, s, h, p, g, n) in enumerate(
            [(2, 320, 4, 64, 2, 32), (1, 128, 2, 32, 1, 16), (1, 96, 2, 32, 1, 16)]):
        rng = np.random.default_rng(i)
        x = rng.standard_normal((bsz, s, h, p))
        dt = np.logaddexp(0.0, rng.standard_normal((bsz, s, h)))  # softplus
        a = -np.exp(rng.standard_normal(h) * 0.5)
        b = rng.standard_normal((bsz, s, g, n)) / n**0.5
        c = rng.standard_normal((bsz, s, g, n)) / n**0.5
        cases.append((tuple(_t(v) for v in (x, dt, a, b, c)), {}))
    return cases


# -- oracles for the CPU sweep ------------------------------------------------------------


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().to(torch.float32).numpy() if t.dtype == torch.bfloat16 \
        else t.detach().cpu().numpy()


def _pack_oracle(x: torch.Tensor) -> np.ndarray:
    from repro_torch.kernels.mask_compress.ref import mask_pack_reference

    rows = _np(x).reshape(-1, x.shape[-1])
    pad = -rows.shape[1] % 32
    words = mask_pack_reference(np.pad(rows, ((0, 0), (0, pad))))
    return words.reshape(*x.shape[:-1], -1)


def _dangling_oracle(a: torch.Tensor, w: torch.Tensor):
    from repro_torch.kernels.mask_compress.ref import dangling_filter_reference

    return dangling_filter_reference(_np(a), _np(w))


def _kv_pack_oracle(x: torch.Tensor) -> dict:
    from repro_torch.kernels.kv_cache.ref import kv_pack_reference

    values, words, nnz = kv_pack_reference(_np(x))
    return {"values": values, "mask": words, "nnz": nnz}


def _kv_unpack_oracle(values: torch.Tensor, mask: torch.Tensor, length: int) -> np.ndarray:
    from repro_torch.kernels.kv_cache.ref import kv_unpack_reference

    return kv_unpack_reference(_np(values), _np(mask), length)


def _dx_oracle(g: torch.Tensor, w: torch.Tensor) -> np.ndarray:
    return _np(g).astype(np.float64) @ _np(w).astype(np.float64).T


def _dw_oracle(x: torch.Tensor, g: torch.Tensor) -> np.ndarray:
    return _np(x).astype(np.float64).T @ _np(g).astype(np.float64)


# -- the table ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OpSpec:
    """One op of the table."""

    name: str
    #: the wrapper that launches the op's CUDA kernel; None: plain version only
    kernel: Optional[Callable]
    #: the plain PyTorch version (what the wrapper runs on CPU tensors)
    plain: Callable
    #: zero-arg callable -> list of (args, kwargs[, compare]) on CPU tensors
    examples: Optional[Callable[[], list]]
    #: {"kind": "exact"} | {"kind": "allclose", "atol", "rtol"} | {"kind": "rel", "tol"}
    compare: dict
    #: an independent oracle on the same (CPU) arguments, for the CPU sweep
    oracle: Optional[Callable] = None


_EXACT = {"kind": "exact"}
_BWD_COMPARE = {"kind": "rel", "tol": 1e-5}


@functools.cache
def _table() -> dict[str, OpSpec]:
    # imported here: the wrappers import this module for note_metric
    from repro_torch.kernels.flash_attention.ops import attention_reference, flash_attention
    from repro_torch.kernels.kv_cache import ops as kv
    from repro_torch.kernels.mask_compress import ops as mc
    from repro_torch.kernels.masked_matmul import backward as bwd
    from repro_torch.kernels.masked_matmul.ops import masked_matmul, masked_matmul_reference
    from repro_torch.kernels.ssd_scan.ops import ssd_scan, ssd_scan_chunked, ssd_scan_reference
    from repro_torch.kernels.stochastic_round.ops import sr_reference, stochastic_round

    specs = [
        OpSpec("masked_matmul", masked_matmul, masked_matmul_reference, _mm_examples, _EXACT),
        OpSpec("masked_matmul_dx", bwd.masked_matmul_dx, bwd.masked_matmul_dx_reference,
               _dx_examples, _BWD_COMPARE, _dx_oracle),
        OpSpec("masked_matmul_dw", bwd.masked_matmul_dw, bwd.masked_matmul_dw_reference,
               _dw_examples, _BWD_COMPARE, _dw_oracle),
        OpSpec("mask_pack", mc.mask_pack, mc.mask_pack_reference, _pack_examples, _EXACT,
               _pack_oracle),
        OpSpec("mask_unpack", None, mc.mask_unpack, None, _EXACT),
        OpSpec("dangling_filter", mc.dangling_filter, mc.dangling_filter_reference,
               _dangling_examples, _EXACT, _dangling_oracle),
        OpSpec("kv_pack", kv.kv_pack, kv.kv_pack_reference, _kv_pack_examples, _EXACT,
               _kv_pack_oracle),
        OpSpec("kv_unpack", None, kv.kv_unpack, _kv_unpack_examples, _EXACT, _kv_unpack_oracle),
        OpSpec("stochastic_round", stochastic_round, sr_reference, _sr_examples, _EXACT),
        OpSpec("flash_attention", flash_attention, attention_reference, _fa_examples,
               {"kind": "allclose", "atol": 2e-5, "rtol": 0.0}),
        OpSpec("ssd_scan", ssd_scan, ssd_scan_chunked, _ssd_examples,
               {"kind": "rel", "tol": 1e-4}, ssd_scan_reference),
    ]
    return {s.name: s for s in specs}


def ops() -> list[str]:
    return sorted(_table())


def op_spec(op: str) -> OpSpec:
    table = _table()
    if op not in table:
        raise KeyError(f"unknown kernel op {op!r}; registered: {sorted(table)}")
    return table[op]
