"""SPRING core: fixed-point SR arithmetic + binary-mask sparsity (port of
``repro/core``; the same public names).

The names load on first use (PEP 562): the core's modules and the kernel
wrappers import each other, so importing them all here, as the
reference's ``__init__`` does, would close a cycle whichever is imported
first."""

import importlib

_EXPORTS = {
    "fixedpoint": ("SPRING_ACCUM_FORMAT", "SPRING_FORMAT", "FixedPointFormat", "from_int",
                   "quantize_nearest", "quantize_stochastic", "quantize_stochastic_from_bits",
                   "ste_quantize_nearest", "ste_quantize_stochastic", "to_int"),
    "masking": ("MaskedVector", "compression_ratio", "density", "mask_decode", "mask_encode",
                "pack_mask_bits", "tile_occupancy", "unpack_mask_bits"),
    "sparsity": ("MatchedOperands", "apply_joint_mask", "generate_masks",
                 "postcompute_sparsity", "precompute_sparsity", "sparse_dot"),
    "spring_ops": ("DENSE", "QUANT", "QUANT_SPARSE", "KeyGen", "SpringConfig", "spring_conv2d",
                   "spring_einsum", "spring_matmul"),
}
_WHERE = {name: mod for mod, names in _EXPORTS.items() for name in names}
__all__ = sorted(_WHERE)


def __getattr__(name: str):
    if name not in _WHERE:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{_WHERE[name]}"), name)
    globals()[name] = value
    return value


def __dir__() -> list:
    return sorted(set(globals()) | set(__all__))
