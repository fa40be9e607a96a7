"""PyTorch + CUDA port of the SPRING reproduction (``repro``).

Mirrors ``repro``'s module layout so each file names its counterpart:
``repro_torch/serving/engine.py`` answers to ``repro/serving/engine.py``.
It imports ``torch`` and never ``jax`` or ``repro``; the parity tests
(``tests/test_torch_*.py``) are the only place both packages meet.

Every Pallas kernel on a ported path is a hand-written CUDA C++ kernel
under ``csrc/`` (built with ``nvcc`` for ``sm_90a`` at first use and
loaded with ctypes, see ``kernels/cuda.py``).  Each kernel wrapper
dispatches on the tensor's device: a CUDA tensor launches the kernel or
raises, a CPU tensor runs the plain PyTorch version beside it.
"""
