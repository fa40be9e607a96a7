"""Benchmarks of the port (twins of the reference's ``benchmarks/``):
``bench_kernels`` (kernel times and the kernel parity sweep),
``bench_table1`` and ``bench_paper_figs`` (paper Table 1 and Figs. 11-16
from ``perfmodel``), ``bench_compression`` (paper Fig. 5).  Each module
has ``rows()`` and runs as ``python -m repro_torch.benchmarks.<name>``."""
