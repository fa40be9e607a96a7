"""Elementwise stochastic rounding (port of ``repro/kernels/stochastic_round``)."""
