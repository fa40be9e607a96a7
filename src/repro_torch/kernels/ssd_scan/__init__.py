"""Hand-written CUDA kernels for the Mamba-2 SSD chunked scan."""
