"""Hand-written CUDA kernel for the tile-skipping fixed-point matmul."""
