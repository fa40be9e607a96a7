"""Hand-written CUDA kernel for blockwise online-softmax (flash) attention."""
