"""Fixed-point grid, binary-mask encoding and the SPRING matmul."""
