"""Binary-mask packing: the warp-ballot CUDA kernel and its plain version."""
