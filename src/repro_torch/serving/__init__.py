"""Continuous-batching serving engine over the binary-mask packed KV pool."""
