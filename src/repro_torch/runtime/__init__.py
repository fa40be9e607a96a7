"""Training step builders (port of ``repro/runtime``, the CNN step)."""
