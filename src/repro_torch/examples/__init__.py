"""The reference's examples, run on the port: ``python -m
repro_torch.examples.<quickstart|serve_batched|train_lm>`` (``--device``,
default ``cuda``)."""
