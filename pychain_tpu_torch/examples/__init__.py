"""Runnable recipes of the port: ``python -m
pychain_tpu_torch.examples.<name>``."""
