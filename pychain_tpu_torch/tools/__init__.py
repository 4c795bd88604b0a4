"""Measurement tools of the port (``python -m pychain_tpu_torch.tools.<name>``)."""
