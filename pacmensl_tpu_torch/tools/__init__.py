"""Command-line measurement tools of the port (``python -m
pacmensl_tpu_torch.tools.<name>``)."""
