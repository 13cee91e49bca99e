"""Runnable examples of the port: ``python -m zipnn_tpu_torch.examples.<name>``."""
