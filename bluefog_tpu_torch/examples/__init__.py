"""Runnable examples: ``python -m bluefog_tpu_torch.examples.<name>``."""
