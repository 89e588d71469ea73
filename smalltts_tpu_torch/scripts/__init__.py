"""Command-line entry points of the port, run as `python -m
smalltts_tpu_torch.scripts.<name>` (the repository's root scripts/ drive
the JAX package)."""
