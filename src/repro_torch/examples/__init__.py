"""Runnable examples of the port (``python -m repro_torch.examples.<name>``),
the counterparts of the JAX package's ``examples/``; each runs on the GPU
unless ``--device cpu`` is given."""
