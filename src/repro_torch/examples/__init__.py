"""Runnable examples of the port (``python -m repro_torch.examples.<name>``):
the JAX package's ``examples/`` in PyTorch, on the card unless
``--device cpu`` is given."""
