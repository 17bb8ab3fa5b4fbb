"""The port's twins of the JAX package's examples (``examples/jax_*.py``),
run as ``python -m horovod_tpu_torch.examples.<name>``."""
