"""Package version of the PyTorch port (tracks the JAX package's)."""

__version__ = "0.1.0"
