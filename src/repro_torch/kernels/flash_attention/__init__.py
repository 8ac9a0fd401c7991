"""Package marker: the flash-attention kernel (binding, wrapper, plain
version)."""
