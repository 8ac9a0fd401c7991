"""Package marker: the gradstats kernels (binding, wrapper, plain
version)."""
