"""Package marker: the Mamba selective-scan kernel (binding, wrapper,
plain version)."""
