"""The JAX package's ``examples/`` as modules of the port: narrated
drivers of the port's entry points, each run as ``python -m
repro_torch.examples.<name>`` on ``cuda`` unless given ``--device cpu``.
``common`` holds the setups they share (the port's copy of
``benchmarks/common.py``'s)."""
