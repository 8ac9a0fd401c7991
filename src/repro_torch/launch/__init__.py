"""Launchers of the port on the card (the JAX package's ``repro.launch``
counterpart): ``profile`` times the serving main path under
``torch.profiler``."""
