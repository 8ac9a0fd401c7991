"""Launchers of the port (the JAX package's ``repro.launch``
counterpart): ``train`` runs AdLoCo training (Algorithm 3); ``profile``
times the serving main path under ``torch.profiler``."""
