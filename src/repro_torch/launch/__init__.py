"""Launchers of the port (the JAX package's ``repro.launch``
counterpart): ``train`` runs AdLoCo training (Algorithm 3); ``profile``
times the serving main path under ``torch.profiler``.  The analysis
layer: ``mesh`` (the H100 production meshes and constants), ``specs``
(meta inputs and sharding plans), ``op_analysis`` (per-card op count),
``dryrun`` (the meta-device dry run on a fake process group) and
``roofline`` (the H100 roofline over its artifacts)."""
