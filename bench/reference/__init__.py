"""The plain reference that decides ``correct``: plain PyTorch in float32.

``model``: the dense decoder of the port's equations (``loss`` of one
row, each layer recomputed in the backward so that full-size rows fit).
``optim``: AdamW and the Nesterov outer step as the configuration
states them.  ``train``: the readings a training cell compares (the
first inner steps, the per-sample probe's statistics and decision, the
outer step), for the reference and, with a fault or in a lower
precision, for a stand-in put in the program's place.

It imports torch, numpy and the benchmark's own weights and traffic
modules; never ``jax``, the JAX package ``repro`` or anything of the
port ``repro_torch``.  Matrix products run in float32 with TF32 off.
"""
