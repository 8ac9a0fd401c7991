"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version (``kernel.py`` binding / ``ops.py`` wrapper / ``ref.py``
plain version, as in the JAX package).  CUDA sources live in
``repro_torch/csrc`` and are built by ``_build.py`` at first use."""
