"""The benchmark of the PyTorch port (``repro_torch``) on NVIDIA H100s.

One command runs one cell once, from the root of a checkout::

    python3 -m bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name (``bench.spec``): the cell's
file ``bench/workloads/<cell>.json`` names a configuration
(``bench/configs/<config>.json``) and a traffic mix
(``bench/traffic/<traffic>.json``, whose ``kind`` picks the driver
``bench/kinds/<kind>.py``); each metric that ``BENCHMARK.json`` lists
for the cell is read by ``bench/metrics/<metric>.py``.  The plain
reference that decides ``correct`` is ``bench/reference/``; it imports
nothing of the port.  Nothing here imports ``jax``, ``jaxlib`` or the
JAX package ``repro``.
"""
