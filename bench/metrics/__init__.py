"""One reader per metric, ``bench/metrics/<metric>.py``, loaded by its
path (``bench.spec.reader``).  ``read(run)`` takes the run's record
(``bench.record.Run``) and returns the value, or None where the run
holds nothing to read it from; the harness then leaves the metric out
of the result line."""
