"""One driver per kind of traffic, ``bench/kinds/<kind>.py``, each with
``run(cell, seed, seconds, trace, device, t_start)``: it builds the
system under test, warms up, measures the window, runs the check once
the window has closed and returns the run's record and the numbers
compared."""
