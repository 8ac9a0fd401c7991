"""Seconds from the process's start to the window's start: imports,
CUDA, the weights, the token pool, round 1 (warm-up and the program's
side of the check) and the first run's kernel build."""


def read(run):
    return run.setup_s
