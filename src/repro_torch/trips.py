"""How many runs of itself an op stands for: a loop body traced once.

``models.layers.scan_blocks`` traces one full block of the sequential
scan on meta tensors for all of its blocks, inside ``repeated(n)``;
``launch.op_analysis.OpCounter`` reads ``trips()`` and counts what it
sees that many times.  The context variable lives here, below both, so
that the models never import the analysis layer.
"""
from __future__ import annotations

import contextlib
import contextvars

_TRIPS = contextvars.ContextVar("repro_torch_trips", default=1)


def trips() -> int:
    """How many runs the ops now running stand for (1 outside
    ``repeated``)."""
    return _TRIPS.get()


@contextlib.contextmanager
def repeated(n: int):
    """Inside the block, every op stands for ``n`` runs of itself (a loop
    body traced once for ``n`` trips; nested blocks multiply).  Nothing
    but an ``OpCounter`` reads it."""
    tok = _TRIPS.set(_TRIPS.get() * n)
    try:
        yield
    finally:
        _TRIPS.reset(tok)
