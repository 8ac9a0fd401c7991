"""The one holder of the training step's span factory.

``core.diloco.step_spans`` hands its factory here for the steps it
scopes, and ``span(name)`` opens the factory's span: the inner step's
``forward``, ``backward`` and ``adamw`` and the model's layers' ``mla``
and ``moe``.  The factory is held process-wide, not in a context
variable: a remat recompute runs the layers again on autograd's device
thread, where a context variable reads its default, and the
recompute's spans open inside ``backward`` all the same.  With no factory handed in (serving, the dry run, a plain
call) ``span`` opens nothing.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

_FACTORY: list = [None]


@contextlib.contextmanager
def opened_by(factory: Optional[Callable]):
    """Within it, ``span(name)`` opens ``factory(name)``."""
    saved, _FACTORY[0] = _FACTORY[0], factory
    try:
        yield
    finally:
        _FACTORY[0] = saved


def span(name: str):
    factory = _FACTORY[0]
    return contextlib.nullcontext() if factory is None else factory(name)
