"""Public gradstats wrapper: dispatch by device.

A CUDA tensor goes to the two Hopper kernels (``kernel.colsum_mean``,
then ``kernel.moments``) or the call raises; a CPU tensor goes to the
plain version (``ref.gradstats_reduce_ref``).  Nothing falls back from
one to the other.

Unlike the JAX wrapper, no padded copy of G is made (at the training
main path G is 9.75 GB): the kernels mask the ragged D tail, loop over
the true B rows and divide by the true B, so no rescale follows.

``colsum_chunk`` and ``moments_chunk`` are the two passes one at a time,
for a G streamed in row chunks (``core.batching.per_sample_probe``):
the column sums accumulate over the chunks, then each chunk's moments
are taken against the whole mean.

``colsum_launches`` and ``moments_launches`` count the launches of each
kernel made through this wrapper (plain integers; set them to 0 to
start a count).
"""
from __future__ import annotations

import torch

from typing import Optional

from repro_torch.kernels.gradstats import kernel
from repro_torch.kernels.gradstats.ref import (colsum_chunk_ref,
                                               gradstats_reduce_ref,
                                               moments_ref)

colsum_launches = 0
moments_launches = 0


def gradstats_reduce(G):
    """G (B, D) -> (s (B,), d (B,), n2 (), b ()), all f32.  See
    ``core.batching``."""
    global colsum_launches, moments_launches
    if G.device.type == "cpu":
        return gradstats_reduce_ref(G)
    gbar = kernel.colsum_mean(G)
    colsum_launches += 1
    s, d, n2 = kernel.moments(G, gbar)
    moments_launches += 1
    return s, d, n2, torch.tensor(float(G.shape[0]), device=G.device)


def colsum_chunk(G, acc, *, accumulate: bool,
                 divisor: Optional[float] = None):
    """G's (R, D) column sums into ``acc`` (D,) f32 in place, added to
    its values when ``accumulate``, divided by ``divisor`` if given;
    returns ``acc``."""
    global colsum_launches
    if G.device.type == "cpu":
        return colsum_chunk_ref(G, acc, accumulate=accumulate,
                                divisor=divisor)
    kernel.colsum_into(G, acc, accumulate=accumulate,
                       divisor=float(divisor or 0.0))
    colsum_launches += 1
    return acc


def moments_chunk(G, gbar):
    """G (R, D) against the whole probe's mean gbar (D,) f32 -> (s (R,),
    d (R,), n2 ())."""
    global moments_launches
    if G.device.type == "cpu":
        return moments_ref(G, gbar)
    out = kernel.moments(G, gbar)
    moments_launches += 1
    return out
