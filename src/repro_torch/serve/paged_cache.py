"""Host-side block accounting for the paged KV cache.

A copy of the JAX package's ``repro/serve/paged_cache.py`` (numpy only).
Device memory is one pool of ``num_blocks`` fixed-size blocks
(``models.init_paged_cache``: leaves (L, num_blocks + 1, block_size,
Hk, hd), last row = scratch).  This module owns which lane holds which
physical block: a LIFO free list plus per-lane block-table rows
((n_lanes, nb_max) int32, -1 = unallocated) that the device gather
consumes directly.

Identity position layout: table entry j of a lane covers absolute
positions [j * block_size, (j + 1) * block_size) of that lane's
request — no ring wraparound, so a request's total length is bounded
by ``nb_max * block_size`` while CONCURRENCY is bounded only by the
pool (the point of paging: short requests don't reserve worst-case
dense rows).
"""
from __future__ import annotations

from typing import List

import numpy as np


class BlockPool:
    """Free-list allocator over a pool of fixed-size KV blocks."""

    def __init__(self, num_blocks: int, block_size: int, n_lanes: int,
                 nb_max: int):
        assert num_blocks >= 1 and block_size >= 1
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.n_lanes = n_lanes
        self.nb_max = nb_max
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self.tables = np.full((n_lanes, nb_max), -1, np.int32)

    # ------------------------------------------------------------ queries
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.num_blocks - len(self._free)

    def blocks_for(self, n_tokens: int) -> int:
        """Blocks needed to cover positions [0, n_tokens)."""
        return -(-n_tokens // self.block_size)

    def lane_blocks(self, lane: int) -> int:
        return int((self.tables[lane] >= 0).sum())

    # ------------------------------------------------------------ mutation
    def ensure(self, lane: int, n_tokens: int) -> bool:
        """Grow ``lane``'s table until positions [0, n_tokens) are
        covered.  Returns False (no change) if the request outgrew its
        table or the pool is exhausted."""
        need = self.blocks_for(n_tokens)
        if need > self.nb_max:
            return False
        have = self.lane_blocks(lane)
        if need - have > len(self._free):
            return False
        for j in range(have, need):
            self.tables[lane, j] = self._free.pop()
        return True

    def release(self, lane: int) -> None:
        """Return every block the lane holds to the free list."""
        for j in range(self.nb_max):
            b = int(self.tables[lane, j])
            if b >= 0:
                self._free.append(b)
        self.tables[lane, :] = -1

    def no_leak(self) -> bool:
        """True iff every block is home: all tables empty and the free
        list is exactly {0 .. num_blocks-1}."""
        return bool((self.tables < 0).all()) \
            and sorted(self._free) == list(range(self.num_blocks))
