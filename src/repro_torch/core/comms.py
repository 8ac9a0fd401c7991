"""Communication accounting — the quantity AdLoCo minimizes (Theorem 2).

Port of the metering half of ``repro/core/comms.py``: ``param_bytes``
and ``CommsMeter``.  Counts every inter-instance parameter exchange:
DiLoCo outer syncs, MIT merges and the final consolidation.  Bytes use
the ring all-reduce model: 2 (p−1)/p · payload per participant.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import torch


def param_bytes(params: Dict[str, torch.Tensor]) -> int:
    return int(sum(t.numel() * t.element_size() for t in params.values()))


@dataclass
class CommsMeter:
    events: int = 0                  # discrete sync events (paper's C(N))
    total_bytes: float = 0.0
    log: List[dict] = field(default_factory=list)

    def record(self, kind: str, participants: int, payload_bytes: int,
               step: int) -> None:
        p = max(participants, 1)
        ring = 2.0 * (p - 1) / p * payload_bytes * p   # total wire bytes
        self.events += 1
        self.total_bytes += ring
        self.log.append({"step": step, "kind": kind,
                         "participants": p, "bytes": ring})

    def snapshot(self) -> dict:
        return {"events": self.events, "bytes": self.total_bytes}
