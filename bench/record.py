"""What one run of a cell recorded: the input of the metric readers."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from bench.weights import Dense


@dataclass
class Trace:
    """A traced window (``bench.trace``).  Times in seconds."""
    window_s: float
    busy_s: float
    kernels: int                          # device kernel records
    by_name: Dict[str, Tuple[float, int]]  # device op -> (seconds, records)
    idle_by_host: Dict[str, float]        # host op at a gap -> idle seconds


@dataclass
class Round:
    samples: int                          # sequences trained, all workers
    mode: str                             # "plain" | "accum"
    phase_ms: Dict[str, float]            # TrainerRound.clock, device ms
    probes: List[List[int]]               # [B, rows, chunks] per probe
    seconds: float = 0.0                  # host clock
    alloc: Dict[str, int] = field(default_factory=dict)  # allocator deltas


@dataclass
class Run:
    cell: str
    model: Dense
    seq_len: int
    setup_s: float
    window_s: float                       # host clock, first to last round
    rounds: List[Round]
    window_peak_bytes: int
    launches: Dict[str, int] = field(default_factory=dict)  # gradstats
    trace: Optional[Trace] = None

    @property
    def tokens(self) -> int:
        """Tokens of the inner steps completed in the window."""
        return sum(r.samples for r in self.rounds) * self.seq_len

    @property
    def probe_rows(self) -> int:
        return sum(p[0] for r in self.rounds for p in r.probes)

    def phase_ms(self, *names: str) -> float:
        return sum(r.phase_ms.get(n, 0.0) for r in self.rounds for n in names)
