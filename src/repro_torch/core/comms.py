"""Communication accounting and cost models — the quantity AdLoCo
minimizes (Theorem 2).  Port of ``repro/core/comms.py``.

Counts every inter-instance parameter exchange: DiLoCo outer syncs
(all-reduce of pseudo-gradients over a trainer's M workers), MIT merges
(weighted all-reduce over the merge set), and final consolidation.
Bytes use the ring all-reduce model: 2 (p−1)/p · payload per participant.
The time models (``ring_allreduce_time``, ``CommDomain``,
``hierarchical_allreduce_time``) and ``TimedCommsMeter`` are the JAX
package's logic, copied: pure Python float arithmetic in the same
order, so the cluster runtime's simulated clock agrees with the JAX
package's to the bit.  Only ``param_bytes`` touches tensors.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple, Union

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


def ring_allreduce_time(payload_bytes: float, participants: int,
                        link_bw: float, latency: float = 0.0) -> float:
    """Latency + bandwidth cost of one ring all-reduce, in seconds.

    2(p−1) ring steps, each paying the per-hop latency; every node
    transmits 2(p−1)/p · payload bytes over its (slowest) link.  With
    p <= 1 there is nothing to exchange.  A non-positive bandwidth is a
    misconfiguration and fails loudly (there is no 1 byte/s floor to
    silently absorb it).
    """
    p = max(int(participants), 1)
    if p == 1 or payload_bytes <= 0:
        return 0.0
    if link_bw <= 0.0:
        raise ValueError(f"link_bw must be positive, got {link_bw}")
    steps = 2 * (p - 1)
    wire = 2.0 * (p - 1) / p * payload_bytes
    return steps * latency + wire / link_bw


@dataclass
class CommDomain:
    """One fabric domain in an n-level all-reduce hierarchy.

    A *leaf* domain is a group of ``size`` nodes whose links run at
    ``bw`` bytes/s with ``latency`` seconds per hop.  An *internal*
    domain joins its ``children`` with per-path bandwidth ``bw`` — one
    child's route to its peers at this level, not an aggregate pipe —
    and per-hop ``latency``.  Nesting domains to any depth describes a
    rack / pod / cluster style fabric; :func:`hierarchical_allreduce_time`
    prices an all-reduce over the tree by recursing over the levels.
    """

    bw: float
    latency: float = 0.0
    size: int = 0
    children: Tuple["CommDomain", ...] = ()

    def __post_init__(self) -> None:
        self.children = tuple(self.children)
        if self.children and self.size:
            raise ValueError("a CommDomain is either a leaf (size) or a "
                             "parent (children), not both")

    def leaves(self) -> int:
        """Total node count under this domain."""
        if not self.children:
            return max(int(self.size), 0)
        return sum(c.leaves() for c in self.children)


def _prune(d: CommDomain):
    """Drop empty groups and collapse single-child levels (a level with
    one participating child prices nothing — there is no ring to run)."""
    if not d.children:
        return d if d.size >= 1 else None
    kids = [k for k in (_prune(c) for c in d.children) if k is not None]
    if not kids:
        return None
    if len(kids) == 1:
        return kids[0]
    return CommDomain(bw=d.bw, latency=d.latency, children=tuple(kids))


def _check_bws(d: CommDomain) -> None:
    if not d.children:
        if d.size > 1 and d.bw <= 0.0:
            raise ValueError(f"leaf domain bandwidth must be positive, "
                             f"got {d.bw}")
        return
    if d.bw <= 0.0:
        raise ValueError(f"internal domain bandwidth must be positive, "
                         f"got {d.bw}")
    for c in d.children:
        _check_bws(c)


def _scatter(payload_bytes: float, d: CommDomain):
    """(reduce-scatter time down this subtree, shard capacity).

    After the subtree's reduce-scatter every node holds a shard no
    larger than ``payload / capacity``; unbalanced sibling groups leave
    the largest shard — ``payload / min(child capacities)`` — as the
    critical payload of the level above.  The all-gather back up is the
    mirror image and costs the same, which is why callers double it.
    """
    if not d.children:
        p = d.size
        if p <= 1:
            return 0.0, max(p, 1)
        return (p - 1) * d.latency + ((p - 1) / p * payload_bytes) / d.bw, p
    subs = [_scatter(payload_bytes, c) for c in d.children]
    down = max(t for t, _ in subs)
    cap = min(c for _, c in subs)
    k = len(d.children)
    here = (k - 1) * d.latency + ((k - 1) / k * (payload_bytes / cap)) / d.bw
    return down + here, k * cap


def _tree_allreduce_time(payload_bytes: float, root: CommDomain) -> float:
    d = _prune(root)
    if d is None or d.leaves() <= 1 or payload_bytes <= 0:
        return 0.0
    _check_bws(d)
    if not d.children:
        return ring_allreduce_time(payload_bytes, d.size, d.bw, d.latency)
    subs = [_scatter(payload_bytes, c) for c in d.children]
    down = max(t for t, _ in subs)
    shard = payload_bytes / min(c for _, c in subs)
    cross = ring_allreduce_time(shard, len(d.children), d.bw, d.latency)
    return 2.0 * down + cross


def _per_pod(value, pod_sizes: Sequence[int], what: str):
    try:
        vals = [float(v) for v in value]
    except TypeError:
        return [float(value)] * len(pod_sizes)
    if len(vals) != len(pod_sizes):
        raise ValueError(f"per-pod {what} needs {len(pod_sizes)} entries, "
                         f"got {len(vals)}")
    return vals


def hierarchical_allreduce_time(payload_bytes: float,
                                tree: Union[CommDomain, Sequence[int]],
                                intra_bw=None, inter_bw: float = None, *,
                                intra_latency=0.0,
                                inter_latency: float = 0.0) -> float:
    """N-level hierarchical all-reduce cost, in seconds.

    The schedule is a recursion over fabric levels: ring reduce-scatter
    inside every leaf group (siblings run in parallel; the slowest group
    is the critical path), then a reduce-scatter of the surviving shards
    across each internal level on the way up, a full shard ring across
    the top level's children, and the mirror-image all-gathers back
    down.  At every level ``bw`` is the bandwidth of one *path* (one
    child's route to its peers at that level), not an aggregate pipe:
    the per-node shard rings are concurrent, which is what makes the
    schedule collapse to the flat ring when upper levels match the node
    links.  The shard entering a level is ``payload / min(child
    capacities)`` — the smallest sibling sets the granularity, which is
    why a lopsided split can lose to a flat ring threaded through the
    same fabric (see :meth:`~repro_torch.cluster.network.
    Topology.allreduce_time`, which routes via the cheaper of the two).

    ``tree`` is either a :class:`CommDomain` (arbitrary depth >= 1; a
    single leaf domain is priced *exactly* as
    :func:`ring_allreduce_time`) or, for the classic two-level pod
    scheme, a sequence of pod sizes with ``intra_bw``/``intra_latency``
    as single values or per-pod sequences and ``inter_bw``/
    ``inter_latency`` for the cross-pod paths.  The two spellings agree
    bit-for-bit at depth 2.
    """
    if isinstance(tree, CommDomain):
        if intra_bw is not None or inter_bw is not None:
            raise ValueError("pass bandwidths inside the CommDomain tree, "
                             "not as separate arguments")
        return _tree_allreduce_time(payload_bytes, tree)
    pod_sizes = tree
    if intra_bw is None:
        raise ValueError("intra_bw is required with the pod-sizes "
                         "spelling (or pass a CommDomain tree)")
    bws = _per_pod(intra_bw, pod_sizes, "intra_bw")
    lats = _per_pod(intra_latency, pod_sizes, "intra_latency")
    pods = [(int(s), b, l) for s, b, l in zip(pod_sizes, bws, lats)
            if s >= 1]
    if not pods:
        return 0.0
    total = sum(s for s, _, _ in pods)
    if total <= 1 or payload_bytes <= 0:
        return 0.0
    if any(b <= 0.0 for _, b, _ in pods):
        raise ValueError(f"intra_bw must be positive, got {intra_bw}")
    if len(pods) > 1 and (inter_bw is None or inter_bw <= 0.0):
        raise ValueError(f"inter_bw must be positive, got {inter_bw}")
    return _tree_allreduce_time(payload_bytes, CommDomain(
        bw=inter_bw if inter_bw is not None else 1.0,
        latency=inter_latency,
        children=tuple(CommDomain(bw=b, latency=l, size=s)
                       for s, b, l in pods)))


@dataclass
class TimedCommsMeter(CommsMeter):
    """CommsMeter that also accounts simulated wall-clock spent in each
    collective (the quantity async outer syncs hide behind compute).

    ``total_real_time`` separately accumulates *measured* seconds when
    an execution backend ran the collective for real (a process
    backend; the sim backend only prices); simulated and measured time
    live side by side in the log so model error is inspectable per
    event.
    """

    total_time: float = 0.0
    total_real_time: float = 0.0

    def record_timed(self, kind: str, participants: int, payload_bytes: int,
                     step: int, duration: float) -> float:
        self.record(kind, participants, payload_bytes, step)
        self.log[-1]["time_s"] = duration
        self.total_time += duration
        return duration

    def add_real_time(self, entry: dict, seconds: float) -> None:
        """Attach measured wire seconds to a previously recorded event
        (the runtime learns them only after the backend executes)."""
        entry["real_s"] = entry.get("real_s", 0.0) + seconds
        self.total_real_time += seconds
