"""Virtual node profiles for the cluster runtime.  Port of
``repro/cluster/node.py``.

A :class:`NodeProfile` is a two-term roofline (compute / device memory)
plus a link spec.  The defaults are one NVIDIA H100 SXM (constants
below, each with its source); tests and benchmarks pass their own.
Heterogeneity is expressed as a per-node ``speed`` scale (flops, memory
and link bandwidth all scale together — a slow node is slow end to
end), stragglers as lognormal jitter on every round's compute time, and
scheduled degradations as time-windowed slowdown factors.
"""
from __future__ import annotations

import itertools
import zlib
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

#: dense bf16 tensor-core FLOP/s of one H100 SXM (NVIDIA H100 Tensor
#: Core GPU datasheet: 989 TFLOPS bf16 without sparsity)
PEAK_FLOPS = 989e12
#: HBM3 bytes/s of one H100 SXM (same datasheet: 3.35 TB/s)
HBM_BW = 3.35e12
#: NVLink 4 bytes/s one way per GPU (same datasheet: 900 GB/s
#: bidirectional per GPU, so 450 GB/s each way — what a ring all-reduce
#: step sends on)
LINK_BW = 450e9
#: default per-hop link latency (s): 2 us, a choice of this port, of the
#: order NCCL's cost model gives one NVLink ring step for small messages
#: (the ``hwLat`` table of its ``src/graph/tuning.cc``: a few us)
DEFAULT_LATENCY = 2e-6


@dataclass
class Slowdown:
    """Compute runs ``factor``x slower inside [start, end)."""

    start: float
    end: float
    factor: float


@dataclass
class NodeProfile:
    name: str
    flops: float                    # peak FLOP/s
    hbm_bw: float                   # device-memory bytes/s
    link_bw: float                  # bytes/s on this node's link
    link_latency: float = DEFAULT_LATENCY
    jitter: float = 0.0             # lognormal sigma on compute time
    seed: int = 0
    pod: Optional[int] = None       # pod membership (None -> pod 0)
    rack: Optional[int] = None      # rack within the pod (None -> rack 0)
    slowdowns: List[Slowdown] = field(default_factory=list)
    _rng: Optional[np.random.Generator] = field(
        default=None, repr=False, compare=False)

    @classmethod
    def from_roofline(cls, name: str = "h100", *, speed: float = 1.0,
                      jitter: float = 0.0, seed: int = 0,
                      link_latency: float = DEFAULT_LATENCY,
                      pod: Optional[int] = None,
                      rack: Optional[int] = None,
                      flops: Optional[float] = None,
                      hbm_bw: Optional[float] = None,
                      link_bw: Optional[float] = None) -> "NodeProfile":
        """H100-class node scaled by ``speed``; explicit overrides win
        (tests shrink the constants so toy problems land in a regime
        where compute and comm times are comparable)."""
        return cls(name=name,
                   flops=(flops if flops is not None else PEAK_FLOPS) * speed,
                   hbm_bw=(hbm_bw if hbm_bw is not None else HBM_BW) * speed,
                   link_bw=(link_bw if link_bw is not None else LINK_BW)
                   * speed,
                   link_latency=link_latency, jitter=jitter, seed=seed,
                   pod=pod, rack=rack)

    def add_slowdown(self, start: float, duration: float,
                     factor: float) -> None:
        self.slowdowns.append(Slowdown(start, start + duration, factor))

    def slow_factor(self, now: float) -> float:
        f = 1.0
        for s in self.slowdowns:
            if s.start <= now < s.end:
                f *= s.factor
        return f

    def compute_time(self, flops: float, bytes_accessed: float,
                     now: float) -> float:
        """Roofline step time max(compute, memory) under the node's
        current slowdown, with optional straggler jitter (lognormal,
        mean-one in log space, deterministic per node seed)."""
        base = max(flops / max(self.flops, 1.0),
                   bytes_accessed / max(self.hbm_bw, 1.0))
        base *= self.slow_factor(now)
        if self.jitter > 0.0:
            if self._rng is None:
                # crc32, not hash(): str hashing is salted per process
                # and would break cross-run reproducibility
                self._rng = np.random.default_rng(
                    np.random.SeedSequence(
                        [self.seed, zlib.crc32(self.name.encode())]))
            base *= float(self._rng.lognormal(0.0, self.jitter))
        return base


def make_heterogeneous_profiles(n: int, ratio: float = 1.0, *,
                                jitter: float = 0.0, seed: int = 0,
                                link_latency: float = DEFAULT_LATENCY,
                                flops: Optional[float] = None,
                                hbm_bw: Optional[float] = None,
                                link_bw: Optional[float] = None
                                ) -> List[NodeProfile]:
    """``n`` nodes with speeds geometrically spaced from 1.0 (node 0)
    down to 1/ratio (node n-1) — the paper's "heterogeneous hardware"
    axis.  ratio=1 is a homogeneous cluster."""
    if n <= 0:
        return []
    profiles = []
    for i in range(n):
        expo = i / max(n - 1, 1)
        speed = float(ratio) ** (-expo) if ratio > 0 else 1.0
        profiles.append(NodeProfile.from_roofline(
            name=f"node{i}", speed=speed, jitter=jitter, seed=seed + i,
            link_latency=link_latency, flops=flops, hbm_bw=hbm_bw,
            link_bw=link_bw))
    return profiles


def make_pod_profiles(pod_sizes: List[int], ratio: float = 1.0, *,
                      jitter: float = 0.0, seed: int = 0,
                      link_latency: float = DEFAULT_LATENCY,
                      flops: Optional[float] = None,
                      hbm_bw: Optional[float] = None,
                      link_bw: Optional[float] = None
                      ) -> List[NodeProfile]:
    """Pod-structured cluster: nodes are homogeneous inside a pod and
    pod speeds are geometrically spaced from 1.0 (pod 0) down to
    1/ratio (last pod) — the realistic shape of mixed-generation
    fleets.  Node ``p{i}n{j}`` carries ``pod=i`` so
    :meth:`~repro_torch.cluster.network.Topology.from_profiles` can recover
    the grouping; interleave the returned list before handing it to
    ``run_cluster`` if trainers should span pods."""
    P = len(pod_sizes)
    profiles = []
    for pi, size in enumerate(pod_sizes):
        expo = pi / max(P - 1, 1)
        speed = float(ratio) ** (-expo) if ratio > 0 else 1.0
        for j in range(size):
            profiles.append(NodeProfile.from_roofline(
                name=f"p{pi}n{j}", speed=speed, jitter=jitter,
                seed=seed + 1000 * pi + j, link_latency=link_latency,
                pod=pi, flops=flops, hbm_bw=hbm_bw, link_bw=link_bw))
    return profiles


def make_rack_profiles(shape: List[List[int]], ratio: float = 1.0, *,
                       jitter: float = 0.0, seed: int = 0,
                       link_latency: float = DEFAULT_LATENCY,
                       flops: Optional[float] = None,
                       hbm_bw: Optional[float] = None,
                       link_bw: Optional[float] = None
                       ) -> List[NodeProfile]:
    """Rack/pod-structured cluster for three-level fabrics: ``shape``
    lists, per pod, the node count of each of its racks (``[[2, 2],
    [3]]`` is pod 0 with two 2-node racks and pod 1 with one 3-node
    rack).  Nodes are homogeneous inside a pod and pod speeds are
    geometrically spaced from 1.0 (pod 0) down to 1/``ratio`` (last
    pod), matching :func:`make_pod_profiles`.  Node ``p{i}r{j}n{k}``
    carries ``pod=i, rack=j`` so
    :meth:`~repro_torch.cluster.network.Topology.from_profiles` (with
    ``pod_bw``) can recover the rack -> pod -> cluster tree; interleave
    the returned list before handing it to ``run_cluster`` if trainers
    should span pods."""
    P = len(shape)
    profiles = []
    for pi, racks in enumerate(shape):
        expo = pi / max(P - 1, 1)
        speed = float(ratio) ** (-expo) if ratio > 0 else 1.0
        for ri, size in enumerate(racks):
            for k in range(size):
                profiles.append(NodeProfile.from_roofline(
                    name=f"p{pi}r{ri}n{k}", speed=speed, jitter=jitter,
                    seed=seed + 10000 * pi + 100 * ri + k,
                    link_latency=link_latency, pod=pi, rack=ri,
                    flops=flops, hbm_bw=hbm_bw, link_bw=link_bw))
    return profiles


def interleave_pods(profiles: List[NodeProfile]) -> List[NodeProfile]:
    """Round-robin the profiles across their pods (``pod`` attribute,
    None -> pod 0), so consecutive slices — and therefore the trainers
    ``run_cluster`` carves out of the list — span pods and every outer
    sync crosses the inter-pod bottleneck."""
    groups: dict = {}
    for p in profiles:
        groups.setdefault(p.pod if p.pod is not None else 0, []).append(p)
    ordered = [groups[k] for k in sorted(groups)]
    return [p for tup in itertools.zip_longest(*ordered) for p in tup
            if p is not None]
