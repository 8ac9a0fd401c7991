"""Network cost models: flat ring and an n-level fabric-domain tree.

Port of ``repro/cluster/network.py``: pure Python float arithmetic,
copied in the same order, so prices agree with the JAX package's to the
bit.  Extends the byte accounting of ``repro_torch.core.comms`` into
*time*.  Two models share one interface (``allreduce_time`` /
``point_to_point_time`` / ``add_fabric_window``, all taking a ``now``):

:class:`NetworkModel`
    The flat model: one ring over all participants, bottlenecked by the
    slowest link.  Kept as the topology-oblivious baseline.
:class:`Topology`
    Nodes grouped into a tree of :class:`FabricDomain`\\ s — rack ->
    pod -> cluster, to any depth.  Leaf domains hold nodes (their links
    are the nodes' own ``link_bw``); each internal domain joins its
    children with explicit per-path bandwidth/latency.  Collectives are
    priced by :func:`~repro_torch.core.comms.hierarchical_allreduce_time`
    (reduce-scatter down the levels, a shard ring across the top
    bottleneck, all-gather back up).  The classic two-level pod scheme
    is the depth-2 special case and prices bit-identically to it.

Every domain carries its *own* time-varying fabric state: a
:class:`FabricSchedule` is a baseline ``bw_scale``/``extra_latency``
plus piecewise-constant :class:`FabricWindow`\\ s, so scenarios can open
bursty congestion windows on one level — or one named domain — without
touching the others.  The cluster runtime re-prices in-flight
collectives *and* join-time point-to-point transfers at every window
edge.
"""
from __future__ import annotations

import copy
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.comms import (CommDomain, TimedCommsMeter,
                                    hierarchical_allreduce_time,
                                    ring_allreduce_time)
from repro_torch.cluster.node import DEFAULT_LATENCY, NodeProfile

#: fixed scopes for fabric windows; ``Topology`` additionally accepts
#: ``"level:<k>"`` (every domain at height k, 0 = leaves),
#: ``"domain:<name>"`` (one named domain — every path at that level) and
#: ``"edge:<name>"`` (one named domain's *uplink*: only the single path
#: joining that child to its siblings degrades, so one bad cable is
#: priced on traffic through that child and nowhere else).  The flat
#: NetworkModel has a single fabric and treats every valid scope as the
#: wire.
FABRIC_SCOPES = ("all", "intra", "inter")


@dataclass
class FabricWindow:
    """Fabric degradation active inside [start, end): link bandwidth is
    multiplied by ``bw_scale`` and every hop pays ``extra_latency``."""

    start: float
    end: float
    bw_scale: float = 1.0
    extra_latency: float = 0.0


@dataclass
class FabricSchedule:
    """Piecewise-constant time-varying fabric state.

    ``bw_scale``/``extra_latency`` are the always-on baseline;
    overlapping windows compose (scales multiply, latencies add), so a
    congestion burst during a partition degrades the fabric further.
    """

    bw_scale: float = 1.0
    extra_latency: float = 0.0
    windows: List[FabricWindow] = field(default_factory=list)

    def add_window(self, start: float, duration: Optional[float] = None, *,
                   bw_scale: float = 1.0,
                   extra_latency: float = 0.0) -> FabricWindow:
        """Open a window at ``start``; ``duration`` of None (or <= 0)
        means the degradation is permanent."""
        if bw_scale <= 0.0:
            raise ValueError(f"bw_scale must be positive, got {bw_scale}")
        if extra_latency < 0.0:
            raise ValueError(
                f"extra_latency must be >= 0, got {extra_latency}")
        end = (start + duration if duration is not None and duration > 0
               else math.inf)
        w = FabricWindow(start, end, bw_scale, extra_latency)
        self.windows.append(w)
        return w

    def at(self, now: float) -> Tuple[float, float]:
        """(bandwidth scale, extra latency) in effect at time ``now``."""
        scale, extra = self.bw_scale, self.extra_latency
        for w in self.windows:
            if w.start <= now < w.end:
                scale *= w.bw_scale
                extra += w.extra_latency
        return scale, extra

    def change_points(self) -> List[float]:
        """Finite window edges, sorted — the instants pricing changes."""
        pts = {w.start for w in self.windows}
        pts |= {w.end for w in self.windows if math.isfinite(w.end)}
        return sorted(pts)


def _asym(s: "FabricSchedule") -> bool:
    """True when a schedule can deviate from the identity — the
    structural guard keeping uplink-free topologies bit-identical to
    the pre-uplink pricing."""
    return bool(s.windows) or s.bw_scale != 1.0 or s.extra_latency != 0.0


def _check_scope(scope: str) -> None:
    if scope in FABRIC_SCOPES:
        return
    if (scope.startswith("level:") or scope.startswith("domain:")
            or scope.startswith("edge:")):
        return
    raise ValueError(f"scope must be one of {FABRIC_SCOPES} or "
                     f"'level:<k>' / 'domain:<name>' / 'edge:<name>', "
                     f"got {scope!r}")


@dataclass
class FabricDomain:
    """One domain in the fabric level tree.

    A *leaf* domain lists the node names it contains; its links are the
    nodes' own ``link_bw``/``link_latency``, so it needs no bandwidth of
    its own.  An *internal* domain joins its ``children`` with per-path
    bandwidth ``bw`` (one child's route to its peers at this level, not
    an aggregate pipe) and per-hop ``latency``.  Every domain carries
    its own :class:`FabricSchedule`: a congestion window on a pod's
    domain squeezes only the links joining that pod's racks, a window on
    the root squeezes only the paths joining pods.

    ``uplink`` is the schedule on THIS domain's single path up into its
    parent's level (``scope="edge:<name>"``): where ``fabric`` on the
    parent degrades every sibling path symmetrically, a window on one
    child's uplink prices only collectives and transfers whose route
    actually crosses that child's edge — the per-path fabric-asymmetry
    model.  Empty on the root (it has no parent edge).
    """

    name: str
    bw: Optional[float] = None
    latency: float = 0.0
    children: List["FabricDomain"] = field(default_factory=list)
    nodes: List[str] = field(default_factory=list)
    fabric: FabricSchedule = field(default_factory=FabricSchedule)
    uplink: FabricSchedule = field(default_factory=FabricSchedule)


@dataclass
class NetworkModel:
    """Flat cost model: every collective is one ring over the global
    min-bandwidth link.

    ``bw_scale``/``extra_latency`` seed the baseline of the fabric
    schedule (kept as constructor arguments for compatibility);
    scenarios add time-windowed degradations on top via
    :meth:`add_fabric_window`.
    """

    bw_scale: float = 1.0
    extra_latency: float = 0.0
    fabric: Optional[FabricSchedule] = None

    def __post_init__(self) -> None:
        if self.fabric is None:
            self.fabric = FabricSchedule(bw_scale=self.bw_scale,
                                         extra_latency=self.extra_latency)
        elif self.bw_scale != 1.0 or self.extra_latency != 0.0:
            raise ValueError(
                "pass the baseline via the FabricSchedule, not both a "
                "fabric and bw_scale/extra_latency")

    def add_fabric_window(self, start: float,
                          duration: Optional[float] = None, *,
                          bw_scale: float = 1.0, extra_latency: float = 0.0,
                          scope: str = "all") -> None:
        _check_scope(scope)          # flat fabric: every scope is the wire
        self.fabric.add_window(start, duration, bw_scale=bw_scale,
                               extra_latency=extra_latency)

    def fabric_change_points(self) -> List[float]:
        return self.fabric.change_points()

    def allreduce_time(self, payload_bytes: float,
                       nodes: Sequence[NodeProfile], *,
                       now: float = 0.0) -> float:
        p = len(nodes)
        if p <= 1:
            return 0.0
        scale, extra = self.fabric.at(now)
        bw = min(n.link_bw for n in nodes) * scale
        if bw <= 0.0:
            raise ValueError(
                f"non-positive effective bandwidth {bw!r} among "
                f"{[n.name for n in nodes]}; check link_bw / bw_scale")
        lat = max(n.link_latency for n in nodes) + extra
        return ring_allreduce_time(payload_bytes, p, bw, lat)

    def point_to_point_time(self, payload_bytes: float, src: NodeProfile,
                            dst: NodeProfile, *, now: float = 0.0) -> float:
        """One-directional transfer (elastic join: shipping params to a
        fresh trainer)."""
        scale, extra = self.fabric.at(now)
        bw = min(src.link_bw, dst.link_bw) * scale
        if bw <= 0.0:
            raise ValueError(
                f"non-positive effective bandwidth {bw!r} between "
                f"{src.name!r} and {dst.name!r}; check link_bw / bw_scale")
        lat = max(src.link_latency, dst.link_latency) + extra
        return lat + payload_bytes / bw


@dataclass
class Topology:
    """N-level fabric: a tree of :class:`FabricDomain`\\ s.

    Construct either from the classic two-level pod spelling — ``pods``
    lists node *names* per pod, joined by cross-pod paths of ``inter_bw``
    each — or from an explicit ``tree`` (see :meth:`from_profiles` for
    the rack/pod/cluster builder).  Collectives are routed reduce-scatter
    down the levels -> shard ring across the top -> all-gather up, which
    reduces to the plain ring whenever all participants share a leaf
    domain.  Because the smallest sibling group sets the cross-phase
    shard granularity, a lopsided split can lose to a plain ring
    threaded through the same fabric; :meth:`allreduce_time` routes the
    cheaper of the two.

    Every domain has its own time-varying :class:`FabricSchedule`;
    :meth:`add_fabric_window` scopes a degradation to all links
    (``"all"``), the leaf level (``"intra"``), every internal level
    (``"inter"``), one level (``"level:<k>"``, 0 = leaves), or one named
    domain (``"domain:<name>"``).  ``intra_fabric``/``inter_fabric``
    keep the two-level spelling working: when given, all leaf (resp.
    internal) domains share that schedule object.
    """

    pods: Optional[List[List[str]]] = None
    inter_bw: Optional[float] = None
    inter_latency: float = DEFAULT_LATENCY
    intra_fabric: Optional[FabricSchedule] = None
    inter_fabric: Optional[FabricSchedule] = None
    tree: Optional[FabricDomain] = None

    def __post_init__(self) -> None:
        if self.tree is None:
            if self.pods is None or self.inter_bw is None:
                raise ValueError("Topology needs either a tree or "
                                 "pods + inter_bw")
            if self.inter_bw <= 0.0:
                raise ValueError(f"inter_bw must be positive, got "
                                 f"{self.inter_bw}")
            leaves = [
                FabricDomain(
                    name=f"p{i}", nodes=list(pod),
                    fabric=(self.intra_fabric if self.intra_fabric
                            is not None else FabricSchedule()))
                for i, pod in enumerate(self.pods)]
            self.tree = FabricDomain(
                name="cluster", bw=self.inter_bw,
                latency=self.inter_latency, children=leaves,
                fabric=(self.inter_fabric if self.inter_fabric is not None
                        else FabricSchedule()))
        self._reindex()

    # ------------------------------------------------------------ index
    def _reindex(self) -> None:
        self._domains: List[FabricDomain] = []
        self._by_name: Dict[str, FabricDomain] = {}
        self._parent: Dict[int, Optional[FabricDomain]] = {}
        self._height: Dict[int, int] = {}
        self._leaf_of: Dict[str, FabricDomain] = {}
        self._pod_of: Dict[str, int] = {}

        def walk(dom: FabricDomain, parent: Optional[FabricDomain],
                 top: int) -> int:
            if dom.nodes and dom.children:
                raise ValueError(f"domain {dom.name!r} is both a leaf "
                                 f"(nodes) and a parent (children)")
            if dom.name in self._by_name:
                raise ValueError(f"domain name {dom.name!r} appears more "
                                 f"than once in the tree")
            self._domains.append(dom)
            self._by_name[dom.name] = dom
            self._parent[id(dom)] = parent
            if dom.children:
                if dom.bw is None or dom.bw <= 0.0:
                    raise ValueError(
                        f"internal domain {dom.name!r} needs a positive "
                        f"bw, got {dom.bw}")
                h = 1 + max(walk(c, dom, i if parent is None else top)
                            for i, c in enumerate(dom.children))
            else:
                for n in dom.nodes:
                    if n in self._leaf_of:
                        raise ValueError(f"node {n!r} appears in more "
                                         f"than one domain")
                    self._leaf_of[n] = dom
                    self._pod_of[n] = top
                h = 0
            self._height[id(dom)] = h
            return h

        walk(self.tree, None, 0)
        # derived two-level view: node names under each top-level child
        def names(dom: FabricDomain) -> List[str]:
            if not dom.children:
                return list(dom.nodes)
            return [n for c in dom.children for n in names(c)]
        self.pods = ([names(c) for c in self.tree.children]
                     if self.tree.children else [names(self.tree)])

    def __deepcopy__(self, memo) -> "Topology":
        new = object.__new__(Topology)
        memo[id(self)] = new
        new.inter_bw = self.inter_bw
        new.inter_latency = self.inter_latency
        new.intra_fabric = copy.deepcopy(self.intra_fabric, memo)
        new.inter_fabric = copy.deepcopy(self.inter_fabric, memo)
        new.tree = copy.deepcopy(self.tree, memo)
        new._reindex()               # recomputes pods from the copied tree
        return new

    @classmethod
    def from_profiles(cls, profiles: Sequence[NodeProfile], *,
                      inter_bw: float,
                      inter_latency: float = DEFAULT_LATENCY,
                      pod_bw: Optional[float] = None,
                      pod_latency: float = DEFAULT_LATENCY) -> "Topology":
        """Build the tree from profile attributes.

        Without ``pod_bw``: the two-level scheme — profiles group by
        their ``pod`` attribute (None -> pod 0) into leaf domains joined
        by cross-pod paths of ``inter_bw``.  With ``pod_bw``: three
        levels — profiles group by ``(pod, rack)`` (None -> 0) into rack
        leaf domains named ``p<i>r<j>``, racks join inside pod domains
        ``p<i>`` over paths of ``pod_bw``/``pod_latency``, and pods join
        at the ``cluster`` root over ``inter_bw``/``inter_latency``.
        """
        if pod_bw is None:
            pods: Dict[int, List[str]] = {}
            for p in profiles:
                pods.setdefault(p.pod if p.pod is not None else 0,
                                []).append(p.name)
            return cls(pods=[pods[k] for k in sorted(pods)],
                       inter_bw=inter_bw, inter_latency=inter_latency)
        grouped: Dict[int, Dict[int, List[str]]] = {}
        for p in profiles:
            pi = p.pod if p.pod is not None else 0
            ri = p.rack if p.rack is not None else 0
            grouped.setdefault(pi, {}).setdefault(ri, []).append(p.name)
        pods_doms = [
            FabricDomain(
                name=f"p{pi}", bw=pod_bw, latency=pod_latency,
                children=[FabricDomain(name=f"p{pi}r{ri}",
                                       nodes=grouped[pi][ri])
                          for ri in sorted(grouped[pi])])
            for pi in sorted(grouped)]
        return cls(tree=FabricDomain(name="cluster", bw=inter_bw,
                                     latency=inter_latency,
                                     children=pods_doms))

    # ----------------------------------------------------------- lookup
    def _leaf(self, name: str) -> FabricDomain:
        try:
            return self._leaf_of[name]
        except KeyError:
            raise ValueError(f"node {name!r} is not in the topology "
                             f"(known: {sorted(self._leaf_of)})") from None

    def pod_of(self, name: str) -> int:
        """Index of the top-level domain containing ``name`` (the pod
        index under the two-level spelling)."""
        self._leaf(name)
        return self._pod_of[name]

    def domain_names(self) -> List[str]:
        return [d.name for d in self._domains]

    # ----------------------------------------------------------- fabric
    def _scope_domains(self, scope: str) -> List[FabricDomain]:
        _check_scope(scope)
        if scope == "all":
            return list(self._domains)
        if scope == "intra":
            return [d for d in self._domains if not d.children]
        if scope == "inter":
            return [d for d in self._domains if d.children]
        if scope.startswith("level:"):
            try:
                k = int(scope.split(":", 1)[1])
            except ValueError:
                raise ValueError(f"bad level scope {scope!r}") from None
            doms = [d for d in self._domains if self._height[id(d)] == k]
            if not doms:
                raise ValueError(
                    f"no domains at level {k} (tree height "
                    f"{self._height[id(self.tree)]})")
            return doms
        name = scope.split(":", 1)[1]
        if name not in self._by_name:
            raise ValueError(f"unknown domain {name!r} (known: "
                             f"{self.domain_names()})")
        return [self._by_name[name]]

    def add_fabric_window(self, start: float,
                          duration: Optional[float] = None, *,
                          bw_scale: float = 1.0, extra_latency: float = 0.0,
                          scope: str = "all") -> None:
        if scope.startswith("edge:"):
            # per-path asymmetry: the window lands on one child's
            # uplink schedule, so only routes crossing that edge pay
            name = scope.split(":", 1)[1]
            if name not in self._by_name:
                raise ValueError(f"unknown domain {name!r} (known: "
                                 f"{self.domain_names()})")
            dom = self._by_name[name]
            if self._parent[id(dom)] is None:
                raise ValueError(f"domain {name!r} is the root and has "
                                 f"no uplink edge")
            dom.uplink.add_window(start, duration, bw_scale=bw_scale,
                                  extra_latency=extra_latency)
            return
        # domains may share a schedule object (the two-level spelling
        # shares one across all pods): dedupe so a window lands once
        scheds = {id(d.fabric): d.fabric
                  for d in self._scope_domains(scope)}
        for f in scheds.values():
            f.add_window(start, duration, bw_scale=bw_scale,
                         extra_latency=extra_latency)

    def fabric_change_points(self) -> List[float]:
        pts: set = set()
        scheds = {id(s): s for d in self._domains
                  for s in (d.fabric, d.uplink)}
        for f in scheds.values():
            pts |= set(f.change_points())
        return sorted(pts)

    def participant_tree(self, names: Sequence[str]):
        """Participant-pruned domain tree as nested lists of node names
        (a leaf group is a flat name list, in caller order) — the same
        pruning :meth:`allreduce_time` prices: empty domains drop,
        single-child levels collapse.  Execution backends map this onto
        nested process groups so a real hierarchical all-reduce runs
        where the tree says it should."""
        doms = {id(self._leaf(nm)) for nm in names}

        def build(dom: FabricDomain):
            if not dom.children:
                if id(dom) not in doms:
                    return None
                return [nm for nm in names if self._leaf_of[nm] is dom]
            kids = [k for k in (build(c) for c in dom.children)
                    if k is not None]
            if not kids:
                return None
            if len(kids) == 1:
                return kids[0]
            return kids

        return build(self.tree)

    # ---------------------------------------------------------- pricing
    def allreduce_time(self, payload_bytes: float,
                       nodes: Sequence[NodeProfile], *,
                       now: float = 0.0) -> float:
        if len(nodes) <= 1:
            return 0.0
        members: Dict[int, List[NodeProfile]] = {}
        for n in nodes:
            members.setdefault(id(self._leaf(n.name)), []).append(n)
        # effective per-level links of the participant-pruned tree; the
        # same walk collects the bottleneck set for the flat fallback
        path_bws: List[float] = []
        path_lats: List[float] = []

        def build(dom: FabricDomain) -> Optional[CommDomain]:
            if not dom.children:
                g = members.get(id(dom))
                if not g:
                    return None
                scale, extra = dom.fabric.at(now)
                bw = min(n.link_bw for n in g) * scale
                if bw <= 0.0:
                    raise ValueError(
                        f"non-positive effective intra_bw {bw!r} in domain "
                        f"{dom.name!r} among {[n.name for n in g]}; check "
                        f"link_bw / bw_scale")
                lat = max(n.link_latency for n in g) + extra
                path_bws.append(bw)
                path_lats.append(lat)
                return CommDomain(bw=bw, latency=lat, size=len(g))
            pairs = [(c, k) for c, k in ((c, build(c))
                                         for c in dom.children)
                     if k is not None]
            if not pairs:
                return None
            if len(pairs) == 1:      # level not crossed: prices nothing
                return pairs[0][1]
            scale, extra = dom.fabric.at(now)
            bw = dom.bw * scale
            lat = dom.latency + extra
            ups = [c.uplink for c, _ in pairs]
            if any(_asym(u) for u in ups):
                # per-path asymmetry: the exchange at this level is
                # bottlenecked by the slowest participating child's
                # uplink; non-participating siblings' edges price
                # nothing.  Structurally guarded so the symmetric case
                # stays bit-identical to the uplink-free model.
                states = [u.at(now) for u in ups]
                bw *= min(s for s, _ in states)
                lat += max(e for _, e in states)
            if bw <= 0.0:
                raise ValueError(
                    f"non-positive effective bandwidth {bw!r} on domain "
                    f"{dom.name!r}; check bw / bw_scale")
            path_bws.append(bw)
            path_lats.append(lat)
            return CommDomain(bw=bw, latency=lat,
                              children=tuple(k for _, k in pairs))

        spec = build(self.tree)
        hier = hierarchical_allreduce_time(payload_bytes, spec)
        if not spec.children:
            return hier
        # the smallest sibling group sets the cross-phase shard
        # granularity, so a lopsided split can make the level schedule
        # lose to a plain ring threaded through the same fabric — route
        # the cheaper one
        flat = ring_allreduce_time(payload_bytes, len(nodes),
                                   min(path_bws), max(path_lats))
        return min(hier, flat)

    def _path(self, a: FabricDomain, b: FabricDomain) -> List[FabricDomain]:
        """Internal domains crossed between two leaves: each side's
        ancestors up to and including the lowest common one."""
        up_a: List[FabricDomain] = []
        d = self._parent[id(a)]
        while d is not None:
            up_a.append(d)
            d = self._parent[id(d)]
        idx = {id(x): i for i, x in enumerate(up_a)}
        up_b: List[FabricDomain] = []
        d = self._parent[id(b)]
        while d is not None and id(d) not in idx:
            up_b.append(d)
            d = self._parent[id(d)]
        if d is None:
            raise ValueError(f"domains {a.name!r} and {b.name!r} share no "
                             f"ancestor")
        return up_a[:idx[id(d)] + 1] + up_b

    def _edges(self, a: FabricDomain, b: FabricDomain
               ) -> List[FabricDomain]:
        """Child domains whose uplink edge an a->b route crosses: each
        side's chain from the leaf up to (excluding) the lowest common
        ancestor."""
        up_a: List[FabricDomain] = [a]
        d = self._parent[id(a)]
        while d is not None:
            up_a.append(d)
            d = self._parent[id(d)]
        idx = {id(x): i for i, x in enumerate(up_a)}
        up_b: List[FabricDomain] = [b]
        d = self._parent[id(b)]
        while d is not None and id(d) not in idx:
            up_b.append(d)
            d = self._parent[id(d)]
        return up_a[:idx[id(d)]] + up_b

    def point_to_point_time(self, payload_bytes: float, src: NodeProfile,
                            dst: NodeProfile, *, now: float = 0.0) -> float:
        """One-directional transfer (elastic join): bottlenecked by both
        endpoints' links and every internal level crossed between their
        leaf domains, each of which also adds its per-hop latency."""
        ls, ld = self._leaf(src.name), self._leaf(dst.name)
        sscale, sextra = ls.fabric.at(now)
        if ls is ld:
            bw = min(src.link_bw, dst.link_bw) * sscale
            lat = max(src.link_latency, dst.link_latency) + sextra
        else:
            dscale, dextra = ld.fabric.at(now)
            bw = min(src.link_bw * sscale, dst.link_bw * dscale)
            lat = max(src.link_latency + sextra, dst.link_latency + dextra)
            for dom in self._path(ls, ld):
                scale, extra = dom.fabric.at(now)
                bw = min(bw, dom.bw * scale)
                lat += dom.latency + extra
            for edge in self._edges(ls, ld):
                # a degraded uplink squeezes only routes crossing that
                # child's single edge into its parent level (the edge
                # rides the parent's per-path bw, further scaled)
                if not _asym(edge.uplink):
                    continue
                par = self._parent[id(edge)]
                us, ue = edge.uplink.at(now)
                ps, _pe = par.fabric.at(now)
                bw = min(bw, par.bw * ps * us)
                lat += ue
        if bw <= 0.0:
            raise ValueError(
                f"non-positive effective bandwidth {bw!r} between "
                f"{src.name!r} and {dst.name!r}; check link_bw / bw_scale")
        return lat + payload_bytes / bw


__all__ = ["FABRIC_SCOPES", "CommDomain", "FabricDomain", "FabricSchedule",
           "FabricWindow", "NetworkModel", "Topology", "TimedCommsMeter",
           "hierarchical_allreduce_time", "ring_allreduce_time",
           "DEFAULT_LATENCY"]
