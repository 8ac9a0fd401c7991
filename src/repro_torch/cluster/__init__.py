"""repro_torch.cluster — event-driven cluster runtime for AdLoCo.  Port
of ``repro/cluster``.

Runs real AdLoCo numerics (the same ``TrainerRound`` primitives as
``repro_torch.core.adloco``, on the card unless the caller names another
device) over simulated heterogeneous nodes, so the paper's
dynamic-workload scenarios — stragglers, congested fabrics, flapping
racks, pod partitions, trainers joining and leaving — can be exercised
and timed.  The division of labor:

* a network model (``NetworkModel`` / ``Topology``) describes **where**
  a collective runs — which fabric domains it crosses and what each
  level's paths cost on the simulated clock;
* an execution backend (``repro_torch.cluster.backend``) supplies
  **how** it executes: ``SimBackend`` prices it analytically and
  reduces the workers' tensors in this process; ``TorchProcessBackend``
  runs one process per worker and executes it as real
  ``torch.distributed`` all-reduces (``python -m
  repro_torch.cluster.launch_mp`` spawns the processes);
* the scenario decides **what happens** while it runs.

None of the three may change the numerics: the sync policy with merging
off gives the host loop ``train_adloco``'s numerics under every network
model.  Time is pure Python float arithmetic in the JAX package's
order, so a run's ``ClusterReport.summary()``, ``applied_events`` and
``Trace.sim_digest()`` equal the JAX package's on the same inputs.

Quick start (on the CPU, as the tests run it)::

    from repro_torch.cluster import (Topology, make_rack_profiles,
                                     run_cluster)

    # 3-level fabric: 2 pods x 2 racks x 2 nodes; 400 Gb/s NDR between
    # pods, four such links between the racks of a pod
    profiles = make_rack_profiles([[2, 2], [2, 2]], ratio=2.0)
    topo = Topology.from_profiles(profiles, inter_bw=400e9 / 8,
                                  pod_bw=4 * 400e9 / 8)
    pool, hist, report = run_cluster(loss_fn, inits, streams, acfg,
                                     policy="async", profiles=profiles,
                                     network=topo, device="cpu",
                                     scenario="correlated_pod_failure")
    # hist.sim_time x hist.loss -> progress under the simulated clock

Sync policies
-------------
``sync``
    Barrier semantics of ``train_adloco``: a trainer blocks on its outer
    all-reduce before its next round.  Use it as the ground truth.
``async``
    ACCO-style overlap: workers keep computing while the outer
    all-reduce is in flight; the delayed pseudo-gradient applies on
    arrival and workers rebase onto it.  With adaptive batching the
    round's batch statistics ride the outer sync as one fused
    ``piggyback`` collective and the decision folds when it lands.
``elastic``
    ``async`` plus scripted ``ClusterEvent``\\ s — trainers leave
    (folded into the pool via ``mit.do_merge``) and join (cloned from
    the most-advanced trainer onto spare nodes and streams); merges are
    round-tagged and skip trainers that drifted past
    ``acfg.merge_drift_window``.  ``ClusterSpec(autoscale=
    BandAutoscale(...))`` lets a policy script joins and leaves from the
    batch trajectory.

Reporting: ``ClusterReport.summary()`` (the digest surface) and
``summary(extended=True)``; ``Trace`` records typed spans and instants
(``run_cluster(trace=Trace())``), exports Perfetto JSON
(``to_perfetto``) and derives the utilization ledger and the overlap
fraction; ``python -m repro_torch.cluster.trace_report <trace.json>``
prints them.  Scenarios are registered by name in
``repro_torch.cluster.scenarios`` (the JAX package's fourteen, with its
default knobs).

The node defaults are one NVIDIA H100 SXM (``node.py`` gives each
constant's source); a ``Topology``'s links between pods are the
caller's.  ``TorchProcessBackend`` is the counterpart of the JAX
package's ``JaxProcessBackend``; its launcher joins the ranks in one
gloo group, which carries CPU and CUDA tensors alike (on one card every
rank shares it).
"""
from repro_torch.cluster.autoscale import BandAutoscale, ElasticPolicy
from repro_torch.cluster.backend import (CollectiveBackend, SimBackend,
                                         TorchProcessBackend)
from repro_torch.cluster.network import (FABRIC_SCOPES, CommDomain,
                                         FabricDomain, FabricSchedule,
                                         FabricWindow, NetworkModel,
                                         Topology)
from repro_torch.cluster.node import (NodeProfile, Slowdown, interleave_pods,
                                      make_heterogeneous_profiles,
                                      make_pod_profiles, make_rack_profiles)
from repro_torch.cluster.runtime import (POLICIES, ClusterEvent,
                                         ClusterReport, ClusterSpec,
                                         run_cluster)
from repro_torch.cluster.scenarios import (SCENARIOS, Scenario,
                                           build_scenario, list_scenarios,
                                           register_scenario)
from repro_torch.cluster.trace import (Span, Trace, TraceEvent,
                                       validate_perfetto)

__all__ = [
    "FABRIC_SCOPES", "POLICIES", "SCENARIOS", "BandAutoscale",
    "ClusterEvent", "ClusterReport", "ClusterSpec", "CollectiveBackend",
    "CommDomain", "ElasticPolicy", "FabricDomain", "FabricSchedule",
    "FabricWindow", "NetworkModel", "NodeProfile", "Scenario",
    "SimBackend", "Slowdown", "Span", "Topology", "TorchProcessBackend",
    "Trace", "TraceEvent",
    "build_scenario", "interleave_pods", "list_scenarios",
    "make_heterogeneous_profiles", "make_pod_profiles",
    "make_rack_profiles", "register_scenario", "run_cluster",
    "validate_perfetto",
]
