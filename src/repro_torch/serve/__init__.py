"""repro_torch.serve: the router/replica serving tier -- N
``ServingPipeline`` replicas behind one request front-end.

The port of ``repro.serve``. A :class:`Router` consumes one heterogeneous
request stream and fans it out across N :class:`Replica` workers -- each a
``ServingPipeline`` on its own thread, with its own bounded inbox, its own
engine and, on a GPU, its own CUDA stream -- then merges the per-request
records back into one completion-order stream with replica attribution and
tier-level p50/p90/p99 latency.

Placement is a pluggable :class:`RoutingPolicy` (``ROUTING_POLICIES``):
``round_robin`` (the determinism anchor), ``least_loaded``
(effort-weighted shortest queue, via the shared thread-safe
``RoundsHistory``), ``kind_affinity`` (sticky shape placement per
replica), ``deadline`` (deadline-aware least-loaded). Watermark-triggered
**work stealing** rebalances skew at runtime: a replica whose pending work
drains pulls a batch from the deepest peer's inbox tail. Both are
bitwise-invisible in results -- a request's trajectory depends only on
(rid, padded shape), which no placement decision changes; with
``round_robin`` and stealing off the tier is pinned bitwise-identical to
running each replica's share through ``serve_async`` solo.

Entry points: :func:`serve_routed` (collect everything), :class:`Router`
(incremental generator + context manager). An engine list on sub-meshes of
a ``torch.distributed`` world (``repro_torch.dist.make_sharded_engine``,
one mesh a replica) spans processes: world rank 0 is the front, each mesh's
rank 0 leads its replica, and a :class:`RemoteReplica` stands for a replica
led elsewhere (``router``'s module docstring).
"""

from repro_torch.serve.replica import (RemoteReplica, Replica, ReplicaLoad,
                                       RoutedRecord)
from repro_torch.serve.router import (Router, RouterResult, RouterStats,
                                      serve_routed)
from repro_torch.serve.routing import (DeadlineRouting, KindAffinityRouting,
                                       LeastLoadedRouting, ROUTING_POLICIES,
                                       RoundRobinRouting, RoutingPolicy,
                                       get_routing_policy,
                                       list_routing_policies,
                                       register_routing_policy)

__all__ = [
    "DeadlineRouting", "KindAffinityRouting", "LeastLoadedRouting",
    "ROUTING_POLICIES",
    "RemoteReplica", "Replica", "ReplicaLoad", "RoundRobinRouting",
    "RoutedRecord",
    "Router", "RouterResult", "RouterStats", "RoutingPolicy",
    "get_routing_policy", "list_routing_policies",
    "register_routing_policy", "serve_routed",
]
