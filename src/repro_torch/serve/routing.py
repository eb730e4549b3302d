"""Routing policies: *which replica takes the next request*.

The port of ``repro.serve.routing``: pure host code, so the picks are the
reference's on the same load sequence. The router tier
(``repro_torch.serve.router``) dispatches one heterogeneous request stream
across N :class:`~repro_torch.serve.replica.Replica` workers; a
:class:`RoutingPolicy` makes the per-request placement call from the
replicas' live load (:class:`~repro_torch.serve.replica.ReplicaLoad`
snapshots). Policies are addressable by string through
``ROUTING_POLICIES`` -- the fourth ``repro_torch.core.registry.Registry``
family, after schedulers, update backends, and admission policies -- so
``Router(routing="least_loaded")`` stays serializable and ``register_routing_policy`` plugs in custom
strategies with the same decorator surface as the other three.

Built-ins:

- ``round_robin`` -- request i goes to replica ``i % N``, load-blind. The
  determinism anchor: with stealing off, each replica's share is a pure
  function of arrival order, so per-request results are bitwise identical
  to running that share through ``serve_async`` solo (pinned by test).
- ``least_loaded`` -- weighted shortest-queue-first: place where (pending
  depth x expected effort) is smallest. The request-granularity analog of
  Residual BP's informed-priority argument -- spend capacity where the
  backlog (in expected rounds, not just requests) is smallest.
- ``kind_affinity`` -- sticky kind -> replica placement so each replica
  sees few distinct padded shapes (denser buckets); unseen kinds seed on
  the least-loaded
  replica.
- ``deadline`` -- deadline-aware least-loaded: deadlined requests avoid
  replicas already holding urgent work (``ReplicaLoad.urgent``), spreading
  SLO pressure so one replica's backlog does not blow every deadline
  queued behind it. Policies whose ``pick`` accepts an ``slo`` keyword
  receive the request's latency budget; three-argument picks keep
  working untouched.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from repro_torch.core.registry import Registry

__all__ = ["ROUTING_POLICIES", "RoutingPolicy", "RoundRobinRouting",
           "LeastLoadedRouting", "KindAffinityRouting", "DeadlineRouting",
           "get_routing_policy", "list_routing_policies",
           "register_routing_policy"]


class RoutingPolicy:
    """Base routing policy: per-request replica placement.

    One instance drives one :class:`~repro_torch.serve.router.Router` (policies
    hold routing state -- a round-robin cursor, an affinity map -- so
    ``bind`` refuses reuse across routers, mirroring ``AdmissionPolicy``).
    Subclasses override :meth:`pick`; the contract is a single integer in
    ``range(n_replicas)`` chosen from the request's identity and the
    replicas' load snapshots. ``pick`` runs on the router thread only, so
    policies need no internal locking.
    """

    name = "base"

    def __init__(self):
        self.router = None

    def bind(self, router) -> "RoutingPolicy":
        """Attach to the driving router (called once from its constructor);
        returns self so construction chains. Rebinding a used instance
        raises -- pass a registry spec string (always constructed fresh) or
        a new instance per router."""
        if self.router is not None and self.router is not router:
            raise ValueError(
                f"{type(self).__name__} instance is already bound to a "
                "router; routing policies are per-router -- use a registry "
                "spec string or a fresh instance")
        self.router = router
        return self

    def pick(self, rid: int, kind: Tuple[int, ...],
             loads: Sequence) -> int:
        """The replica index for request ``rid`` of bucket-shape ``kind``
        given one :class:`~repro_torch.serve.replica.ReplicaLoad` per
        replica."""
        raise NotImplementedError

    @staticmethod
    def _least_loaded(loads: Sequence) -> int:
        """Smallest effort-weighted pending depth; ties break to the lowest
        index (deterministic)."""
        return min(range(len(loads)), key=lambda i: (loads[i].weight, i))


class RoundRobinRouting(RoutingPolicy):
    """Load-blind round robin: request ``rid``'s arrival position modulo
    the replica count. The determinism anchor -- each replica's share
    depends only on arrival order, never on timing -- and the right
    default for effort-homogeneous streams."""

    name = "round_robin"

    def __init__(self):
        super().__init__()
        self._next = 0

    def pick(self, rid: int, kind: Tuple[int, ...],
             loads: Sequence) -> int:
        i = self._next % len(loads)
        self._next += 1
        return i


class LeastLoadedRouting(RoutingPolicy):
    """Weighted shortest-queue placement: the replica whose pending depth,
    weighted by the shared
    :class:`~repro_torch.core.batch.RoundsHistory`'s mean
    observed rounds per kind (``ReplicaLoad.weight``), is smallest. A
    replica holding two heavy requests reads as more loaded than one
    holding three light ones -- the informed-priority idea one level above
    message scheduling."""

    name = "least_loaded"

    def pick(self, rid: int, kind: Tuple[int, ...],
             loads: Sequence) -> int:
        return self._least_loaded(loads)


class KindAffinityRouting(RoutingPolicy):
    """Sticky kind -> replica placement: every request of a bucket-shape
    kind lands on the replica that saw the kind first, so each replica
    serves few distinct padded shapes -- buckets fill denser (shapes
    scale *per replica*, not with the tier's total).
    An unseen kind seeds on the currently least-loaded replica;
    ``spread`` caps how many kinds may stick to one replica before
    placement falls back to least-loaded (0 = unbounded)."""

    name = "kind_affinity"

    def __init__(self, spread: int = 0):
        super().__init__()
        if spread < 0:
            raise ValueError(f"spread must be >= 0, got {spread}")
        self.spread = spread
        self._affinity: Dict[Tuple[int, ...], int] = {}
        self._kinds_at: Dict[int, int] = {}

    def pick(self, rid: int, kind: Tuple[int, ...],
             loads: Sequence) -> int:
        i = self._affinity.get(kind)
        if i is not None and i < len(loads):
            return i
        i = self._least_loaded(loads)
        if not self.spread or self._kinds_at.get(i, 0) < self.spread:
            self._affinity[kind] = i
            self._kinds_at[i] = self._kinds_at.get(i, 0) + 1
        return i


class DeadlineRouting(RoutingPolicy):
    """Deadline-aware least-loaded placement.

    A request carrying an SLO (the router passes ``slo`` because this
    ``pick`` declares the keyword) lands on the replica minimizing
    effort-weighted depth *plus* an urgency penalty per deadlined request
    already queued there (``ReplicaLoad.urgent``), so SLO pressure spreads
    across the fleet instead of stacking behind one replica's backlog.
    Requests without a deadline place plain least-loaded -- they can
    afford to wait behind urgent work."""

    name = "deadline"

    def __init__(self, urgency_weight: float = 1.0):
        super().__init__()
        if urgency_weight < 0:
            raise ValueError(
                f"urgency_weight must be >= 0, got {urgency_weight}")
        self.urgency_weight = urgency_weight

    def pick(self, rid: int, kind: Tuple[int, ...],
             loads: Sequence, slo: "float | None" = None) -> int:
        if slo is None:
            return self._least_loaded(loads)
        return min(range(len(loads)),
                   key=lambda i: (loads[i].weight
                                  + self.urgency_weight * loads[i].urgent,
                                  i))


#: name -> RoutingPolicy class; names are the canonical serialized form
#: (``Router(routing=...)``). A ``Registry`` (dict subclass): plain-dict
#: reads keep working, unknown names raise the uniform registry KeyError.
ROUTING_POLICIES: Registry[type] = Registry("routing policy", {
    "round_robin": RoundRobinRouting,
    "least_loaded": LeastLoadedRouting,
    "kind_affinity": KindAffinityRouting,
    "deadline": DeadlineRouting,
})


def register_routing_policy(name: str, *, overwrite: bool = False):
    """Class decorator registering a :class:`RoutingPolicy` subclass under
    ``name`` (lowercased), making it addressable by string spec --
    ``Router(routing="mine")`` -- exactly like ``register_scheduler`` /
    ``register_admission_policy``. Duplicate names raise ``ValueError``
    unless ``overwrite=True``."""
    return ROUTING_POLICIES.register(name, overwrite=overwrite)


def list_routing_policies() -> List[str]:
    """Sorted registered routing-policy names (valid ``Router(routing=...)``
    specs)."""
    return ROUTING_POLICIES.names()


def get_routing_policy(spec, **kwargs) -> RoutingPolicy:
    """Resolve a routing-policy spec: a registry name (+ constructor
    kwargs) or an already-built :class:`RoutingPolicy` instance (kwargs
    must then be empty)."""
    if isinstance(spec, str):
        return ROUTING_POLICIES.lookup(spec)(**kwargs)
    if kwargs:
        raise ValueError("routing kwargs only apply to string specs, got "
                         f"instance {type(spec).__name__} plus {kwargs}")
    return spec
