"""Fleet serving (PyTorch port of ``repro/serving/fleet/``): data-parallel
engine replicas behind a request router, with an optional disaggregated
prefill/decode split.

This package scales *engines* — N :class:`~repro_torch.serving.batching.
engine.ContinuousEngine` replicas from one compressed container, a
:class:`Router` with pluggable placement policies, health states, and
deadline-aware shedding, and a :class:`HandoffCoordinator` shipping
prefilled KV between replicas as entropy-coded block payloads (the cold
tier's codec round-trip as wire format).  The whole fleet stays
per-request bit-identical to a single engine
(``tests/test_torch_fleet_identity.py``).
"""
from .driver import FleetDriver
from .handoff import HandoffCoordinator, HandoffPayload
from .router import POLICIES, ReplicaHandle, ReplicaState, Router

__all__ = [
    "FleetDriver", "HandoffCoordinator", "HandoffPayload", "POLICIES",
    "ReplicaHandle", "ReplicaState", "Router",
]
