"""Distributed utilities of the port (``repro/distributed``): gradient
compression and fault tolerance, and the multi-device serving path's
sharding rules (``sharding``), hints and sharded weights (``ctx``) and
collectives (``collectives``)."""
