"""Serving observability (stdlib only): :mod:`.trace` spans and the
:mod:`.metrics` registry, copied from the JAX package."""
