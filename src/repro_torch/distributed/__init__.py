"""Distributed training utilities of the port (``repro/distributed``, the
parts that are local math or host logic): gradient compression and fault
tolerance."""
