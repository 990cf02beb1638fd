"""Checkpointing (port of ``repro/checkpoint``)."""
