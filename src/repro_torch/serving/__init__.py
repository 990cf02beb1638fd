"""Lockstep serving: the weight load path and :class:`.engine.Engine`."""
