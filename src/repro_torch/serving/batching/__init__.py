"""Continuous-batching serving subsystem (PyTorch port of
``repro/serving/batching/``).

Request lifecycle (:mod:`.request`), bounded admission queue (:mod:`.queue`),
slot-based KV cache pool (:mod:`.slots`), the scheduler that runs them over
the shared step functions (:mod:`.engine`), and Poisson traffic with its
replay driver (:mod:`.traffic`).
"""
from .engine import ContinuousEngine
from .queue import QueueFullError, RequestQueue
from .request import Request, RequestState, SamplingParams
from .slots import SlotBatchManager
from .traffic import poisson_trace, replay

__all__ = [
    "ContinuousEngine", "QueueFullError", "Request", "RequestQueue",
    "RequestState", "SamplingParams", "SlotBatchManager", "poisson_trace",
    "replay",
]
