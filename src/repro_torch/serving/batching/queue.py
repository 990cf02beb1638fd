"""Bounded admission queue for continuous-batching serving (PyTorch port of
``repro/serving/batching/queue.py``, without the paged engine's ``peek``
and the fleet's ``requeue``; stdlib only).

FIFO with two control points:

* **Backpressure** — ``submit`` raises :class:`QueueFullError` once
  ``max_queue`` requests are waiting (the caller sheds load instead of the
  engine hoarding unbounded host memory).
* **Deadlines** — a request may carry ``deadline_s`` (max seconds it is
  willing to wait for admission); ``pop`` lazily expires overdue requests
  instead of handing dead work to the batch.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Deque, List, Optional

from repro_torch.obs import metrics as obs_metrics
from .request import Request, RequestState


class QueueFullError(RuntimeError):
    """Raised by submit when the queue is at its bound."""


class RequestQueue:
    def __init__(self, max_queue: int = 64):
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.max_queue = max_queue
        self._q: Deque[Request] = deque()
        self.expired: List[Request] = []     # deadline casualties, for metrics
        self.n_rejected = 0

    def __len__(self) -> int:
        return len(self._q)

    def submit(self, req: Request, now: Optional[float] = None) -> Request:
        """Admit ``req`` to the waiting line (stamps ``t_arrival``)."""
        if len(self._q) >= self.max_queue:
            self.n_rejected += 1
            req.state = RequestState.REJECTED
            req.finish_reason = "queue_full"
            obs_metrics.counter("queue.shed").inc(reason="queue_full")
            raise QueueFullError(
                f"queue at bound ({self.max_queue} waiting); request "
                f"{req.rid} rejected")
        req.t_arrival = time.monotonic() if now is None else now
        req.state = RequestState.QUEUED
        self._q.append(req)
        obs_metrics.counter("queue.submitted").inc()
        obs_metrics.gauge("queue.depth").set(len(self._q))
        return req

    def pop(self, now: Optional[float] = None) -> Optional[Request]:
        """Next admissible request, or None.  Overdue requests are expired in
        passing (state EXPIRED, ``finish_reason="deadline"``)."""
        now = time.monotonic() if now is None else now
        while self._q:
            req = self._q.popleft()
            obs_metrics.gauge("queue.depth").set(len(self._q))
            if req.expired(now):
                req.state = RequestState.EXPIRED
                req.finish_reason = "deadline"
                req.t_finished = now
                self.expired.append(req)
                obs_metrics.counter("queue.shed").inc(reason="deadline")
                if req.t_arrival is not None:
                    obs_metrics.histogram("queue.wait_s").observe(
                        now - req.t_arrival, outcome="shed")
                continue
            return req
        return None
