"""Request router over data-parallel engine replicas (PyTorch port of
``repro/serving/fleet/router.py``; host code only).

One :class:`Router` fronts N replica queues.  It owns three decisions:

* **Placement** — which UP replica takes the next request.  Policies are
  pluggable by name (``POLICIES``): ``round-robin`` rotates; ``least-loaded``
  ranks replicas by ``queue depth + occupied slots`` with the replica index
  as the deterministic tie-break (equal load never routes differently on two
  runs — ``tests/fleet/test_router.py`` pins this).
* **Backpressure** — a replica whose queue is at its bound is skipped this
  round; when every candidate is full, ``dispatch`` returns None and the
  request stays at the fleet intake for the next pump (never dropped).
* **Shedding** — requests whose admission deadline passed shed with reason
  ``deadline`` (the same lazy-expiry semantics as ``RequestQueue.peek``);
  requests with no UP replica to run on shed with reason ``no_replica``.
  Every shed increments ``fleet.shed{reason}`` and lands in ``self.shed``.

Replica health is a three-state machine on :class:`ReplicaHandle`:
UP (routable) → DRAINING (finishes in-flight work, accepts nothing new) →
FAILED (dead; the driver evacuates and redrives its requests).  DRAINING and
FAILED are both non-routable; only FAILED triggers redrive.

Thread-crossing contract: ``dispatch`` and ``_shed`` mutate router state
under ``self._lock``.
The load snapshot a policy ranks on is racy-but-benign: a replica worker
popping its queue mid-ranking only makes the chosen replica *less* loaded
than estimated, and the post-choice queue-bound check keeps backpressure
exact for the single dispatching thread.
"""
from __future__ import annotations

import enum
import threading
import time
from typing import Callable, List, Optional

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from ..batching.engine import ContinuousEngine
from ..batching.request import Request, RequestState

POLICIES = ("round-robin", "least-loaded")


class ReplicaState(enum.Enum):
    UP = "up"
    DRAINING = "draining"    # finishes in-flight work, accepts no new work
    FAILED = "failed"        # dead; requests evacuated and redriven


class ReplicaHandle:
    """One engine replica as the router sees it: identity, health, load."""

    def __init__(self, idx: int, engine: ContinuousEngine, device=None):
        self.idx = idx
        self.engine = engine
        self.device = device          # the torch device its engine serves on
        self.state = ReplicaState.UP

    @property
    def queue_depth(self) -> int:
        return len(self.engine.queue)

    @property
    def occupied_slots(self) -> int:
        # alloc registers mid-prefill requests too, so this counts every
        # request physically on the replica
        return self.engine.slots.n_slots - self.engine.slots.n_free

    @property
    def load(self) -> int:
        """The least-loaded ranking key: waiting + running requests."""
        return self.queue_depth + self.occupied_slots

    @property
    def accepting(self) -> bool:
        return self.state is ReplicaState.UP

    def __repr__(self) -> str:
        return (f"ReplicaHandle(idx={self.idx}, state={self.state.value}, "
                f"load={self.load})")


class Router:
    """Dispatch one request stream across replica queues."""

    def __init__(self, replicas: List[ReplicaHandle], *,
                 policy: str = "round-robin",
                 admission_gate: Optional[
                     Callable[[ReplicaHandle, Request], bool]] = None):
        if policy not in POLICIES:
            raise ValueError(f"unknown router policy {policy!r}; "
                             f"choose from {', '.join(POLICIES)}")
        if not replicas:
            raise ValueError("router needs at least one replica")
        self.replicas = replicas
        self.policy = policy
        # test/chaos seam: called (replica, request) before a submit; False
        # vetoes this replica for this round (fault harness rejection plans)
        self.admission_gate = admission_gate
        self.shed: List[Request] = []
        self.n_dispatched = 0
        self._rr = 0                  # round-robin cursor
        self._lock = threading.Lock()

    # ------------------------------------------------------------- ranking
    def _candidates(self) -> List[ReplicaHandle]:
        """Routable replicas in policy preference order (deterministic)."""
        up = [h for h in self.replicas if h.accepting]
        if not up:
            return []
        if self.policy == "round-robin":
            k = self._rr % len(up)
            return up[k:] + up[:k]
        # least-loaded; idx breaks ties so equal load is reproducible
        return sorted(up, key=lambda h: (h.load, h.idx))

    # ------------------------------------------------------------ dispatch
    def dispatch(self, req: Request,
                 now: Optional[float] = None) -> Optional[ReplicaHandle]:
        """Place ``req`` on a replica queue, or shed it, or defer it.

        Returns the chosen handle on success.  Returns None in two distinct
        situations the caller tells apart via ``req.done``:

        * ``req.done`` — the request was *shed* terminally (deadline passed,
          or no UP replica exists); it is in ``self.shed`` with
          ``finish_reason`` set and the ``fleet.shed{reason}`` count bumped.
        * not done — pure backpressure (every UP replica full or vetoed);
          the request belongs back at the intake for a later pump.
        """
        with self._lock:
            now = time.monotonic() if now is None else now
            if req.expired(now):
                self._shed_locked(req, "deadline", now)
                return None
            cands = self._candidates()
            if not cands:
                self._shed_locked(req, "no_replica", now)
                return None
            with obs_trace.span("fleet.dispatch", rid=req.rid,
                                policy=self.policy):
                for h in cands:
                    if len(h.engine.queue) >= h.engine.queue.max_queue:
                        continue      # per-replica backpressure: skip, not shed
                    if self.admission_gate is not None \
                            and not self.admission_gate(h, req):
                        obs_metrics.counter("fleet.admission_rejects").inc()
                        continue
                    h.engine.submit_request(req)
                    self._rr += 1
                    self.n_dispatched += 1
                    obs_metrics.counter("fleet.dispatched").inc(
                        replica=h.idx)
                    return h
            return None

    def _shed_locked(self, req: Request, reason: str,
                     now: Optional[float] = None) -> None:
        """Terminal shed (caller holds the lock): mirror the queue's expiry
        bookkeeping at the fleet boundary."""
        req.state = RequestState.EXPIRED if reason == "deadline" \
            else RequestState.REJECTED
        req.finish_reason = reason
        req.t_finished = time.monotonic() if now is None else now
        self.shed.append(req)
        obs_metrics.counter("fleet.shed").inc(reason=reason)

    def shed_request(self, req: Request, reason: str,
                     now: Optional[float] = None) -> None:
        """Public terminal-shed entry for the driver (intake overflow,
        undeliverable handoffs)."""
        with self._lock:
            self._shed_locked(req, reason, now)

    # -------------------------------------------------------------- health
    @property
    def n_up(self) -> int:
        return sum(1 for h in self.replicas if h.state is ReplicaState.UP)
