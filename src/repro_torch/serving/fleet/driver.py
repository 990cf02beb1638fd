"""Data-parallel fleet of ContinuousEngine replicas (PyTorch port of
``repro/serving/fleet/driver.py``).

Topology: one bounded **intake** queue at the fleet boundary, a
:class:`~repro_torch.serving.fleet.router.Router` spreading intake over N
replica queues, and optionally a disaggregated split where the first P replicas run
prefill-only (their ``handoff_sink`` exports finished prompt KV) and the
remaining D replicas decode-only, bridged by a
:class:`~repro_torch.serving.fleet.handoff.HandoffCoordinator`.

Weights: all replicas serve from ONE compressed container.
``from_container`` decodes it once and shares the tree
(``weights="share"``) or decodes one copy per replica
(``weights="per-replica"`` — the multi-host stand-in); ``weight_bytes()``
accounts both honestly, counting a copy per device when replicas are
placed on distinct ``devices``.  Replica ``i`` serves on ``devices[i %
len(devices)]``; with ``devices=None`` every engine resolves its device as
each entry point does (``cuda``, raising without a card).  Every replica
shares one :class:`~repro_torch.serving.engine.ServeSteps`, so all replicas
run the SAME step functions, and a replica's continuous step has the same
shapes as a single engine's with as many slots (all ``n_slots`` lanes a
decode step, ``(1, chunk)`` a prefill chunk) — so no output row depends on
its neighbours' values, which is what makes the fleet bit-identity contract
(any request's greedy tokens == a single engine's, regardless of replica
count, policy, or failures) hold on a card as on the CPU.

Drive modes:

* ``step()`` / ``run()`` — deterministic lockstep: pump dispatch, step every
  live replica once, pump the handoff.  Single-threaded; what the fault
  and identity tests (and ``launch/serve.py --replicas``) use.
* ``start_workers()`` / ``stop_workers()`` — one thread per replica stepping
  its own engine, with dispatch pumped from the submitting thread
  (``traffic.replay_fleet(threaded=True)``).  Replicas on one card queue
  onto its one default stream, so the threads overlap host dispatch at
  most; plain DP only — disaggregation is lockstep-only because adopting
  into a stepping engine would race its block pool.

Failure semantics: ``kill_replica`` marks the handle FAILED (its worker, if
any, exits and is joined), evacuates every queued / mid-prefill / decoding
request off the engine, resets each (``Request.requeue`` — generated tokens
discarded; determinism regenerates them bit-identically) and re-enqueues
them at the *front* of the intake in arrival order.  Nothing is lost,
nothing runs twice to completion.  ``drain_replica`` stops new placements
but lets in-flight work finish.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.spec import KVCompressionSpec
from repro_torch.models.layers import QT, QT4, to_device
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from ..engine import ServeConfig, ServeSteps
from ..batching.engine import ContinuousEngine
from ..batching.queue import QueueFullError, RequestQueue
from ..batching.request import Request, SamplingParams
from .handoff import HandoffCoordinator
from .router import ReplicaHandle, ReplicaState, Router


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of a params dict, QT / QT4 triples taken apart."""
    out: List[torch.Tensor] = []
    for v in tree.values():
        out.extend(v if isinstance(v, (QT, QT4)) else (v,))
    return out


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _on(tree, dev: torch.device) -> bool:
    """Every tensor of ``tree`` already on ``dev`` (``cuda`` without an
    index meaning any card's current device, as ``.to`` reads it)."""
    return all(t.device.type == dev.type
               and dev.index in (None, t.device.index)
               for t in _tensors(tree))


class FleetDriver:
    """N data-parallel engine replicas behind one router."""

    def __init__(self, cfg: ArchConfig, params: Any, sc: ServeConfig, *,
                 n_replicas: int = 2,
                 policy: str = "round-robin",
                 n_slots: int = 4,
                 max_queue: int = 16,
                 prefill_chunk: int = 8,
                 admit_chunks_per_step: int = 4,
                 kv_spec: Optional[KVCompressionSpec] = None,
                 kv_blocks: Optional[int] = None,
                 max_intake: int = 256,
                 disaggregate: Optional[Tuple[int, int]] = None,
                 handoff_transport=None,
                 devices: Optional[List[Any]] = None,
                 steps: Optional[ServeSteps] = None,
                 admission_gate=None,
                 replica_params: Optional[List[Any]] = None):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        if disaggregate is not None:
            P, D = disaggregate
            if P < 1 or D < 1:
                raise ValueError(f"disaggregate needs >= 1 prefill and >= 1 "
                                 f"decode replica, got {disaggregate}")
            if P + D != n_replicas:
                raise ValueError(f"disaggregate {P}:{D} must sum to "
                                 f"n_replicas={n_replicas}")
            if kv_spec is None:
                raise ValueError(
                    "disaggregated mode needs the paged KV cache (kv_spec): "
                    "the handoff ships entropy-coded block payloads")
        self.cfg = cfg
        self.sc = sc
        self.prefill_chunk = prefill_chunk
        self.disaggregate = disaggregate
        # one ServeSteps for the whole fleet: replica-count-independent
        # numerics by construction
        self.steps = steps if steps is not None else ServeSteps(cfg, sc)

        # ---- weight placement: share one tree or hold one per replica ----
        if replica_params is not None:
            if len(replica_params) != n_replicas:
                raise ValueError(f"replica_params has {len(replica_params)} "
                                 f"trees for {n_replicas} replicas")
            self.weight_mode = "per-replica"
            trees = list(replica_params)
        else:
            self.weight_mode = "share"
            trees = [params] * n_replicas
        if devices is not None:
            if not devices:
                raise ValueError("devices list is empty")
            devices = [torch.device(d) for d in devices]
            placed: Dict[tuple, Any] = {}
            pinned = []
            for i, tree in enumerate(trees):
                dev = devices[i % len(devices)]
                key = (id(tree), str(dev))
                if key not in placed:
                    # sharing across distinct devices = one copy per
                    # device; weight_bytes() counts each copy
                    placed[key] = tree if _on(tree, dev) else \
                        {k: to_device(v, dev) for k, v in tree.items()}
                pinned.append(placed[key])
            trees = pinned
        self._replica_trees = trees

        # ---- replicas -----------------------------------------------------
        n_prefill = disaggregate[0] if disaggregate else n_replicas
        self.replicas: List[ReplicaHandle] = []
        for i in range(n_replicas):
            eng = ContinuousEngine(
                cfg, trees[i], sc, n_slots=n_slots, max_queue=max_queue,
                prefill_chunk=prefill_chunk,
                admit_chunks_per_step=admit_chunks_per_step,
                steps=self.steps, kv_spec=kv_spec, kv_blocks=kv_blocks,
                # the sink is wired after the coordinator exists (below);
                # construction order: decode handles -> coordinator -> sinks
                handoff_sink=None,
                device=devices[i % len(devices)] if devices else None)
            self.replicas.append(ReplicaHandle(i, eng, device=eng.device))
        self.prefill_replicas = self.replicas[:n_prefill]
        self.decode_replicas = self.replicas[n_prefill:]

        self.handoff: Optional[HandoffCoordinator] = None
        if disaggregate is not None:
            self.handoff = HandoffCoordinator(
                self.decode_replicas, transport=handoff_transport)
            for h in self.prefill_replicas:
                h.engine.handoff_sink = self.handoff.sink

        # router targets: replicas that ADMIT new requests (prefill side
        # under disaggregation; everyone otherwise)
        self.router = Router(self.prefill_replicas, policy=policy,
                             admission_gate=admission_gate)
        self.intake = RequestQueue(max_intake)
        self.n_steps = 0
        self.n_submitted = 0
        self._threads: Dict[int, threading.Thread] = {}
        self._stop_flag = False
        self._lock = threading.Lock()
        self._update_gauges()

    # ------------------------------------------------------------ factories
    @classmethod
    def from_container(cls, cm, cfg: ArchConfig, sc: ServeConfig, *,
                       n_replicas: int = 2, weights: str = "share",
                       backend: Optional[str] = None, **kw) -> "FleetDriver":
        """Build a fleet from one compressed container.

        ``weights="share"`` decodes the container ONCE and every replica
        serves the same resident tree (decode-once-then-share — the
        single-host fleet).  ``weights="per-replica"`` decodes one copy per
        replica (the multi-host stand-in: each host pays its own decode and
        holds its own bytes).  Both are accounted by ``weight_bytes()``.
        Each copy is decoded straight onto the device of the first replica
        that serves it (``devices``, else ``cuda``), through ``backend``.
        """
        from ..engine import load_params_from_compressed
        if weights not in ("share", "per-replica"):
            raise ValueError(f"weights must be 'share' or 'per-replica', "
                             f"got {weights!r}")
        devices = kw.get("devices")

        def load(i):
            dev = devices[i % len(devices)] if devices else None
            return load_params_from_compressed(cm, backend=backend,
                                               device=dev)

        if weights == "share":
            return cls(cfg, load(0), sc, n_replicas=n_replicas, **kw)
        replica_params = [load(i) for i in range(n_replicas)]
        return cls(cfg, None, sc, n_replicas=n_replicas,
                   replica_params=replica_params, **kw)

    # ------------------------------------------------------------ accounting
    def weight_bytes(self) -> Dict[str, Any]:
        """Resident weight bytes across the fleet, honestly counted: one
        entry per distinct in-memory tree (sharing collapses to one copy;
        per-replica or per-device placement counts each copy; a QT / QT4
        triple counts its symbols, scales and zeros)."""
        unique: Dict[int, Any] = {}
        for tree in self._replica_trees:
            unique[id(tree)] = tree
        per_copy = [_tree_bytes(t) for t in unique.values()]
        return {"mode": self.weight_mode, "copies": len(per_copy),
                "bytes_per_copy": per_copy[0] if per_copy else 0,
                "total_bytes": sum(per_copy)}

    # ---------------------------------------------------------------- submit
    def submit(self, prompt, max_new_tokens: int, *,
               sampling: SamplingParams = SamplingParams(),
               eos_id: Optional[int] = None,
               deadline_s: Optional[float] = None) -> Request:
        """Queue one request at the fleet intake (raises ``QueueFullError``
        under intake backpressure, with the shed recorded)."""
        req = Request(prompt=prompt, max_new_tokens=max_new_tokens,
                      sampling=sampling, eos_id=eos_id, deadline_s=deadline_s)
        P = req.prompt_len
        chunks = -(-P // self.prefill_chunk) * self.prefill_chunk
        need = max(P + max_new_tokens, chunks)
        if need > self.sc.max_len:
            raise ValueError(
                f"request {req.rid} needs {need} cache rows but max_len is "
                f"{self.sc.max_len}")
        try:
            self.intake.submit(req)
        except QueueFullError:
            self.router.shed_request(req, "queue_full")
            raise
        self.n_submitted += 1
        obs_metrics.counter("fleet.submitted").inc()
        return req

    # ------------------------------------------------------------- dispatch
    def pump(self) -> int:
        """Move intake requests onto replica queues through the router.

        Pops in FIFO order; a request the router defers (pure backpressure)
        goes back to the *front* of the intake and the pump stops — FIFO
        order is part of the determinism contract.  Intake requests whose
        deadline lapsed expire in passing (``RequestQueue`` lazy expiry)
        and are mirrored to ``fleet.shed{deadline}``.
        """
        if not len(self.intake):
            self._update_gauges()
            return 0
        with obs_trace.span("fleet.pump", depth=len(self.intake)):
            n_exp0 = len(self.intake.expired)
            dispatched = 0
            while True:
                req = self.intake.pop()
                if req is None:
                    break
                h = self.router.dispatch(req)
                if h is not None:
                    dispatched += 1
                    continue
                if req.done:
                    continue          # shed terminally by the router
                self.intake.requeue(req)
                break                 # backpressure: retry next pump
            for _ in range(len(self.intake.expired) - n_exp0):
                obs_metrics.counter("fleet.shed").inc(reason="deadline")
            self._update_gauges()
            return dispatched

    # -------------------------------------------------------------- stepping
    def step(self) -> bool:
        """One lockstep fleet iteration: dispatch, step every live replica,
        pump the handoff.  Returns False when nothing moved — with no
        external intervention (fault plans), a False step means the fleet is
        drained or permanently stuck, so ``run()`` stops."""
        self.n_steps += 1
        moved = self.pump() > 0
        for h in self.replicas:
            if h.state is ReplicaState.FAILED:
                continue
            if h.engine.has_work:
                moved |= h.engine.step()
        if self.handoff is not None:
            delivered, ticked = self.handoff.pump(
                shed=self.router.shed_request)
            moved |= delivered > 0 or ticked > 0
        self._update_gauges()
        return moved

    def run(self, max_steps: Optional[int] = None) -> List[Request]:
        """Lockstep to completion (or ``max_steps``); returns finished."""
        steps = 0
        while self.has_work:
            if not self.step():
                break                 # drained or stuck — state inspectable
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return self.finished

    @property
    def has_work(self) -> bool:
        if len(self.intake):
            return True
        if self.handoff is not None and self.handoff.pending:
            return True
        return any(h.state is not ReplicaState.FAILED and h.engine.has_work
                   for h in self.replicas)

    # ------------------------------------------------------------ harvesting
    @property
    def finished(self) -> List[Request]:
        """Finished requests across all replicas, by rid (deterministic)."""
        out: List[Request] = []
        for h in self.replicas:
            out.extend(h.engine.finished)
        return sorted(out, key=lambda r: r.rid)

    @property
    def shed(self) -> List[Request]:
        """Every terminally shed request: fleet-boundary sheds (router),
        intake deadline expiries, and replica-queue deadline expiries."""
        out = list(self.router.shed) + list(self.intake.expired)
        for h in self.replicas:
            out.extend(h.engine.queue.expired)
        return out

    # ---------------------------------------------------------------- health
    def kill_replica(self, idx: int) -> List[Request]:
        """Fail replica ``idx`` and redrive its requests through the intake.

        Returns the evacuated requests (already reset and re-enqueued,
        oldest first).  Idempotent: a second kill returns []."""
        h = self.replicas[idx]
        if h.state is ReplicaState.FAILED:
            return []
        h.state = ReplicaState.FAILED
        t = self._threads.get(h.idx)
        if t is not None:
            t.join(timeout=60.0)      # worker sees FAILED and exits
            if t.is_alive():
                raise RuntimeError(f"replica {idx} worker failed to stop")
        victims = h.engine.evacuate()
        for r in victims:
            r.requeue()
        if victims:
            obs_metrics.counter("fleet.redrives").inc(len(victims))
        for r in reversed(victims):   # front-insert keeps arrival order
            self.intake.requeue(r)
        self._update_gauges()
        return victims

    def drain_replica(self, idx: int) -> ReplicaHandle:
        """Stop routing new work to replica ``idx``; in-flight work (queued
        included) finishes normally."""
        h = self.replicas[idx]
        if h.state is ReplicaState.UP:
            h.state = ReplicaState.DRAINING
        return h

    # --------------------------------------------------------------- threads
    def start_workers(self) -> None:
        """One stepping thread per live replica (plain-DP fleets only).

        Dispatch stays on the submitting thread (``pump()``), which is the
        single writer of the intake; replica queues cross threads only
        through ``RequestQueue``'s append/popleft pairs."""
        if self._threads:
            raise RuntimeError("fleet workers already running")
        if self.handoff is not None:
            raise NotImplementedError(
                "threaded fleets are plain DP today: adopting a handoff "
                "into a stepping engine would race its block pool")
        with self._lock:
            self._stop_flag = False
        for h in self.replicas:
            if h.state is ReplicaState.FAILED:
                continue
            t = threading.Thread(target=self._worker, args=(h,),
                                 name=f"fleet-replica-{h.idx}", daemon=True)
            with self._lock:
                self._threads[h.idx] = t
            t.start()

    def _worker(self, h: ReplicaHandle) -> None:
        while True:
            with self._lock:
                stop = self._stop_flag
            if stop or h.state is ReplicaState.FAILED:
                return
            if h.engine.has_work:
                h.engine.step()
            else:
                time.sleep(5e-4)

    def stop_workers(self) -> None:
        with self._lock:
            self._stop_flag = True
        for t in list(self._threads.values()):
            t.join(timeout=60.0)
            if t.is_alive():
                raise RuntimeError("fleet worker failed to stop")
        with self._lock:
            self._threads.clear()
            self._stop_flag = False
        if any(h.device.type == "cuda" for h in self.replicas):
            # each worker thread's cuBLAS handle leaves its workspace in
            # the caching allocator after the thread ends (tens of MB on an
            # H100); free them with the threads that made them
            torch._C._cuda_clearCublasWorkspaces()

    # ----------------------------------------------------------------- gauges
    def _update_gauges(self) -> None:
        obs_metrics.gauge("fleet.replicas_up").set(
            sum(1 for h in self.replicas if h.state is ReplicaState.UP))
        obs_metrics.gauge("fleet.queue_depth").set(len(self.intake))
