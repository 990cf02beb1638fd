"""Continuous-batching engine: slot-batched decode with mid-flight admission
(PyTorch port of ``repro/serving/batching/engine.py``: the slot pool and
the paged KV cache).

The scheduler loop (one ``step()``):

  1. **Admit** — if the admission pipeline is idle and a slot is free, the
     next queued request reserves the slot and starts chunk-prefilling
     through the shared ``ServeSteps.prefill_chunk_fn`` (fixed ``(1,
     chunk)`` shape) into a ``(1, max_len)`` scratch cache.  Under load the
     prefill advances at most ``admit_chunks_per_step`` chunks per
     scheduler step (default 4), decode steps running in between — so
     in-flight requests pay a bounded slice of prefill latency per
     generated token, never a whole queued prompt; when nothing is decoding
     there is no lane to stall and the prefill drains to completion
     immediately.  On the last chunk the scratch rows are copied into the
     reserved slot and the request's first token is sampled from the logit
     at its true last prompt position.
  2. **Decode** — ONE ``decode_fn`` call advances every slot: ``pos`` is
     the ``(n_slots,)`` per-slot ``kv_len`` tensor, so a request 3 tokens
     deep and one 300 tokens deep share one step (ragged attention via
     per-slot masking in ``models/layers.py``).
  3. **Detach** — slots whose request hit EOS or ``max_new_tokens`` are
     released (and their cache rows compacted) without stalling the batch;
     the freed slot is eligible for admission on the next step.

Inactive slots still ride through the step (their lane computes a garbage
token that is never read, and their row-0 cache write lands in freed memory
that the next ``insert`` overwrites) — wasted lanes are the price of one
step shape, and they convert into admitted requests on the very next step.

Numerics: the engine drives the SAME step functions as the lockstep
:class:`~repro_torch.serving.engine.Engine`, and per-slot masking makes each
lane independent of its neighbors, so on the CPU a request's greedy tokens
are bit-identical whether it runs alone through ``Engine.generate`` or
packed in a slot batch (``tests/test_torch_batching.py``).  On a card the
library matmuls may sum a batch of 8 rows in another order than one row,
so agreement there is measured (``chip_smoke.py``'s ``continuous`` phase).
One carve-out: MoE dispatch capacity is shared across the batch, so
bit-identity additionally needs ``capacity_factor >= num_experts / top_k``
(no token ever drops); ``__init__`` warns when a config falls short.

Sampling: each request draws from its own ``torch.Generator`` on the
engine's device, seeded with ``SamplingParams.seed`` at admission, once per
sampled token (greedy lanes never draw), so a request's tokens depend on
its seed and not on which requests share its batch.

Paged KV (``kv_spec``): a :class:`~repro_torch.serving.kvcache.
BlockKVManager` replaces the slot pool.  Admission peeks at the queue's head
and pops it only once the manager can cover its whole allocation
(peek-then-plan); prefill runs through ``paged_prefill_chunk_fn`` straight
into the request's pool blocks, starting after the prefix-shared chunks the
manager lets it skip, and the decode step gathers every slot's sequence
through ``decode_tables()`` (all-trash rows for lanes not yet live).  With
bf16 blocks and ``max_len`` a multiple of the block size the tokens equal
the slot pool's bitwise.  Paged KV rides dense residency on one device, as
in the JAX package.

Multi-device (``mesh``): the slot pool is placed as
``ServeSteps.cache_shardings(n_slots, layout="slot")`` resolves it — each
data group holds and steps the block of slots at its coordinate (and,
for the dense and MoE families, each rank of the model axis its block of
the KV heads, where whole heads divide it).  Every rank runs the same
host scheduler and takes the same deterministic decisions; an admitted
request prefills on the data group that holds its slot, whose first token
the others receive, and after each decode step the ranks gather every
slot's token over the data axes, so every rank holds every request's
output.  Deadlines (a per-rank clock) are refused on a mesh.

Fleet seams (:mod:`repro_torch.serving.fleet`): ``steps=`` shares one
``ServeSteps`` across replicas; ``handoff_sink`` (paged engines only) takes
each request the moment its prefill is done and its first token sampled;
``export_request`` / ``can_adopt`` / ``adopt_request`` carry a prefilled
request's KV blocks and sampling lane ``(token, generator state,
temperature)`` between engines, so a sampled request continues from the
exact generator offset it left; ``evacuate`` strips a failed replica.
"""
from __future__ import annotations

import time
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs.base import ArchConfig
from repro_torch.core.spec import KVCompressionSpec
from repro_torch.models import api
from repro_torch.models.layers import QT, QT4
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from ..engine import ServeConfig, ServeSteps, _fence, sample
from ..kvcache import BlockKVManager
from .queue import RequestQueue
from .request import Request, RequestState, SamplingParams
from .slots import SlotBatchManager


def _weights_device(params: Any) -> torch.device:
    """Where serving weights live: a resident store says so itself; a
    params dict by its embedding (a tensor or a QT / QT4 triple)."""
    if hasattr(params, "device"):
        return torch.device(params.device)
    w = params["embed"]
    return (w.q if isinstance(w, (QT, QT4)) else w).device


class ContinuousEngine:
    """Serve concurrent, independently-arriving requests over one slot batch
    on ``device`` (``cuda`` unless the caller names the CPU).

    Families must implement the slot-batch cache contract
    (``api.supports_continuous_batching``): dense and moe.

    ``resident="compressed"`` serves the slot batch straight from the
    entropy-coded container — ``params`` must then be a
    :class:`repro_torch.serving.resident.CompressedResidentWeights`, and the
    per-layer step loops replace the whole-tree steps with identical
    numerics.

    ``kv_spec`` serves through the paged KV block pool under that policy
    (``kv_blocks`` blocks, default one slot pool's worth plus the trash
    block); it needs a family with the paged contract and dense residency,
    and raises otherwise rather than serve the slot pool.

    ``admit_chunks_per_step`` bounds the prefill chunks one scheduler step
    runs while a batch is decoding: the prefill latency an in-flight request
    pays per token.
    """

    def __init__(self, cfg: ArchConfig, params: Any, sc: ServeConfig, *,
                 n_slots: int = 8, max_queue: int = 64,
                 prefill_chunk: int = 32, admit_chunks_per_step: int = 4,
                 steps: Optional[ServeSteps] = None, resident: str = "dense",
                 kv_spec: Optional[KVCompressionSpec] = None,
                 kv_blocks: Optional[int] = None, handoff_sink=None,
                 device=None, mesh=None):
        if not api.supports_continuous_batching(cfg):
            raise NotImplementedError(
                f"family {cfg.family!r} does not implement the slot-batch "
                f"cache contract (prefill_chunk + per-slot decode positions);"
                f" supported today: dense, moe")
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        if admit_chunks_per_step < 1:
            raise ValueError(f"admit_chunks_per_step must be >= 1, "
                             f"got {admit_chunks_per_step}")
        if cfg.moe is not None and \
                cfg.moe.capacity_factor * cfg.moe.top_k < cfg.moe.num_experts:
            # GShard capacity is shared across the batch, so a token that
            # routes fine solo can be DROPPED when packed with busy neighbors
            # — packing-dependent outputs.  cf >= E/top_k admits the worst
            # case (every token on one expert) and restores bit-identity.
            import warnings
            warnings.warn(
                f"{cfg.name}: moe capacity_factor={cfg.moe.capacity_factor} "
                f"< num_experts/top_k = "
                f"{cfg.moe.num_experts / cfg.moe.top_k:.2f}; expert overflow "
                f"under slot batching can drop tokens a solo run would keep, "
                f"so outputs may depend on batch packing (raise "
                f"capacity_factor to >= num_experts/top_k for bit-identical "
                f"serving)", stacklevel=2)
        if handoff_sink is not None and kv_spec is None:
            raise ValueError(
                "handoff_sink needs the paged KV cache (kv_spec): the "
                "disaggregated handoff ships block payloads, and only "
                "BlockKVManager implements export_blocks")
        self.device = _device.resolve(device if mesh is None
                                      else mesh.device)
        got = _weights_device(params)
        if got.type != self.device.type:
            raise ValueError(f"weights on {got} cannot serve an engine on "
                             f"{self.device}")
        self.cfg = cfg
        self.params = params
        self.sc = sc
        # disaggregated prefill replicas: called as sink(engine, slot, req)
        # right after a request's prefill completes and its first token is
        # sampled; the sink must export_request() the slot
        self.handoff_sink = handoff_sink
        self.steps = steps if steps is not None else \
            ServeSteps(cfg, sc, mesh=mesh, resident=resident)
        self.mesh = self.steps.mesh
        self.paged = kv_spec is not None
        if self.paged:
            if not api.supports_paged_kv(cfg):
                raise NotImplementedError(
                    f"family {cfg.family!r} does not implement the paged "
                    f"block-pool cache contract (init_kv_pool + "
                    f"paged_decode_step); supported today: dense, moe")
            if self.steps.paged_decode_fn is None:
                raise NotImplementedError(
                    "paged KV needs the dense-residency whole-tree steps; "
                    "serve with resident='dense'")
            if self.mesh is not None:
                raise NotImplementedError(
                    "paged KV is single-device today: the block table is a "
                    "host-side gather index with no sharding rule yet")
            self.slots: Any = BlockKVManager(
                cfg, n_slots, sc.max_len, spec=kv_spec, n_blocks=kv_blocks,
                prefill_chunk=prefill_chunk, device=self.device)
        else:
            # on a mesh this rank holds the slot block the resolved "slot"
            # spec gives its data coordinate
            self.slots = SlotBatchManager(
                cfg, n_slots, sc.max_len, device=self.device,
                rows=self.steps.batch_rows(n_slots, layout="slot"),
                **self.steps.local_heads_kw)
        self._slot_axes = self.steps.batch_axes(n_slots, layout="slot")
        self.queue = RequestQueue(max_queue)
        self.prefill_chunk = prefill_chunk
        self.admit_chunks_per_step = admit_chunks_per_step
        self.finished: List[Request] = []
        self.n_decode_steps = 0
        self.n_prefill_chunks = 0
        self._prefilling: Optional[dict] = None   # in-flight admission state
        # per-slot step state: last token, temperature, the request's
        # generator (None for a free slot)
        self._tokens = np.zeros((n_slots,), np.int64)
        self._temps = np.zeros((n_slots,), np.float32)
        self._gens: List[Optional[torch.Generator]] = [None] * n_slots

    # --------------------------------------------------------------- submit
    def submit(self, prompt, max_new_tokens: int, *,
               sampling: SamplingParams = SamplingParams(),
               eos_id: Optional[int] = None,
               deadline_s: Optional[float] = None) -> Request:
        """Queue one request (raises ``QueueFullError`` under backpressure)."""
        req = Request(prompt=np.asarray(prompt), max_new_tokens=max_new_tokens,
                      sampling=sampling, eos_id=eos_id, deadline_s=deadline_s)
        return self.submit_request(req)

    def submit_request(self, req: Request) -> Request:
        """Queue a pre-built :class:`Request`.  Raises ``QueueFullError``
        under backpressure and ``ValueError`` when the request cannot fit
        ``max_len`` on any step (or carries a deadline on a mesh, where
        each rank's clock would decide its expiry on its own)."""
        if self.mesh is not None and req.deadline_s is not None:
            raise ValueError("deadlines are refused on a mesh: every rank "
                             "must take the same admission decisions")
        P = req.prompt_len
        chunks = -(-P // self.prefill_chunk) * self.prefill_chunk
        need = max(P + req.max_new_tokens, chunks)
        if need > self.sc.max_len:
            raise ValueError(
                f"request {req.rid} needs {need} cache rows (prompt {P} + "
                f"{req.max_new_tokens} new, prefill padded to {chunks}) but "
                f"max_len is {self.sc.max_len}")
        return self.queue.submit(req)

    # ------------------------------------------------------------ admission
    def _start_prefill(self, req: Request) -> None:
        """Reserve a slot and set up the chunked-prefill pipeline state."""
        req.state = RequestState.PREFILLING
        req.t_admitted = time.monotonic()
        obs_metrics.histogram("queue.wait_s").observe(
            req.queue_wait_s or 0.0, outcome="admitted")
        P, chunk = req.prompt_len, self.prefill_chunk
        padded = -(-P // chunk) * chunk
        toks = torch.zeros((1, padded), dtype=torch.int64)
        toks[0, :P] = torch.from_numpy(req.prompt.astype(np.int64))
        if self.paged:
            # block admission: claim table entries (taking shared prefix
            # blocks) and start prefill AFTER the shared region — the block
            # manager keeps the final chunk (position P-1) to run
            got = self.slots.alloc(req)
            assert got is not None, "admission past can_admit"
            slot, skip = got
            self._prefilling = dict(req=req, slot=slot,
                                    toks=toks.to(self.device), c0=skip,
                                    last=None, scratch=None)
            return
        slot = self.slots.alloc(req)
        assert slot is not None, "admission with no free slot"
        # only the data group holding the slot prefills it
        scratch = self.steps.mod.init_cache(
            self.cfg, 1, self.sc.max_len, device=self.device,
            **self.steps.local_heads_kw) if self.slots.holds(slot) else None
        self._prefilling = dict(req=req, slot=slot, toks=toks.to(self.device),
                                c0=0, last=None, scratch=scratch)

    def _advance_prefill(self) -> None:
        """Run ONE prefill chunk; on the last chunk, copy the scratch rows
        into the reserved slot and sample the request's first token."""
        st = self._prefilling
        req, chunk = st["req"], self.prefill_chunk
        P, c0 = req.prompt_len, st["c0"]
        with obs_trace.span("serve.admit_chunk", rid=req.rid, c0=c0):
            tokens = st["toks"][:, c0:c0 + chunk]
            pos = torch.full((1,), c0, dtype=torch.int64, device=self.device)
            if self.paged:
                bt = torch.from_numpy(self.slots.table_rows([st["slot"]]))
                logits, self.slots.pool = self.steps.paged_prefill_chunk_fn(
                    self.params, tokens, self.slots.pool,
                    bt.to(self.device, torch.int64), pos)
            elif st["scratch"] is not None:
                logits, st["scratch"] = self.steps.prefill_chunk_fn(
                    self.params, tokens, st["scratch"], pos)
            else:
                logits = None           # another data group's slot
            _fence(self.device)
        self.n_prefill_chunks += 1
        if c0 <= P - 1 < c0 + chunk and logits is not None:
            st["last"] = logits[:, P - 1 - c0][:, None]     # (1, 1, V)
        st["c0"] = c0 + chunk
        if st["c0"] < st["toks"].shape[1]:
            return
        self._prefilling = None
        slot = st["slot"]
        if self.paged:
            self.slots.insert(slot, P)      # prefill wrote the pool in place
        else:
            self.slots.insert(slot, st["scratch"], P)
        temp = req.sampling.temperature
        gen = torch.Generator(device=self.device)
        gen.manual_seed(req.sampling.seed)
        tok = self._first_token(slot, st["last"], temp, gen)
        req.t_first_token = time.monotonic()
        obs_metrics.histogram("request.ttft_s").observe(req.ttft_s or 0.0)
        req.state = RequestState.DECODING
        req.output.append(tok)
        self._tokens[slot] = tok
        self._temps[slot] = temp
        self._gens[slot] = gen
        if self._hit_stop(req, tok):
            self._detach(slot, req, tok)
        elif self.handoff_sink is not None:
            # disaggregated prefill replica: the request never decodes here —
            # the sink exports the slot's KV blocks + sampling lane and the
            # decode side continues from the exact same state
            self.handoff_sink(self, slot, req)

    def _holds(self, slot: int) -> bool:
        """True when this rank steps ``slot`` (every slot on one device)."""
        return self.paged or self.slots.holds(slot)

    def _first_token(self, slot: int, last: Optional[torch.Tensor],
                     temp: float, gen: torch.Generator) -> int:
        """The request's first token: sampled by the data group holding
        ``slot`` and, on a mesh, received by every other rank."""
        tok = int(sample(last, temp, gen)[0]) if self._holds(slot) else 0
        if not self._slot_axes:
            return tok
        from repro_torch.distributed import collectives
        (axis,) = self._slot_axes
        n_loc = self.slots.rows.stop - self.slots.rows.start
        t = torch.tensor([tok], dtype=torch.int64, device=self.device)
        return int(collectives.pick(self.mesh, t, axis, slot // n_loc)[0])

    def _decoding(self) -> List[int]:
        return [s for s, r in enumerate(self.slots.requests)
                if r is not None and r.state is RequestState.DECODING]

    # ------------------------------------------------------------- stepping
    @torch.inference_mode()
    def step(self) -> bool:
        """One scheduler iteration: advance admission by at most
        ``admit_chunks_per_step`` prefill chunks (to completion while nothing
        is decoding), then one decode step over every slot.  Returns False
        when idle (nothing queued, nothing prefilling, nothing decoding)."""
        with obs_trace.span("serve.step", step=self.n_decode_steps):
            return self._step_inner()

    def _step_inner(self) -> bool:
        progressed = False
        chunks = 0
        while True:
            if self._prefilling is None and self.slots.n_free:
                if self.paged:
                    # peek-then-plan: commit the pop only once the block
                    # manager can cover the head's whole allocation; one
                    # clock reading, so a deadline cannot pass in between
                    now = time.monotonic()
                    head = self.queue.peek(now)
                    if head is not None and self.slots.can_admit(head):
                        self._start_prefill(self.queue.pop(now))
                else:
                    req = self.queue.pop()
                    if req is not None:
                        self._start_prefill(req)
            if self._prefilling is None:
                break
            self._advance_prefill()
            chunks += 1
            progressed = True
            if self._decoding() and chunks >= self.admit_chunks_per_step:
                break       # a batch is running: bounded stall, move on

        active = self._decoding()
        if not active:
            return progressed

        with obs_trace.span("serve.decode_batch", active=len(active)):
            dev = self.device
            if self.paged:
                pos = torch.from_numpy(self.slots.kv_len).to(dev)
                tok = torch.from_numpy(self._tokens[:, None]).to(dev)
                bt = torch.from_numpy(self.slots.decode_tables())
                logits, self.slots.pool = self.steps.paged_decode_fn(
                    self.params, tok, self.slots.pool,
                    bt.to(dev, torch.int64), pos)
            else:
                # this rank's block of slots (every slot on one device)
                rows = self.slots.rows
                pos = torch.from_numpy(self.slots.kv_len[rows]).to(dev)
                tok = torch.from_numpy(self._tokens[rows, None]).to(dev)
                with self.steps.rows_over(self._slot_axes):
                    logits, self.slots.cache = self.steps.decode_fn(
                        self.params, tok, self.slots.cache, pos)
            new_tok = self._sample_slots(logits, active)
        self.n_decode_steps += 1
        obs_metrics.counter("serve.tokens").inc(len(active))
        for s in active:
            self.slots.kv_len[s] += 1
            req = self.slots.requests[s]
            t = int(new_tok[s])
            req.output.append(t)
            self._tokens[s] = t
            if self._hit_stop(req, t):
                self._detach(s, req, t)
        return True

    def _sample_slots(self, logits: torch.Tensor,
                      active: List[int]) -> np.ndarray:
        """Logits of this rank's slots -> (n_slots,) host tokens: argmax for
        every lane, then one draw from its own generator for each active
        sampled lane (greedy lanes never draw); on a mesh the data groups'
        blocks are gathered into the whole vector."""
        r0 = 0 if self.paged else self.slots.rows.start
        out = sample(logits, 0.0)
        for s in active:
            if self._temps[s] > 0 and self._holds(s):
                out[s - r0] = sample(logits[s - r0:s - r0 + 1],
                                     float(self._temps[s]), self._gens[s])[0]
        if self._slot_axes:
            from repro_torch.distributed import collectives
            out = collectives.all_gather(self.mesh, out, 0, self._slot_axes)
        return out.cpu().numpy()

    def run(self) -> List[Request]:
        """Drain queue + slots to completion; returns finished requests."""
        n0 = len(self.finished)
        while self.step():
            pass
        return self.finished[n0:]

    @property
    def has_work(self) -> bool:
        return bool(len(self.queue)) or self._prefilling is not None \
            or bool(self.slots.active)

    # ---------------------------------------------------------- fleet seams
    def _clear_lane(self, slot: int) -> None:
        self._tokens[slot] = 0
        self._temps[slot] = 0.0
        self._gens[slot] = None

    @torch.inference_mode()
    def export_request(self, slot: int):
        """Detach ``slot``'s request mid-flight for a KV handoff.

        Returns ``(req, kv_len, blocks, lane)``: the request object, its
        committed KV length, the per-block host leaves
        (``BlockKVManager.export_blocks``), and the sampling lane ``(token,
        generator state, temperature)`` a peer engine needs to continue
        decode from the exact state this engine would have used (the state
        is ``Generator.get_state()``: a CPU byte tensor, for a card's
        generator too).  The slot is released.  Paged engines only."""
        assert self.paged, "export_request needs the paged KV cache"
        req = self.slots.requests[slot]
        assert req is not None, f"export of free slot {slot}"
        kv_len = int(self.slots.kv_len[slot])
        blocks = self.slots.export_blocks(slot)
        lane = (int(self._tokens[slot]), self._gens[slot].get_state(),
                float(self._temps[slot]))
        self.slots.release(slot)
        self._clear_lane(slot)
        return req, kv_len, blocks, lane

    def can_adopt(self, req: Request, kv_len: int, n_blocks: int) -> bool:
        """Probe for ``adopt_request`` (peek-then-adopt, like can_admit)."""
        assert self.paged, "can_adopt needs the paged KV cache"
        return self.slots.can_import(req, kv_len, n_blocks)

    @torch.inference_mode()
    def adopt_request(self, req: Request, kv_len: int, blocks, lane) -> bool:
        """Admit an externally prefilled request: install its KV blocks and
        sampling lane, then decode it like any local request.  Returns False
        (nothing changed) when no slot or not enough pool blocks are free —
        the handoff coordinator retries on a later pump.  Paged engines
        only."""
        assert self.paged, "adopt_request needs the paged KV cache"
        slot = self.slots.import_blocks(req, kv_len, blocks)
        if slot is None:
            return False
        tok, state, temp = lane
        gen = torch.Generator(device=self.device)
        gen.set_state(state)
        req.state = RequestState.DECODING
        self._tokens[slot] = tok
        self._temps[slot] = temp
        self._gens[slot] = gen
        return True

    @torch.inference_mode()
    def evacuate(self) -> List[Request]:
        """Strip every unfinished request off the engine, oldest first.

        The failed-replica redrive path: the fleet driver marks a replica
        FAILED, evacuates it, resets each request (``Request.requeue``) and
        re-enqueues them at the fleet intake — nothing is lost, nothing is
        duplicated.  Queued, mid-prefill, and decoding requests are all
        harvested; the engine is left empty but serviceable."""
        out: List[Request] = []
        while True:
            r = self.queue.pop()    # lazy-expires overdue heads in passing
            if r is None:
                break
            out.append(r)
        # a mid-prefill request already occupies its reserved slot (alloc
        # registered it in slots.requests), so the slot sweep below
        # harvests it and returns its blocks; only the pipeline state needs
        # clearing here
        self._prefilling = None
        for s, r in enumerate(list(self.slots.requests)):
            if r is not None:
                self.slots.release(s)
                self._clear_lane(s)
                out.append(r)
        out.sort(key=lambda r: (r.t_arrival if r.t_arrival is not None
                                else float("inf"), r.rid))
        return out

    # -------------------------------------------------------------- private
    @staticmethod
    def _hit_stop(req: Request, tok: int) -> bool:
        return (req.eos_id is not None and tok == req.eos_id) \
            or len(req.output) >= req.max_new_tokens

    def _detach(self, slot: int, req: Request, tok: int) -> None:
        req.finish_reason = "eos" \
            if (req.eos_id is not None and tok == req.eos_id) else "length"
        req.state = RequestState.FINISHED
        req.t_finished = time.monotonic()
        self.slots.release(slot)
        self._clear_lane(slot)
        self.finished.append(req)
        obs_metrics.histogram("request.latency_s").observe(req.latency_s or 0.0)
        obs_metrics.counter("requests.finished").inc(reason=req.finish_reason)
        # lifecycle record built from the Request's own monotonic stamps
        # (same clock Lifecycle uses), so the chain is exact, not re-measured
        lc = obs_metrics.lifecycle(req.rid, outcome=req.finish_reason,
                                   tokens=len(req.output))
        for name, t in (("queued", req.t_arrival),
                        ("admitted", req.t_admitted),
                        ("first_token", req.t_first_token),
                        ("done", req.t_finished)):
            if t is not None:
                lc.event(name, t)
