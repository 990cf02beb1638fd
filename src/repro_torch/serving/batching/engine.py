"""Continuous-batching engine: slot-batched decode with mid-flight admission
(PyTorch port of ``repro/serving/batching/engine.py``, slot pool only).

The scheduler loop (one ``step()``):

  1. **Admit** — if the admission pipeline is idle and a slot is free, the
     next queued request reserves the slot and starts chunk-prefilling
     through the shared ``ServeSteps.prefill_chunk_fn`` (fixed ``(1,
     chunk)`` shape) into a ``(1, max_len)`` scratch cache.  Under load the
     prefill advances at most ``ADMIT_CHUNKS_PER_STEP`` (4) chunks per
     scheduler step, decode steps running in between — so
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

Sampling: each request draws from its own ``torch.Generator`` on the
engine's device, seeded with ``SamplingParams.seed`` at admission, once per
sampled token (greedy lanes never draw), so a request's tokens depend on
its seed and not on which requests share its batch.

Not ported: the paged KV cache (``kv_spec`` / ``kv_blocks``), the fleet
seams (``handoff_sink``, ``export_request`` / ``adopt_request`` /
``evacuate``) and the MoE capacity warning (MoE is not ported).
"""
from __future__ import annotations

import time
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import api
from repro_torch.models.layers import QT, QT4
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from ..engine import ServeConfig, ServeSteps, _fence, sample
from .queue import RequestQueue
from .request import Request, RequestState, SamplingParams
from .slots import SlotBatchManager

# prefill chunks one scheduler step may run while a batch is decoding: the
# bound on the prefill latency an in-flight request pays per token
ADMIT_CHUNKS_PER_STEP = 4


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
    (``api.supports_continuous_batching``): dense today.

    ``resident="compressed"`` serves the slot batch straight from the
    entropy-coded container — ``params`` must then be a
    :class:`repro_torch.serving.resident.CompressedResidentWeights`, and the
    per-layer step loops replace the whole-tree steps with identical
    numerics.
    """

    def __init__(self, cfg: ArchConfig, params: Any, sc: ServeConfig, *,
                 n_slots: int = 8, max_queue: int = 64,
                 prefill_chunk: int = 32, resident: str = "dense",
                 device=None):
        if not api.supports_continuous_batching(cfg):
            raise NotImplementedError(
                f"family {cfg.family!r} does not implement the slot-batch "
                f"cache contract (prefill_chunk + per-slot decode positions);"
                f" supported today: dense")
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        self.device = _device.resolve(device)
        got = _weights_device(params)
        if got.type != self.device.type:
            raise ValueError(f"weights on {got} cannot serve an engine on "
                             f"{self.device}")
        self.cfg = cfg
        self.params = params
        self.sc = sc
        self.steps = ServeSteps(cfg, sc, resident=resident)
        self.slots = SlotBatchManager(cfg, n_slots, sc.max_len,
                                      device=self.device)
        self.queue = RequestQueue(max_queue)
        self.prefill_chunk = prefill_chunk
        self.finished: List[Request] = []
        self.n_decode_steps = 0
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
        ``max_len`` on any step."""
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
        slot = self.slots.alloc(req)
        assert slot is not None, "admission with no free slot"
        self._prefilling = dict(
            req=req, slot=slot, toks=toks.to(self.device), c0=0, last=None,
            scratch=self.steps.mod.init_cache(self.cfg, 1, self.sc.max_len,
                                              device=self.device))

    def _advance_prefill(self) -> None:
        """Run ONE prefill chunk; on the last chunk, copy the scratch rows
        into the reserved slot and sample the request's first token."""
        st = self._prefilling
        req, chunk = st["req"], self.prefill_chunk
        P, c0 = req.prompt_len, st["c0"]
        with obs_trace.span("serve.admit_chunk", rid=req.rid, c0=c0):
            logits, st["scratch"] = self.steps.prefill_chunk_fn(
                self.params, st["toks"][:, c0:c0 + chunk], st["scratch"],
                torch.full((1,), c0, dtype=torch.int64, device=self.device))
            _fence(self.device)
        if c0 <= P - 1 < c0 + chunk:
            st["last"] = logits[:, P - 1 - c0][:, None]     # (1, 1, V)
        st["c0"] = c0 + chunk
        if st["c0"] < st["toks"].shape[1]:
            return
        self._prefilling = None
        slot = st["slot"]
        self.slots.insert(slot, st["scratch"], P)
        temp = req.sampling.temperature
        gen = torch.Generator(device=self.device)
        gen.manual_seed(req.sampling.seed)
        tok = int(sample(st["last"], temp, gen)[0])
        req.t_first_token = time.monotonic()
        obs_metrics.histogram("request.ttft_s").observe(req.ttft_s or 0.0)
        req.state = RequestState.DECODING
        req.output.append(tok)
        self._tokens[slot] = tok
        self._temps[slot] = temp
        self._gens[slot] = gen
        if self._hit_stop(req, tok):
            self._detach(slot, req, tok)

    def _decoding(self) -> List[int]:
        return [s for s, r in enumerate(self.slots.requests)
                if r is not None and r.state is RequestState.DECODING]

    # ------------------------------------------------------------- stepping
    @torch.inference_mode()
    def step(self) -> bool:
        """One scheduler iteration: advance admission by at most
        ``ADMIT_CHUNKS_PER_STEP`` prefill chunks (to completion while nothing
        is decoding), then one decode step over every slot.  Returns False
        when idle (nothing queued, nothing prefilling, nothing decoding)."""
        with obs_trace.span("serve.step", step=self.n_decode_steps):
            return self._step_inner()

    def _step_inner(self) -> bool:
        progressed = False
        chunks = 0
        while True:
            if self._prefilling is None and self.slots.n_free:
                req = self.queue.pop()
                if req is not None:
                    self._start_prefill(req)
            if self._prefilling is None:
                break
            self._advance_prefill()
            chunks += 1
            progressed = True
            if self._decoding() and chunks >= ADMIT_CHUNKS_PER_STEP:
                break       # a batch is running: bounded stall, move on

        active = self._decoding()
        if not active:
            return progressed

        with obs_trace.span("serve.decode_batch", active=len(active)):
            dev = self.device
            pos = torch.from_numpy(self.slots.kv_len).to(dev)
            tok = torch.from_numpy(self._tokens[:, None]).to(dev)
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
        """(n_slots, 1, V) logits -> (n_slots,) host tokens: argmax for
        every lane, then one draw from its own generator for each active
        sampled lane (greedy lanes never draw)."""
        out = sample(logits, 0.0).cpu().numpy()
        for s in active:
            if self._temps[s] > 0:
                out[s] = int(sample(logits[s:s + 1], float(self._temps[s]),
                                    self._gens[s])[0])
        return out

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
        self._tokens[slot] = 0
        self._temps[slot] = 0.0
        self._gens[slot] = None
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
