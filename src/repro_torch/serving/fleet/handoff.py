"""Disaggregated prefill→decode KV handoff (PyTorch port of
``repro/serving/fleet/handoff.py``).

Prefill replicas run admission + chunked prefill only; the moment a
request's prompt KV is committed and its first token sampled, the engine's
``handoff_sink`` hands the slot to a :class:`HandoffCoordinator`, which

1. **exports** the slot's KV blocks (``ContinuousEngine.export_request`` →
   ``BlockKVManager.export_blocks``, host leaves, bf16 as int16 bit
   patterns) plus the sampling lane ``(token, generator state, temp)``,
2. **entropy-codes** each block with the cold tier's codec round-trip
   (``kvcache.cold.encode_block_leaves`` — the SAME wire format eviction
   persists, so the transfer is lossless by the same argument: uint8 code
   leaves entropy-coded per-leaf, bf16 scale/zero raw), and
3. **delivers** the payload to the least-loaded UP decode replica
   (``adopt_request`` → ``import_blocks``), which continues decode from the
   exact device state the prefill replica would have used.

Bit-identity across the wire: the codec round-trip is byte-lossless
(``tests/test_torch_fleet_identity.py`` asserts decode(encode(blocks)) is
byte-equal), rows past ``kv_len`` in the last block are unreachable under
``kv_len`` masking, and the first token plus the request's
``torch.Generator`` state (``get_state()``: seed and Philox offset on a
card) travel with the payload — so the decode replica's token stream is
bit-identical to a single engine running the whole request, sampled
requests included (the fleet contract).

The coordinator is **single-threaded by contract**: the lockstep
:class:`~repro_torch.serving.fleet.driver.FleetDriver` pumps it between replica
steps.  Threaded fleets run plain DP (no disaggregation) today — adopting
into an engine while its worker thread steps would race the block pool.

``transport`` is the fault-injection seam: a callable ``payload -> int``
returning how many pumps to delay delivery (the fault harness's
delay-KV-handoff plans); None delivers on the next pump.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.codecs import get_codec
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from ..batching.engine import ContinuousEngine
from ..batching.request import Request
from ..kvcache.cold import (decode_block_leaves, encode_block_leaves,
                            entry_nbytes)
from .router import ReplicaHandle, ReplicaState

# entropy codec for the uint8 code leaves on the wire (the reference's
# default; the bf16 scale/zero leaves cross raw)
WIRE_CODEC = "rans"


@dataclasses.dataclass
class HandoffPayload:
    """One prefilled request on the wire: entropy-coded KV + sampling lane."""
    req: Request
    kv_len: int
    blocks: List[Dict[str, object]]   # encoded entries (cold-tier format)
    token: int                        # first sampled token (already in output)
    state: torch.Tensor               # the request's Generator.get_state()
    temp: float
    delay: int = 0                    # transport pumps left before delivery

    @property
    def payload_bytes(self) -> int:
        return sum(entry_nbytes(entry) for entry in self.blocks)

    def decode_blocks(self) -> List[Dict[str, np.ndarray]]:
        return [decode_block_leaves(entry) for entry in self.blocks]

    @property
    def lane(self) -> Tuple[int, torch.Tensor, float]:
        return (self.token, self.state, self.temp)


class HandoffCoordinator:
    """Prefill→decode bridge over entropy-coded block payloads."""

    def __init__(self, decode_replicas: List[ReplicaHandle], *,
                 transport: Optional[Callable[[HandoffPayload], int]] = None):
        if not decode_replicas:
            raise ValueError("disaggregated mode needs >= 1 decode replica")
        self.codec = get_codec(WIRE_CODEC)
        self.decode_replicas = decode_replicas
        self.transport = transport
        self.n_handoffs = 0
        self.n_delivered = 0
        self.bytes_on_wire = 0
        self._pending: Deque[HandoffPayload] = deque()

    @property
    def pending(self) -> int:
        return len(self._pending)

    # ----------------------------------------------------------- prefill side
    def sink(self, engine: ContinuousEngine, slot: int, req: Request) -> None:
        """``ContinuousEngine.handoff_sink`` hook: export + encode + enqueue."""
        with obs_trace.span("fleet.handoff_encode", rid=req.rid):
            req2, kv_len, blocks, (tok, state, temp) = \
                engine.export_request(slot)
            assert req2 is req
            encoded = [encode_block_leaves(self.codec, leaves)[0]
                       for leaves in blocks]
        payload = HandoffPayload(req=req, kv_len=kv_len, blocks=encoded,
                                 token=tok, state=state, temp=temp)
        if self.transport is not None:
            payload.delay = max(0, int(self.transport(payload)))
        self.n_handoffs += 1
        self.bytes_on_wire += payload.payload_bytes
        obs_metrics.counter("fleet.handoffs").inc()
        obs_metrics.counter("fleet.handoff_bytes").inc(payload.payload_bytes)
        self._pending.append(payload)

    # ------------------------------------------------------------ decode side
    def _pick(self) -> Optional[ReplicaHandle]:
        up = [h for h in self.decode_replicas
              if h.state is ReplicaState.UP]
        if not up:
            return None
        return min(up, key=lambda h: (h.occupied_slots, h.idx))

    def pump(self, shed: Optional[Callable[[Request, str], None]] = None
             ) -> Tuple[int, int]:
        """Deliver ready payloads; count down transport delays.

        Returns ``(delivered, ticked)`` — ``ticked`` counts payloads whose
        delay advanced, so the lockstep driver can tell "progress is
        happening" from "stuck".  A payload no UP decode replica exists for
        is handed to ``shed(req, "no_replica")`` (terminal) rather than
        pending forever; a payload the decode side merely cannot fit *right
        now* stays pending for the next pump.
        """
        delivered = 0
        ticked = 0
        keep: Deque[HandoffPayload] = deque()
        while self._pending:
            p = self._pending.popleft()
            if p.delay > 0:
                p.delay -= 1
                ticked += 1
                keep.append(p)
                continue
            h = self._pick()
            if h is None:
                if shed is not None:
                    shed(p.req, "no_replica")
                    continue
                keep.append(p)
                continue
            with obs_trace.span("fleet.handoff_adopt", rid=p.req.rid,
                                replica=h.idx, blocks=len(p.blocks)):
                ok = h.engine.adopt_request(p.req, p.kv_len,
                                            p.decode_blocks(), p.lane)
            if ok:
                delivered += 1
                self.n_delivered += 1
            else:
                keep.append(p)       # decode side full: retry next pump
        self._pending = keep
        return delivered, ticked
