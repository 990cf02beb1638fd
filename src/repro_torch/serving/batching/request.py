"""Request lifecycle for continuous-batching serving (PyTorch port of
``repro/serving/batching/request.py``; numpy and stdlib only).

A request is born QUEUED (admission control in :class:`~.queue.RequestQueue`),
becomes PREFILLING while its prompt is chunk-prefilled into a scratch cache,
DECODING once it occupies a slot of the batched KV cache, and detaches as
FINISHED (EOS or ``max_new_tokens``) without stalling the rest of the batch.
EXPIRED marks requests whose admission deadline passed while still queued;
REJECTED marks requests bounced by the queue bound.

Timestamps are monotonic-clock seconds stamped by the queue/engine; the
traffic benchmark derives queue wait, TTFT, and end-to-end latency from them.
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
import time
from typing import List, Optional

import numpy as np


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"
    DECODING = "decoding"
    FINISHED = "finished"
    EXPIRED = "expired"      # admission deadline passed while queued
    REJECTED = "rejected"    # queue bound hit at submit


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling: greedy at ``temperature <= 0``; otherwise
    temperature-categorical from a request-private ``torch.Generator``
    seeded with ``seed`` (one draw per generated token)."""
    temperature: float = 0.0
    seed: int = 0


_ids = itertools.count()


@dataclasses.dataclass
class Request:
    prompt: np.ndarray                       # (P,) int32 token ids
    max_new_tokens: int
    sampling: SamplingParams = SamplingParams()
    eos_id: Optional[int] = None             # None = run to max_new_tokens
    deadline_s: Optional[float] = None       # max seconds queued before expiry
    rid: int = dataclasses.field(default_factory=lambda: next(_ids))

    state: RequestState = RequestState.QUEUED
    output: List[int] = dataclasses.field(default_factory=list)
    finish_reason: Optional[str] = None      # "eos" | "length" | "deadline" | "queue_full" | "no_replica"
    redrives: int = 0                        # times re-enqueued after a replica failure

    t_arrival: Optional[float] = None
    t_admitted: Optional[float] = None
    t_first_token: Optional[float] = None
    t_finished: Optional[float] = None

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, "
                             f"got {self.max_new_tokens}")

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def done(self) -> bool:
        return self.state in (RequestState.FINISHED, RequestState.EXPIRED,
                              RequestState.REJECTED)

    # ---- metric views (None until the corresponding event happened) --------
    @property
    def queue_wait_s(self) -> Optional[float]:
        if self.t_admitted is None or self.t_arrival is None:
            return None
        return self.t_admitted - self.t_arrival

    @property
    def ttft_s(self) -> Optional[float]:
        if self.t_first_token is None or self.t_arrival is None:
            return None
        return self.t_first_token - self.t_arrival

    @property
    def latency_s(self) -> Optional[float]:
        if self.t_finished is None or self.t_arrival is None:
            return None
        return self.t_finished - self.t_arrival

    def requeue(self) -> None:
        """Reset for a redrive after a replica failure (fleet router).

        Generated tokens are discarded and the request decodes again from
        its prompt — greedy decode is deterministic and sampling reseeds
        the same per-request generator from ``sampling.seed``, so the rerun
        reproduces the lost tokens bit-identically.  ``t_arrival`` is
        kept: the deadline covers total time in the system, redrives
        included."""
        self.state = RequestState.QUEUED
        self.output = []
        self.finish_reason = None
        self.t_admitted = None
        self.t_first_token = None
        self.redrives += 1

    def expired(self, now: Optional[float] = None) -> bool:
        if self.deadline_s is None or self.t_arrival is None:
            return False
        return (time.monotonic() if now is None else now) \
            > self.t_arrival + self.deadline_s
