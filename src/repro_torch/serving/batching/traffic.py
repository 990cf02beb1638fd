"""Synthetic traffic generation + replay for continuous-batching serving
(PyTorch port of ``repro/serving/batching/traffic.py``): one engine
(``replay``) or a fleet (``replay_fleet``).

Shared by ``repro_torch.launch.serve --traffic`` and ``chip_smoke.py`` so
arrival pacing, ragged-request sampling, and the submit-when-due driver loop
live in one place.  ``poisson_trace`` draws with numpy exactly as the JAX
package does, so a seed gives the same trace in both packages, bit for bit.
"""
from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np

from .engine import ContinuousEngine
from .queue import QueueFullError
from .request import Request

Trace = List[Tuple[float, np.ndarray, int]]     # (arrival_s, prompt, max_new)


def poisson_trace(n_requests: int, *, rate_per_s: float, prompt_max: int,
                  gen_max: int, vocab: int, seed: int = 0,
                  prompt_min: int = 4, gen_min: int = 2,
                  prefix_pool: int = 0, prefix_len: int = 0) -> Trace:
    """Seeded Poisson arrival trace with ragged prompt/gen lengths.

    The ragged lower bounds clamp to the caller's maxima, so degenerate
    settings (``prompt_max < prompt_min``) produce fixed-size requests
    instead of crashing.

    ``prefix_pool > 0`` models shared system prompts: ``prefix_pool``
    distinct prefixes of ``prefix_len`` tokens are drawn once, and every
    request opens with one of them (uniformly chosen) followed by a ragged
    unique suffix of at least one token — the workload prefix sharing in the
    paged KV cache is built to exploit.

    **Determinism contract (fleet serving).**  Request *content* is drawn
    from a per-request derived stream: entry ``i``'s (prompt, gen) depends
    only on ``(seed, i)``, the length bounds, and the prefix pool — never on
    ``n_requests``, ``rate_per_s``, or anything drawn for other entries.
    Arrival pacing and the prefix pool each have their own derived stream.
    A trace is therefore *prefix-stable*: ``poisson_trace(n, ...)[:k] ==
    poisson_trace(k, ...)`` (same kwargs) for every ``k <= n``, so the fleet
    benchmark can scale trace length with replica count without any
    request's content changing.  The pre-fleet version drew everything from
    ONE stream, where the block of ``n`` arrival gaps shifted every
    subsequent draw — two traces differing only in length disagreed on
    every prompt.
    """
    arrivals_rng = np.random.default_rng([seed, 0])
    gaps = arrivals_rng.exponential(1.0 / rate_per_s, n_requests)
    arrivals = np.cumsum(gaps) - (gaps[0] if n_requests else 0.0)
    pmin = min(prompt_min, prompt_max)
    gmin = min(gen_min, gen_max)
    prefixes = []
    if prefix_pool > 0:
        if prefix_len < 1:
            raise ValueError(f"prefix_pool={prefix_pool} needs "
                             f"prefix_len >= 1, got {prefix_len}")
        prefix_rng = np.random.default_rng([seed, 1])
        prefixes = [prefix_rng.integers(0, vocab,
                                        (prefix_len,)).astype(np.int32)
                    for _ in range(prefix_pool)]
    trace: Trace = []
    for i in range(n_requests):
        rng = np.random.default_rng([seed, 2, i])   # request-private stream
        G = int(rng.integers(gmin, gen_max + 1))
        if prefixes:
            smax = max(prompt_max - prefix_len, 1)  # suffix keeps >= 1 token
            S = int(rng.integers(1, smax + 1))
            prompt = np.concatenate([
                prefixes[int(rng.integers(len(prefixes)))],
                rng.integers(0, vocab, (S,)).astype(np.int32)])
        else:
            P = int(rng.integers(pmin, prompt_max + 1))
            prompt = rng.integers(0, vocab, (P,)).astype(np.int32)
        trace.append((float(arrivals[i]), prompt, G))
    return trace


def replay(ce: ContinuousEngine, trace: Trace, *, shed_on_full: bool = False
           ) -> Tuple[List[Optional[Request]], int, float]:
    """Feed ``trace`` through the engine as arrival timestamps come due.

    Returns ``(requests, shed, makespan_s)`` — ``requests`` in trace order
    (None where an arrival was shed), ``shed`` the number of arrivals
    bounced by queue backpressure (only possible with ``shed_on_full=True``;
    otherwise ``QueueFullError`` propagates), and the wall-clock makespan.
    """
    t0 = time.monotonic()
    pending = list(trace)
    requests: List[Optional[Request]] = []
    shed = 0
    while pending or ce.has_work:
        now = time.monotonic() - t0
        while pending and pending[0][0] <= now:
            _, prompt, max_new = pending[0]
            try:
                requests.append(ce.submit(prompt, max_new))
            except QueueFullError:
                if not shed_on_full:
                    raise
                shed += 1
                requests.append(None)
            pending.pop(0)
        if not ce.step() and pending:
            time.sleep(max(0.0, min(pending[0][0] - (time.monotonic() - t0),
                                    1e-3)))
    return requests, shed, time.monotonic() - t0


def replay_fleet(driver, trace: Trace, *, shed_on_full: bool = False,
                 threaded: bool = False
                 ) -> Tuple[List[Optional[Request]], int, float]:
    """Feed ``trace`` through a :class:`~repro_torch.serving.fleet.
    FleetDriver`.

    Same submit-when-due pacing and return shape as :func:`replay`, but
    arrivals land at the fleet intake and the router spreads them over the
    replicas.  ``threaded=True`` runs one worker thread per replica
    (``driver.start_workers``) with the submit loop pumping dispatch from
    this thread; the default steps the whole fleet in deterministic lockstep
    (``driver.step``) — the mode every fleet test uses.

    Threaded, the loop also waits until every submitted request is done: a
    worker that has popped a request off its queue but not yet reserved its
    slot shows no work for a moment (its first torch call releases the
    interpreter lock in between), and ``has_work`` alone would end the
    replay with that request in flight.
    """
    t0 = time.monotonic()
    pending = list(trace)
    requests: List[Optional[Request]] = []
    shed = 0

    def in_flight() -> bool:
        return threaded and any(r is not None and not r.done
                                for r in requests)

    if threaded:
        driver.start_workers()
    try:
        while pending or driver.has_work or in_flight():
            now = time.monotonic() - t0
            while pending and pending[0][0] <= now:
                _, prompt, max_new = pending[0]
                try:
                    requests.append(driver.submit(prompt, max_new))
                except QueueFullError:
                    if not shed_on_full:
                        raise
                    shed += 1
                    requests.append(None)
                pending.pop(0)
            if threaded:
                driver.pump()
                time.sleep(2e-4)
            elif not driver.step() and pending:
                time.sleep(max(0.0,
                               min(pending[0][0] - (time.monotonic() - t0),
                                   1e-3)))
    finally:
        if threaded:
            driver.stop_workers()
    return requests, shed, time.monotonic() - t0
