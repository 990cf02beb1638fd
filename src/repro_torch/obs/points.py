"""Instrumentation-point catalog (PyTorch port of ``repro/obs/points.py``):
the span and metric names each serving mode is REQUIRED to emit.

``scripts/check_trace.py --expect MODE`` validates an emitted trace/metrics
pair against the JAX package's catalog and fails if any registered point
produced zero events; the port serves the same modes under the same names,
so it keeps a copy of the catalog, entry for entry (held equal to the JAX
package's by ``tests/test_torch_obs_points.py``), plus the informational
points of ``PORT_ONLY_POINTS``, which only the port emits.

``INFORMATIONAL_POINTS`` lists best-effort instrumentation: emitted by some
code path but required by no serving mode.
"""
from __future__ import annotations

from typing import Dict, List

# span names (trace file) and metric names (metrics JSON-lines) that MUST
# appear at least once for a serve in the given mode
EXPECTED_POINTS: Dict[str, Dict[str, List[str]]] = {
    # lockstep Engine.generate, --resident compressed --fused.  NOTE: no
    # decode.exec_step / decode.symbols here — when every matmul tensor is
    # fused, the entropy decode happens inside the fused kernel (payload
    # handles), so the host-side scheduler decode never runs; the per-layer
    # slot still materializes the carve-out views (resident.slot_tensors).
    "resident-fused-lockstep": {
        "spans": [
            "serve.prefill",
            "serve.decode_step",
            "serve.layer",
            "resident.decode",
            "resident.consume_wait",
        ],
        "metrics": [
            "load.decode_load_s",
            "serve.decode_tok_per_s",
            "serve.e2e_tok_per_s",
            "serve.decode_step_s",
            "resident.prefetch_issued",
            "resident.fused_tensors",
            "resident.slot_tensors",
        ],
    },
    # lockstep Engine.generate, --resident compressed (unfused)
    "resident-lockstep": {
        "spans": [
            "serve.prefill",
            "serve.decode_step",
            "serve.layer",
            "resident.decode",
            "resident.consume_wait",
            "decode.exec_step",
        ],
        "metrics": [
            "load.decode_load_s",
            "serve.decode_tok_per_s",
            "serve.decode_step_s",
            "resident.prefetch_issued",
            "resident.slot_tensors",
            "decode.symbols",
        ],
    },
    # lockstep Engine.generate, --resident dense (streaming load)
    "dense-lockstep": {
        "spans": [
            "load.stream",
            "serve.prefill",
            "serve.decode_step",
            "decode.chunk",
        ],
        "metrics": [
            "load.decode_load_s",
            "load.time_to_first_weight_s",
            "serve.decode_tok_per_s",
            "serve.decode_step_s",
            "decode.symbols",
        ],
    },
    # ContinuousEngine (--batch-slots), dense residency
    "continuous": {
        "spans": [
            "serve.step",
            "serve.admit_chunk",
            "serve.decode_batch",
        ],
        "metrics": [
            "queue.depth",
            "queue.submitted",
            "queue.wait_s",
            "slots.occupied",
            "slots.inserts",
            "request.ttft_s",
            "request.latency_s",
        ],
    },
    # FleetDriver (--replicas N): the fleet boundary plus every replica's
    # continuous-engine points.  fleet.pump only spans when the intake has
    # requests to place and fleet.dispatch only on a routing decision, so
    # any fleet serve that moves traffic must emit both — a router refactor
    # that silently stops routing (or stops recording it) goes dark here.
    "fleet-continuous": {
        "spans": [
            "fleet.pump",
            "fleet.dispatch",
            "serve.step",
            "serve.admit_chunk",
            "serve.decode_batch",
        ],
        "metrics": [
            "fleet.submitted",
            "fleet.dispatched",
            "fleet.replicas_up",
            "fleet.queue_depth",
            "queue.depth",
            "queue.submitted",
            "queue.wait_s",
            "slots.occupied",
            "slots.inserts",
            "request.ttft_s",
            "request.latency_s",
        ],
    },
    # ContinuousEngine with the paged KV cache (--batch-slots --kv-spec).
    # kv.shared_hits only fires on a prefix hit, so this mode's smoke
    # traffic MUST replay shared system prompts (--prefix-sharing traffic
    # does) — a serve that never hits is indistinguishable from sharing
    # having gone dark.
    "paged-continuous": {
        "spans": [
            "serve.step",
            "serve.admit_chunk",
            "serve.decode_batch",
            "kv.admit",
        ],
        "metrics": [
            "queue.depth",
            "queue.submitted",
            "queue.wait_s",
            "slots.occupied",
            "slots.inserts",
            "request.ttft_s",
            "request.latency_s",
            "kv.resident_bytes",
            "kv.blocks_free",
            "kv.shared_hits",
        ],
    },
}

# Best-effort instrumentation: emitted by some code path but required by no
# serving mode (mode-dependent, probe-only, or benchmark-oriented).  The
# catalog-sync checker keeps this bidirectional with the emit sites: every
# name here has at least one emit site, every emit site is in exactly one
# of EXPECTED_POINTS / INFORMATIONAL_POINTS.
INFORMATIONAL_POINTS: Dict[str, List[str]] = {
    "spans": [
        "fleet.handoff_adopt",      # disaggregated fleets only
        "fleet.handoff_encode",
        "kv.cold_decode",           # only with a cold-tier codec configured
        "kv.cold_encode",
        "resident.prefetch_issue",
    ],
    "metrics": [
        "decode.calls",             # scheduler chunking detail
        "fleet.admission_rejects",  # admission-gate vetoes (chaos/test seam)
        "fleet.handoff_bytes",      # disaggregated fleets only
        "fleet.handoffs",
        "fleet.redrives",           # only after a replica failure
        "fleet.shed",               # only under overload / failures
        "kv.cold_evictions",        # cold tier / eviction pressure only
        "kv.cold_restores",
        "kv.dropped_evictions",
        "kv.shared_misses",         # zero on non-sharing traffic
        "load.decodes",
        "queue.shed",               # only under overload
        "requests.finished",
        "resident.fused_fallback",  # zero when every tensor fuses
        "resident.prefetch_hit",    # hit/wait split of consume_wait
        "resident.prefetch_wait",
        "resident.consume_wait_s",  # port only: consume_wait's seconds summed
        "serve.prefill_s",          # lockstep wall-clock breakdown
        "serve.decode_s",
        "serve.ttft_s",
        "serve.tokens",
        "slots.compactions",        # only when fragmentation triggers
        "slots.releases",
    ],
}

# Points the port emits and the JAX package does not, each one also listed
# above; the rest of the catalog is the JAX package's, entry for entry.
PORT_ONLY_POINTS: Dict[str, List[str]] = {
    "spans": [],
    "metrics": ["resident.consume_wait_s"],
}
