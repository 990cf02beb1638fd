"""Lockstep serving engine with the EntroLLM weight path (PyTorch port of
``repro/serving/engine.py``: dense and compressed residency, lockstep).

Pipeline (paper Alg. 1 EDGE DEVICE OPERATIONS):

  1. **Load**: :func:`load_params_from_compressed` decodes the entropy-coded
     container once per engine start.  The default load *streams*: the
     :class:`~repro_torch.core.scheduler.DecodeScheduler` feeds
     fixed-budget chunks (embedding first) through a decoder backend with
     double-buffered prefetch — on a card, the CUDA decode kernels — so host
     memory stays bounded and the first weights are resident long before
     the last chunk decodes (``time_to_first_weight_s``).
  2. **Residency**: decoded weights stay *quantized* (uint8 symbols + scale +
     zero as :class:`~repro_torch.models.layers.QT` triples, nibble-packed
     :class:`~repro_torch.models.layers.QT4` at 4 bits) in device memory and
     are dequantized in bf16 at each use.
     With ``resident="compressed"`` the container stays entropy-coded
     instead (:class:`~repro_torch.serving.resident.CompressedResidentWeights`)
     and each layer's weights are decoded just before its matmuls, or inside
     them through the fused kernels.
  3. **Serve**: ``prefill`` then repeated ``decode_step``; sampling is
     greedy or temperature-categorical through a ``torch.Generator``.

Entry points run on the card unless the caller passes ``device="cpu"``, and
raise when asked for a card that is not there.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs.base import ArchConfig
from repro_torch.core.spec import quantizable_shape as _quantizable_shape
from repro_torch.core.store import _DEFAULT_CHUNK, CompressedModel
from repro_torch.models import api
from repro_torch.models.layers import pack_qt, to_device
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

# historical ad-hoc metric-dict keys -> canonical registry gauge names (the
# read-through surface Engine.generate keeps, same as the JAX package's)
_LEGACY_GENERATE_KEYS = {
    "prefill_s": "serve.prefill_s",
    "decode_s": "serve.decode_s",
    "ttft_s": "serve.ttft_s",
    "decode_tok_per_s": "serve.decode_tok_per_s",
    "e2e_tok_per_s": "serve.e2e_tok_per_s",
    "tok_per_s": "serve.decode_tok_per_s",
}


def _fence(dev: torch.device) -> None:
    """Synchronize when the active tracer asked for fenced spans
    (``--trace-sync``): CUDA launches are asynchronous, so without a fence a
    span around a step measures the enqueue, not the compute."""
    if obs_trace.sync_enabled():
        _device.synchronize(dev)


@dataclasses.dataclass
class ServeConfig:
    max_len: int = 2048
    temperature: float = 0.0           # 0 => greedy


def load_params_from_compressed(model: CompressedModel, *,
                                quantized: bool = True,
                                backend: Optional[str] = None,
                                chunk_symbols: Optional[int] = _DEFAULT_CHUNK,
                                stream: bool = True,
                                device=None,
                                metrics: Optional[dict] = None
                                ) -> Dict[str, Any]:
    """Decode the container into serving weights on ``device``, streaming by
    default.

    quantized=True  -> {name: QT(q, scale, zero)} + fp32 leftovers (EntroLLM
                       path); 4-bit tensors pack nibble pairs into QT4 (0.5
                       bytes/param resident)
    quantized=False -> dense fp32 weights (baseline path)

    ``stream=True`` consumes :meth:`CompressedModel.iter_decode` chunk by
    chunk (``chunk_symbols``; ``None`` = one monolithic chunk), embedding
    first; ``stream=False`` decodes everything in one batch.  ``backend`` is
    a decoder-registry name (``numpy`` / ``torch`` / ``cuda``; None = follow
    ``device``).  ``device`` is ``cuda`` unless the caller names the CPU.

    When a ``metrics`` dict is passed it is filled with
    ``time_to_first_weight_s`` (start -> first decoded tensor resident),
    ``decode_load_s`` (total), and the resolved ``decode_backend`` name.
    """
    from repro_torch.core.decode_backends import get_backend
    dev = _device.resolve(device)
    t0 = time.perf_counter()
    ttfw: Optional[float] = None
    resolved = get_backend(backend, device=dev)

    if stream:
        kw = dict(backend=resolved, first=("embed",),
                  chunk_symbols=chunk_symbols)
        pairs = (model.iter_dequantize(**kw) if not quantized
                 else model.iter_quantized_weights(**kw))
    elif quantized:
        pairs = iter(model.quantized_weights(backend=resolved).items())
    else:
        pairs = iter(model.dequantize_all(backend=resolved).items())

    def place(v):
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(v)
        return to_device(v, dev)

    out: Dict[str, Any] = {}
    with obs_trace.span("load.stream", cat="load", backend=resolved.name,
                        stream=stream, quantized=quantized):
        if quantized:
            for k, v in model.unquantized.items():
                out[k] = place(v)
        for name, val in pairs:
            if quantized and name in model.qmeta:
                q, scale, zero = val
                bits = model.qmeta[name]["bits"]
                if (not _quantizable_shape(name, model.tensors[name].shape)
                        or model.qmeta[name]["granularity"] == "per_group"):
                    # norm scales / biases quantized by an explicit rule, and
                    # per-group scales (which do not broadcast against the
                    # weight), dequantize at load like the JAX package
                    out[name] = place(model._dequantize_one(name, q))
                else:
                    out[name] = place(pack_qt(q, scale, zero, bits=bits))
            else:
                out[name] = place(val)
            if ttfw is None:
                _device.synchronize(dev)
                ttfw = time.perf_counter() - t0
        _device.synchronize(dev)
    load_s = time.perf_counter() - t0
    obs_metrics.gauge("load.decode_load_s").set(load_s)
    obs_metrics.gauge("load.time_to_first_weight_s").set(
        ttfw if ttfw is not None else 0.0)
    obs_metrics.counter("load.decodes").inc(backend=resolved.name)
    if metrics is not None:
        metrics["time_to_first_weight_s"] = ttfw if ttfw is not None else 0.0
        metrics["decode_load_s"] = load_s
        metrics["decode_backend"] = resolved.name
    return out


def sample(logits: torch.Tensor, temperature: float,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """(B, S, V) logits -> (B,) int32 tokens from the last position: argmax
    when ``temperature <= 0`` (first index on ties, as ``jnp.argmax``),
    else a categorical draw from ``softmax(logits / temperature)``."""
    last = logits[:, -1]
    if temperature <= 0.0:
        return torch.argmax(last, dim=-1).to(torch.int32)
    probs = torch.softmax(last.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


class ServeSteps:
    """The per-architecture step functions every serving front end drives:
    :class:`Engine` (lockstep) and
    :class:`repro_torch.serving.batching.ContinuousEngine` (slot batch).
    ``decode_fn`` takes ``pos`` as an int (lockstep) or a ``(B,)`` tensor
    (per-slot positions); ``prefill_chunk_fn`` writes one prompt chunk at
    ``(B,)`` offsets.

    ``resident="dense"`` (default) runs the whole-tree steps over a params
    dict.  ``resident="compressed"`` builds per-layer step loops instead:
    ``params`` must then be a
    :class:`repro_torch.serving.resident.CompressedResidentWeights`, and each
    step loops the layers in execution order, taking layer ``l``'s slot just
    before its block while the worker thread decodes layer ``l+1``.  The
    loops keep the step signatures, so :class:`Engine` drives either mode
    unchanged, and greedy decode is bit-identical between the two (the
    per-layer blocks mirror the loop bodies op for op).
    """

    def __init__(self, cfg: ArchConfig, sc: ServeConfig, *,
                 resident: str = "dense"):
        if resident not in ("dense", "compressed"):
            raise ValueError(f"resident must be 'dense' or 'compressed', "
                             f"got {resident!r}")
        if resident == "compressed" and not api.supports_resident_serving(cfg):
            raise NotImplementedError(
                f"family {cfg.family!r} does not implement the per-layer "
                f"weight-slot contract (embed_step / resident_block); "
                f"supported today: dense")
        self.cfg = cfg
        self.sc = sc
        self.mod = api.build(cfg)
        self.resident = resident
        if resident == "compressed":
            self.prefill_fn = self._resident_prefill
            self.decode_fn = self._resident_step
            self.prefill_chunk_fn = self._resident_step

    def prefill_fn(self, params, prompt: torch.Tensor):
        return self.mod.prefill(self.cfg, params, prompt,
                                max_len=self.sc.max_len)

    def decode_fn(self, params, token: torch.Tensor, cache, pos):
        return self.mod.decode_step(self.cfg, params, token, cache, pos)

    def prefill_chunk_fn(self, params, tokens: torch.Tensor, cache,
                         pos: torch.Tensor):
        return self.mod.prefill_chunk(self.cfg, params, tokens, cache, pos)

    # ------------------------------------------------- compressed residency
    def _resident_prefill(self, weights, prompt: torch.Tensor):
        """Per-layer twin of ``prefill``: full causal attention per layer, each
        layer's (k, v) written into the zero-padded cache row as it is
        produced."""
        B, S = prompt.shape
        dev = prompt.device
        x = self.mod.embed_step(self.cfg, weights.globals, prompt)
        positions = torch.arange(S, device=dev)
        cache = self.mod.init_cache(self.cfg, B, self.sc.max_len,
                                    device=dev)
        weights.prefetch(0)
        for l in range(weights.n_layers):
            with obs_trace.span("serve.layer", layer=l, phase="prefill"):
                lp = weights.get(l)
                weights.prefetch((l + 1) % weights.n_layers)
                x, (k, v) = self.mod.resident_prefill_block(
                    self.cfg, lp, x, positions=positions)
                cache["k"][l, :, :S] = k
                cache["v"][l, :, :S] = v
                _fence(dev)
        return self.mod.head_step(self.cfg, weights.globals, x,
                                  last_only=True), cache

    def _resident_step(self, weights, tokens: torch.Tensor, cache, pos):
        """Per-layer twin of ``decode_step`` AND ``prefill_chunk`` (the
        block reads S from the token shape; ``pos`` passes through, an int
        or a (B,) tensor): ``get(l)`` returns layer l's slot (usually
        already decoded by the worker), ``prefetch(l+1)`` starts the next
        layer's decode, and the wrap-around prefetch primes layer 0 for the
        next step."""
        x = self.mod.embed_step(self.cfg, weights.globals, tokens)
        weights.prefetch(0)
        for l in range(weights.n_layers):
            with obs_trace.span("serve.layer", layer=l, phase="step"):
                lp = weights.get(l)
                weights.prefetch((l + 1) % weights.n_layers)
                x, cache = self.mod.resident_block(self.cfg, lp, x, cache, l,
                                                   pos)
                _fence(tokens.device)
        return self.mod.head_step(self.cfg, weights.globals, x), cache


class Engine:
    """Lockstep serving: one fixed-shape batch per ``generate`` call, on
    ``device`` (``cuda`` unless the caller names the CPU).

    ``resident="compressed"`` serves straight from the entropy-coded
    container: pass a :class:`repro_torch.serving.resident.
    CompressedResidentWeights` as ``params``."""

    def __init__(self, cfg: ArchConfig, params: Any, sc: ServeConfig, *,
                 device=None, resident: str = "dense"):
        self.cfg = cfg
        self.params = params
        self.sc = sc
        self.device = _device.resolve(device)
        self.steps = ServeSteps(cfg, sc, resident=resident)

    @torch.inference_mode()
    def generate(self, prompt, steps: int, *, seed: int = 0,
                 echo_metrics: bool = False):
        """prompt: (B, S) int tokens (tensor or array).  Returns (B, steps)
        int32 tokens on the engine's device (and the metrics view when
        ``echo_metrics``)."""
        dev = self.device
        sync: Callable[[], None] = lambda: _device.synchronize(dev)
        prompt = torch.as_tensor(prompt, dtype=torch.int64, device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        B, S = prompt.shape
        t0 = time.perf_counter()
        with obs_trace.span("serve.prefill"):
            logits, cache = self.steps.prefill_fn(self.params, prompt)
            sync()
        t_prefill = time.perf_counter() - t0
        toks = []
        tok = sample(logits, self.sc.temperature, gen)[:, None]
        sync()
        t_first_token = time.perf_counter() - t0
        toks.append(tok)
        t1 = time.perf_counter()
        step_hist = obs_metrics.histogram("serve.decode_step_s")
        for i in range(steps - 1):
            ts = time.perf_counter()
            with obs_trace.span("serve.decode_step", step=i):
                logits, cache = self.steps.decode_fn(
                    self.params, tok.to(torch.int64), cache, S + i)
                tok = sample(logits, self.sc.temperature, gen)[:, None]
                toks.append(tok)
                _fence(dev)
            step_hist.observe(time.perf_counter() - ts)
        out = torch.cat(toks, dim=1)
        sync()
        t_decode = time.perf_counter() - t1
        decode_tps = B * max(steps - 1, 1) / max(t_decode, 1e-9)
        e2e_tps = B * steps / max(time.perf_counter() - t0, 1e-9)
        obs_metrics.gauge("serve.prefill_s").set(t_prefill)
        obs_metrics.gauge("serve.decode_s").set(t_decode)
        obs_metrics.gauge("serve.ttft_s").set(t_first_token)
        obs_metrics.gauge("serve.decode_tok_per_s").set(decode_tps)
        obs_metrics.gauge("serve.e2e_tok_per_s").set(e2e_tps)
        obs_metrics.counter("serve.tokens").inc(B * steps)
        if echo_metrics:
            return out, obs_metrics.LegacyMetricsView(
                obs_metrics.default_registry(), _LEGACY_GENERATE_KEYS)
        return out
