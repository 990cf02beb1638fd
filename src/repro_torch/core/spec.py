"""Declarative per-tensor compression policy (DESIGN.md §7).

The paper's Alg. 1 fixes ONE model-wide bit-width and ONE global Huffman
table.  :class:`CompressionSpec` generalizes that to an ordered rule list —
first matching rule wins, like firewall rules — so one container can mix
4- and 8-bit tensors, alternative entropy coders, per-channel/per-group
quantization, and explicit keep-fp32 carve-outs:

    spec = CompressionSpec.parse(
        "*norm*:fp32; layers/*mlp*:bits=4,codec=rans; *:bits=8,codec=huffman")
    cm = CompressedModel.compress(params, spec=spec)

Rules resolve to a :class:`TensorPolicy` per tensor.  Tensors no rule
matches fall back to the paper's policy: :func:`default_quantize_predicate`
(DESIGN.md §5) decides *whether* to quantize, and the spec's defaults decide
*how*.  A matching rule OVERRIDES that predicate — a bare ``*`` catch-all
quantizes everything it reaches, biases and sensitive SSM params included,
so keep explicit ``fp32`` carve-outs ahead of it (or omit the catch-all).  ``bits="auto"`` picks 4 vs. 8 per tensor from two signals
(:func:`auto_choose_bits`): the relative quantization error at 4 bits must
stay under ``auto_tol``, and the 4-bit symbol histogram must actually be
compressible (entropy under ``auto_entropy_cap`` — a near-uniform 4-bit
histogram means entropy coding would win nothing over the error risk).

The grammar for ``CompressionSpec.parse`` (the ``--compress-spec`` CLI
surface)::

    spec    := clause (';' clause)*
    clause  := pattern ':' opt (',' opt)*
    opt     := 'fp32' | 'auto' | INT            # bare int = bits
             | key '=' value                    # bits/codec/granularity/
                                                # group/scheme
    pattern := fnmatch glob over tensor names ('*', '?', '[..]')
             | 'defaults'                       # reserved: sets the spec
                                                # DEFAULTS, not a rule

A ``defaults:`` clause configures what unmatched tensors get (they still
pass through :func:`default_quantize_predicate` first) — unlike a ``*``
catch-all rule, which overrides the predicate.  It also accepts the
encoder-wide parameters ``auto_tol`` / ``auto_entropy_cap`` /
``segment_symbols`` / ``max_code_len``.  ``describe()`` emits this form
(non-default encoder params included), so provenance strings round-trip
with identical semantics.

``validate()`` checks every referenced codec against the codec registry and
every bit-width against the uint8-symbol range — called upfront by
``launch/serve.py`` so a typo fails with the registered list, not a deep
KeyError mid-compress (the same contract as ``--decode-backend``).
"""
from __future__ import annotations

import dataclasses
import fnmatch
from typing import Optional, Tuple, Union

import numpy as np

from . import quant
from .segmentation import DEFAULT_SEGMENT_SYMBOLS

AUTO = "auto"

# encoder-wide parameters: legal only in a 'defaults:' clause, carried by
# describe() when they differ from the dataclass defaults
_SPEC_WIDE_KEYS = frozenset(
    ("auto_tol", "auto_entropy_cap", "segment_symbols", "max_code_len"))

_GRANULARITY_ALIASES = {
    "per_tensor": quant.Granularity.PER_TENSOR,
    "tensor": quant.Granularity.PER_TENSOR,
    "per_channel": quant.Granularity.PER_CHANNEL,
    "channel": quant.Granularity.PER_CHANNEL,
    "per_group": quant.Granularity.PER_GROUP,
    "group": quant.Granularity.PER_GROUP,
}


SENSITIVE_NAME_KEYS = ("norm", "scale", "bias", "a_log", "dt_", "conv_")


def quantizable_shape(name: str, shape: Tuple[int, ...]) -> bool:
    """Shape/name-only twin of :func:`default_quantize_predicate`, for
    callers that hold container metadata rather than the tensor itself
    (e.g. the serving loader deciding quantized residency)."""
    if len(shape) < 2:
        return False
    lname = name.lower()
    if any(k in lname for k in SENSITIVE_NAME_KEYS):
        return False
    return int(np.prod(shape)) >= 4096


def default_quantize_predicate(name: str, w: np.ndarray) -> bool:
    """Quantize matrix-shaped weights; keep norms / biases / tiny or sensitive params
    (e.g. SSM ``A_log``/``dt``) in full precision, per DESIGN.md §5."""
    return quantizable_shape(name, np.shape(w))


@dataclasses.dataclass(frozen=True)
class CompressionRule:
    """One ordered rule: name pattern -> how (or whether) to compress.

    ``None`` fields inherit the spec's defaults; ``bits`` may be an int,
    ``"auto"``, or None (= spec default).  ``keep_fp32`` short-circuits
    everything else for matching tensors.
    """

    pattern: str
    bits: Union[int, str, None] = None
    codec: Optional[str] = None
    granularity: Optional[quant.Granularity] = None
    group: Optional[int] = None
    scheme: Optional[quant.Scheme] = None
    keep_fp32: bool = False

    def matches(self, name: str) -> bool:
        return fnmatch.fnmatchcase(name, self.pattern)


@dataclasses.dataclass(frozen=True, eq=False)
class TensorPolicy:
    """The fully resolved decision for one tensor."""

    quantize: bool
    bits: int = 8
    codec: str = "huffman"
    granularity: quant.Granularity = quant.Granularity.PER_TENSOR
    group: int = 128
    scheme: Optional[quant.Scheme] = None
    rule: Optional[CompressionRule] = None     # provenance (None = default path)
    # bits="auto" probes by actually quantizing at 4 bits; when 4 wins, the
    # probe's QuantizedTensor rides along so compress() need not redo it
    qt: Optional[quant.QuantizedTensor] = None


def auto_choose_bits(w: np.ndarray, *, granularity: quant.Granularity,
                     group: int, tol: float, entropy_cap: float
                     ) -> Tuple[int, Optional[quant.QuantizedTensor]]:
    """Pick 4 vs. 8 bits for one tensor (the spec's ``bits="auto"`` policy).

    Returns ``(bits, qt4)`` where ``qt4`` is the probe's 4-bit
    :class:`~repro_torch.core.quant.QuantizedTensor` when 4 wins (reusable by the
    caller — the probe already paid for the quantization) and None otherwise.

    4 bits wins iff BOTH hold:
      * **bulk** relative quantization error <= ``tol`` — error and signal
        energy are measured over the sub-99.9th-percentile ``|w|`` mass.
        Outliers must be excluded from the *denominator*: a single huge entry
        dominates ``E[w^2]`` and makes the collapsed-to-one-bin bulk look
        accurate, which is exactly the failure mode that forces 8 bits;
      * 4-bit symbol entropy ``<= entropy_cap`` — a histogram near the
        uniform 4.0 bits would entropy-code to ~4 bits anyway, so the halved
        symbol width buys little storage for the added error.
    """
    from .entropy import shannon_entropy, symbol_frequencies
    qt4 = quant.quantize(w, 4, granularity, group=group)
    deq = quant.dequantize(qt4)
    bulk = np.abs(w) <= np.quantile(np.abs(w), 0.999)
    denom = float(np.mean(np.square(w[bulk]))) + 1e-20
    rel_err = float(np.mean(np.square((w - deq)[bulk]))) / denom
    h4 = shannon_entropy(symbol_frequencies(qt4.q, 16))
    if rel_err <= tol and h4 <= entropy_cap:
        return 4, qt4
    return 8, None


@dataclasses.dataclass(frozen=True)
class CompressionSpec:
    """Ordered per-tensor rules + defaults for everything they leave open."""

    rules: Tuple[CompressionRule, ...] = ()
    default_bits: Union[int, str] = 8
    default_codec: str = "huffman"
    default_granularity: quant.Granularity = quant.Granularity.PER_TENSOR
    default_group: int = 128
    auto_tol: float = 3e-2          # bits="auto": max relative 4-bit MSE
    #   (a clean Gaussian tensor quantizes to 4 bits at ~2% relative MSE;
    #    outlier-heavy tensors blow well past 3% and stay at 8 bits)
    auto_entropy_cap: float = 3.9   # bits="auto": max useful 4-bit entropy
    segment_symbols: int = DEFAULT_SEGMENT_SYMBOLS
    max_code_len: int = 12          # huffman length limit (codec-specific kw)
    source: Optional[str] = None    # the parsed text, for provenance

    # ---------------------------------------------------------------- resolve
    def resolve(self, name: str, w: np.ndarray) -> TensorPolicy:
        """First matching rule wins; unmatched tensors take the paper's
        default predicate + the spec defaults."""
        w = np.asarray(w)
        for rule in self.rules:
            if not rule.matches(name):
                continue
            if rule.keep_fp32:
                return TensorPolicy(quantize=False, rule=rule)
            return self._policy(w, rule=rule,
                                bits=(rule.bits if rule.bits is not None
                                      else self.default_bits),
                                codec=rule.codec or self.default_codec,
                                granularity=(rule.granularity
                                             or self.default_granularity),
                                group=(rule.group if rule.group is not None
                                       else self.default_group),
                                scheme=rule.scheme)
        if not default_quantize_predicate(name, w):
            return TensorPolicy(quantize=False)
        return self._policy(w, rule=None, bits=self.default_bits,
                            codec=self.default_codec,
                            granularity=self.default_granularity,
                            group=self.default_group, scheme=None)

    def _policy(self, w, *, rule, bits, codec, granularity, group,
                scheme) -> TensorPolicy:
        qt = None
        if bits == AUTO:
            bits, qt = auto_choose_bits(w, granularity=granularity,
                                        group=group, tol=self.auto_tol,
                                        entropy_cap=self.auto_entropy_cap)
            if scheme is not None:
                qt = None    # probe used choose_scheme; a forced scheme differs
        return TensorPolicy(quantize=True, bits=int(bits), codec=codec,
                            granularity=granularity, group=group,
                            scheme=scheme, rule=rule, qt=qt)

    # --------------------------------------------------------------- validate
    def codecs_used(self) -> Tuple[str, ...]:
        names = {r.codec for r in self.rules if r.codec}
        names.add(self.default_codec)
        return tuple(sorted(names))

    def validate(self) -> "CompressionSpec":
        """Fail fast on unknown codecs / unrepresentable bit-widths."""
        from . import codecs
        for name in self.codecs_used():
            codecs.get_codec(name)       # raises with the registered list
        for b in [self.default_bits] + [r.bits for r in self.rules
                                        if r.bits is not None]:
            if b == AUTO:
                continue
            if not (isinstance(b, int) and 1 <= b <= 8):
                raise ValueError(f"bits must be in [1, 8] or 'auto', got {b!r}"
                                 + (f" (spec: {self.source})"
                                    if self.source else ""))
        for g in [self.default_group] + [r.group for r in self.rules
                                         if r.group is not None]:
            if not (isinstance(g, int) and g >= 1):
                raise ValueError(f"group must be >= 1, got {g!r}"
                                 + (f" (spec: {self.source})"
                                    if self.source else ""))
        return self

    # ------------------------------------------------------------------ parse
    @classmethod
    def parse(cls, text: str, **defaults) -> "CompressionSpec":
        """Parse the rule mini-language (see module docstring)."""
        rules = []
        for clause in filter(None, (c.strip() for c in text.split(";"))):
            if ":" not in clause:
                raise ValueError(f"bad spec clause {clause!r}: expected "
                                 f"'pattern:opt[,opt...]'")
            pattern, _, body = clause.partition(":")
            is_defaults = pattern.strip().lower() == "defaults"
            kw: dict = {}
            for opt in filter(None, (o.strip() for o in body.split(","))):
                key, eq, value = opt.partition("=")
                key = key.strip().lower()
                value = value.strip()
                if not eq:
                    if key == "fp32":
                        kw["keep_fp32"] = True
                    elif key == AUTO:
                        kw["bits"] = AUTO
                    elif key.isdigit():
                        kw["bits"] = int(key)
                    else:
                        raise ValueError(
                            f"bad option {opt!r} in clause {clause!r}: "
                            f"expected fp32 / auto / <bits> / key=value")
                elif key == "bits":
                    kw["bits"] = AUTO if value == AUTO else int(value)
                elif key == "codec":
                    kw["codec"] = value
                elif key in ("granularity", "gran"):
                    try:
                        kw["granularity"] = _GRANULARITY_ALIASES[value.lower()]
                    except KeyError:
                        raise ValueError(
                            f"unknown granularity {value!r}; one of "
                            f"{sorted(_GRANULARITY_ALIASES)}") from None
                elif key == "group":
                    kw["group"] = int(value)
                elif key == "scheme":
                    kw["scheme"] = quant.Scheme(value)
                elif key in ("auto_tol", "auto_entropy_cap"):
                    kw[key] = float(value)
                elif key in ("segment_symbols", "max_code_len"):
                    kw[key] = int(value)
                else:
                    raise ValueError(f"unknown spec key {key!r} in "
                                     f"clause {clause!r}")
            if is_defaults:
                # reserved clause: sets the spec DEFAULTS (unmatched tensors
                # still pass the keep-fp32 predicate), not a catch-all rule
                if kw.get("keep_fp32") or "scheme" in kw:
                    raise ValueError(f"clause {clause!r}: 'defaults' takes "
                                     f"bits/codec/granularity/group and "
                                     f"encoder params only")
                defaults.update({
                    (k if k in _SPEC_WIDE_KEYS else f"default_{k}"): v
                    for k, v in kw.items()})
            elif set(kw) & _SPEC_WIDE_KEYS:
                raise ValueError(
                    f"clause {clause!r}: {sorted(set(kw) & _SPEC_WIDE_KEYS)} "
                    f"are spec-wide; put them in a 'defaults:' clause")
            else:
                rules.append(CompressionRule(pattern=pattern.strip(), **kw))
        return cls(rules=tuple(rules), source=text, **defaults).validate()

    def describe(self) -> str:
        """Canonical spec text: rules + a ``defaults:`` clause.  Built from
        the resolved fields — NOT the raw ``source`` — so defaults passed to
        ``parse()`` as keyword arguments (e.g. serve.py's per-channel) are
        recorded and ``parse(describe())`` round-trips with identical
        semantics."""
        parts = []
        for r in self.rules:
            opts = ("fp32" if r.keep_fp32 else ",".join(
                f"{k}={v}" for k, v in [
                    ("bits", r.bits), ("codec", r.codec),
                    ("granularity", r.granularity.value if r.granularity
                     else None),
                    ("group", r.group),
                    ("scheme", r.scheme.value if r.scheme else None),
                ] if v is not None))
            parts.append(f"{r.pattern}:{opts}")
        # 'defaults', NOT a '*' rule: a catch-all rule would override the
        # keep-fp32 predicate the original spec's defaults preserved
        field_defaults = {f.name: f.default for f in dataclasses.fields(self)}
        extras = "".join(
            f",{k}={getattr(self, k)}" for k in sorted(_SPEC_WIDE_KEYS)
            if getattr(self, k) != field_defaults[k])
        parts.append(f"defaults:bits={self.default_bits}"
                     f",codec={self.default_codec}"
                     f",granularity={self.default_granularity.value}"
                     f",group={self.default_group}" + extras)
        return "; ".join(parts)


@dataclasses.dataclass(frozen=True)
class KVCompressionSpec:
    """Paged KV-cache compression policy (the ``--kv-spec`` CLI surface).

    The weight-side :class:`CompressionSpec` is an ordered per-tensor rule
    list; the KV cache needs far less machinery — one uniform policy covers
    every block, because blocks are interchangeable units of one pool:

    * ``bits`` — in-pool precision: 16 keeps dense bf16 blocks (paged layout
      only, bit-identical to the slot pool), 8/4 quantize each block's K/V
      per (token, head) with an asymmetric grid
      (:func:`repro_torch.models.layers.kv_quantize` — the jnp twin of
      :func:`repro_torch.core.quant.quantize`'s ASYMMETRIC scheme);
    * ``block_size`` — tokens per block (the paging granularity);
    * ``codec`` — optional cold-tier entropy codec (``huffman`` / ``rans`` /
      ``raw`` from the codec registry): evicted shared blocks are
      entropy-coded to host bytes instead of dropped, so a prefix hit on a
      cold block costs one serial decode instead of a re-prefill.  Quantized
      pools only — there is no sub-bf16 symbol alphabet to code at bits=16;
    * ``sharing`` — content-hash prefix sharing of full, immutable prompt
      blocks across requests (docs/KV_CACHE.md has the COW rules).

    Grammar (comma-separated, mirroring one ``CompressionSpec`` clause)::

        opt  := 'sharing' | INT                  # bare int = bits
              | ('bits'|'block'|'codec'|'sharing') '=' value

    e.g. ``"bits=4,block=16,codec=rans,sharing"``.  ``validate()`` checks
    the codec against the registry upfront (same contract as
    ``CompressionSpec.validate``); ``describe()`` round-trips.
    """

    bits: int = 16
    block_size: int = 16
    codec: Optional[str] = None
    sharing: bool = False
    source: Optional[str] = None    # the parsed text, for provenance

    @classmethod
    def parse(cls, text: str, **overrides) -> "KVCompressionSpec":
        kw: dict = {}
        for opt in filter(None, (o.strip() for o in text.split(","))):
            key, eq, value = opt.partition("=")
            key = key.strip().lower()
            value = value.strip()
            if not eq:
                if key == "sharing":
                    kw["sharing"] = True
                elif key.isdigit():
                    kw["bits"] = int(key)
                else:
                    raise ValueError(
                        f"bad kv-spec option {opt!r}: expected sharing / "
                        f"<bits> / bits=/block=/codec=/sharing=")
            elif key == "bits":
                kw["bits"] = int(value)
            elif key in ("block", "block_size"):
                kw["block_size"] = int(value)
            elif key == "codec":
                kw["codec"] = None if value.lower() in ("", "none") else value
            elif key == "sharing":
                kw["sharing"] = value.lower() in ("1", "true", "yes", "on")
            else:
                raise ValueError(f"unknown kv-spec key {key!r} in {text!r}")
        kw.update(overrides)
        return cls(source=text, **kw).validate()

    def validate(self) -> "KVCompressionSpec":
        if self.bits not in (16, 8, 4):
            raise ValueError(f"kv bits must be 16 (dense), 8, or 4; got "
                             f"{self.bits!r}"
                             + (f" (kv-spec: {self.source})"
                                if self.source else ""))
        if not (isinstance(self.block_size, int) and self.block_size >= 1):
            raise ValueError(f"kv block_size must be >= 1, got "
                             f"{self.block_size!r}")
        if self.codec is not None:
            from . import codecs
            codecs.get_codec(self.codec)     # raises with the registered list
            if self.bits == 16:
                raise ValueError(
                    "kv codec (cold-block entropy coding) needs a quantized "
                    "pool: entropy coding targets the uint8 symbol stream, "
                    "so set bits=8 or bits=4 alongside codec="
                    + (f" (kv-spec: {self.source})" if self.source else ""))
        return self

    def describe(self) -> str:
        """Canonical spec text; ``parse(describe())`` round-trips."""
        s = f"bits={self.bits},block={self.block_size}"
        if self.codec:
            s += f",codec={self.codec}"
        if self.sharing:
            s += ",sharing"
        return s


def spec_from_legacy(bits: int = 8,
                     granularity: quant.Granularity = quant.Granularity.PER_TENSOR,
                     *, codec: str = "huffman",
                     segment_symbols: int = DEFAULT_SEGMENT_SYMBOLS,
                     max_code_len: int = 12) -> CompressionSpec:
    """The pre-spec ``compress(bits=, granularity=)`` call, as a spec."""
    return CompressionSpec(default_bits=bits, default_codec=codec,
                           default_granularity=granularity,
                           segment_symbols=segment_symbols,
                           max_code_len=max_code_len)
