"""EntroLLM compressed model container (paper Alg. 1 lines 11-16 + §III-C layout).

On-disk layout (a single ``.npz``) — **format v2** (DESIGN.md §7,
docs/ARCHITECTURE.md "Container format"):

  * one or more serialized code tables (one per ``(codec, bits)`` group —
    mixed 4/8-bit symbols cannot share one 256-symbol histogram), each
    rebuilt deterministically from its stored histogram,
  * per-tensor metadata: shape, bits, scheme, granularity, codec/table id,
    scale/zero arrays, segment offsets / byte sizes / symbol counts,
  * one contiguous uint8 payload holding every segment stream (byte aligned).

**Format v1** (single global Huffman table, uniform bits) is read
bit-identically by :meth:`CompressedModel.load`; new containers are always
written as v2.

The encode side is driven by a declarative :class:`repro_torch.core.spec.
CompressionSpec` (ordered per-tensor rules: pattern -> bits / codec /
granularity / keep-fp32, with an ``auto`` 4-vs-8-bit policy); the legacy
``compress(bits=, granularity=, should_quantize=)`` arguments remain as the
single-rule shorthand.

Decode path mirrors Alg. 1's EDGE DEVICE OPERATIONS: load tables + streams,
then multi-stream parallel decode through a named backend (``numpy`` /
``torch`` / ``cuda`` — see :mod:`repro_torch.core.decode_backends`), then either
dequantize to the compute dtype or hand the still-quantized weights to the
fused dequant-matmul serving path.  All decode entry points are thin
consumers of :class:`repro_torch.core.scheduler.DecodeScheduler`; the ``iter_*``
variants stream tensors incrementally with bounded host memory
(docs/ARCHITECTURE.md, "Streaming decode").
"""
from __future__ import annotations

import dataclasses
import json
from typing import (Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np

from . import codecs, quant
from .codecs.base import CodeTable
from .segmentation import (DEFAULT_SEGMENT_SYMBOLS, SegmentedTensor,
                           segment_and_encode)
from .spec import (CompressionSpec, TensorPolicy, default_quantize_predicate,
                   spec_from_legacy)

# "use the scheduler's default budget" sentinel, so ``chunk_symbols=None``
# can mean "one monolithic chunk" consistently across every decode entry point
_DEFAULT_CHUNK: object = object()

CONTAINER_FORMAT_VERSION = 2


@dataclasses.dataclass
class CodecGroupStats:
    """Per-(codec, bits) group numbers — one row of the stats breakdown."""

    table_id: str
    codec: str
    bits: int
    param_count: int           # symbols in this group
    entropy_bits: float        # Shannon bound for the group histogram
    effective_bits: float      # ACHIEVED bits/symbol (payload bits / symbols)
    quant_bytes: int           # bits/8 per param
    encoded_bytes: int         # this group's share of the payload

    @property
    def shannon_ratio(self) -> float:
        """achieved / bound — 1.0 is the Shannon wall."""
        return self.effective_bits / max(self.entropy_bits, 1e-12)


@dataclasses.dataclass
class CompressionStats:
    """The numbers reported in the paper's Table I, per model.

    Mixed-precision containers report one :class:`CodecGroupStats` per
    ``(codec, bits)`` group; the scalar ``bits`` / ``entropy_bits`` /
    ``effective_bits`` properties are the symbol-weighted aggregates, so
    Table I stays correct when 4- and 8-bit tensors share a container.
    """

    param_count: int
    raw_bytes: int             # fp16 baseline (2 bytes/param)
    quant_bytes: int           # sum of bits/8 per param (+ fp32 leftovers)
    encoded_bytes: int         # entropy-coded payload (+ fp32 leftovers)
    metadata_bytes: int
    unquantized_params: int
    groups: List[CodecGroupStats] = dataclasses.field(default_factory=list)

    @property
    def quantized_params(self) -> int:
        return sum(g.param_count for g in self.groups)

    def _weighted(self, attr: str) -> float:
        n = self.quantized_params
        if n == 0:
            return 0.0
        return sum(getattr(g, attr) * g.param_count for g in self.groups) / n

    @property
    def bits(self) -> float:
        """Symbol-weighted stored bit-width (int-valued for uniform models)."""
        return self._weighted("bits")

    @property
    def entropy_bits(self) -> float:
        return self._weighted("entropy_bits")

    @property
    def effective_bits(self) -> float:
        return self._weighted("effective_bits")

    @property
    def shannon_ratio(self) -> float:
        """achieved / bound, symbol-weighted — 1.0 is the Shannon wall."""
        return self.effective_bits / max(self.entropy_bits, 1e-12)

    @property
    def reduction_vs_quant(self) -> float:
        return 1.0 - self.encoded_bytes / max(self.quant_bytes, 1)

    @property
    def reduction_vs_fp16(self) -> float:
        return 1.0 - self.encoded_bytes / max(self.raw_bytes, 1)


class CompressedModel:
    """In-memory compressed representation of a pytree of weights."""

    def __init__(self, tables: Dict[str, CodeTable],
                 tensors: Dict[str, SegmentedTensor],
                 qmeta: Dict[str, dict], payload: np.ndarray,
                 unquantized: Dict[str, np.ndarray],
                 spec: Optional[CompressionSpec] = None):
        self.tables = tables        # table id -> CodeTable
        self.tensors = tensors
        self.qmeta = qmeta          # name -> {bits, scheme, granularity,
        #                                      scale, zero, codec, table}
        self.payload = payload
        self.unquantized = unquantized  # small / sensitive tensors kept in fp32
        self.spec = spec

    @property
    def table(self) -> CodeTable:
        """Legacy single-table accessor (v1 containers / uniform specs)."""
        if len(self.tables) == 1:
            return next(iter(self.tables.values()))
        raise AttributeError(
            f"container holds {len(self.tables)} code tables "
            f"({sorted(self.tables)}); use .tables / .table_for(name)")

    def table_for(self, name: str) -> CodeTable:
        return self.tables[self.qmeta[name]["table"]]

    def table_id_for(self, name: str) -> str:
        return self.qmeta[name]["table"]

    # ---------------------------------------------------------------- compression
    @classmethod
    def compress(
        cls,
        params: Dict[str, np.ndarray],
        spec: Optional[CompressionSpec] = None,
        *,
        bits: int = 8,
        granularity: quant.Granularity = quant.Granularity.PER_TENSOR,
        should_quantize: Optional[Callable[[str, np.ndarray], bool]] = None,
        segment_symbols: int = DEFAULT_SEGMENT_SYMBOLS,
        max_code_len: int = 12,
    ) -> "CompressedModel":
        """Quantize + entropy-encode a named parameter dict.

        ``spec`` is the primary interface: ordered per-tensor rules resolve
        each tensor to (bits, codec, granularity, ...) or keep-fp32.  The
        keyword arguments are the pre-spec shorthand (one model-wide rule +
        optional predicate) and are ignored when ``spec`` is given — except
        ``should_quantize``, which still overrides the whether-to-quantize
        default for tensors no spec rule matches.
        """
        if spec is None:
            spec = spec_from_legacy(bits, granularity,
                                    segment_symbols=segment_symbols,
                                    max_code_len=max_code_len)
        spec.validate()

        qts: Dict[str, quant.QuantizedTensor] = {}
        policies: Dict[str, TensorPolicy] = {}
        unquantized: Dict[str, np.ndarray] = {}
        for name, w in params.items():
            w = np.asarray(w, dtype=np.float32)
            if should_quantize is not None and \
                    not any(r.matches(name) for r in spec.rules):
                # legacy predicate replaces the default whether-to-quantize
                # (spec defaults still decide HOW when it says yes)
                if should_quantize(name, w):
                    pol = spec._policy(
                        w, rule=None, bits=spec.default_bits,
                        codec=spec.default_codec,
                        granularity=spec.default_granularity,
                        group=spec.default_group, scheme=None)
                else:
                    pol = TensorPolicy(quantize=False)
            else:
                pol = spec.resolve(name, w)
            if not pol.quantize:
                unquantized[name] = w
                continue
            policies[name] = pol
            # bits="auto" already quantized at 4 bits inside the probe
            qts[name] = pol.qt if pol.qt is not None else quant.quantize(
                w, pol.bits, pol.granularity, group=pol.group,
                scheme=pol.scheme, name=name)

        # Alg.1 line 11, per group: one frequency table across each
        # (codec, bits) group of the model (v1 == the single-group case).
        from .entropy import global_frequencies
        group_names: Dict[str, List[str]] = {}
        for name, qt in qts.items():
            tid = f"{policies[name].codec}{qt.bits}"
            group_names.setdefault(tid, []).append(name)
        tables: Dict[str, CodeTable] = {}
        for tid, names in group_names.items():
            pol = policies[names[0]]
            gbits = qts[names[0]].bits
            freqs = global_frequencies((qts[n].q for n in names), 1 << gbits)
            tables[tid] = codecs.get_codec(pol.codec).build(
                freqs, gbits, max_code_len=spec.max_code_len)

        tensors: Dict[str, SegmentedTensor] = {}
        qmeta: Dict[str, dict] = {}
        chunks: List[np.ndarray] = []
        offset = 0
        for name, qt in qts.items():
            tid = f"{policies[name].codec}{qt.bits}"
            meta, streams = segment_and_encode(name, qt.q, tables[tid],
                                               spec.segment_symbols)
            offs = []
            for s in streams:
                offs.append(offset)
                chunks.append(s)
                offset += len(s)
            meta.seg_offsets = np.array(offs, dtype=np.int64)
            tensors[name] = meta
            qmeta[name] = dict(
                bits=qt.bits, scheme=qt.scheme.value,
                granularity=qt.granularity.value,
                scale=qt.scale, zero=qt.zero,
                codec=policies[name].codec, table=tid,
            )
        payload = (np.concatenate(chunks) if chunks else np.zeros(0, np.uint8))
        return cls(tables, tensors, qmeta, payload, unquantized, spec=spec)

    # --------------------------------------------------------------- decompression
    def scheduler(self, *, backend=None, chunk_symbols=_DEFAULT_CHUNK,
                  first: Sequence[str] = (), prefetch: bool = True,
                  device=None):
        """Build a :class:`~repro_torch.core.scheduler.DecodeScheduler` over this
        container.  ``chunk_symbols=None`` -> one monolithic chunk (the
        lock-step all-segments batch); a positive budget (default: the
        scheduler's per-layer budget) -> bounded-memory streaming with
        double-buffered prefetch."""
        from .scheduler import DEFAULT_CHUNK_SYMBOLS, DecodeScheduler
        if chunk_symbols is _DEFAULT_CHUNK:
            chunk_symbols = DEFAULT_CHUNK_SYMBOLS
        return DecodeScheduler(self, backend=backend,
                               chunk_symbols=chunk_symbols, first=first,
                               prefetch=prefetch, device=device)

    def decode_tensor(self, name: str, *, backend=None) -> np.ndarray:
        """Parallel-decode one tensor back to its uint8 symbols."""
        from .bitstream import pack_streams
        from .decode_backends import DecoderBackend, get_backend
        meta = self.tensors[name]
        b = backend if isinstance(backend, DecoderBackend) \
            else get_backend(backend or "numpy")
        streams = [
            self.payload[o: o + n]
            for o, n in zip(meta.seg_offsets, meta.seg_nbytes)
        ]
        mat, _ = pack_streams(streams)
        out = b.decode_table(self.table_for(name), mat, meta.seg_counts)
        flat = np.concatenate([out[i, : int(c)] for i, c in enumerate(meta.seg_counts)]) \
            if len(streams) > 1 else out[0, : int(meta.seg_counts[0])]
        return flat.astype(np.uint8).reshape(meta.shape)

    def iter_decode(self, *, backend=None,
                    chunk_symbols: Optional[int] = _DEFAULT_CHUNK,
                    first: Sequence[str] = (),
                    prefetch: bool = True,
                    device=None) -> Iterator[Tuple[str, np.ndarray]]:
        """Stream ``(name, uint8 symbols)`` tensors as they finish decoding.

        ``chunk_symbols`` defaults to the scheduler's budget (per-layer
        groups, ~512k symbols/chunk) so host memory stays bounded by the
        chunk size; ``None`` means one monolithic chunk — the same convention
        as :class:`~repro_torch.core.scheduler.DecodeScheduler` everywhere.
        """
        if chunk_symbols is _DEFAULT_CHUNK:
            from .scheduler import DEFAULT_CHUNK_SYMBOLS
            chunk_symbols = DEFAULT_CHUNK_SYMBOLS
        sched = self.scheduler(backend=backend, chunk_symbols=chunk_symbols,
                               first=first, prefetch=prefetch, device=device)
        return sched.iter_decode()

    def decode_all(self, *, backend=None,
                   device=None) -> Dict[str, np.ndarray]:
        """Alg. 1 EDGE DEVICE OPERATIONS: decode every tensor.

        ALL segments of ALL tensors are batched into per-table lock-step
        multi-stream decodes — the paper's "assign segments across threads"
        with lanes playing the threads; batching keeps every lane busy
        regardless of per-tensor segment counts (per-tensor decoding is
        lane-starved for small tensors — measured ~6x slower in
        benchmarks/table2).  Peak host memory ~ total model size; use
        :meth:`iter_decode` / :meth:`iter_quantized_weights` for the
        bounded-memory streaming path.
        """
        sched = self.scheduler(backend=backend, chunk_symbols=None,
                               prefetch=False, device=device)
        return dict(sched.iter_decode())

    def iter_dequantize(self, **kw) -> Iterator[Tuple[str, np.ndarray]]:
        """Stream fully dequantized fp32 tensors (unquantized ones first)."""
        for name, w in self.unquantized.items():
            yield name, w
        for name, q in self.iter_decode(**kw):
            yield name, self._dequantize_one(name, q)

    def _dequantize_one(self, name: str, q: np.ndarray) -> np.ndarray:
        m = self.qmeta[name]
        qt = quant.QuantizedTensor(
            q=q, scale=m["scale"], zero=m["zero"], bits=m["bits"],
            scheme=quant.Scheme(m["scheme"]),
            granularity=quant.Granularity(m["granularity"]),
            shape=self.tensors[name].shape,
        )
        return quant.dequantize(qt)

    def dequantize_all(self, *, backend=None,
                       device=None) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = dict(self.unquantized)
        for name, q in self.decode_all(backend=backend,
                                       device=device).items():
            out[name] = self._dequantize_one(name, q)
        return out

    def iter_quantized_weights(self, **kw) -> Iterator[
            Tuple[str, Tuple[np.ndarray, np.ndarray, np.ndarray]]]:
        """Stream ``name -> (q, scale, zero)`` triples for the quantized
        serving path — weights stay integer in device memory; tensors arrive
        incrementally with bounded host memory."""
        for name, q in self.iter_decode(**kw):
            m = self.qmeta[name]
            yield name, (q, m["scale"], m["zero"])

    def quantized_weights(self, *, backend=None, device=None
                          ) -> Dict[str, Tuple[np.ndarray, np.ndarray,
                                               np.ndarray]]:
        """Decode to (q, scale, zero) triples for the quantized serving
        path — weights stay integer in device memory, dequantized at use."""
        symbols = self.decode_all(backend=backend, device=device)
        return {
            name: (q, self.qmeta[name]["scale"], self.qmeta[name]["zero"])
            for name, q in symbols.items()
        }

    # ------------------------------------------------------------------- statistics
    def stats(self) -> CompressionStats:
        groups: List[CodecGroupStats] = []
        for tid, table in sorted(self.tables.items()):
            names = [n for n, m in self.qmeta.items() if m["table"] == tid]
            n_sym = sum(self.tensors[n].n_symbols for n in names)
            payload_bits = sum(int(self.tensors[n].seg_bits.sum())
                               for n in names)
            groups.append(CodecGroupStats(
                table_id=tid, codec=table.codec_name, bits=table.bits,
                param_count=n_sym, entropy_bits=table.entropy,
                effective_bits=payload_bits / max(n_sym, 1),
                quant_bytes=(n_sym * table.bits) // 8,
                encoded_bytes=(payload_bits + 7) // 8,
            ))
        n_q = sum(g.param_count for g in groups)
        n_u = sum(int(np.prod(w.shape)) for w in self.unquantized.values())
        meta_bytes = sum(
            m["scale"].size * 4 + m["zero"].size * 4 for m in self.qmeta.values()
        ) + sum(sum(a.size * a.itemsize for a in t.to_arrays().values())
                for t in self.tables.values())
        return CompressionStats(
            param_count=n_q + n_u,
            raw_bytes=2 * (n_q + n_u),
            quant_bytes=sum(g.quant_bytes for g in groups) + n_u * 2,
            encoded_bytes=sum(g.encoded_bytes for g in groups) + n_u * 2,
            metadata_bytes=int(meta_bytes),
            unquantized_params=n_u,
            groups=groups,
        )

    # ------------------------------------------------------------------ persistence
    def save(self, path: str) -> None:
        """Write a v2 container (v1 remains readable via :meth:`load`)."""
        arrays: Dict[str, np.ndarray] = {
            "__payload__": self.payload,
            "__format_version__": np.array([CONTAINER_FORMAT_VERSION],
                                           dtype=np.int64),
        }
        manifest: Dict[str, dict] = {
            "version": CONTAINER_FORMAT_VERSION,
            "tables": {}, "tensors": {}, "qmeta": {}, "unquantized": [],
            "spec": self.spec.describe() if self.spec is not None else None,
        }
        for tid, table in self.tables.items():
            manifest["tables"][tid] = table.to_manifest()
            for k, arr in table.to_arrays().items():
                arrays[f"tbl::{tid}::{k}"] = arr
        for name, t in self.tensors.items():
            key = f"t::{name}"
            manifest["tensors"][name] = dict(shape=list(t.shape), n_symbols=t.n_symbols)
            arrays[key + "::seg_offsets"] = t.seg_offsets
            arrays[key + "::seg_nbytes"] = t.seg_nbytes
            arrays[key + "::seg_counts"] = t.seg_counts
            arrays[key + "::seg_bits"] = t.seg_bits
        for name, m in self.qmeta.items():
            manifest["qmeta"][name] = dict(
                bits=m["bits"], scheme=m["scheme"],
                granularity=m["granularity"],
                codec=m["codec"], table=m["table"])
            arrays[f"q::{name}::scale"] = m["scale"]
            arrays[f"q::{name}::zero"] = m["zero"]
        for name, w in self.unquantized.items():
            manifest["unquantized"].append(name)
            arrays[f"u::{name}"] = w
        arrays["__manifest__"] = np.frombuffer(
            json.dumps(manifest).encode(), dtype=np.uint8)
        np.savez(path, **arrays)

    @classmethod
    def load(cls, path: str) -> "CompressedModel":
        z = np.load(path if path.endswith(".npz") else path + ".npz")
        if "__format_version__" in z.files:
            version = int(z["__format_version__"][0])
            if version != CONTAINER_FORMAT_VERSION:
                raise ValueError(
                    f"unsupported container format v{version} "
                    f"(this build reads v1 and v{CONTAINER_FORMAT_VERSION})")
            return cls._load_v2(z)
        return cls._load_v1(z)

    @staticmethod
    def _load_tensors(z, manifest) -> Dict[str, SegmentedTensor]:
        """Per-tensor segment tables — layout shared by formats v1 and v2."""
        tensors: Dict[str, SegmentedTensor] = {}
        for name, tm in manifest["tensors"].items():
            key = f"t::{name}"
            tensors[name] = SegmentedTensor(
                name=name, shape=tuple(tm["shape"]),
                n_symbols=int(tm["n_symbols"]),
                seg_offsets=z[key + "::seg_offsets"],
                seg_nbytes=z[key + "::seg_nbytes"],
                seg_counts=z[key + "::seg_counts"],
                seg_bits=z[key + "::seg_bits"],
            )
        return tensors

    @classmethod
    def _load_v2(cls, z) -> "CompressedModel":
        manifest = json.loads(bytes(z["__manifest__"]).decode())
        tables: Dict[str, CodeTable] = {}
        for tid, tman in manifest["tables"].items():
            prefix = f"tbl::{tid}::"
            arrs = {k[len(prefix):]: z[k] for k in z.files
                    if k.startswith(prefix)}
            tables[tid] = codecs.table_from_container(tman, arrs)
        tensors = cls._load_tensors(z, manifest)
        qmeta, unquantized = {}, {}
        for name, qm in manifest["qmeta"].items():
            qmeta[name] = dict(
                bits=int(qm["bits"]), scheme=qm["scheme"],
                granularity=qm["granularity"],
                codec=qm["codec"], table=qm["table"],
                scale=z[f"q::{name}::scale"], zero=z[f"q::{name}::zero"],
            )
        for name in manifest["unquantized"]:
            unquantized[name] = z[f"u::{name}"]
        # revive the recorded spec so provenance survives load -> save
        # (describe() emits canonical text, so this parse round-trips; an
        # unknown-codec container already failed above at table revival)
        spec = None
        spec_text = manifest.get("spec")
        if spec_text:
            try:
                spec = CompressionSpec.parse(spec_text)
            except (ValueError, KeyError):
                spec = None
        return cls(tables, tensors, qmeta, z["__payload__"], unquantized,
                   spec=spec)

    @classmethod
    def _load_v1(cls, z) -> "CompressedModel":
        """Pre-registry containers: ONE global Huffman table, uniform bits.

        Reads the exact layout the v1 writer produced; the revived
        ``HuffmanCodeTable`` rebuilds the identical canonical code + LUT from
        the stored histogram, so decode is bit-identical to the v1 reader
        (pinned by tests/test_container_v2.py against a committed fixture).
        """
        manifest = json.loads(bytes(z["__manifest__"]).decode())
        tensors = cls._load_tensors(z, manifest)
        qmeta, unquantized = {}, {}
        bits = 8
        for name, qm in manifest["qmeta"].items():
            bits = int(qm["bits"])
        tid = f"huffman{bits}"
        for name, qm in manifest["qmeta"].items():
            qmeta[name] = dict(
                bits=int(qm["bits"]), scheme=qm["scheme"], granularity=qm["granularity"],
                codec="huffman", table=tid,
                scale=z[f"q::{name}::scale"], zero=z[f"q::{name}::zero"],
            )
        for name in manifest["unquantized"]:
            unquantized[name] = z[f"u::{name}"]
        table = codecs.HuffmanCodeTable(z["__freqs__"], bits=bits,
                                        max_len=int(z["__max_len__"][0]))
        return cls({tid: table}, tensors, qmeta, z["__payload__"], unquantized)


# re-exported for back-compat; the policy itself lives in repro_torch.core.spec
__all__ = ["CompressedModel", "CompressionStats", "CodecGroupStats",
           "default_quantize_predicate", "CompressionSpec"]
