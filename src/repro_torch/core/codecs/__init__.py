"""Pluggable entropy-codec registry (DESIGN.md §7).

Mirrors :mod:`repro_torch.core.decode_backends`: the *coder* choice becomes a
named, first-class decision instead of a hard-wired Huffman import.  A codec
is a (name, table builder) pair; building yields a
:class:`~repro_torch.core.codecs.base.CodeTable` that owns encode, the decode
lookup arrays, and its serialization — one table per ``(codec, bits)`` group
in a v2 container (mixed 4/8-bit symbols cannot share one histogram).

Registered codecs:

* ``huffman`` — the paper's canonical length-limited Huffman code (prefix
  kernel family; today's default).
* ``rans`` — tANS/FSE fractional-bit coder (tans kernel family); closes the
  integer-bit gap to the Shannon bound on peaky histograms.
* ``raw`` — fixed-width bit packing (prefix family, identity LUT); the
  "quantized only" baseline row of Table I.

``get_codec(name)`` raises with the registered list on unknown names so CLI
misconfiguration is loud (``launch/serve.py`` validates ``--codec`` /
``--compress-spec`` upfront, like ``--decode-backend``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np

from .base import CodeTable
from . import huffman as _huffman
from . import rans as _rans
from . import raw as _raw
from .huffman import HuffmanCodeTable
from .rans import RansCodeTable
from .raw import RawCodeTable


@dataclasses.dataclass(frozen=True)
class EntropyCodec:
    """A named entropy coder: builds tables and revives them from containers.

    ``build(freqs, bits, **kw) -> CodeTable``; ``kw`` is codec-specific
    (``max_code_len`` for huffman, ``table_log`` for rans) and unknown keys
    are ignored by each builder.
    """

    name: str
    build: Callable[..., CodeTable]
    table_cls: type

    def from_container(self, manifest: dict,
                       arrays: Dict[str, np.ndarray]) -> CodeTable:
        return self.table_cls.from_container(manifest, arrays)


_REGISTRY: Dict[str, EntropyCodec] = {}


def register_codec(codec: EntropyCodec) -> EntropyCodec:
    _REGISTRY[codec.name] = codec
    return codec


def codec_names() -> List[str]:
    return sorted(_REGISTRY)


def get_codec(name: str) -> EntropyCodec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown entropy codec {name!r}; "
                       f"registered: {codec_names()}") from None


def table_from_container(manifest: dict,
                         arrays: Dict[str, np.ndarray]) -> CodeTable:
    """Revive a serialized table: manifest['codec'] routes to its codec."""
    return get_codec(manifest["codec"]).from_container(manifest, arrays)


register_codec(EntropyCodec(name="huffman", build=_huffman.build,
                            table_cls=HuffmanCodeTable))
register_codec(EntropyCodec(name="rans", build=_rans.build,
                            table_cls=RansCodeTable))
register_codec(EntropyCodec(name="raw", build=_raw.build,
                            table_cls=RawCodeTable))

__all__ = [
    "CodeTable", "EntropyCodec", "HuffmanCodeTable", "RansCodeTable",
    "RawCodeTable", "register_codec", "codec_names", "get_codec",
    "table_from_container",
]
