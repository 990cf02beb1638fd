"""Weights carried across from the JAX package.

The JAX package and the port share one flat parameter layout (same names,
same shapes), so a parameter dict moves between them as numpy arrays:
:func:`params_from_numpy` casts each array to the port schema's dtype (bf16
weights, float32 norms) and places it on ``device``.  A bf16 array widened
to float32 on the way over casts back exactly.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from . import device as _device
from .configs.base import ArchConfig
from .models import api


def params_from_numpy(cfg: ArchConfig, params: Mapping[str, np.ndarray],
                      device=None) -> Dict[str, torch.Tensor]:
    """``{name: ndarray}`` (the JAX package's parameter dict, converted with
    ``np.asarray(v, np.float32)``) -> the port's parameter dict on
    ``device`` (``cuda`` unless the caller names the CPU)."""
    dev = _device.resolve(device)
    schema = api.build(cfg).schema(cfg)
    if set(params) != set(schema):
        raise KeyError(f"parameter names differ from the {cfg.name} schema: "
                       f"missing {sorted(set(schema) - set(params))}, "
                       f"extra {sorted(set(params) - set(schema))}")
    out = {}
    for name, spec in schema.items():
        a = np.array(params[name], dtype=np.float32)   # a writable copy
        if a.shape != spec.shape:
            raise ValueError(f"{name}: shape {a.shape} != schema {spec.shape}")
        out[name] = torch.from_numpy(a).to(spec.dtype).to(dev)
    return out
