"""Parameters from numpy: the bridge that lets both packages share weights.

``params_from_numpy`` takes the JAX package's parameter pytree converted to
numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``: nested dicts,
decoder layers stacked by block position under ``blocks/0`` ..
``blocks/{period - 1}`` (jamba's attention and mamba layers; every other
config has period 1), a MoE config's experts under
``blocks/{p}/moe/{router, wi_gate, wi_up, wo}``, an encoder-decoder
config's ``blocks/0/cross_attn`` and ``enc_blocks/0``) and returns the
port's tree of
tensors, same keys, same layouts.  ``models.base.finish_unembedding`` then
gives a tied config the ``unembed`` copy of ``embed.T`` and pads an
unembedding whose vocabulary is not a multiple of 8 with zero columns.
Shapes are checked against the port's ``param_specs``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.base import (
    ModelConfig, finish_unembedding, iter_specs, param_specs,
)


def params_from_numpy(cfg: ModelConfig, np_tree: Dict[str, Any],
                      device: Optional[torch.device] = None) -> Dict[str, Any]:
    """Numpy parameter tree -> tensors in ``cfg.dtype`` on ``device``
    (default ``cuda``)."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    out: Dict[str, Any] = {}
    for path, spec in iter_specs(param_specs(cfg)):
        node = np_tree
        for k in path:
            node = node[k]
        arr = np.asarray(node)
        if tuple(arr.shape) != spec.shape:
            raise ValueError(f"{'/'.join(path)}: shape {arr.shape}, spec {spec.shape}")
        # via f32: numpy has no native bfloat16 that torch can read
        t = torch.from_numpy(np.array(arr, dtype=np.float32))
        dst = out
        for k in path[:-1]:
            dst = dst.setdefault(k, {})
        dst[path[-1]] = t.to(device=dev, dtype=dtype)
    return finish_unembedding(cfg, out)
