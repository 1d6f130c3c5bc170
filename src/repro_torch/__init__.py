"""PyTorch / CUDA (Hopper) port of the LLM-42 serving system.

A second package beside ``repro`` (the JAX reference, never imported here).
Module paths and names follow ``repro``: ``repro/x/y.py`` has its
counterpart at ``repro_torch/x/y.py``.  Entry points run on ``cuda`` unless
the caller passes ``device="cpu"`` (``resolve_device``); on the card every
model GEMM and every single-token paged attention runs in a hand-written
Hopper kernel (``repro_torch.kernels``).
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else
    ``cuda``; raises when CUDA is wanted and no card is visible."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device visible; pass device='cpu' to run the plain versions")
    return dev
