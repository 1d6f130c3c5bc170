"""Model configs ported so far: the dense full-attention family.

Each module exposes ``config()`` (the exact architecture) and
``smoke_config()`` (a reduced same-family variant for CPU tests), as in
``repro.configs``.
"""

from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.base import ModelConfig

ARCH_IDS: List[str] = [
    "llama3_8b",
    "tinyllama_1_1b",
    "phi3_mini_3_8b",
    "internlm2_20b",
    "command_r_35b",
]

#: canonical dashed ids -> module names
DASHED = {
    "llama3-8b": "llama3_8b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "internlm2-20b": "internlm2_20b",
    "command-r-35b": "command_r_35b",
}


def _module(name: str):
    key = DASHED.get(name, name).replace("-", "_").replace(".", "_")
    if key not in ARCH_IDS:
        raise ValueError(f"{name}: not ported yet (ported: {ARCH_IDS})")
    return importlib.import_module(f"repro_torch.configs.{key}")


def get_config(name: str) -> ModelConfig:
    return _module(name).config()


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke_config()

