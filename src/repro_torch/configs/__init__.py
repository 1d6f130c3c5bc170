"""Model configs: every architecture of ``repro.configs`` (dense, MoE,
the recurrent ssm family: rwkv6, the hybrid family: jamba, the
encoder-decoder family and prefix embeddings), with their sliding-window
long-context variants, plus the paper's own Llama-3-8B.

Each module exposes ``config()`` (the exact architecture) and
``smoke_config()`` (a reduced same-family variant for CPU tests), and
where it has one ``long_config()`` (the sliding-window variant), as in
``repro.configs``.  ``list_archs`` is the reference's list of the assigned
architectures; ``llama3-8b`` is served besides them.
"""

from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.base import ModelConfig

#: the assigned architectures, in the reference's order
ASSIGNED: List[str] = [
    "llava_next_mistral_7b",
    "kimi_k2_1t_a32b",
    "tinyllama_1_1b",
    "seamless_m4t_medium",
    "internlm2_20b",
    "command_r_35b",
    "llama4_scout_17b_a16e",
    "jamba_1_5_large_398b",
    "rwkv6_3b",
    "phi3_mini_3_8b",
]

#: every module of this registry: the assigned ones and the paper's model
ARCH_IDS: List[str] = ["llama3_8b"] + ASSIGNED

#: canonical dashed ids -> module names
DASHED = {
    "llama3-8b": "llama3_8b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "internlm2-20b": "internlm2_20b",
    "command-r-35b": "command_r_35b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "rwkv6-3b": "rwkv6_3b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
}


def _module(name: str):
    key = DASHED.get(name, name).replace("-", "_").replace(".", "_")
    if key not in ARCH_IDS:
        raise ValueError(f"{name}: no such architecture (known: {ARCH_IDS})")
    return importlib.import_module(f"repro_torch.configs.{key}")


def get_config(name: str) -> ModelConfig:
    return _module(name).config()


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke_config()


def get_long_config(name: str) -> ModelConfig:
    """The long-context variant (a sliding window, or the config itself for
    a natively sub-quadratic one), or raise if there is none."""
    mod = _module(name)
    if not hasattr(mod, "long_config"):
        raise ValueError(f"{name} has no sub-quadratic long-context variant")
    return mod.long_config()


def supports_long(name: str) -> bool:
    return hasattr(_module(name), "long_config")


def list_archs() -> List[str]:
    """The assigned architectures (``repro.configs.list_archs``)."""
    return list(ASSIGNED)
