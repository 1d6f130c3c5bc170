"""phi3-mini-3.8b [dense] — RoPE SwiGLU GQA [arXiv:2404.14219].

kv=32 == num_heads: phi-3-mini is effectively MHA.  ``long_config``
(``phi3-mini-3.8b-sw4k``) models long context with sliding-window
attention, window 4096, kept in a ring of ``window + RING_SLACK`` slots.

Field for field the JAX package's ``repro/configs/phi3_mini_3_8b.py``.
"""
import dataclasses

from repro_torch.models.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-3.8b",
        family="dense",
        num_layers=32,
        d_model=3072,
        num_heads=32,
        num_kv_heads=32,
        d_ff=8192,
        vocab_size=32064,
        head_dim=96,
        rope_theta=10000.0,
        tie_embeddings=False,
        max_seq_len=32768 + 128,
        dtype="bfloat16",
        source="arXiv:2404.14219 (Phi-3)",
    )


def long_config() -> ModelConfig:
    return dataclasses.replace(
        config(), name="phi3-mini-3.8b-sw4k", attn_kind="sliding", window=4096,
        max_seq_len=524288 + 128,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), name="phi3-smoke", num_layers=2, d_model=256, num_heads=8,
        num_kv_heads=8, head_dim=32, d_ff=512, vocab_size=512, max_seq_len=512, dtype="float32",
    )
