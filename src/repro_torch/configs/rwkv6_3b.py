"""rwkv6-3b [ssm] — Finch, data-dependent decay [arXiv:2404.05892].

Attention-free: O(1) recurrent state, so long_500k runs natively.
num_heads/num_kv_heads are nominal (d_model / rwkv_head_dim) — there is no
attention; they size the rwkv head reshape.

Field for field the JAX package's ``repro/configs/rwkv6_3b.py``.
"""
import dataclasses

from repro_torch.models.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b",
        family="ssm",
        num_layers=32,
        d_model=2560,
        num_heads=40,
        num_kv_heads=40,
        d_ff=8960,
        vocab_size=65536,
        rwkv_head_dim=64,
        tie_embeddings=False,
        max_seq_len=524288 + 128,
        dtype="bfloat16",
        source="arXiv:2404.05892 (RWKV-6 Finch)",
    )


def long_config() -> ModelConfig:
    return config()  # natively sub-quadratic


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), name="rwkv6-smoke", num_layers=2, d_model=256, num_heads=4,
        num_kv_heads=4, d_ff=512, vocab_size=512, rwkv_head_dim=64,
        max_seq_len=512, dtype="float32",
    )
