"""jamba-1.5-large-398b [hybrid] — Mamba+attn 1:7 interleave, MoE
[arXiv:2403.19887].

72 layers; attention every 8th layer (1 attn : 7 mamba); MoE FFN on every
other layer (16 experts, top-2), so the block period is 8.  long_500k runs
with the attention layers bounded by a 4096 sliding window (mamba layers
are O(1)-state already).

Field for field the JAX package's ``repro/configs/jamba_1_5_large_398b.py``.
"""
import dataclasses

from repro_torch.models.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        num_layers=72,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=24576,
        moe_d_ff=24576,
        vocab_size=65536,
        head_dim=128,
        num_experts=16,
        top_k=2,
        moe_every=2,
        moe_offset=1,
        attn_every=8,
        d_state=16,
        d_conv=4,
        expand=2,
        rope_theta=10000.0,
        tie_embeddings=False,
        max_seq_len=32768 + 128,
        dtype="bfloat16",
        source="arXiv:2403.19887 (Jamba-1.5)",
    )


def long_config() -> ModelConfig:
    return dataclasses.replace(
        config(), name="jamba-1.5-large-sw4k", attn_kind="sliding", window=4096,
        max_seq_len=524288 + 128,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), name="jamba-smoke", num_layers=4, d_model=256, num_heads=8,
        num_kv_heads=2, head_dim=32, d_ff=512, moe_d_ff=512, vocab_size=512,
        num_experts=4, top_k=2, moe_every=2, moe_offset=1, attn_every=2,
        d_state=8, d_conv=4, expand=2, max_seq_len=512, dtype="float32",
    )
