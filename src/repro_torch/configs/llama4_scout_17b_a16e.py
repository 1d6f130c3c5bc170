"""llama4-scout-17b-a16e [moe] — MoE, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E].

16 experts, top-1 routing, every layer MoE.  The long-context variant
(``long_config``, ``llama4-scout-chunked8k``) models chunked-local
(iRoPE-style) attention as a sliding window of 8192.  Text-only backbone:
image tokens would arrive as prefix embeddings, which the port does not
take yet.

Field for field the JAX package's ``repro/configs/llama4_scout_17b_a16e.py``.
"""
import dataclasses

from repro_torch.models.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e",
        family="moe",
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        d_ff=8192,
        moe_d_ff=8192,
        vocab_size=202048,
        head_dim=128,
        num_experts=16,
        top_k=1,
        rope_theta=500000.0,
        tie_embeddings=False,
        max_seq_len=32768 + 128,
        dtype="bfloat16",
        source="hf:meta-llama/Llama-4-Scout-17B-16E",
    )


def long_config() -> ModelConfig:
    return dataclasses.replace(
        config(), name="llama4-scout-chunked8k", attn_kind="sliding",
        window=8192, max_seq_len=524288 + 128,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), name="llama4-scout-smoke", num_layers=2, d_model=256,
        num_heads=8, num_kv_heads=2, head_dim=32, d_ff=256, moe_d_ff=256,
        vocab_size=512, num_experts=4, top_k=1, max_seq_len=512,
        dtype="float32",
    )
