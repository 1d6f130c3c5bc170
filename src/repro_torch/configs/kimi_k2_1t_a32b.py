"""kimi-k2-1t-a32b [moe] — trillion-param MoE [arXiv:2501.kimi2].

61L, d_model=7168, 64H (GQA kv=8, head_dim 112), per-expert d_ff=2048, 384
experts top-8, first layer dense (DeepSeek-V3-style first_k_dense=1).

Field for field the JAX package's ``repro/configs/kimi_k2_1t_a32b.py``.
"""
import dataclasses

from repro_torch.models.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b",
        family="moe",
        num_layers=61,
        d_model=7168,
        num_heads=64,
        num_kv_heads=8,
        d_ff=2048,
        moe_d_ff=2048,
        vocab_size=163840,
        head_dim=112,
        num_experts=384,
        top_k=8,
        first_k_dense=1,
        rope_theta=50000.0,
        tie_embeddings=False,
        max_seq_len=32768 + 128,
        dtype="bfloat16",
        source="arXiv:2501.kimi2 (Kimi K2, paper-table config)",
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), name="kimi-k2-smoke", num_layers=2, d_model=256, num_heads=8,
        num_kv_heads=2, head_dim=32, d_ff=256, moe_d_ff=256, vocab_size=512,
        num_experts=4, top_k=2, first_k_dense=1, max_seq_len=512,
        dtype="float32",
    )
