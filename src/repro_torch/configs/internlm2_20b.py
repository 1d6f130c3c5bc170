"""internlm2-20b [dense] — GQA [arXiv:2403.17297].

Field for field the JAX package's ``repro/configs/internlm2_20b.py``.
"""
import dataclasses

from repro_torch.models.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-20b",
        family="dense",
        num_layers=48,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        d_ff=16384,
        vocab_size=92544,
        head_dim=128,
        rope_theta=1000000.0,
        tie_embeddings=False,
        max_seq_len=32768 + 128,
        dtype="bfloat16",
        source="arXiv:2403.17297 (InternLM2)",
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), name="internlm2-smoke", num_layers=2, d_model=384,
        num_heads=6, num_kv_heads=2, head_dim=64, d_ff=768, vocab_size=512,
        max_seq_len=512, dtype="float32",
    )
