"""tinyllama-1.1b [dense] — llama2-arch small [arXiv:2401.02385].

Field for field the JAX package's ``repro/configs/tinyllama_1_1b.py``.
"""
import dataclasses

from repro_torch.models.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="tinyllama-1.1b",
        family="dense",
        num_layers=22,
        d_model=2048,
        num_heads=32,
        num_kv_heads=4,
        d_ff=5632,
        vocab_size=32000,
        head_dim=64,
        rope_theta=10000.0,
        tie_embeddings=False,
        max_seq_len=32768 + 128,
        dtype="bfloat16",
        source="arXiv:2401.02385 (TinyLlama), llama2 architecture",
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), name="tinyllama-smoke", num_layers=2, d_model=256,
        num_heads=8, num_kv_heads=2, head_dim=32, d_ff=512, vocab_size=512,
        max_seq_len=512, dtype="float32",
    )
