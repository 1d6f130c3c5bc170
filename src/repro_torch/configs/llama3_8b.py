"""llama3-8b: the paper's evaluation model (Llama-3.1-8B-Instruct).

Field for field the JAX package's ``repro/configs/llama3_8b.py``.
"""
import dataclasses

from repro_torch.models.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b",
        family="dense",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14336,
        vocab_size=128256,
        head_dim=128,
        rope_theta=500000.0,
        tie_embeddings=False,
        max_seq_len=32768 + 128,
        dtype="bfloat16",
        source="meta-llama/Llama-3.1-8B-Instruct (paper's model)",
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), name="llama3-smoke", num_layers=2, d_model=256, num_heads=8,
        num_kv_heads=2, head_dim=32, d_ff=512, vocab_size=512, max_seq_len=512, dtype="float32",
    )
