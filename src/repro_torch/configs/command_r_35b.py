"""command-r-35b [dense] — GQA, no-bias [hf:CohereForAI/c4ai-command-r-v01].

Command-R ties input/output embeddings (model card).

Field for field the JAX package's ``repro/configs/command_r_35b.py``.
"""
import dataclasses

from repro_torch.models.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="command-r-35b",
        family="dense",
        num_layers=40,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=22528,
        vocab_size=256000,
        head_dim=128,
        rope_theta=8000000.0,
        use_bias=False,
        tie_embeddings=True,
        max_seq_len=32768 + 128,
        dtype="bfloat16",
        source="hf:CohereForAI/c4ai-command-r-v01",
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), name="command-r-smoke", num_layers=2, d_model=512,
        num_heads=8, num_kv_heads=2, head_dim=64, d_ff=1024, vocab_size=512,
        max_seq_len=512, dtype="float32",
    )
