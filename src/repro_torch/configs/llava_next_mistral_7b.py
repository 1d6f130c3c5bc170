"""llava-next-mistral-7b [vlm]: anyres tiling
[hf:llava-hf/llava-v1.6-mistral-7b-hf].

Field for field the JAX package's ``repro/configs/llava_next_mistral_7b.py``.
The Mistral-7B language backbone is ported whole; the vision tower (CLIP
ViT-L/336) and projector are stubbed: ``models.multimodal.vision_embeds``
provides 576 * (1 + 4) = 2880 patch-token embeddings (anyres: base image
and 4 tiles), prepended to the prompt.
"""
import dataclasses

from repro_torch.models.base import ModelConfig
from repro_torch.models.multimodal import num_vision_tokens


def config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-mistral-7b",
        family="dense",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14336,
        vocab_size=32000,
        head_dim=128,
        rope_theta=1000000.0,
        tie_embeddings=False,
        num_prefix_embeds=num_vision_tokens(),  # 2880 anyres patch tokens
        max_seq_len=32768 + 128,
        dtype="bfloat16",
        source="hf:llava-hf/llava-v1.6-mistral-7b-hf (Mistral-7B backbone)",
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), name="llava-next-smoke", num_layers=2, d_model=256,
        num_heads=8, num_kv_heads=2, head_dim=32, d_ff=512, vocab_size=512,
        num_prefix_embeds=16, max_seq_len=512, dtype="float32",
    )
