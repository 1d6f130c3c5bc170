"""seamless-m4t-medium [audio]: encoder-decoder, multimodal
[arXiv:2308.11596].

Field for field the JAX package's ``repro/configs/seamless_m4t_medium.py``.
The speech encoder's w2v-BERT conv frontend is stubbed: the encoder
consumes precomputed frame embeddings (``models.multimodal.audio_frames``).
The 12-layer encoder and 12-layer decoder are ported whole.  kv = 16 ==
num_heads: standard MHA.
"""
import dataclasses

from repro_torch.models.base import ModelConfig

ENCODER_FRAMES = 1024  # ~20s speech after conv subsampling


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium",
        family="encdec",
        num_layers=12,
        num_encoder_layers=12,
        encoder_seq_len=ENCODER_FRAMES,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        d_ff=4096,
        vocab_size=256206,
        head_dim=64,
        rope_theta=10000.0,
        tie_embeddings=False,
        max_seq_len=32768 + 128,
        dtype="bfloat16",
        source="arXiv:2308.11596 (SeamlessM4T medium)",
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), name="seamless-smoke", num_layers=2, num_encoder_layers=2,
        encoder_seq_len=32, d_model=256, num_heads=8, num_kv_heads=8,
        head_dim=32, d_ff=512, vocab_size=512, max_seq_len=512, dtype="float32",
    )
