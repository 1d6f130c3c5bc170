"""Modality frontend stubs: the perception stacks are stubbed, the
transformers that consume their embeddings are not.

PyTorch counterpart of ``repro.models.multimodal``, with the same shapes
and the same 0.02 scale, drawn from an explicit ``torch.Generator``:

* llava-next: the vision tower (CLIP ViT-L/336) and its projector are
  stubbed; ``vision_embeds`` returns patch embeddings of the right shape.
  LLaVA-NeXT's "anyres" tiling is a 336 px base image and up to 4 tiles of
  24 x 24 = 576 patches each: ``576 * (1 + num_tiles)`` prefix positions.
* seamless-m4t: the mel-spectrogram and conv feature extractor (the
  w2v-BERT frontend) are stubbed; ``audio_frames`` returns the frame
  embeddings the speech encoder consumes.
"""

from __future__ import annotations

from typing import Optional

import torch

LLAVA_BASE_PATCHES = 576  # 24x24 @ patch 14, 336px
LLAVA_NUM_TILES = 4  # anyres high-res tiles


def num_vision_tokens(num_tiles: int = LLAVA_NUM_TILES) -> int:
    return LLAVA_BASE_PATCHES * (1 + num_tiles)


def _normal(generator: torch.Generator, shape, dtype: torch.dtype,
            device: Optional[torch.device]) -> torch.Tensor:
    dev = generator.device if device is None else torch.device(device)
    x = torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)
    return x.mul_(0.02).to(dtype)


def vision_embeds(generator: torch.Generator, batch: int, d_model: int,
                  num_tiles: int = LLAVA_NUM_TILES, dtype: torch.dtype = torch.float32,
                  device: Optional[torch.device] = None) -> torch.Tensor:
    """Stub of the ViT tower and 2-layer MLP projector's output:
    ``(batch, num_vision_tokens(num_tiles), d_model)``, normal * 0.02, on
    ``device`` (default: the generator's)."""
    return _normal(generator, (batch, num_vision_tokens(num_tiles), d_model), dtype,
                   device)


def audio_frames(generator: torch.Generator, batch: int, num_frames: int, d_model: int,
                 dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None) -> torch.Tensor:
    """Stub of the mel-spectrogram and conv subsampler's output (the w2v-BERT
    frontend): ``(batch, num_frames, d_model)``, normal * 0.02."""
    return _normal(generator, (batch, num_frames, d_model), dtype, device)
