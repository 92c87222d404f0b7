"""gemma3-1b [dense]: 26L d=1152 4H (GQA kv=1) d_ff=6912 vocab=262144,
5:1 local:global. [hf:google/gemma-3-1b-pt; unverified]"""
from __future__ import annotations

from ..models.transformer import ModelConfig
from .base import ArchSpec, standard_shapes
from .gemma3_4b import _blocks


def get_config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b", d_model=1152, vocab_size=262144,
        units=_blocks(1152, 4, 1, 256, 6912, 512, 10_000.0, 1_000_000.0, 26),
        embed_scale=True, sub_quadratic=True)


def get_reduced() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b-smoke", d_model=64, vocab_size=512,
        units=_blocks(64, 2, 1, 32, 128, 16, 10_000.0, 1_000_000.0, 3,
                      pattern=2),
        embed_scale=True, sub_quadratic=True)


SPEC = ArchSpec(
    arch_id="gemma3-1b", family="dense",
    source="hf:google/gemma-3-1b-pt; unverified",
    config=get_config, reduced=get_reduced,
    shapes=standard_shapes(sub_quadratic=True))
