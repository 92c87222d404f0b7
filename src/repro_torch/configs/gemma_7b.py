"""gemma-7b [dense]: 28L d=3072 16H (MHA kv=16) d_ff=24576 vocab=256000,
GeGLU, head_dim=256. [arXiv:2403.08295; hf]"""
from __future__ import annotations

from ..models.modules import AttnConfig
from ..models.transformer import BlockSpec, ModelConfig, UnitSpec
from .base import ArchSpec, standard_shapes


def _cfg(d, H, hd, ff, L, vocab, name):
    blk = BlockSpec(
        kind="attn",
        attn=AttnConfig(d, H, H, hd, rope_theta=10_000.0),
        mlp_kind="dense", d_ff=ff, act="gelu")
    return ModelConfig(name=name, d_model=d, vocab_size=vocab,
                       units=(UnitSpec(L, (blk,)),), embed_scale=True)


def get_config() -> ModelConfig:
    return _cfg(3072, 16, 256, 24576, 28, 256000, "gemma-7b")


def get_reduced() -> ModelConfig:
    return _cfg(64, 4, 16, 192, 3, 512, "gemma-7b-smoke")


SPEC = ArchSpec(
    arch_id="gemma-7b", family="dense", source="arXiv:2403.08295; hf",
    config=get_config, reduced=get_reduced,
    shapes=standard_shapes(sub_quadratic=False))
