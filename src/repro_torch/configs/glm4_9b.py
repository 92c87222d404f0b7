"""glm4-9b [dense]: 40L d=4096 32H (GQA kv=2) d_ff=13696 vocab=151552,
RoPE (partial, 0.5), GQA. [hf:THUDM/glm-4-9b; hf]"""
from __future__ import annotations

from ..models.modules import AttnConfig
from ..models.transformer import BlockSpec, ModelConfig, UnitSpec
from .base import ArchSpec, standard_shapes


def _cfg(d, H, K, hd, ff, L, vocab, name):
    blk = BlockSpec(
        kind="attn",
        attn=AttnConfig(d, H, K, hd, rope_theta=10_000.0, rotary_frac=0.5),
        mlp_kind="dense", d_ff=ff, act="silu")
    return ModelConfig(name=name, d_model=d, vocab_size=vocab,
                       units=(UnitSpec(L, (blk,)),))


def get_config() -> ModelConfig:
    return _cfg(4096, 32, 2, 128, 13696, 40, 151552, "glm4-9b")


def get_reduced() -> ModelConfig:
    return _cfg(64, 4, 2, 16, 128, 3, 512, "glm4-9b-smoke")


SPEC = ArchSpec(
    arch_id="glm4-9b", family="dense", source="hf:THUDM/glm-4-9b; hf",
    config=get_config, reduced=get_reduced,
    shapes=standard_shapes(sub_quadratic=False))
