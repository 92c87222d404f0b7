"""phi3.5-moe-42b-a6.6b [moe]: 32L d=4096 32H (GQA kv=8) per-expert
d_ff=6400, 16 experts top-2, vocab=32064.
[hf:microsoft/Phi-3.5-MoE-instruct; hf]"""
from __future__ import annotations

from ..models.modules import AttnConfig, MoEConfig
from ..models.transformer import BlockSpec, ModelConfig, UnitSpec
from .base import ArchSpec, standard_shapes


def _cfg(d, H, K, hd, L, vocab, E, top_k, ff, name):
    blk = BlockSpec(
        kind="attn",
        attn=AttnConfig(d, H, K, hd, rope_theta=10_000.0),
        mlp_kind="moe",
        moe=MoEConfig(d_model=d, d_ff=ff, n_experts=E, top_k=top_k),
        act="silu")
    return ModelConfig(name=name, d_model=d, vocab_size=vocab,
                       units=(UnitSpec(L, (blk,)),))


def get_config() -> ModelConfig:
    return _cfg(4096, 32, 8, 128, 32, 32064, 16, 2, 6400,
                "phi3.5-moe-42b-a6.6b")


def get_reduced() -> ModelConfig:
    return _cfg(64, 4, 2, 16, 3, 512, 4, 2, 96, "phi3.5-moe-smoke")


SPEC = ArchSpec(
    arch_id="phi3.5-moe-42b-a6.6b", family="moe",
    source="hf:microsoft/Phi-3.5-MoE-instruct; hf",
    config=get_config, reduced=get_reduced,
    shapes=standard_shapes(sub_quadratic=False))
