"""qwen2-vl-7b [vlm]: 28L d=3584 28H (GQA kv=4) d_ff=18944 vocab=152064,
M-RoPE (t/h/w sections 16/24/24), dynamic-resolution vision frontend STUB
(input_specs supplies precomputed patch embeddings). [arXiv:2409.12191; hf]
"""
from __future__ import annotations

from ..models.modules import AttnConfig
from ..models.transformer import BlockSpec, ModelConfig, UnitSpec
from .base import ArchSpec, standard_shapes

MROPE = (16, 24, 24)
N_PATCHES = 256        # stub image => 256 patch embeddings per example


def _cfg(d, H, K, hd, ff, L, vocab, patches, sections, name):
    blk = BlockSpec(
        kind="attn",
        attn=AttnConfig(d, H, K, hd, rope_theta=1_000_000.0,
                        mrope_sections=sections),
        mlp_kind="dense", d_ff=ff, act="silu")
    return ModelConfig(name=name, d_model=d, vocab_size=vocab,
                       units=(UnitSpec(L, (blk,)),), frontend="vision",
                       frontend_len=patches, mrope_sections=sections)


def get_config() -> ModelConfig:
    return _cfg(3584, 28, 4, 128, 18944, 28, 152064, N_PATCHES, MROPE,
                "qwen2-vl-7b")


def get_reduced() -> ModelConfig:
    return _cfg(64, 4, 2, 16, 128, 3, 512, 8, (3, 3, 2), "qwen2-vl-smoke")


SPEC = ArchSpec(
    arch_id="qwen2-vl-7b", family="vlm", source="arXiv:2409.12191; hf",
    config=get_config, reduced=get_reduced,
    shapes=standard_shapes(sub_quadratic=False))
