"""rwkv6-1.6b [ssm]: 24L d=2048 (attention-free) d_ff=7168 vocab=65536 —
Finch, data-dependent decay. [arXiv:2404.05892; unverified]"""
from __future__ import annotations

from ..models.rwkv6 import RWKV6Config
from ..models.transformer import BlockSpec, ModelConfig, UnitSpec
from .base import ArchSpec, standard_shapes


def _cfg(d, hd, ff, L, vocab, name):
    rc = RWKV6Config(d_model=d, head_dim=hd, d_ff=ff)
    blk = BlockSpec(kind="rwkv", rwkv=rc, mlp_kind="rwkv_cmix")
    return ModelConfig(name=name, d_model=d, vocab_size=vocab,
                       units=(UnitSpec(L, (blk,)),), sub_quadratic=True)


def get_config() -> ModelConfig:
    return _cfg(2048, 64, 7168, 24, 65536, "rwkv6-1.6b")


def get_reduced() -> ModelConfig:
    return _cfg(64, 16, 128, 3, 512, "rwkv6-smoke")


SPEC = ArchSpec(
    arch_id="rwkv6-1.6b", family="ssm",
    source="arXiv:2404.05892; unverified",
    config=get_config, reduced=get_reduced,
    shapes=standard_shapes(sub_quadratic=True))
