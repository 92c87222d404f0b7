"""Architecture registry of the port: --arch <id> resolves here.

All ten of the reference's archs (``ARCHS``): the six attention archs,
deepseek-v2-236b (MLA and MoE), phi3.5-moe-42b (MoE), zamba2-7b (mamba2
with a shared attention block) and rwkv6-1.6b. An unknown id is a
KeyError.
"""
from __future__ import annotations

from typing import Dict

from . import (deepseek_v2_236b, gemma3_1b, gemma3_4b, gemma_7b, glm4_9b,
               phi35_moe_42b, qwen2_vl_7b, rwkv6_1p6b, whisper_base,
               zamba2_7b)
from .base import ArchSpec, ShapeSpec

ARCHS: Dict[str, ArchSpec] = {
    spec.arch_id: spec
    for spec in (
        gemma3_4b.SPEC, gemma3_1b.SPEC, glm4_9b.SPEC, gemma_7b.SPEC,
        zamba2_7b.SPEC, deepseek_v2_236b.SPEC, phi35_moe_42b.SPEC,
        whisper_base.SPEC, qwen2_vl_7b.SPEC, rwkv6_1p6b.SPEC,
    )
}


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]


__all__ = ["ARCHS", "ArchSpec", "ShapeSpec", "get_arch"]
