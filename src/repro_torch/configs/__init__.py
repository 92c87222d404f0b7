"""Architecture registry of the port: --arch <id> resolves here.

Eight archs are ported (``ARCHS``): the six attention archs, and
deepseek-v2-236b (MLA and MoE) and phi3.5-moe-42b (MoE). The two others
need blocks the port does not have yet: ``get_arch`` on one of them
raises NotImplementedError (ROADMAP Queue 1 item 5b); an unknown id
stays a KeyError.
"""
from __future__ import annotations

from typing import Dict

from . import (deepseek_v2_236b, gemma3_1b, gemma3_4b, gemma_7b, glm4_9b,
               phi35_moe_42b, qwen2_vl_7b, whisper_base)
from .base import ArchSpec, ShapeSpec

ARCHS: Dict[str, ArchSpec] = {
    spec.arch_id: spec
    for spec in (
        gemma3_4b.SPEC, gemma3_1b.SPEC, glm4_9b.SPEC, gemma_7b.SPEC,
        deepseek_v2_236b.SPEC, phi35_moe_42b.SPEC, whisper_base.SPEC,
        qwen2_vl_7b.SPEC,
    )
}

# the reference's other archs and the blocks they wait on
UNPORTED: Dict[str, str] = {
    "zamba2-7b": "mamba2 and the shared block",
    "rwkv6-1.6b": "rwkv6",
}


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id in UNPORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} needs {UNPORTED[arch_id]}, not ported to "
            "repro_torch yet (ROADMAP Queue 1 item 5b)")
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]


__all__ = ["ARCHS", "ArchSpec", "ShapeSpec", "UNPORTED", "get_arch"]
