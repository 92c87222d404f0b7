"""Config base: ArchSpec (model factory + assigned input shapes).

Every assigned architecture gets one module exposing `get_config()` (the
exact published configuration) and `get_reduced()` (same family, tiny —
used by CPU smoke tests). Shapes follow the assignment:

    train_4k     seq 4096   batch 256   train_step
    prefill_32k  seq 32768  batch 32    serve_prefill
    decode_32k   seq 32768  batch 128   serve_decode (1 new token)
    long_500k    seq 524288 batch 1     serve_decode — sub-quadratic archs
                                        only (skips recorded per arch)
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

from ..models.transformer import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str                    # train | prefill | decode
    seq_len: int
    global_batch: int
    skip: Optional[str] = None   # reason string => cell is N/A


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                  # dense | moe | hybrid | ssm | audio | vlm
    source: str                  # provenance tag from the assignment
    config: Callable[[], ModelConfig]
    reduced: Callable[[], ModelConfig]
    shapes: Tuple[ShapeSpec, ...]


def standard_shapes(*, sub_quadratic: bool, encdec: bool = False,
                    long_skip_reason: str = "full attention (quadratic)"
                    ) -> Tuple[ShapeSpec, ...]:
    long_skip = None if sub_quadratic else long_skip_reason
    if encdec:
        long_skip = "enc-dec with fixed-length encoder; full attention"
    return (
        ShapeSpec("train_4k", "train", 4096, 256),
        ShapeSpec("prefill_32k", "prefill", 32768, 32),
        ShapeSpec("decode_32k", "decode", 32768, 128),
        ShapeSpec("long_500k", "decode", 524288, 1, skip=long_skip),
    )
