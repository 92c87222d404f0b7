"""whisper-base [audio]: 6L enc + 6L dec, d=512 8H d_ff=2048 vocab=51865,
enc-dec with conv frontend STUB (input_specs supplies precomputed frame
embeddings). [arXiv:2212.04356; unverified]

Stubs/deviations (DESIGN.md): vocab padded 51865 -> 51968 (TP-128
alignment); decoder positions use RoPE in place of Whisper's learned
absolute embeddings; the conv1d mel frontend is a stub per the assignment.
"""
from __future__ import annotations

from ..models.modules import AttnConfig
from ..models.transformer import (BlockSpec, EncoderConfig, ModelConfig,
                                  UnitSpec)
from .base import ArchSpec, standard_shapes

VOCAB_PADDED = 51968


def _cfg(d, H, hd, ff, L, vocab, frames, name):
    attn = AttnConfig(d, H, H, hd, rope_theta=10_000.0)
    dec = BlockSpec(kind="attn", attn=attn, mlp_kind="dense", d_ff=ff,
                    act="gelu", gated=False, layernorm=True,
                    cross_attn=True)
    enc = EncoderConfig(n_layers=L, attn=attn, d_ff=ff, n_frames=frames)
    return ModelConfig(name=name, d_model=d, vocab_size=vocab,
                       units=(UnitSpec(L, (dec,)),), encoder=enc,
                       frontend="audio", frontend_len=frames,
                       layernorm=True)


def get_config() -> ModelConfig:
    return _cfg(512, 8, 64, 2048, 6, VOCAB_PADDED, 1500, "whisper-base")


def get_reduced() -> ModelConfig:
    return _cfg(64, 4, 16, 128, 2, 512, 16, "whisper-base-smoke")


SPEC = ArchSpec(
    arch_id="whisper-base", family="audio",
    source="arXiv:2212.04356; unverified",
    config=get_config, reduced=get_reduced,
    shapes=standard_shapes(sub_quadratic=False, encdec=True))
