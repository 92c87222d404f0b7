"""gemma3-4b [dense]: 34L d=2560 8H (GQA kv=4) d_ff=10240 vocab=262144,
5:1 local:global sliding-window attention, 128k context.
[hf:google/gemma-3-1b-pt; unverified]"""
from __future__ import annotations

from ..models.modules import AttnConfig
from ..models.transformer import BlockSpec, ModelConfig, UnitSpec
from .base import ArchSpec, standard_shapes

WINDOW = 1024
HEAD_DIM = 256


def _blocks(d_model, n_heads, n_kv, head_dim, d_ff, window, theta_local,
            theta_global, n_layers, pattern=5):
    local = BlockSpec(
        kind="attn",
        attn=AttnConfig(d_model, n_heads, n_kv, head_dim,
                        rope_theta=theta_local, window=window, qk_norm=True),
        mlp_kind="dense", d_ff=d_ff, act="gelu", post_norms=True)
    glob = BlockSpec(
        kind="attn",
        attn=AttnConfig(d_model, n_heads, n_kv, head_dim,
                        rope_theta=theta_global, qk_norm=True),
        mlp_kind="dense", d_ff=d_ff, act="gelu", post_norms=True)
    unit = (local,) * pattern + (glob,)
    full, rem = divmod(n_layers, pattern + 1)
    units = [UnitSpec(full, unit)]
    if rem:
        units.append(UnitSpec(1, (local,) * rem))
    return tuple(units)


def get_config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b", d_model=2560, vocab_size=262144,
        units=_blocks(2560, 8, 4, HEAD_DIM, 10240, WINDOW,
                      10_000.0, 1_000_000.0, 34),
        embed_scale=True, sub_quadratic=True)


def get_reduced() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b-smoke", d_model=64, vocab_size=512,
        units=_blocks(64, 2, 1, 32, 128, 16, 10_000.0, 1_000_000.0, 4,
                      pattern=2),
        embed_scale=True, sub_quadratic=True)


SPEC = ArchSpec(
    arch_id="gemma3-4b", family="dense",
    source="hf:google/gemma-3-1b-pt; unverified",
    config=get_config, reduced=get_reduced,
    # gemma3 is NOT pure full attention: 5/6 of layers are sliding-window
    # (O(S*W)); the rare global layers are O(S) per decoded token => the
    # long_500k decode cell is tractable and RUN (see DESIGN.md).
    shapes=standard_shapes(sub_quadratic=True))
