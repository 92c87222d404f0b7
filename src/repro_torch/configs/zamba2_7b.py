"""zamba2-7b [hybrid]: 81 Mamba2 layers (d=3584, ssm_state=64) with a
SHARED attention+MLP block (32H MHA, d_ff=14336) applied every 6 layers.
[arXiv:2411.15242; unverified]

Simplification vs the released checkpoint (noted in DESIGN.md): Zamba2
alternates two shared blocks and concatenates the original embedding into
the shared-block input via a down-projection; we use a single shared
pre-norm block. The compute/memory/communication signature (and the reason
it is long_500k-eligible: O(1) SSM state) is preserved.
"""
from __future__ import annotations

from ..models.mamba2 import Mamba2Config
from ..models.modules import AttnConfig
from ..models.transformer import BlockSpec, ModelConfig, UnitSpec
from .base import ArchSpec, standard_shapes


def _cfg(d, H, hd, ff, n_mamba, period, state, name, vocab):
    mamba = BlockSpec(kind="mamba",
                      mamba=Mamba2Config(d_model=d, d_state=state,
                                         head_dim=64, expand=2),
                      mlp_kind="none")
    shared = BlockSpec(kind="attn",
                       attn=AttnConfig(d, H, H, hd, rope_theta=10_000.0),
                       mlp_kind="dense", d_ff=ff, act="gelu",
                       use_shared=True)
    full, rem = divmod(n_mamba, period)
    units = [UnitSpec(full, (shared,) + (mamba,) * period)]
    if rem:
        units.append(UnitSpec(1, (shared,) + (mamba,) * rem))
    # the scanned copy of the shared block carries no params of its own
    # (use_shared=True reads params['shared']) — define the param template:
    shared_tmpl = BlockSpec(kind="attn",
                            attn=AttnConfig(d, H, H, hd,
                                            rope_theta=10_000.0),
                            mlp_kind="dense", d_ff=ff, act="gelu")
    return ModelConfig(name=name, d_model=d, vocab_size=vocab,
                       units=tuple(units), shared_block=shared_tmpl,
                       sub_quadratic=True)


def get_config() -> ModelConfig:
    return _cfg(3584, 32, 112, 14336, 81, 6, 64, "zamba2-7b", 32000)


def get_reduced() -> ModelConfig:
    return _cfg(64, 4, 16, 128, 5, 2, 16, "zamba2-7b-smoke", 512)


SPEC = ArchSpec(
    arch_id="zamba2-7b", family="hybrid",
    source="arXiv:2411.15242; unverified",
    config=get_config, reduced=get_reduced,
    shapes=standard_shapes(sub_quadratic=True))
