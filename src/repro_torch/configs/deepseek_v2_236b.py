"""deepseek-v2-236b [moe]: 60L d=5120 128H MLA (kv_lora=512) vocab=102400,
MoE: 2 shared + 160 routed experts top-6, per-expert d_ff=1536; first
layer dense (d_ff=12288). [arXiv:2405.04434; hf]"""
from __future__ import annotations

from ..models.modules import MLAConfig, MoEConfig
from ..models.transformer import BlockSpec, ModelConfig, UnitSpec
from .base import ArchSpec, standard_shapes


def _cfg(d, H, L, vocab, E, top_k, ff_expert, ff_dense, name,
         q_lora=1536, kv_lora=512, qk_nope=128, qk_rope=64, v_head=128,
         n_shared=2):
    mla = MLAConfig(d_model=d, n_heads=H, q_lora=q_lora, kv_lora=kv_lora,
                    qk_nope=qk_nope, qk_rope=qk_rope, v_head=v_head)
    dense = BlockSpec(kind="mla", mla=mla, mlp_kind="dense", d_ff=ff_dense,
                      act="silu")
    moe = BlockSpec(kind="mla", mla=mla, mlp_kind="moe",
                    moe=MoEConfig(d_model=d, d_ff=ff_expert, n_experts=E,
                                  top_k=top_k, n_shared=n_shared,
                                  shared_d_ff=n_shared * ff_expert),
                    act="silu")
    return ModelConfig(name=name, d_model=d, vocab_size=vocab,
                       units=(UnitSpec(1, (dense,)),
                              UnitSpec(L - 1, (moe,))))


def get_config() -> ModelConfig:
    return _cfg(5120, 128, 60, 102400, 160, 6, 1536, 12288,
                "deepseek-v2-236b")


def get_reduced() -> ModelConfig:
    return _cfg(64, 4, 3, 512, 8, 2, 64, 128, "deepseek-v2-smoke",
                q_lora=32, kv_lora=16, qk_nope=16, qk_rope=8, v_head=16,
                n_shared=1)


SPEC = ArchSpec(
    arch_id="deepseek-v2-236b", family="moe",
    source="arXiv:2405.04434; hf",
    config=get_config, reduced=get_reduced,
    shapes=standard_shapes(sub_quadratic=False))
