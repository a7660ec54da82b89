"""granite-moe-1b-a400m — 24L d1024 16H (kv8) MoE 32e top-8, d_ff(expert)=512.

[hf:ibm-granite/granite-3.0-1b-a400m-base]
"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.lm import LMConfig
from repro_torch.nn.moe import MoEConfig


def full() -> LMConfig:
    return LMConfig(
        name="granite-moe-1b-a400m", n_layers=24, d_model=1024, n_heads=16,
        n_kv_heads=8, head_dim=64, d_ff=512, vocab=49155,
        moe=MoEConfig(d_model=1024, d_ff=512, n_experts=32, top_k=8),
        tie_embeddings=True, rope_base=10000.0,
    )


def smoke() -> LMConfig:
    return LMConfig(
        name="granite-moe-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=32, vocab=256,
        moe=MoEConfig(d_model=64, d_ff=32, n_experts=4, top_k=2,
                      capacity_factor=2.0),
        tie_embeddings=True,
    )


ARCH = ArchSpec(
    id="granite-moe-1b-a400m", family="moe", kind="lm",
    make_full=full, make_smoke=smoke,
    note="Heterogeneous router/expert kernel mix; NSFlow folding applies "
         "(DESIGN.md §4).",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
