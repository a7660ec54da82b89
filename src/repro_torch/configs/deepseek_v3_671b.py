"""deepseek-v3-671b — 61L d7168 128H MLA, 1 shared + 256 routed top-8, MTP.

[arXiv:2412.19437] MLA: q_lora 1536, kv_lora 512, nope 128 / rope 64,
v_head 128; first 3 layers dense (d_ff 18432); expert d_ff 2048.
"""
import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models.lm import LMConfig
from repro_torch.nn.attention import MLAConfig
from repro_torch.nn.moe import MoEConfig


def full() -> LMConfig:
    return LMConfig(
        name="deepseek-v3-671b", n_layers=61, d_model=7168, n_heads=128,
        n_kv_heads=128, head_dim=128, d_ff=2048, vocab=129280,
        attn_kind="mla",
        mla=MLAConfig(d_model=7168, n_heads=128, q_lora_rank=1536,
                      kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
                      v_head_dim=128),
        first_k_dense=3, dense_d_ff=18432,
        moe=MoEConfig(d_model=7168, d_ff=2048, n_experts=256, top_k=8,
                      n_shared=1, shared_d_ff=2048, capacity_factor=1.25),
        mtp=True, tie_embeddings=False, rope_base=10000.0,
        param_dtype=torch.bfloat16,
    )


def smoke() -> LMConfig:
    return LMConfig(
        name="deepseek-v3-smoke", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=32, vocab=256,
        attn_kind="mla",
        mla=MLAConfig(d_model=64, n_heads=4, q_lora_rank=32, kv_lora_rank=16,
                      qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16),
        first_k_dense=1, dense_d_ff=128,
        moe=MoEConfig(d_model=64, d_ff=32, n_experts=4, top_k=2, n_shared=1,
                      shared_d_ff=32, capacity_factor=2.0),
        mtp=True, tie_embeddings=False,
    )


ARCH = ArchSpec(
    id="deepseek-v3-671b", family="moe", kind="lm",
    make_full=full, make_smoke=smoke,
    note="MLA compressed KV cache; EP over model axis; MTP exercises "
         "inter-loop overlap. FSDP + 8-bit AdamW to fit 16 GB/chip.",
    source="arXiv:2412.19437",
)
