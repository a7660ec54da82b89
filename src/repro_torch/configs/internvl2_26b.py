"""internvl2-26b — InternViT (STUB) + InternLM2-20B-class backbone:
48L d6144 48H (kv8) d_ff 16384 vocab 92553. [arXiv:2404.16821]"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.lm import LMConfig
from repro_torch.models.vlm import VLMConfig


def full() -> VLMConfig:
    return VLMConfig(
        lm=LMConfig(name="internvl2-26b", n_layers=48, d_model=6144,
                    n_heads=48, n_kv_heads=8, head_dim=128, d_ff=16384,
                    vocab=92553, tie_embeddings=False),
        n_img_tokens=1024,
    )


def smoke() -> VLMConfig:
    return VLMConfig(
        lm=LMConfig(name="internvl2-smoke", n_layers=2, d_model=64, n_heads=4,
                    n_kv_heads=2, head_dim=16, d_ff=128, vocab=256,
                    tie_embeddings=False, remat=False),
        n_img_tokens=16,
    )


ARCH = ArchSpec(
    id="internvl2-26b", family="vlm", kind="vlm",
    make_full=full, make_smoke=smoke, fsdp=True,
    note="ViT frontend stubbed (input_specs supplies patch embeddings per "
         "brief). Perception->reasoning critical path = the paper's "
         "inter-loop overlap case. long_500k skipped (full attention).",
    source="arXiv:2404.16821",
)
