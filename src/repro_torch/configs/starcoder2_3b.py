"""starcoder2-3b — 30L d3072 24H (kv2) d_ff 12288 vocab 49152, window 4096."""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.lm import LMConfig


def full() -> LMConfig:
    return LMConfig(
        name="starcoder2-3b", n_layers=30, d_model=3072, n_heads=24,
        n_kv_heads=2, head_dim=128, d_ff=12288, vocab=49152,
        pattern=("local",), window=4096, rope_base=999999.0,
        act="gelu", qkv_bias=True, tie_embeddings=True,
    )


def smoke() -> LMConfig:
    return LMConfig(
        name="starcoder2-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab=256,
        pattern=("local",), window=16, act="gelu", qkv_bias=True, remat=False,
    )


ARCH = ArchSpec(
    id="starcoder2-3b", family="dense", kind="lm",
    make_full=full, make_smoke=smoke,
    note="Sliding-window (4096) GQA kv=2. long_500k skipped per assignment "
         "grouping (dense family); window caches would bound state.",
    source="arXiv:2402.19173",
)
