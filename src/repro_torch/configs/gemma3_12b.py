"""gemma3-12b — 48L d3840 16H (kv8) d_ff 15360 vocab 262144, 5:1 local:global.

Local window 1024 @ rope 10k; global rope 1M; qk-norm; (1+w) RMSNorm.
"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.lm import LMConfig


def full() -> LMConfig:
    return LMConfig(
        name="gemma3-12b", n_layers=48, d_model=3840, n_heads=16,
        n_kv_heads=8, head_dim=256, d_ff=15360, vocab=262144,
        pattern=("local", "local", "local", "local", "local", "global"),
        window=1024, rope_base=1_000_000.0, rope_base_local=10_000.0,
        qk_norm=True, norm_offset=1.0, embed_scale=True, tie_embeddings=True,
        act="geglu",
    )


def smoke() -> LMConfig:
    return LMConfig(
        name="gemma3-smoke", n_layers=6, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab=256,
        pattern=("local", "local", "local", "local", "local", "global"),
        window=16, qk_norm=True, norm_offset=1.0, embed_scale=True,
        act="geglu", remat=False,
    )


ARCH = ArchSpec(
    id="gemma3-12b", family="dense", kind="lm",
    make_full=full, make_smoke=smoke, supports_long=True,
    note="Two kernel classes (banded vs full attention) -> dataflow-graph "
         "scheduling applies. long_500k RUNS: 5/6 layers are window-1024 "
         "ring caches; only 8 global layers hold the long cache.",
    source="hf:google/gemma-3-1b-pt (scaled per assignment)",
)
