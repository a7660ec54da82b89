"""stablelm-3b — 32L d2560 32H (kv32=MHA) d_ff 6912 vocab 50304, 25% rotary."""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.lm import LMConfig


def full() -> LMConfig:
    return LMConfig(
        name="stablelm-3b", n_layers=32, d_model=2560, n_heads=32,
        n_kv_heads=32, head_dim=80, d_ff=6912, vocab=50304,
        rotary_pct=0.25, tie_embeddings=False,
    )


def smoke() -> LMConfig:
    return LMConfig(
        name="stablelm-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=96, vocab=256, rotary_pct=0.25,
        tie_embeddings=False, remat=False,
    )


ARCH = ArchSpec(
    id="stablelm-3b", family="dense", kind="lm",
    make_full=full, make_smoke=smoke,
    note="MHA (kv=heads): largest per-token KV cache of the dense set. "
         "long_500k skipped (pure full attention). RMSNorm stands in for "
         "LayerNorm (dims per assignment).",
    source="hf:stabilityai/stablelm-2-1_6b (scaled per assignment)",
)
