"""llama3.2-3b — 28L d3072 24H (kv8) d_ff 8192 vocab 128256. [hf:meta-llama]"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.lm import LMConfig


def full() -> LMConfig:
    return LMConfig(
        name="llama3.2-3b", n_layers=28, d_model=3072, n_heads=24,
        n_kv_heads=8, head_dim=128, d_ff=8192, vocab=128256,
        rope_base=500000.0, tie_embeddings=True,
        remat=False,
    )


def smoke() -> LMConfig:
    return LMConfig(
        name="llama3.2-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab=256, remat=False,
    )


ARCH = ArchSpec(
    id="llama3.2-3b", family="dense", kind="lm",
    make_full=full, make_smoke=smoke,
    note="Single dense kernel class: NSFlow folding inapplicable; DSE/"
         "memory-planner only (DESIGN.md §4). long_500k skipped "
         "(pure full attention).",
    source="hf:meta-llama/Llama-3.2-1B (scaled per assignment)",
)
