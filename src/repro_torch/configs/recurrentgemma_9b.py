"""recurrentgemma-9b — 38L d4096 RG-LRU + local attn (1:2), kv=1, w=2048."""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.griffin import GriffinConfig


def full() -> GriffinConfig:
    return GriffinConfig(name="recurrentgemma-9b", n_layers=38, d_model=4096,
                         n_heads=16, n_kv_heads=1, d_ff=12288, vocab=256000,
                         window=2048, lru_width=4096)


def smoke() -> GriffinConfig:
    return GriffinConfig(name="recurrentgemma-smoke", n_layers=3, d_model=64,
                         n_heads=4, n_kv_heads=1, d_ff=128, vocab=256,
                         window=16, lru_width=64, remat=False)


ARCH = ArchSpec(
    id="recurrentgemma-9b", family="hybrid", kind="griffin",
    make_full=full, make_smoke=smoke, supports_long=True,
    note="2:1 recurrent:attention heterogeneous mix — NSFlow folding "
         "applies. Bounded state (LRU + window ring) -> long_500k runs.",
    source="arXiv:2402.19427",
)
