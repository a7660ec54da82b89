"""rwkv6-7b (Finch) — 32L d4096 attn-free, d_ff 14336 vocab 65536."""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.rwkv6 import RWKVConfig


def full() -> RWKVConfig:
    return RWKVConfig(name="rwkv6-7b", n_layers=32, d_model=4096,
                      d_ff=14336, vocab=65536, head_dim=64, chunk=64)


def smoke() -> RWKVConfig:
    return RWKVConfig(name="rwkv6-smoke", n_layers=2, d_model=64, d_ff=128,
                      vocab=256, head_dim=16, chunk=8, remat=False)


ARCH = ArchSpec(
    id="rwkv6-7b", family="ssm", kind="rwkv",
    make_full=full, make_smoke=smoke, supports_long=True,
    note="Strongest NSFlow analogue in the LM pool: memory-bound WKV "
         "recurrence stream vs MXU channel-mix stream (DESIGN.md §4). "
         "O(1)-state decode -> long_500k runs.",
    source="arXiv:2404.05892",
)
