"""seamless-m4t-large-v2 — enc-dec 24L+24L d1024 16H (kv16) d_ff 8192
vocab 256206; speech frontend STUB (frame embeddings). [arXiv:2308.11596]"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.encdec import EncDecConfig


def full() -> EncDecConfig:
    return EncDecConfig(name="seamless-m4t-large-v2", n_enc_layers=24,
                        n_dec_layers=24, d_model=1024, n_heads=16,
                        n_kv_heads=16, d_ff=8192, vocab=256206)


def smoke() -> EncDecConfig:
    return EncDecConfig(name="seamless-smoke", n_enc_layers=2, n_dec_layers=2,
                        d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
                        vocab=256, remat=False)


ARCH = ArchSpec(
    id="seamless-m4t-large-v2", family="audio", kind="encdec",
    make_full=full, make_smoke=smoke,
    note="Encoder/decoder = two dependent streams (the paper's critical-"
         "path case); serving overlaps encode(i+1) with decode(i). Speech "
         "frontend stubbed per brief. long_500k skipped (full attention).",
    source="arXiv:2308.11596",
)
