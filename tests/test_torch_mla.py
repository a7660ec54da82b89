"""The port's MLA (``repro_torch.nn.attention``'s ``mla_*``) against the
reference's on the CPU.

deepseek-v3's smoke MLA (4 heads, q rank 32, kv rank 16, nope 16 / rope 8,
v head 16) with the reference's parameters carried across: the prefill
``mla_attention`` (``attend_full``, and ``attend_chunked`` with the
threshold lowered in both packages), the compressed cache's shapes, and
the absorbed ``mla_decode_step`` with slots at different depths, outputs
and caches at every step, all within 1e-5 at f32 compute (on f32 caches);
and the decode against the prefill at every position.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import attention as jattn
from repro.nn import init as jinit
from repro_torch import interop
from repro_torch.nn import attention as attn

KW = dict(d_model=64, n_heads=4, q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
          qk_rope_dim=8, v_head_dim=16)
TOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = jattn.MLAConfig(**KW), attn.MLAConfig(**KW)
    jp = jinit.materialize(jattn.mla_spec(jcfg), jax.random.PRNGKey(4))
    return jcfg, cfg, jp, interop.from_reference(jax.tree.map(np.asarray, jp),
                                                 device="cpu")


def _x(b: int, s: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((b, s, KW["d_model"])).astype(
        np.float32)


def _close(got: torch.Tensor, want, tol=TOL):
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


def test_config_spec_and_cache_shapes(setup):
    jcfg, cfg, _, _ = setup
    assert cfg.scale == jcfg.scale == 1.0 / np.sqrt(24)
    jspec = jax.tree.leaves(jattn.mla_spec(jcfg), is_leaf=lambda x: isinstance(x, jinit.P))
    spec = jax.tree.leaves(attn.mla_spec(cfg), is_leaf=lambda x: isinstance(x, attn.P))
    assert [(p.shape, p.axes, p.init, p.scale) for p in spec] == \
        [(p.shape, p.axes, p.init, p.scale) for p in jspec]
    jshape, shape = jattn.mla_cache_shape(jcfg, 3, 40), attn.mla_cache_shape(cfg, 3, 40)
    assert {k: (tuple(t.shape), str(t.dtype)) for k, t in shape.items()} == \
        {k: (s.shape, f"torch.{s.dtype}") for k, s in jshape.items()}
    caches = attn.mla_init_cache(cfg, 3, 40, device="cpu")
    assert not any(bool(t.any()) for t in caches.values())


@pytest.mark.parametrize("chunked", [False, True])
def test_mla_attention(setup, monkeypatch, chunked):
    jcfg, cfg, jp, p = setup
    x = _x(2, 37, seed=1)
    kw = {}
    if chunked:  # past the threshold: the online-softmax chunks, in both
        monkeypatch.setattr(jattn, "CHUNKED_THRESHOLD", 16)
        monkeypatch.setattr(attn, "CHUNKED_THRESHOLD", 16)
        kw = {"kv_chunk": 8}
    want = jattn.mla_attention(jp, jcfg, jnp.asarray(x), jnp.arange(37),
                               compute_dtype=jnp.float32, **kw)
    got = attn.mla_attention(p, cfg, torch.from_numpy(x), torch.arange(37),
                             compute_dtype=torch.float32, **kw)
    _close(got, want)


def test_mla_decode_step(setup):
    """Slots at positions 0 and 9, 24 steps, f32 caches: outputs and the
    compressed caches at every step."""
    jcfg, cfg, jp, p = setup
    jcache = jattn.mla_init_cache(jcfg, 2, 40, dtype=jnp.float32)
    cache = attn.mla_init_cache(cfg, 2, 40, dtype=torch.float32, device="cpu")
    xs = _x(24, 2, seed=2)
    jstep = jax.jit(lambda c, x, pos: jattn.mla_decode_step(
        jp, jcfg, c, x, pos, compute_dtype=jnp.float32))
    start = np.array([0, 9], np.int32)
    for t in range(24):
        pos = start + t
        jcache, want = jstep(jcache, jnp.asarray(xs[t]), jnp.asarray(pos))
        cache, got = attn.mla_decode_step(p, cfg, cache, torch.from_numpy(xs[t]),
                                          torch.from_numpy(pos).long(),
                                          compute_dtype=torch.float32)
        _close(got, want)
        for k in ("ckv", "kpe"):
            _close(cache[k], jcache[k])


def test_mla_decode_matches_prefill(setup):
    """Decoding a sequence token by token gives the prefill's outputs at
    every position (the absorbed and the decompressed forms agree)."""
    _, cfg, _, p = setup
    x = torch.from_numpy(_x(1, 20, seed=3))
    full = attn.mla_attention(p, cfg, x, torch.arange(20), compute_dtype=torch.float32)
    cache = attn.mla_init_cache(cfg, 1, 20, dtype=torch.float32, device="cpu")
    for t in range(20):
        cache, got = attn.mla_decode_step(p, cfg, cache, x[:, t], t,
                                          compute_dtype=torch.float32)
        _close(got, full[:, t].numpy(), tol=1e-4)
