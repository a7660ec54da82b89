"""Parity of the port's GQA attention (``repro_torch.nn.attention``) with
the JAX reference.

Without a window ``attention`` calls ``flash_mha`` (here on the CPU, its
plain version); the reference computes the same function with its plain
``attend_full`` / ``attend_chunked``: within 1e-5 at f32 and the registry's
``flash_attn`` epsilon 3e-2 at bf16 (the reference rounds the scores and
probabilities to bf16, the kernel keeps them in f32).  The windowed twins
and the decode step agree within 1e-5 at f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import attention as jattn
from repro.nn import init as jinit
from repro_torch import interop
from repro_torch.backend import registry
from repro_torch.nn import attention as attn

ATOL = 1e-5
FLASH_EPS = registry.KERNELS["flash_attn"].epsilon


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got: torch.Tensor, want, atol=ATOL):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=0)


def _cfgs(**kw):
    base = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8)
    base.update(kw)
    return jattn.AttnConfig(**base), attn.AttnConfig(**base)


def _params(jcfg, seed=0):
    jp = jinit.materialize(jattn.gqa_spec(jcfg), jax.random.PRNGKey(seed))
    # biases and qk-norm scales draw zeros / ones: give them values
    jp = {k: (v + 0.05 * (i + 1) if v.ndim <= 2 else v)
          for i, (k, v) in enumerate(sorted(jp.items()))}
    return jp, interop.from_reference(jax.tree.map(np.asarray, jp), device="cpu")


CFG_CASES = {
    "gqa": {},
    "mha_partial_rotary": dict(n_kv_heads=4, rotary_dim=2),
    "bias_qknorm": dict(qkv_bias=True, qk_norm=True, rope_base=1e6),
    "window": dict(window=5),
    "mqa_window_qknorm": dict(n_kv_heads=1, window=7, qk_norm=True),
}


def test_spec_matches_reference():
    for kw in CFG_CASES.values():
        jcfg, cfg = _cfgs(**kw)
        jspec, spec = jattn.gqa_spec(jcfg), attn.gqa_spec(cfg)
        assert sorted(jspec) == sorted(spec)
        for k in spec:
            assert (jspec[k].shape, jspec[k].init, jspec[k].scale) == \
                (spec[k].shape, spec[k].init, spec[k].scale)
        assert cfg.scale == jcfg.scale


@pytest.mark.parametrize("case", sorted(CFG_CASES))
def test_gqa_project(case):
    jcfg, cfg = _cfgs(**CFG_CASES[case])
    jp, p = _params(jcfg)
    x = np.random.default_rng(1).standard_normal((2, 11, 32)).astype(np.float32)
    pos = np.arange(11, dtype=np.int32)
    want = jattn.gqa_project(jp, jcfg, jnp.asarray(x), jnp.asarray(pos), jnp.float32)
    got = attn.gqa_project(p, cfg, _t(x), _t(pos), torch.float32)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("window", [None, 1, 4])
@pytest.mark.parametrize("q_offset", [0, 3])
def test_causal_mask(window, q_offset):
    want = np.asarray(jattn.causal_mask(6, 9, q_offset, window))
    assert np.array_equal(attn.causal_mask(6, 9, q_offset, window).numpy(), want)


@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("kv_chunk", [4, 7, 64])
def test_attend_full_and_chunked(window, kv_chunk):
    """The torch twins of the reference's plain attention, including a
    ragged last chunk (kv_chunk 7 over 19 keys)."""
    rng = np.random.default_rng(kv_chunk)
    q, k, v = (rng.standard_normal((2, 19, 3, 8)).astype(np.float32) for _ in range(3))
    mask = jattn.causal_mask(19, 19, window=window)
    want = jattn.attend_full(*map(jnp.asarray, (q, k, v)), mask, 0.3)
    got = attn.attend_full(_t(q), _t(k), _t(v), attn.causal_mask(19, 19, window=window), 0.3)
    _close(got, want)
    want = jattn.attend_chunked(*map(jnp.asarray, (q, k, v)), 0.3, window=window,
                                kv_chunk=kv_chunk)
    got = attn.attend_chunked(_t(q), _t(k), _t(v), 0.3, window=window, kv_chunk=kv_chunk)
    _close(got, want)


@pytest.mark.parametrize("case", sorted(CFG_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_against_reference(case, dtype):
    """Full-sequence attention.  Without a window the port calls the
    flash_attn kernel's wrapper once (``record_kernels``); with one it calls
    no kernel.  f32 within 1e-5, bf16 within the registry's flash_attn
    epsilon."""
    jcfg, cfg = _cfgs(**CFG_CASES[case])
    jp, p = _params(jcfg, seed=3)
    x = np.random.default_rng(2).standard_normal((2, 13, 32)).astype(np.float32)
    pos = np.arange(13, dtype=np.int32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jattn.attention(jp, jcfg, jnp.asarray(x), jnp.asarray(pos), jdt)
    with registry.record_kernels() as rec:
        got = attn.attention(p, cfg, _t(x), _t(pos), tdt)
    assert rec == ([] if cfg.window else [("flash_attn", "kernel")])
    assert got.dtype == tdt
    _close(got, want, ATOL if dtype == "float32" else FLASH_EPS)


def test_unwindowed_attention_equals_reference_chunked_path():
    """Past the reference's CHUNKED_THRESHOLD it switches to
    ``attend_chunked``; the flash path computes the same function."""
    jcfg, cfg = _cfgs(d_model=16, n_heads=2, n_kv_heads=1)
    jp, p = _params(jcfg, seed=4)
    s = jattn.CHUNKED_THRESHOLD + 5
    x = np.random.default_rng(5).standard_normal((1, s, 16)).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)
    want = jattn.attention(jp, jcfg, jnp.asarray(x), jnp.asarray(pos), jnp.float32,
                           kv_chunk=1024)
    _close(attn.attention(p, cfg, _t(x), _t(pos), torch.float32), want)


def test_kv_cache_shapes():
    for window, want_len in ((None, 40), (16, 16), (64, 40)):
        jcfg, cfg = _cfgs(window=window)
        jshape = jattn.kv_cache_shape(jcfg, 3, 40)
        shape = attn.kv_cache_shape(cfg, 3, 40)
        assert tuple(shape["k"].shape) == jshape["k"].shape == (3, want_len, 2, 8)
        assert shape["v"].dtype == torch.bfloat16
        cache = attn.init_kv_cache(cfg, 3, 40, device="cpu")
        assert not cache["k"].any() and cache["k"].device.type == "cpu"


@pytest.mark.parametrize("case", ["gqa", "bias_qknorm", "window", "mqa_window_qknorm"])
def test_decode_steps_with_per_slot_positions(case):
    """Slots at different depths (a per-slot ``pos`` vector), driven token
    by token well past the window, so a ring cache wraps several times;
    outputs and caches against the reference at every step."""
    jcfg, cfg = _cfgs(**CFG_CASES[case])
    jp, p = _params(jcfg, seed=6)
    steps, b, max_len = 24, 3, 32
    start = np.array([0, 5, 2], np.int32)
    jcache = jattn.init_kv_cache(jcfg, b, max_len)
    cache = attn.init_kv_cache(cfg, b, max_len, device="cpu")
    xs = np.random.default_rng(7).standard_normal((steps, b, 32)).astype(np.float32)
    for t in range(steps):
        pos = start + t
        jcache, want = jattn.decode_step(jp, jcfg, jcache, jnp.asarray(xs[t]),
                                         jnp.asarray(pos), jnp.float32)
        cache, got = attn.decode_step(p, cfg, cache, _t(xs[t]), _t(pos), torch.float32)
        _close(got, want)
    for name in ("k", "v"):
        assert np.array_equal(cache[name].float().numpy(),
                              np.asarray(jcache[name].astype(jnp.float32)))


def test_decode_takes_a_scalar_position():
    jcfg, cfg = _cfgs(window=4)
    jp, p = _params(jcfg, seed=8)
    jcache = jattn.init_kv_cache(jcfg, 2, 16)
    cache = attn.init_kv_cache(cfg, 2, 16, device="cpu")
    x = np.random.default_rng(9).standard_normal((2, 32)).astype(np.float32)
    for t in range(6):
        jcache, want = jattn.decode_step(jp, jcfg, jcache, jnp.asarray(x), t, jnp.float32)
        cache, got = attn.decode_step(p, cfg, cache, _t(x), t, torch.float32)
    _close(got, want)


def test_init_kv_cache_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without it")
    _, cfg = _cfgs()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        attn.init_kv_cache(cfg, 1, 8)
