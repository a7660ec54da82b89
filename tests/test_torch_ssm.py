"""Parity of the port's attention-free mixers (``repro_torch.nn.ssm``) and
the layers they need (``nn/layers.py``: ``groupnorm``, ``causal_conv1d``,
``causal_conv1d_step``) with the JAX reference, on the same numpy inputs.

Parameters are the reference's, drawn by its init and then perturbed with
numpy (its zero-initialised LoRA B matrices, biases and decay LoRA would
otherwise leave those paths untested), carried across by
``interop.from_reference``.  Tolerance: 1e-4 of the scale (1e-4 x max(1,
max |want|)) at f32 compute.  The WKV recurrence grows with S: its outputs
reach ~25 here, and the two packages sum in other orders.  ``rglru`` is a
log-depth scan in the port and ``lax.associative_scan`` in the
reference: the same combine in another order, equal within f32 rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import init as jinit
from repro.nn import layers as jlayers
from repro.nn import ssm as jssm
from repro_torch import interop
from repro_torch.nn import layers, ssm

TOL = 1e-4


def _close(got: torch.Tensor, want):
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=TOL * max(1.0, float(np.abs(want).max())), rtol=0)


def _params(spec, seed: int, scale: float = 0.1):
    """The reference's parameters of ``spec`` plus numpy noise: (jax tree,
    port tree)."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(lambda a: np.asarray(a) + scale * rng.normal(size=a.shape)
                        .astype(np.float32),
                        jinit.materialize(spec, jax.random.PRNGKey(seed)))
    return jax.tree.map(jnp.asarray, tree), interop.from_reference(tree, "cpu")


def _wkv_inputs(b=2, s=13, h=3, hd=8, seed=0):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, s, h, hd)).astype(np.float32) for _ in range(3))
    logw = -np.exp(rng.normal(-1.0, 0.5, size=(b, s, h, hd))).astype(np.float32)
    u = rng.normal(size=(h, hd)).astype(np.float32)
    state = rng.normal(size=(b, h, hd, hd)).astype(np.float32)
    return (r, k, v, logw, u), state


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("fn", ["wkv6_scan", "wkv6_chunked"])
def test_wkv6_against_reference(fn, with_state):
    """S = 13 against a chunk of 4 (the last chunk padded); the output and
    the final state."""
    args, state = _wkv_inputs()
    kw = {"chunk": 4} if fn == "wkv6_chunked" else {}
    want_out, want_state = getattr(jssm, fn)(
        *map(jnp.asarray, args), jnp.asarray(state) if with_state else None, **kw)
    out, st = getattr(ssm, fn)(*map(torch.from_numpy, args),
                               torch.from_numpy(state) if with_state else None, **kw)
    _close(out, want_out)
    _close(st, want_state)


@pytest.mark.parametrize("chunk", [1, 4, 5, 16])
def test_wkv6_chunked_equals_scan(chunk):
    """The chunked form against the port's own token scan, with an initial
    state, at chunks that do and do not divide S = 13 (16 > S: one padded
    chunk)."""
    args, state = _wkv_inputs(seed=1)
    t = [torch.from_numpy(a) for a in args]
    want = ssm.wkv6_scan(*t, torch.from_numpy(state))
    got = ssm.wkv6_chunked(*t, torch.from_numpy(state), chunk=chunk)
    for g, w in zip(got, want):
        _close(g, w.numpy())


def test_wkv6_chunked_clamps_large_decays():
    """Decays past LOG_CLAMP within a chunk: the clamp is the reference's."""
    args, state = _wkv_inputs(seed=2)
    args = (*args[:3], args[3] * 40.0, args[4])
    want = jssm.wkv6_chunked(*map(jnp.asarray, args), jnp.asarray(state), chunk=8)
    got = ssm.wkv6_chunked(*map(torch.from_numpy, args), torch.from_numpy(state),
                           chunk=8)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("impl", ["scan", "chunked"])
def test_timemix_against_reference(impl):
    jcfg = jssm.RWKV6Config(32, head_dim=8, shift_lora=4, decay_lora=6, chunk=4,
                            impl=impl)
    cfg = ssm.RWKV6Config(32, head_dim=8, shift_lora=4, decay_lora=6, chunk=4,
                          impl=impl)
    jp, p = _params(jssm.timemix_spec(jcfg), seed=3)
    x = np.random.default_rng(4).normal(size=(2, 11, 32)).astype(np.float32)
    want = jssm.timemix(jp, jcfg, jnp.asarray(x), jnp.float32)
    _close(ssm.timemix(p, cfg, torch.from_numpy(x), torch.float32), want)


def test_timemix_step_against_reference():
    """Three decode steps from a carried state; the state's x_prev stays
    bf16 in both packages."""
    jcfg, cfg = jssm.RWKV6Config(32, head_dim=8), ssm.RWKV6Config(32, head_dim=8)
    jp, p = _params(jssm.timemix_spec(jcfg), seed=5)
    rng = np.random.default_rng(6)
    wkv = rng.normal(size=(2, 4, 8, 8)).astype(np.float32)
    x_prev = rng.normal(size=(2, 32)).astype(np.float32)
    jstate = {"wkv": jnp.asarray(wkv), "x_prev": jnp.asarray(x_prev, jnp.bfloat16)}
    state = {"wkv": torch.from_numpy(wkv),
             "x_prev": torch.from_numpy(x_prev).bfloat16()}
    shapes = ssm.timemix_state_shape(cfg, 2)
    assert {k: (tuple(t.shape), t.dtype) for k, t in shapes.items()} == \
        {k: (tuple(t.shape), t.dtype) for k, t in state.items()}
    for step in range(3):
        x_t = rng.normal(size=(2, 32)).astype(np.float32)
        jstate, want = jssm.timemix_step(jp, jcfg, jstate, jnp.asarray(x_t), jnp.float32)
        state, got = ssm.timemix_step(p, cfg, state, torch.from_numpy(x_t), torch.float32)
        _close(got, want)
        _close(state["wkv"], jstate["wkv"])
        assert state["x_prev"].dtype == torch.bfloat16
        _close(state["x_prev"], jstate["x_prev"].astype(jnp.float32))


@pytest.mark.parametrize("with_prev", [False, True])
def test_channelmix_against_reference(with_prev):
    jp, p = _params(jssm.channelmix_spec(16, 40), seed=7)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(3, 5, 16)).astype(np.float32)
    prev = rng.normal(size=(3, 16)).astype(np.float32) if with_prev else None
    want = jssm.channelmix(jp, jnp.asarray(x), None if prev is None else jnp.asarray(prev),
                           compute_dtype=jnp.float32)
    got = ssm.channelmix(p, torch.from_numpy(x),
                         None if prev is None else torch.from_numpy(prev),
                         compute_dtype=torch.float32)
    _close(got, want)


@pytest.mark.parametrize("s", [1, 7, 33])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_against_reference(s, with_h0):
    """The log-depth scan against ``lax.associative_scan``, ``h0`` folded
    into the first element; f32 within 1e-4 of the scale."""
    jcfg, cfg = jssm.RGLRUConfig(24), ssm.RGLRUConfig(24)
    jp, p = _params(jssm.rglru_spec(jcfg), seed=9)
    rng = np.random.default_rng(10 + s)
    x = rng.normal(size=(2, s, 24)).astype(np.float32)
    h0 = rng.normal(size=(2, 24)).astype(np.float32) if with_h0 else None
    want_h, want_last = jssm.rglru(jp, jcfg, jnp.asarray(x),
                                   None if h0 is None else jnp.asarray(h0))
    got_h, got_last = ssm.rglru(p, cfg, torch.from_numpy(x),
                                None if h0 is None else torch.from_numpy(h0))
    _close(got_h, want_h)
    _close(got_last, want_last)


def test_rglru_step_continues_the_scan():
    """``rglru_step`` against the reference's step, and ``rglru`` over S
    tokens equal to S steps from h0."""
    jcfg, cfg = jssm.RGLRUConfig(24), ssm.RGLRUConfig(24)
    jp, p = _params(jssm.rglru_spec(jcfg), seed=11)
    rng = np.random.default_rng(12)
    x = rng.normal(size=(2, 6, 24)).astype(np.float32)
    h = rng.normal(size=(2, 24)).astype(np.float32)
    jh, th = jnp.asarray(h), torch.from_numpy(h)
    outs = []
    for t in range(6):
        jh, want = jssm.rglru_step(jp, jcfg, jh, jnp.asarray(x[:, t]))
        th, got = ssm.rglru_step(p, cfg, th, torch.from_numpy(x[:, t]))
        _close(got, want)
        _close(th, jh)
        outs.append(got)
    seq, last = ssm.rglru(p, cfg, torch.from_numpy(x), torch.from_numpy(h))
    _close(seq, torch.stack(outs, 1).numpy())
    _close(last, th.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv1d_against_reference(dtype):
    """The K shifted products summed in the reference's order: equal at
    f32 within 1e-4, and bit for bit at bf16."""
    jp, p = _params(jlayers.conv1d_spec(12, 4), seed=13, scale=0.3)
    x = np.random.default_rng(14).normal(size=(2, 9, 12)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jlayers.causal_conv1d(jp, jnp.asarray(x, jdt), jdt)
    got = layers.causal_conv1d(p, torch.from_numpy(x).to(tdt), tdt)
    assert got.dtype == tdt
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))
    else:
        _close(got, want)


def test_causal_conv1d_step_continues_the_conv():
    jp, p = _params(jlayers.conv1d_spec(12, 4), seed=15, scale=0.3)
    rng = np.random.default_rng(16)
    x = rng.normal(size=(2, 7, 12)).astype(np.float32)
    jst = jnp.zeros((2, 3, 12), jnp.float32)
    st = torch.zeros(2, 3, 12)
    outs = []
    for t in range(7):
        jst, want = jlayers.causal_conv1d_step(jp, jst, jnp.asarray(x[:, t]))
        st, got = layers.causal_conv1d_step(p, st, torch.from_numpy(x[:, t]))
        _close(got, want)
        _close(st, jst)
        outs.append(got)
    full = layers.causal_conv1d(p, torch.from_numpy(x), torch.float32)
    _close(torch.stack(outs, 1), full.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_groupnorm_against_reference(dtype):
    rng = np.random.default_rng(17)
    x = (3.0 * rng.normal(size=(2, 5, 24)) + 1.0).astype(np.float32)
    scale, bias = (rng.normal(size=(24,)).astype(np.float32) for _ in "sb")
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jlayers.groupnorm(jnp.asarray(x, jdt), 4, jnp.asarray(scale), jnp.asarray(bias))
    got = layers.groupnorm(torch.from_numpy(x).to(tdt), 4, torch.from_numpy(scale),
                           torch.from_numpy(bias))
    assert got.dtype == tdt
    if dtype == "bfloat16":  # one bf16 step of the value
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                                   atol=1e-2, rtol=2 ** -7)
    else:
        _close(got, want)


@pytest.mark.parametrize("stacked", [False, True])
def test_interop_leaves_conv1d_weights_alone(stacked):
    """``conv1d_spec``'s ``w`` is (K, D), or (reps, K, D) stacked: no 4-D
    leaf under ``w``, so ``from_reference`` carries it across unpermuted."""
    w = np.arange(2 * 4 * 6, dtype=np.float32).reshape(2, 4, 6)
    tree = {"conv": {"w": w if stacked else w[0], "b": np.zeros(6, np.float32)}}
    got = interop.from_reference(tree, "cpu")["conv"]["w"]
    np.testing.assert_array_equal(got.numpy(), tree["conv"]["w"])
