"""Parity of the port's LM layers (``repro_torch.nn.layers``), its spec
system (``repro_torch.nn.init``) and ``interop`` on LM parameter trees with
the JAX reference.

The same numpy inputs go through both packages; kernel-free layers agree
within 1e-5 absolute at f32 (sums taken in another order, ``tanh`` / ``cos``
/ ``sin`` / ``rsqrt`` of two libraries).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import base as jbase
from repro.nn import init as jinit
from repro.nn import layers as jlayers
from repro_torch import interop
from repro_torch.configs import ARCHS
from repro_torch.configs import base as cbase
from repro_torch.nn import init as nninit
from repro_torch.nn import layers

ATOL = 1e-5
DENSE_ARCHS = ("llama3.2-3b", "stablelm-3b", "gemma3-12b", "starcoder2-3b")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got: torch.Tensor, want, atol=ATOL):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                               atol=atol, rtol=0)


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(0)


def test_embedding_and_tied_logits(rng):
    table = rng.standard_normal((50, 16)).astype(np.float32)
    ids = rng.integers(0, 50, (3, 7)).astype(np.int32)
    x = rng.standard_normal((3, 7, 16)).astype(np.float32)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = jlayers.embedding({"table": jnp.asarray(table)}, jnp.asarray(ids), jdt)
        got = layers.embedding({"table": _t(table)}, _t(ids).long(), tdt)
        assert got.dtype == tdt
        assert np.array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    want = jlayers.logits({"table": jnp.asarray(table)}, jnp.asarray(x), jnp.float32)
    _close(layers.logits({"table": _t(table)}, _t(x), torch.float32), want)


@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_rmsnorm_with_offset(rng, offset):
    x = rng.standard_normal((4, 5, 32)).astype(np.float32) * 3
    scale = rng.standard_normal(32).astype(np.float32)
    want = jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), offset=offset)
    _close(layers.rmsnorm({"scale": _t(scale)}, _t(x), offset=offset), want)


def test_layernorm(rng):
    x = rng.standard_normal((4, 5, 32)).astype(np.float32) * 2 + 1
    p = {"scale": rng.standard_normal(32).astype(np.float32),
         "bias": rng.standard_normal(32).astype(np.float32)}
    want = jlayers.layernorm(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    _close(layers.layernorm({k: _t(v) for k, v in p.items()}, _t(x)), want)


@pytest.mark.parametrize("rotary_dim", [None, 4])
@pytest.mark.parametrize("base", [10000.0, 500000.0])
def test_rope_rotate_half_and_partial(rng, rotary_dim, base):
    """Full and partial (stablelm's 25%) rotary, positions as a vector and
    as per-slot (B, 1) decode positions."""
    x = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    pos = np.arange(9, dtype=np.int32) + 40
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), base, rotary_dim)
    _close(layers.apply_rope(_t(x), _t(pos), base, rotary_dim), want)
    xs = x[:, :1]
    slots = np.array([[3], [61]], np.int32)
    want = jlayers.apply_rope(jnp.asarray(xs), jnp.asarray(slots), base, rotary_dim)
    _close(layers.apply_rope(_t(xs), _t(slots), base, rotary_dim), want)


def test_activations(rng):
    """GELU is the tanh form (``jax.nn.gelu``'s default), in ``mlp`` and
    ``geglu`` alike."""
    g = rng.standard_normal((6, 40)).astype(np.float32) * 3
    u = rng.standard_normal((6, 40)).astype(np.float32)
    _close(layers.swiglu(_t(g), _t(u)), jlayers.swiglu(jnp.asarray(g), jnp.asarray(u)))
    _close(layers.geglu(_t(g), _t(u)), jlayers.geglu(jnp.asarray(g), jnp.asarray(u)))
    _close(layers.relu_sq(_t(g)), jlayers.relu_sq(jnp.asarray(g)))
    _close(layers.gelu(_t(g)), jax.nn.gelu(jnp.asarray(g)))
    exact = torch.nn.functional.gelu(_t(g))
    assert float((exact - layers.gelu(_t(g))).abs().max()) > ATOL


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu", "gelu_bias"])
def test_mlp_blocks(kind):
    d, f = 24, 40
    if kind in ("swiglu", "geglu"):
        jspec = jlayers.glu_mlp_spec(d, f)
        spec = layers.glu_mlp_spec(d, f)
    else:
        jspec = jlayers.mlp_spec(d, f, bias=kind == "gelu_bias")
        spec = layers.mlp_spec(d, f, bias=kind == "gelu_bias")
    jp = jinit.materialize(jspec, jax.random.PRNGKey(3))
    if kind == "gelu_bias":  # zeros by init: give the biases values
        jp = jax.tree.map(lambda a: a + 0.1 if a.ndim == 1 else a, jp)
    p = interop.from_reference(_np(jp), device="cpu")
    assert jax.tree.structure(nninit.shapes(spec)) == jax.tree.structure(jp)
    x = np.random.default_rng(4).standard_normal((2, 5, d)).astype(np.float32)
    if kind in ("swiglu", "geglu"):
        jact = getattr(jlayers, kind)
        want = jlayers.glu_mlp(jp, jnp.asarray(x), jact, jnp.float32)
        got = layers.glu_mlp(p, _t(x), getattr(layers, kind), torch.float32)
    else:
        want = jlayers.mlp(jp, jnp.asarray(x), jax.nn.gelu, jnp.float32)
        got = layers.mlp(p, _t(x), layers.gelu, torch.float32)
    _close(got, want)


@pytest.mark.parametrize("arch_id", DENSE_ARCHS)
@pytest.mark.parametrize("full", [False, True])
def test_lm_spec_counts_shapes_and_init_rules(arch_id, full):
    """The port's spec tree equals the reference's leaf for leaf (shape,
    init, scale, dtype), at smoke and published width (specs only, nothing
    drawn at full width)."""
    jarch, arch = JARCHS[arch_id], ARCHS[arch_id]
    jcfg = jarch.make_full() if full else jarch.make_smoke()
    cfg = arch.make_full() if full else arch.make_smoke()
    jspec, spec = jbase.model_spec(jarch, jcfg), cbase.model_spec(arch, cfg)
    jleaves, jdef = jax.tree.flatten(jspec, is_leaf=lambda x: isinstance(x, jinit.P))
    leaves, pdef = jax.tree.flatten(spec, is_leaf=lambda x: isinstance(x, nninit.P))
    assert jdef == pdef
    for a, b in zip(jleaves, leaves):
        assert (a.shape, a.axes, a.init, a.scale, a.constant) == \
            (b.shape, b.axes, b.init, b.scale, b.constant)
        assert np.dtype(a.dtype).itemsize == b.dtype.itemsize
    assert cbase.param_count(arch, cfg) == jbase.param_count(jarch, jcfg)
    assert cbase.active_param_count(arch, cfg) == jbase.active_param_count(jarch, jcfg)
    assert nninit.param_bytes(spec) == jinit.param_bytes(jspec)
    shapes = jax.tree.leaves(nninit.shapes(spec))
    assert all(t.device.type == "meta" for t in shapes)
    assert [tuple(t.shape) for t in shapes] == [tuple(a.shape) for a in jleaves]


def test_materialize_follows_init_rules_on_the_generators_device():
    """Drawn on the generator's device, reproducible from the seed, with the
    reference's rules: ones / zeros exact, normal std = scale or
    1/sqrt(fan_in)."""
    arch = ARCHS["llama3.2-3b"]
    cfg = dataclasses.replace(arch.make_smoke(), d_model=256, d_ff=512, vocab=512)
    spec = cbase.model_spec(arch, cfg)
    a = nninit.materialize(spec, torch.Generator("cpu").manual_seed(5))
    b = nninit.materialize(spec, torch.Generator("cpu").manual_seed(5))
    assert all(torch.equal(x, y) for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))
    body = a["body"]["u0"]
    assert torch.equal(body["ln1"]["scale"], torch.ones(2, 256))
    assert body["attn"]["wq"].device.type == "cpu"
    assert abs(float(a["embed"]["table"].std()) - 0.02) < 1e-3
    assert abs(float(body["attn"]["wq"].std()) - 256 ** -0.5) < 2e-3
    # fan_in of a stacked leaf counts the layer axis, as in the reference
    assert abs(float(body["ffn"]["down"]["w"].std()) - (2 * 512) ** -0.5) < 2e-3


@pytest.mark.parametrize("arch_id", DENSE_ARCHS)
def test_interop_carries_lm_params_exactly(arch_id):
    """``from_reference`` on an LM tree converts the dtype only: stacked
    dense ``w`` leaves are 3-D and the 4-D ``wq``/``wk``/``wv``/``wo`` are
    not under ``"w"``, so no leaf is permuted as an HWIO kernel."""
    jarch = JARCHS[arch_id]
    jp = _np(jinit.materialize(jbase.model_spec(jarch, jarch.make_smoke()),
                               jax.random.PRNGKey(2)))
    p = interop.from_reference(jp, device="cpu")
    jl, jdef = jax.tree.flatten(jp)
    pl, pdef = jax.tree.flatten(p)
    assert jdef == pdef
    assert any(x.ndim == 4 for x in jl)
    for a, b in zip(jl, pl):
        assert b.dtype == torch.float32 and tuple(b.shape) == a.shape
        assert np.array_equal(b.numpy(), a)
