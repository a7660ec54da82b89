"""Parity of the port's RWKV-6 LM (``repro_torch.models.rwkv6``, arch
rwkv6-7b) with the JAX reference.

The smoke arch (2 layers, d 64, heads of 16, chunk 8) with the
reference's parameters carried across (its zero-initialised LoRA B and
decay matrices perturbed with numpy, so those paths count): the
full-context forward (``prefill_fn``, both WKV impls) within 1e-4 at f32
compute and, at the arch's own bf16, within 3e-2 of the logits' scale
(3e-2 x max(1, max |logit|)); ``decode_step`` token by token within 1e-4
at f32 from the reference's state of each step (both packages keep the
token-shift carries in bf16, so a free-running scan is held at the bf16
tolerance, as is the decode against the forward).  At published width:
the config field for field, the parameter tree's shapes and the state's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import base as jbase
from repro.models import rwkv6 as jrwkv
from repro.nn import init as jinit
from repro_torch import interop
from repro_torch.common.tree import tree_map
from repro_torch.configs import ARCHS, get_arch
from repro_torch.configs import base as cbase
from repro_torch.models import rwkv6
from repro_torch.nn import init as nninit

ARCH = "rwkv6-7b"
TOL = {"float32": 1e-4, "bfloat16": 3e-2}  # bf16: of the logits' scale


def _cfgs(dtype: str, **kw):
    jcfg, cfg = JARCHS[ARCH].make_smoke(), ARCHS[ARCH].make_smoke()
    if dtype == "float32":
        jcfg = dataclasses.replace(jcfg, compute_dtype=jnp.float32)
        cfg = dataclasses.replace(cfg, compute_dtype=torch.float32)
    return dataclasses.replace(jcfg, **kw), dataclasses.replace(cfg, **kw)


@pytest.fixture(scope="module")
def params():
    jarch = JARCHS[ARCH]
    rng = np.random.default_rng(0)
    tree = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32),
        jinit.materialize(jbase.model_spec(jarch, jarch.make_smoke()),
                          jax.random.PRNGKey(30)))
    return jax.tree.map(jnp.asarray, tree), interop.from_reference(tree, "cpu")


def _close(got: torch.Tensor, want, dtype: str):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert tuple(got.shape) == want.shape
    atol = TOL[dtype] * (1.0 if dtype == "float32" else max(1.0, np.abs(want).max()))
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=0)


def _tokens(b: int, s: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(np.int32)


def test_config_and_spec_equal_the_reference():
    arch, jarch = get_arch(ARCH), JARCHS[ARCH]
    assert (arch.family, arch.kind, arch.supports_long, arch.fsdp, arch.opt_8bit,
            arch.note, arch.source) == (jarch.family, jarch.kind, jarch.supports_long,
                                        jarch.fsdp, jarch.opt_8bit, jarch.note,
                                        jarch.source)
    for make in ("make_full", "make_smoke"):
        c, jc = getattr(arch, make)(), getattr(jarch, make)()
        fields = {f.name for f in dataclasses.fields(c)} - {"param_dtype", "compute_dtype"}
        assert {f: getattr(c, f) for f in fields} == {f: getattr(jc, f) for f in fields}
        assert dataclasses.asdict(c.tm()) == dataclasses.asdict(jc.tm())
        got = nninit.shapes(cbase.model_spec(arch, c))
        want = jinit.shapes(jbase.model_spec(jarch, jc))
        assert jax.tree.structure(jax.tree.map(lambda t: 0, got)) == \
            jax.tree.structure(jax.tree.map(lambda s: 0, want))
        assert [tuple(t.shape) for t in jax.tree.leaves(got)] == \
            [s.shape for s in jax.tree.leaves(want)]
        shapes = rwkv6.state_shapes(c, 3)
        jshapes = jrwkv.state_shapes(jc, 3)
        for k in jshapes:
            assert tuple(shapes[k].shape) == jshapes[k].shape
            assert str(shapes[k].dtype).split(".")[-1] == jnp.dtype(jshapes[k].dtype).name
    full = jbase.model_spec(jarch, jarch.make_full())
    assert cbase.param_count(arch, arch.make_full()) == \
        sum(int(np.prod(s.shape)) for s in jax.tree.leaves(jinit.shapes(full)))


@pytest.mark.parametrize("impl", ["scan", "chunked"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_fn_logits(params, impl, dtype):
    """Last-token logits of the full-context forward at S = 21 (not a
    multiple of the chunk of 8)."""
    jp, p = params
    jcfg, cfg = _cfgs(dtype, impl=impl)
    toks = _tokens(2, 21, seed=1)
    want = jbase.prefill_fn(JARCHS[ARCH], jcfg)(jp, jnp.asarray(toks))
    got = cbase.prefill_fn(ARCHS[ARCH], cfg)(p, torch.from_numpy(toks).long())
    _close(got, want, dtype)
    hidden = rwkv6.forward(p, cfg, torch.from_numpy(toks).long())
    _close(hidden, jrwkv.forward(jp, jcfg, jnp.asarray(toks)), dtype)


def _state_from(jst):
    """The port's copy of a reference state (bf16 carries stay bf16), in
    memory of its own: the port writes its state in place."""
    return {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
        torch.float32 if v.dtype == jnp.float32 else torch.bfloat16)
        for k, v in jst.items()}


def test_decode_step_from_the_reference_state(params):
    """At f32 compute, 12 tokens each stepped from the reference's state of
    the step before: the logits and the WKV state within 1e-4, the bf16
    token-shift carries within one bf16 step (an f32 value of either
    package may round to the neighbouring bf16 value, and a free-running
    scan then carries that difference on; the bf16 test below runs free)."""
    jp, p = params
    jcfg, cfg = _cfgs("float32")
    toks = _tokens(3, 12, seed=2)
    jstep = jax.jit(lambda p_, st, tok, pos: jrwkv.decode_step(p_, jcfg, st, tok, pos))
    jst = jrwkv.init_state(jcfg, 3)
    for t in range(toks.shape[1]):
        st = _state_from(jst)
        jst, want = jstep(jp, jst, jnp.asarray(toks[:, t]), jnp.int32(t))
        st, got = rwkv6.decode_step(p, cfg, st, torch.from_numpy(toks[:, t]).long(),
                                    torch.full((3,), t))
        _close(got, want, "float32")
        _close(st["wkv"], jst["wkv"], "float32")
        for k in ("tm_x", "cm_x"):
            assert st[k].dtype == torch.bfloat16
            np.testing.assert_allclose(st[k].float().numpy(),
                                       np.asarray(jst[k].astype(jnp.float32)),
                                       atol=TOL["float32"], rtol=2 ** -7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_scan_against_reference_and_forward(params, dtype):
    """12 tokens through ``decode_step`` from a zeroed state, each package
    on its own state: the logits at every step and the last state within
    3e-2 of the scale at either compute dtype (the carries are bf16 in
    both); the last step's logits within that of the full-context
    forward's."""
    jp, p = params
    jcfg, cfg = _cfgs(dtype)
    toks = _tokens(3, 12, seed=2)
    jstep = jax.jit(lambda p_, st, tok, pos: jrwkv.decode_step(p_, jcfg, st, tok, pos))
    jst = jrwkv.init_state(jcfg, 3)
    st = rwkv6.init_state(cfg, 3, device="cpu")
    for t in range(toks.shape[1]):
        jst, want = jstep(jp, jst, jnp.asarray(toks[:, t]), jnp.int32(t))
        st, got = rwkv6.decode_step(p, cfg, st, torch.from_numpy(toks[:, t]).long(),
                                    torch.full((3,), t))
        _close(got, want, "bfloat16")
    for k in ("wkv", "tm_x", "cm_x"):
        _close(st[k], jst[k], "bfloat16")
    fwd = cbase.prefill_fn(ARCHS[ARCH], cfg)(p, torch.from_numpy(toks).long())
    _close(got, np.asarray(fwd.float()), "bfloat16")


def test_decode_with_f32_state_equals_the_forward(params):
    """At f32 compute, with the token-shift carries in f32 (bf16 as
    allocated, as in the reference), 21 tokens through ``decode_step`` give
    the full-context forward's logits at every position within 1e-4, and
    the carries stay f32: the step computes the forward's function, and
    only the bf16 carries part the two otherwise (``chip_smoke.py`` holds
    the decode so at full width)."""
    _, p = params
    _, cfg = _cfgs("float32")
    toks = torch.from_numpy(_tokens(2, 21, seed=5)).long()
    st = tree_map(lambda t: t.float(), rwkv6.init_state(cfg, 2, device="cpu"))
    got = []
    for t in range(toks.shape[1]):
        st, lg = rwkv6.decode_step(p, cfg, st, toks[:, t], None)
        got.append(lg)
    assert st["tm_x"].dtype == st["cm_x"].dtype == torch.float32
    want = rwkv6.logits(p, cfg, rwkv6.forward(p, cfg, toks))
    np.testing.assert_allclose(torch.stack(got, 1).numpy(), want.numpy(),
                               atol=TOL["float32"], rtol=0)
