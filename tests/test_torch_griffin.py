"""Parity of the port's Griffin LM (``repro_torch.models.griffin``, arch
recurrentgemma-9b) with the JAX reference.

The smoke arch (d 64, 4 heads and one KV head of 16, window 16), at its
3 layers (one (rec, rec, attn) unit) and at 5 (a unit and a (rec, rec)
tail), with the reference's parameters carried across (biases and other
zero-initialised leaves perturbed with numpy): the full-context forward
(``prefill_fn``) past the window within 1e-4 at f32 compute and, at bf16,
within 3e-2 of the logits' scale (3e-2 x max(1, max |logit|)); and
``decode_step`` for 24 tokens, so the attention layers' ring caches wrap
past the window of 16: within 1e-4 at f32 from the reference's state of
each step (the conv carries and the KV rings are bf16 in both packages,
so a free-running scan is held at the bf16 tolerance, as is the decode
against the forward).  At published width: the config field for field,
the parameter tree's shapes and the state's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import base as jbase
from repro.models import griffin as jgriffin
from repro.nn import init as jinit
from repro_torch import interop
from repro_torch.common.tree import tree_map
from repro_torch.configs import ARCHS, get_arch
from repro_torch.configs import base as cbase
from repro_torch.models import griffin
from repro_torch.nn import init as nninit

ARCH = "recurrentgemma-9b"
TOL = {"float32": 1e-4, "bfloat16": 3e-2}  # bf16: of the logits' scale
STEPS = 24              # past the smoke window of 16


def _cfgs(dtype: str, n_layers: int):
    jcfg = dataclasses.replace(JARCHS[ARCH].make_smoke(), n_layers=n_layers)
    cfg = dataclasses.replace(ARCHS[ARCH].make_smoke(), n_layers=n_layers)
    if dtype == "float32":
        jcfg = dataclasses.replace(jcfg, compute_dtype=jnp.float32)
        cfg = dataclasses.replace(cfg, compute_dtype=torch.float32)
    return jcfg, cfg


@pytest.fixture(scope="module")
def params():
    """Per depth (3, 5): the reference's parameters plus noise, and the
    port's copy."""
    out = {}
    for n in (3, 5):
        jcfg, _ = _cfgs("bfloat16", n)
        rng = np.random.default_rng(n)
        tree = jax.tree.map(
            lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32),
            jinit.materialize(jbase.model_spec(JARCHS[ARCH], jcfg),
                              jax.random.PRNGKey(40 + n)))
        out[n] = (jax.tree.map(jnp.asarray, tree), interop.from_reference(tree, "cpu"))
    return out


def _close(got: torch.Tensor, want, dtype: str):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert tuple(got.shape) == want.shape
    atol = TOL[dtype] * (1.0 if dtype == "float32" else max(1.0, np.abs(want).max()))
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=0)


def _tokens(b: int, s: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(np.int32)


def _state_from(jst):
    """The port's copy of a reference state, in memory of its own (the
    port writes its state in place), bf16 leaves kept bf16."""
    return jax.tree.map(lambda v: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
        torch.float32 if v.dtype == jnp.float32 else torch.bfloat16), jst)


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
        assert c.plan() == jc.plan()
        assert dataclasses.asdict(c.lru()) == dataclasses.asdict(jc.lru())
        got = nninit.shapes(cbase.model_spec(arch, c))
        want = jinit.shapes(jbase.model_spec(jarch, jc))
        assert jax.tree.structure(jax.tree.map(lambda t: 0, got)) == \
            jax.tree.structure(jax.tree.map(lambda s: 0, want))
        assert [tuple(t.shape) for t in jax.tree.leaves(got)] == \
            [s.shape for s in jax.tree.leaves(want)]
        shapes = jax.tree.leaves(griffin.state_shapes(c, 3, 4096))
        jshapes = jax.tree.leaves(jgriffin.state_shapes(jc, 3, 4096))
        assert [(tuple(t.shape), str(t.dtype).split(".")[-1]) for t in shapes] == \
            [(s.shape, jnp.dtype(s.dtype).name) for s in jshapes]
    full = jbase.model_spec(jarch, jarch.make_full())
    assert cbase.param_count(arch, arch.make_full()) == \
        sum(int(np.prod(s.shape)) for s in jax.tree.leaves(jinit.shapes(full)))


@pytest.mark.parametrize("n_layers", [3, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_fn_logits(params, n_layers, dtype):
    """Last-token logits of the full-context forward at S = 21, past the
    window of 16; the hidden states at every position."""
    jp, p = params[n_layers]
    jcfg, cfg = _cfgs(dtype, n_layers)
    toks = _tokens(2, 21, seed=1)
    want = jbase.prefill_fn(JARCHS[ARCH], jcfg)(jp, jnp.asarray(toks))
    got = cbase.prefill_fn(ARCHS[ARCH], cfg)(p, torch.from_numpy(toks).long())
    _close(got, want, dtype)
    hidden = griffin.forward(p, cfg, torch.from_numpy(toks).long())
    _close(hidden, jgriffin.forward(jp, jcfg, jnp.asarray(toks)), dtype)


def test_decode_step_from_the_reference_state(params):
    """At f32 compute, 5 layers, 24 tokens at per-slot positions (one slot
    two tokens behind), each stepped from the reference's state of the step
    before: the logits and the LRU states within 1e-4, the bf16 conv carries
    and KV rings within one bf16 step."""
    jp, p = params[5]
    jcfg, cfg = _cfgs("float32", 5)
    toks = _tokens(3, STEPS, seed=2)
    jstep = jax.jit(lambda p_, st, tok, pos: jgriffin.decode_step(p_, jcfg, st, tok, pos))
    jst = jgriffin.init_state(jcfg, 3, 64)
    for t in range(STEPS):
        pos = np.array([t, t, max(t - 2, 0)], np.int32)
        st = _state_from(jst)
        jst, want = jstep(jp, jst, jnp.asarray(toks[:, t]), jnp.asarray(pos))
        st, got = griffin.decode_step(p, cfg, st, torch.from_numpy(toks[:, t]).long(),
                                      torch.from_numpy(pos).long())
        _close(got, want, "float32")
        for mine, theirs in zip(jax.tree.leaves(st), jax.tree.leaves(jst)):
            if theirs.dtype == jnp.float32:
                _close(mine, theirs, "float32")
            else:
                assert mine.dtype == torch.bfloat16
                np.testing.assert_allclose(mine.float().numpy(),
                                           np.asarray(theirs.astype(jnp.float32)),
                                           atol=TOL["float32"], rtol=2 ** -7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_scan_against_reference_and_forward(params, dtype):
    """24 tokens from a zeroed state, each package on its own state, the
    rings wrapping: the logits at every step within 3e-2 of the scale of the
    reference's, and the last step's within that of the forward's."""
    jp, p = params[3]
    jcfg, cfg = _cfgs(dtype, 3)
    toks = _tokens(2, STEPS, seed=3)
    jstep = jax.jit(lambda p_, st, tok, pos: jgriffin.decode_step(p_, jcfg, st, tok, pos))
    jst = jgriffin.init_state(jcfg, 2, 64)
    st = griffin.init_state(cfg, 2, 64, device="cpu")
    assert st["body"]["u2"]["k"].shape[2] == cfg.window
    for t in range(STEPS):
        jst, want = jstep(jp, jst, jnp.asarray(toks[:, t]), jnp.int32(t))
        st, got = griffin.decode_step(p, cfg, st, torch.from_numpy(toks[:, t]).long(), t)
        _close(got, want, "bfloat16")
    fwd = cbase.prefill_fn(ARCHS[ARCH], cfg)(p, torch.from_numpy(toks).long())
    _close(got, np.asarray(fwd.float()), "bfloat16")


def test_decode_with_f32_state_equals_the_forward(params):
    """At f32 compute, with the decode state cast to f32 (the conv windows
    and the KV rings, bf16 as allocated), 24 tokens through ``decode_step``
    give the full-context forward's logits at every position within 1e-4,
    the rings wrapping past the window: the step computes the forward's
    function, and only the bf16 state parts the two otherwise
    (``chip_smoke.py`` holds the decode so at full width)."""
    _, p = params[3]
    _, cfg = _cfgs("float32", 3)
    toks = torch.from_numpy(_tokens(2, STEPS, seed=5)).long()
    st = tree_map(lambda t: t.float() if t.is_floating_point() else t,
                  griffin.init_state(cfg, 2, 64, device="cpu"))
    got = []
    for t in range(STEPS):
        st, lg = griffin.decode_step(p, cfg, st, toks[:, t], t)
        got.append(lg)
    assert st["body"]["u2"]["k"].dtype == torch.float32
    want = griffin.logits(p, cfg, griffin.forward(p, cfg, toks))
    np.testing.assert_allclose(torch.stack(got, 1).numpy(), want.numpy(),
                               atol=TOL["float32"], rtol=0)
