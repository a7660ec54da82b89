"""Parity of the port's VLM backbone (``repro_torch.models.vlm``, arch
internvl2-26b) with the JAX reference.

The smoke arch (2 layers, d 64, 4 heads and 2 KV heads of 16, an untied
head, 16 image tokens) with the reference's parameters carried across:
the forward over [patch embeddings ‖ text embeddings] (the ``lm`` body,
one ``flash_attn`` call per layer) and ``prefill_fn`` on
``{"patch_embeds", "tokens"}``, within 1e-4 at f32 compute and 3e-2 of
the logits' scale (3e-2 x max(1, max |logit|)) at bf16; ``decode_step``
(the ``lm`` decoder's) on f32 caches within 1e-4.  ``serve_fns`` raises
for the kind, as the reference's does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import base as jbase
from repro.models import vlm as jvlm
from repro.nn import init as jinit
from repro_torch import interop
from repro_torch.backend import registry
from repro_torch.configs import ARCHS, get_arch
from repro_torch.configs import base as cbase
from repro_torch.models import vlm
from repro_torch.nn import init as nninit

ARCH = "internvl2-26b"
TOL = {"float32": 1e-4, "bfloat16": 3e-2}  # bf16: of the logits' scale


def _cfgs(dtype: str):
    jcfg, cfg = JARCHS[ARCH].make_smoke(), ARCHS[ARCH].make_smoke()
    if dtype == "float32":
        jcfg = dataclasses.replace(jcfg, lm=dataclasses.replace(
            jcfg.lm, compute_dtype=jnp.float32))
        cfg = dataclasses.replace(cfg, lm=dataclasses.replace(
            cfg.lm, compute_dtype=torch.float32))
    return jcfg, cfg


@pytest.fixture(scope="module")
def params():
    jarch = JARCHS[ARCH]
    jp = jinit.materialize(jbase.model_spec(jarch, jarch.make_smoke()),
                           jax.random.PRNGKey(50))
    return jp, interop.from_reference(jax.tree.map(np.asarray, jp), "cpu")


def _close(got: torch.Tensor, want, dtype: str):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert tuple(got.shape) == want.shape
    atol = TOL[dtype] * (1.0 if dtype == "float32" else max(1.0, np.abs(want).max()))
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=0)


def _inputs(b: int, s: int, seed: int):
    rng = np.random.default_rng(seed)
    patches = rng.normal(size=(b, 16, 64)).astype(np.float32)
    return patches, rng.integers(0, 256, (b, s)).astype(np.int32)


def test_config_and_spec_equal_the_reference():
    arch, jarch = get_arch(ARCH), JARCHS[ARCH]
    assert (arch.family, arch.kind, arch.supports_long, arch.fsdp, arch.opt_8bit,
            arch.note, arch.source) == (jarch.family, jarch.kind, jarch.supports_long,
                                        jarch.fsdp, jarch.opt_8bit, jarch.note,
                                        jarch.source)
    for make in ("make_full", "make_smoke"):
        c, jc = getattr(arch, make)(), getattr(jarch, make)()
        assert c.n_img_tokens == jc.n_img_tokens
        fields = {f.name for f in dataclasses.fields(c.lm)} - {
            "param_dtype", "compute_dtype", "mla", "moe"}
        assert {f: getattr(c.lm, f) for f in fields} == \
            {f: getattr(jc.lm, f) for f in fields}
        got = nninit.shapes(cbase.model_spec(arch, c))
        want = jinit.shapes(jbase.model_spec(jarch, jc))
        assert [tuple(t.shape) for t in jax.tree.leaves(got)] == \
            [s.shape for s in jax.tree.leaves(want)]
    with pytest.raises(NotImplementedError, match="non-token inputs"):
        cbase.serve_fns(arch, arch.make_smoke(), max_len=32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_prefill_fn(params, dtype):
    """16 patch embeddings and 21 tokens: the hidden states at every
    position, the aux loss (0.0), and ``prefill_fn``'s last-token logits
    through one flash_attn call per layer."""
    jp, p = params
    jcfg, cfg = _cfgs(dtype)
    patches, toks = _inputs(2, 21, seed=1)
    jh, jaux = jvlm.forward(jp, jcfg, jnp.asarray(patches), jnp.asarray(toks))
    h, aux = vlm.forward(p, cfg, torch.from_numpy(patches), torch.from_numpy(toks).long())
    assert aux == 0.0 and float(jaux) == 0.0
    assert tuple(h.shape) == (2, 16 + 21, 64)
    _close(h, jh, dtype)
    want = jbase.prefill_fn(JARCHS[ARCH], jcfg)(
        jp, {"patch_embeds": jnp.asarray(patches), "tokens": jnp.asarray(toks)})
    with registry.record_kernels() as rec:
        got = cbase.prefill_fn(ARCHS[ARCH], cfg)(
            p, {"patch_embeds": torch.from_numpy(patches),
                "tokens": torch.from_numpy(toks).long()})
    assert rec == [("flash_attn", "kernel")] * cfg.lm.n_layers
    assert got.dtype == cfg.lm.compute_dtype
    _close(got, want, dtype)


def test_decode_step_delegates_to_the_lm(params):
    """Eight decode steps on f32 caches, f32 compute: the logits within
    1e-4 of the reference's at every step."""
    jp, p = params
    jcfg, cfg = _cfgs("float32")
    _, toks = _inputs(2, 8, seed=2)
    shapes = vlm.cache_shapes(cfg, 2, 32)
    jshapes = jvlm.cache_shapes(jcfg, 2, 32)
    assert [tuple(t.shape) for t in jax.tree.leaves(shapes)] == \
        [s.shape for s in jax.tree.leaves(jshapes)]
    jc = jax.tree.map(lambda s: jnp.zeros(s.shape, jnp.float32), jshapes)
    caches = jax.tree.map(lambda t: torch.zeros(t.shape), shapes)
    assert all(not bool(t.any()) for t in jax.tree.leaves(
        vlm.init_caches(cfg, 2, 32, device="cpu")))
    for t in range(toks.shape[1]):
        jc, want = jvlm.decode_step(jp, jcfg, jc, jnp.asarray(toks[:, t]), jnp.int32(t))
        caches, got = vlm.decode_step(p, cfg, caches, torch.from_numpy(toks[:, t]).long(), t)
        _close(got, want, "float32")
