"""Parity of the port's LM training losses (``configs.base.loss_fn``) with
the JAX reference, on the CPU, and of what they run through: ``flash_mha``
under grad (``_FlashMHA``: the kernel forward, the plain chain's backward)
and ``remat``.

Each arch at ``make_smoke()`` with f32 compute, the reference's parameters
carried across (``interop.from_reference``), one numpy batch of (2, 16)
tokens: the loss within 1e-5 relative of ``jax.value_and_grad`` of the
reference's ``loss_fn`` (jitted: op by op, deepseek-v3's takes 22 s) and
every gradient leaf within 1e-4 of its max |grad| (the NSAI training
tests' bounds; measured on all nine: losses within 8.7e-8 relative, grads
within 4.5e-6 of the scale).  This file holds the four dense archs;
``test_torch_lm_loss_kinds.py`` the MoE, MLA + MTP, recurrent and VLM ones.
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
from repro_torch import interop
from repro_torch.backend import registry
from repro_torch.common.tree import tree_leaves
from repro_torch.configs import ARCHS
from repro_torch.configs import base as cbase
from repro_torch.kernels.flash_attn import ops as flash_ops
from repro_torch.kernels.flash_attn import ref as flash_ref
from repro_torch.models import lm
from repro_torch.nn import init as nninit
from repro_torch.train import optimizer as opt

torch.set_num_threads(2)

LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4
DENSE_ARCHS = ("llama3.2-3b", "stablelm-3b", "gemma3-12b", "starcoder2-3b")


def f32_cfgs(arch_id: str):
    """(reference cfg, port cfg) at ``make_smoke()`` with f32 compute."""
    jcfg, cfg = JARCHS[arch_id].make_smoke(), ARCHS[arch_id].make_smoke()
    if ARCHS[arch_id].kind == "vlm":
        return (dataclasses.replace(jcfg, lm=dataclasses.replace(
                    jcfg.lm, compute_dtype=jnp.float32)),
                dataclasses.replace(cfg, lm=dataclasses.replace(
                    cfg.lm, compute_dtype=torch.float32)))
    return (dataclasses.replace(jcfg, compute_dtype=jnp.float32),
            dataclasses.replace(cfg, compute_dtype=torch.float32))


def smoke_batch(arch_id: str, cfg, seed: int, b: int = 2, s: int = 16) -> dict:
    rng = np.random.default_rng(seed)
    vocab = cfg.lm.vocab if ARCHS[arch_id].kind == "vlm" else cfg.vocab
    batch = {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
             "targets": rng.integers(0, vocab, (b, s)).astype(np.int32)}
    if ARCHS[arch_id].kind == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (b, cfg.n_img_tokens, cfg.lm.d_model)).astype(np.float32)
    return batch


def check_loss_parity(arch_id: str, seed: int) -> None:
    """``configs.base.loss_fn`` of both packages on the same parameters and
    batch: the loss within 1e-5 relative, each grad leaf within 1e-4 of
    its max |grad|."""
    jcfg, cfg = f32_cfgs(arch_id)
    jparams = jinit.materialize(jbase.model_spec(JARCHS[arch_id], jcfg),
                                jax.random.PRNGKey(seed))
    batch = smoke_batch(arch_id, cfg, seed)
    jloss, jgrads = jax.jit(jax.value_and_grad(jbase.loss_fn(JARCHS[arch_id], jcfg)))(
        jparams, jax.tree.map(jnp.asarray, batch))
    params = interop.from_reference(jax.tree.map(np.asarray, jparams), "cpu")
    loss, grads = opt.value_and_grad(cbase.loss_fn(ARCHS[arch_id], cfg))(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(loss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    want = tree_leaves(interop.from_reference(jax.tree.map(np.asarray, jgrads), "cpu"))
    got = tree_leaves(grads)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g is not None and g.shape == w.shape
        scale = max(float(w.abs().max()), 1e-30)
        assert float((g - w).abs().max()) <= GRAD_TOL * scale


@pytest.mark.parametrize("arch_id", DENSE_ARCHS)
def test_dense_loss_and_grads_match_reference(arch_id):
    check_loss_parity(arch_id, seed=DENSE_ARCHS.index(arch_id))


def test_loss_fn_kinds_and_encdec():
    """``loss_fn`` resolves every kind, the enc-dec one included (its
    parity with the reference in ``test_torch_encdec_train.py``); an
    unknown kind raises."""
    assert {a.kind for a in ARCHS.values()} == {"lm", "rwkv", "griffin", "vlm", "encdec"}
    for arch in ARCHS.values():
        assert callable(cbase.loss_fn(arch, arch.make_smoke()))
    seamless = ARCHS["seamless-m4t-large-v2"]
    cfg = seamless.make_smoke()
    params = nninit.materialize(cbase.model_spec(seamless, cfg),
                                torch.Generator().manual_seed(0))
    batch = {"frames": torch.zeros(1, 6, cfg.d_model),
             "tgt_tokens": torch.zeros(1, 4, dtype=torch.long),
             "tgt_targets": torch.zeros(1, 4, dtype=torch.long)}
    assert torch.isfinite(cbase.loss_fn(seamless, cfg)(params, batch))
    with pytest.raises(ValueError, match="linear"):
        cbase.loss_fn(dataclasses.replace(seamless, kind="linear"), cfg)


# -- flash_mha under grad ---------------------------------------------------------


def _qkv(dtype, layout: str, seed: int):
    """q (1, 24, 4, 32), k / v (1, 40, 4, 32): contiguous, or views of
    (B, H, S, hd) tensors transposed into place."""
    rng = np.random.default_rng(seed)

    def draw(s):
        if layout == "contiguous":
            return torch.from_numpy(rng.standard_normal((1, s, 4, 32)).astype(np.float32))
        return torch.from_numpy(rng.standard_normal((1, 4, s, 32)).astype(np.float32)
                                ).transpose(1, 2)

    return [draw(s).to(dtype) for s in (24, 40, 40)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("layout", ["contiguous", "transposed"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_function_cpu_bit_exact(dtype, layout, causal):
    """On the CPU, ``flash_mha`` under grad goes through ``_FlashMHA``: its
    output and the gradients of q, k and v equal autograd through
    ``flash_attention_ref`` bit for bit, views included."""
    base = _qkv(dtype, layout, seed=int(causal) + 2 * (layout == "transposed"))
    g = torch.from_numpy(np.random.default_rng(9).standard_normal((1, 24, 4, 32))
                         .astype(np.float32)).to(dtype)
    results = []
    for fn in (lambda q, k, v: flash_ops.flash_mha(q, k, v, 0.17, causal=causal),
               lambda q, k, v: flash_ops._plain(q, k, v, 0.17, causal)):
        leaves = [t.detach().clone().requires_grad_() for t in base]
        args = [t if layout == "contiguous" else t.transpose(1, 2).contiguous().transpose(1, 2)
                for t in leaves]
        out = fn(*args)
        results.append((out, torch.autograd.grad(out, leaves, g)))
    (out_f, grads_f), (out_p, grads_p) = results
    assert out_f.grad_fn is not None and "FlashMHA" in type(out_f.grad_fn).__name__
    assert torch.equal(out_f, out_p)
    for a, b in zip(grads_f, grads_p):
        assert a.dtype == dtype and torch.equal(a, b)
    assert torch.equal(out_p, flash_ref.flash_attention_ref(
        *(t.transpose(1, 2).reshape(4, -1, 32) for t in base), scale=0.17,
        causal=causal).reshape(1, 4, 24, 32).transpose(1, 2))


def test_flash_function_only_under_grad():
    """Without grad (no_grad, or inputs that need none) the wrapper records
    no autograd node; a gradient is asked only of inputs that need one."""
    q, k, v = _qkv(torch.float32, "contiguous", seed=5)
    assert flash_ops.flash_mha(q, k, v, 0.2).grad_fn is None
    qg = q.clone().requires_grad_()
    with torch.no_grad():
        assert torch.equal(flash_ops.flash_mha(qg, k, v, 0.2), flash_ops.flash_mha(q, k, v, 0.2))
    out = flash_ops.flash_mha(qg, k, v, 0.2)
    (gq,) = torch.autograd.grad(out.sum(), [qg])
    assert gq.shape == q.shape and k.grad is None


# -- remat ------------------------------------------------------------------------


REMAT_ARCHS = ("llama3.2-3b", "gemma3-12b", "rwkv6-7b", "recurrentgemma-9b",
               "internvl2-26b")


def _with_remat(arch_id: str, cfg, remat: bool):
    if ARCHS[arch_id].kind == "vlm":
        return dataclasses.replace(cfg, lm=dataclasses.replace(cfg.lm, remat=remat))
    return dataclasses.replace(cfg, remat=remat)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch_id", REMAT_ARCHS)
def test_remat_grads_bit_exact(arch_id, dtype):
    """On the CPU the loss and every gradient with ``remat=True`` equal those
    with ``remat=False`` bit for bit; under remat the flash_mha of each
    unwindowed layer in ``body`` is called twice (the forward, and its
    recompute in the backward; gemma3's smoke plan puts its global layer in
    the tail, as the reference's does), and without grad remat changes
    nothing."""
    arch = ARCHS[arch_id]
    cfg = f32_cfgs(arch_id)[1] if dtype == "float32" else arch.make_smoke()
    gen = torch.Generator().manual_seed(7)
    params = nninit.materialize(cbase.model_spec(arch, cfg), gen)
    batch = {k: torch.from_numpy(v) for k, v in smoke_batch(arch_id, cfg, 11).items()}
    out = {}
    for remat in (False, True):
        loss_fn = cbase.loss_fn(arch, _with_remat(arch_id, cfg, remat))
        with registry.record_kernels() as rec:
            value, grads = opt.value_and_grad(loss_fn)(params, batch)
        with torch.no_grad():
            plain = loss_fn(params, batch)
        out[remat] = (value, grads, sum(k == "flash_attn" for k, _ in rec), plain)
    (v0, g0, n0, p0), (v1, g1, n1, p1) = out[False], out[True]
    assert torch.equal(v0, v1) and torch.equal(p0, p1) and torch.equal(v0, p0)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1), strict=True):
        assert torch.equal(a, b)
    flash, in_body = 0, 0
    if arch.kind in ("lm", "vlm"):
        plan = lm.stage_plan(cfg.lm if arch.kind == "vlm" else cfg)
        in_body = plan.repeats * sum(a == "global" for a, _ in plan.unit)
        flash = in_body + sum(a == "global" for a, _ in plan.prefix + plan.tail)
    assert n0 == flash and n1 == flash + in_body
