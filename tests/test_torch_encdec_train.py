"""The enc-dec kind's training loss and the serving twin, on the CPU.

``configs.base.loss_fn`` of seamless-m4t-large-v2 at ``make_smoke()`` and
f32 compute against ``jax.value_and_grad`` of the reference's (jitted), on
the reference's parameters and one numpy batch of ``frames``,
``tgt_tokens`` and ``tgt_targets``: the loss within 1e-5 relative, each
gradient leaf within 1e-4 of its max |grad| (the bounds of
``test_torch_lm_loss.py``).  ``remat`` (each encoder and decoder layer
recomputed in the backward) gives the same gradients bit for bit.

``examples/serve_lm_torch.py`` runs both parts on the CPU; its enc-dec
part's greedy tokens equal a plain loop over the port's ``encode`` /
``decode_step`` on the same batches, so issuing encode(i+1) before
decode(i) changes no result, and at f32 compute a loop over the
reference's functions with the parameters carried across.
"""

import dataclasses
import importlib.util
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import base as jbase
from repro.models import encdec as jed
from repro.nn import init as jinit
from repro_torch import interop
from repro_torch.common.tree import tree_leaves
from repro_torch.configs import ARCHS
from repro_torch.configs import base as cbase
from repro_torch.models import encdec
from repro_torch.nn import init as nninit
from repro_torch.train import optimizer as opt

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH_ID = "seamless-m4t-large-v2"
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4


def f32_cfgs():
    jcfg, cfg = JARCHS[ARCH_ID].make_smoke(), ARCHS[ARCH_ID].make_smoke()
    return (dataclasses.replace(jcfg, compute_dtype=jnp.float32),
            dataclasses.replace(cfg, compute_dtype=torch.float32))


def batch_np(cfg, seed: int, b: int = 2, s_src: int = 24, s_tgt: int = 16) -> dict:
    rng = np.random.default_rng(seed)
    return {"frames": rng.standard_normal((b, s_src, cfg.d_model)).astype(np.float32),
            "tgt_tokens": rng.integers(0, cfg.vocab, (b, s_tgt)).astype(np.int32),
            "tgt_targets": rng.integers(0, cfg.vocab, (b, s_tgt)).astype(np.int32)}


def test_loss_and_grads_match_reference():
    jcfg, cfg = f32_cfgs()
    arch, jarch = ARCHS[ARCH_ID], JARCHS[ARCH_ID]
    jparams = jinit.materialize(jbase.model_spec(jarch, jcfg), jax.random.PRNGKey(7))
    batch = batch_np(cfg, 7)
    jloss, jgrads = jax.jit(jax.value_and_grad(jbase.loss_fn(jarch, jcfg)))(
        jparams, jax.tree.map(jnp.asarray, batch))
    params = interop.from_reference(jax.tree.map(np.asarray, jparams), "cpu")
    loss, grads = opt.value_and_grad(cbase.loss_fn(arch, cfg))(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(loss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    want = tree_leaves(interop.from_reference(jax.tree.map(np.asarray, jgrads), "cpu"))
    got = tree_leaves(grads)
    assert len(got) == len(want) == len(tree_leaves(params))
    for g, w in zip(got, want):
        assert g is not None and g.shape == w.shape
        scale = max(float(w.abs().max()), 1e-30)
        assert float((g - w).abs().max()) <= GRAD_TOL * scale


def test_remat_is_bit_for_bit():
    """Under grad, ``remat=True`` recomputes every layer in the backward
    (``torch.utils.checkpoint``) and gives the loss and every gradient of
    ``remat=False`` bit for bit; without grad it changes nothing."""
    _, cfg = f32_cfgs()
    arch = ARCHS[ARCH_ID]
    params = nninit.materialize(cbase.model_spec(arch, cfg), torch.Generator().manual_seed(2))
    batch = {k: torch.from_numpy(v) for k, v in batch_np(cfg, 2).items()}
    out = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        out[remat] = opt.value_and_grad(cbase.loss_fn(arch, c))(params, batch)
        with torch.no_grad():
            assert torch.equal(encdec.encode(params, c, batch["frames"]),
                               encdec.encode(params, cfg, batch["frames"]))
    (l0, g0), (l1, g1) = out[False], out[True]
    assert torch.equal(l0, l1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1), strict=True):
        assert torch.equal(a, b)


def example():
    spec = importlib.util.spec_from_file_location(
        "serve_lm_torch", ROOT / "examples" / "serve_lm_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_runs_both_parts_on_the_cpu():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, str(ROOT / "examples" / "serve_lm_torch.py"),
                          "--device", "cpu"], capture_output=True, text=True, env=env,
                         timeout=300, check=True).stdout
    assert "llama-smoke: 8 requests" in out
    assert "enc-dec pipelined serving: 3 batches x 8 tokens" in out


def plain_loop(params, cfg, frames, new_tokens: int, max_len: int):
    """Encode, then decode, batch after batch: greedy tokens (B, new)."""
    out = []
    for f in frames:
        enc = encdec.encode(params, cfg, f)
        caches = encdec.init_caches(params, cfg, enc, max_len, device="cpu")
        tok = torch.zeros(f.shape[0], dtype=torch.long)
        toks = []
        for t in range(new_tokens):
            caches, logits = encdec.decode_step(params, cfg, caches, tok, t)
            tok = logits.argmax(-1)
            toks.append(tok)
        out.append(torch.stack(toks, 1))
    return out


def test_example_overlap_equals_plain_loops():
    """The example's enc-dec part at its smoke defaults (bf16 compute, the
    port's seeded parameters) against the port's plain loop; then at f32
    compute on the reference's parameters against a loop over the
    reference's ``encode`` / ``init_caches`` / ``decode_step``."""
    twin = example()
    served = twin.serve_encdec_overlap("cpu")
    _, cfg, params = twin._make(ARCH_ID, "smoke", torch.device("cpu"))
    frames = twin.encdec_frames(cfg.d_model, 3, 2, 24)
    want = plain_loop(params, cfg, frames, 8, 32)
    assert [tuple(s["tokens"].shape) for s in served] == [(2, 8)] * 3
    for s, w in zip(served, want, strict=True):
        assert torch.equal(s["tokens"], w)

    jcfg, cfg32 = f32_cfgs()
    jparams = jinit.materialize(jbase.model_spec(JARCHS[ARCH_ID], jcfg),
                                jax.random.PRNGKey(0))
    params32 = interop.from_reference(jax.tree.map(np.asarray, jparams), "cpu")
    served = twin.serve_encdec_overlap("cpu", cfg=cfg32, params=params32)
    encode = jax.jit(lambda p, f: jed.encode(p, jcfg, f))
    step = jax.jit(lambda p, c, tok, pos: jed.decode_step(p, jcfg, c, tok, pos))
    for s, f in zip(served, frames, strict=True):
        enc = encode(jparams, jnp.asarray(f.float().numpy()).astype(jnp.bfloat16))
        caches = jed.init_caches(jparams, jcfg, enc, 32)
        tok = jnp.zeros((2,), jnp.int32)
        toks = []
        for t in range(8):
            caches, logits = step(jparams, caches, tok, jnp.int32(t))
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            toks.append(np.asarray(tok))
        np.testing.assert_array_equal(s["tokens"].numpy(), np.stack(toks, 1))


def test_example_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        example().serve_encdec_overlap()
