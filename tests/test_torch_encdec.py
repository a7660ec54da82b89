"""Parity of the port's enc-dec kind (``repro_torch.models.encdec``,
``nn/attention.py:cross_attention`` / ``encode_kv``, the seamless config and
its ``configs.base`` branches) with the JAX reference, on the CPU.

seamless-m4t-large-v2 at ``make_smoke()`` (2 + 2 layers, d 64, 4 heads),
the reference's parameters carried across (``interop.from_reference``),
frames and tokens drawn with numpy, S_src = 24 against S_tgt = 16 so that
the cross-attention's query and key lengths differ.  ``encode``,
``decode_train`` and ``prefill_fn`` at f32 compute lie within 1e-5 of each
output's max |x|, and at bf16 within 3e-2 of it.

The cross K/V caches are bf16 whatever the compute dtype, as the reference
fixes them.  At f32 compute the two packages' f32 K/V differ in the last
bit now and then, and such a value can round to the neighbouring bf16
value (as in the LM's KV cache, ``test_torch_lm.py``): 1 element of 6144 here.
So the caches are held within one bf16 step, element by element, and
bit-equal at all but one element in 10^3; the decode steps are held at
1e-4 stepping from the reference's caches of each step, and free-running
from the same start within one bf16 step of the logits' scale.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import base as jbase
from repro.models import encdec as jed
from repro.nn import attention as jattn
from repro.nn import init as jinit
from repro.nn import layers as jlayers
from repro_torch import interop
from repro_torch.common.tree import tree_map
from repro_torch.configs import ARCHS, get_arch
from repro_torch.configs import base as cbase
from repro_torch.models import encdec
from repro_torch.nn import attention as attn
from repro_torch.nn import init as nninit
from repro_torch.nn import layers

torch.set_num_threads(2)

ARCH_ID = "seamless-m4t-large-v2"
S_SRC, S_TGT, BATCH = 24, 16, 2
BF16_STEP = 2.0 ** -7   # one bf16 step, relative to the value


def cfgs(dtype: str = "float32"):
    """(reference cfg, port cfg) at ``make_smoke()`` in ``dtype`` compute."""
    jcfg, cfg = JARCHS[ARCH_ID].make_smoke(), ARCHS[ARCH_ID].make_smoke()
    return (dataclasses.replace(jcfg, compute_dtype=getattr(jnp, dtype)),
            dataclasses.replace(cfg, compute_dtype=getattr(torch, dtype)))


@pytest.fixture(scope="module")
def params():
    jcfg, _ = cfgs()
    jp = jinit.materialize(jbase.model_spec(JARCHS[ARCH_ID], jcfg), jax.random.PRNGKey(31))
    return jp, interop.from_reference(jax.tree.map(np.asarray, jp), "cpu")


def inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((BATCH, S_SRC, 64)).astype(np.float32)
    tgt = rng.integers(0, 256, (BATCH, S_TGT)).astype(np.int32)
    return frames, tgt


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def to_torch(tree):
    """A reference tree of arrays (bf16 included) as CPU tensors of the
    same dtypes."""
    return jax.tree.map(lambda x: torch.from_numpy(to_np(x)).to(
        getattr(torch, jnp.dtype(x.dtype).name)), tree)


def near(got, want, tol: float) -> float:
    """|got - want| within ``tol`` x max(1e-30, max |want|); returns the
    error relative to that scale."""
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, err
    return err


def by_path(tree, path: str = "") -> dict:
    """{path: leaf} of a nested dict of specs, arrays or tensors."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in by_path(sub, f"{path}/{key}").items()}
    return {path: tree}


def shapes_by_path(tree) -> dict:
    return {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in by_path(tree).items()}


def pairs(mine, theirs) -> list:
    """(port leaf, reference leaf) by path; the paths must agree."""
    a, b = by_path(mine), by_path(theirs)
    assert sorted(a) == sorted(b)
    return [(a[k], b[k]) for k in sorted(a)]


def test_config_and_arch_match_reference():
    """``full()`` and ``smoke()`` equal the reference's field for field
    (dtypes by name), the ``ARCH`` too, over the port's fields: the
    reference's without ``scan_unroll``, which tunes its compiled scan; the
    parameter tree equals the reference's leaf for leaf, 1,370,343,424
    parameters at ``full()``."""
    arch, jarch = get_arch(ARCH_ID), JARCHS[ARCH_ID]
    for f in ("id", "family", "kind", "supports_long", "fsdp", "opt_8bit", "note",
              "source"):
        assert getattr(arch, f) == getattr(jarch, f), f
    for make in ("make_full", "make_smoke"):
        c, jc = getattr(arch, make)(), getattr(jarch, make)()
        assert {f.name for f in dataclasses.fields(c)} == \
            {f.name for f in dataclasses.fields(jc)} - {"scan_unroll"}
        for f in dataclasses.fields(c):
            mine, theirs = getattr(c, f.name), getattr(jc, f.name)
            if f.name.endswith("dtype"):
                assert str(mine).split(".")[-1] == jnp.dtype(theirs).name, f.name
            else:
                assert mine == theirs, f.name
        assert (c.hd, c.attn_cfg().scale) == (jc.hd, jc.attn_cfg().scale)
        spec = cbase.model_spec(arch, c)
        jspec = jbase.model_spec(jarch, jc)
        assert {k: v[0] for k, v in shapes_by_path(spec).items()} == \
            {k: v[0] for k, v in shapes_by_path(jspec).items()}
        assert cbase.param_count(arch, c) == jinit.param_count(jspec)
    assert cbase.param_count(arch, arch.make_full()) == 1_370_343_424


def test_cache_shapes_match_reference():
    _, cfg = cfgs()
    jcfg = JARCHS[ARCH_ID].make_smoke()
    mine = encdec.cache_shapes(cfg, 3, 40, 24)
    theirs = jed.cache_shapes(jcfg, 3, 40, 24)
    assert shapes_by_path(mine) == shapes_by_path(theirs)
    assert {d for _, d in shapes_by_path(mine).values()} == {"bfloat16"}


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 3e-2)])
def test_encode_decode_train_prefill_match_reference(params, dtype, tol):
    """``encode``, ``decode_train`` (on each package's own encoder output),
    the logits and ``prefill_fn`` (the encoder output's mean)."""
    jp, p = params
    jcfg, cfg = cfgs(dtype)
    frames, tgt = inputs(1)
    je = jed.encode(jp, jcfg, jnp.asarray(frames))
    e = encdec.encode(p, cfg, torch.from_numpy(frames))
    assert e.dtype == getattr(torch, dtype)
    near(e, je, tol)
    jh = jed.decode_train(jp, jcfg, je, jnp.asarray(tgt))
    h = encdec.decode_train(p, cfg, e, torch.from_numpy(tgt))
    near(h, jh, tol)
    near(layers.logits(p["embed"], h, cfg.compute_dtype),
         jlayers.logits(jp["embed"], jh, jcfg.compute_dtype), tol)
    jpre = jbase.prefill_fn(JARCHS[ARCH_ID], jcfg)(jp, jnp.asarray(frames))
    pre = cbase.prefill_fn(ARCHS[ARCH_ID], cfg)(p, torch.from_numpy(frames))
    assert tuple(pre.shape) == (BATCH, 64)
    near(pre, jpre, tol)


def test_cross_attention_and_encode_kv_match_reference(params):
    """One layer's ``encode_kv`` and ``cross_attention`` at Sq = 16 and
    Sq = 1 against the reference's, f32."""
    jp, p = params
    jcfg, cfg = cfgs()
    rng = np.random.default_rng(2)
    enc_out = rng.standard_normal((BATCH, S_SRC, 64)).astype(np.float32)
    jx = jax.tree.map(lambda a: a[0], jp["dec"]["xattn"])
    x = tree_map(lambda a: a[0], p["dec"]["xattn"])
    jkv = jattn.encode_kv(jx, jcfg.attn_cfg(), jnp.asarray(enc_out), jnp.float32)
    kv = attn.encode_kv(x, cfg.attn_cfg(), torch.from_numpy(enc_out), torch.float32)
    for n in ("k", "v"):
        near(kv[n], jkv[n], 1e-6)
    for sq in (S_TGT, 1):
        h = rng.standard_normal((BATCH, sq, 64)).astype(np.float32)
        near(attn.cross_attention(x, cfg.attn_cfg(), torch.from_numpy(h), kv, torch.float32),
             jattn.cross_attention(jx, jcfg.attn_cfg(), jnp.asarray(h), jkv, jnp.float32),
             1e-5)


def test_init_caches_and_decode_steps_match_reference(params):
    """The bf16 cross caches within one bf16 step of the reference's and
    bit-equal at all but one element in 10^3; 8 greedy decode steps at f32
    compute: stepped from the reference's caches of each step, logits
    within 1e-4 and the written self caches within one bf16 step;
    free-running from the same start, logits within one bf16 step of their
    scale."""
    jp, p = params
    jcfg, cfg = cfgs()
    frames, _ = inputs(3)
    je = jed.encode(jp, jcfg, jnp.asarray(frames))
    e = encdec.encode(p, cfg, torch.from_numpy(frames))
    jc = jed.init_caches(jp, jcfg, je, 32)
    c = encdec.init_caches(p, cfg, e, 32, device="cpu")
    assert c["cross"]["k"].dtype == torch.bfloat16 and c["self"]["k"].dtype == torch.bfloat16
    for got, want in pairs(c, jc):
        got, want = to_np(got), to_np(want)
        assert got.shape == want.shape
        assert (np.abs(got - want) <= BF16_STEP * np.abs(want)).all()
        assert (got != want).sum() <= got.size // 1000
    tok = np.zeros(BATCH, np.int32)
    free = c
    for t in range(8):
        stepped = to_torch(jc)
        jc, jl = jed.decode_step(jp, jcfg, jc, jnp.asarray(tok), jnp.int32(t))
        stepped, logits = encdec.decode_step(p, cfg, stepped, torch.from_numpy(tok), t)
        np.testing.assert_allclose(to_np(logits), to_np(jl), atol=1e-4, rtol=0)
        for got, want in pairs(stepped, jc):
            assert (np.abs(to_np(got) - to_np(want)) <= BF16_STEP * np.abs(to_np(want))).all()
        free, free_logits = encdec.decode_step(p, cfg, free, torch.from_numpy(tok),
                                               torch.tensor(t))
        scale = max(1.0, float(np.abs(to_np(jl)).max()))
        np.testing.assert_allclose(to_np(free_logits), to_np(jl), rtol=0,
                                   atol=BF16_STEP / 2 * scale)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    assert free is c   # the same cache dict, written in place


def f32_caches(p, cfg, enc_out, max_len: int):
    """``init_caches`` with every leaf f32 and the cross K/V taken from
    ``encode_kv`` at f32, not rounded to bf16: the state a decode needs to
    agree with ``decode_train`` at f32 within 1e-4."""
    c = tree_map(lambda t: t.float(), encdec.init_caches(p, cfg, enc_out, max_len,
                                                         device="cpu"))
    for i in range(cfg.n_dec_layers):
        kv = attn.encode_kv(tree_map(lambda a: a[i], p["dec"]["xattn"]), cfg.attn_cfg(),
                            enc_out, cfg.compute_dtype)
        for n in ("k", "v"):
            c["cross"][n][i] = kv[n]
    return c


def teacher_forced(p, cfg, caches, tgt: torch.Tensor) -> torch.Tensor:
    """The decode step scanned over ``tgt`` (B, S): logits (B, S, V)."""
    out = []
    for t in range(tgt.shape[1]):
        caches, logits = encdec.decode_step(p, cfg, caches, tgt[:, t], t)
        out.append(logits)
    return torch.stack(out, 1)


@pytest.mark.parametrize("zero_cross", [False, True])
def test_decode_step_matches_decode_train(params, zero_cross):
    """Port only, f32: over a teacher-forced target, the decode step's
    logits equal ``decode_train``'s at every position within 1e-4; with the
    cross caches zeroed the same check fails, so it reads the encoder."""
    _, p = params
    _, cfg = cfgs()
    frames, tgt = inputs(4)
    tgt = torch.from_numpy(tgt)
    e = encdec.encode(p, cfg, torch.from_numpy(frames))
    want = layers.logits(p["embed"], encdec.decode_train(p, cfg, e, tgt), cfg.compute_dtype)
    caches = f32_caches(p, cfg, e, S_TGT)
    if zero_cross:
        for n in ("k", "v"):
            caches["cross"][n].zero_()
    err = float((teacher_forced(p, cfg, caches, tgt) - want).abs().max())
    assert (err > 1e-4) == zero_cross, err


def test_serving_kinds_refuse_encdec_and_decode_fn_resolves():
    """``serve_fns`` and ``lm_engine`` refuse the kind, as the reference's
    do; ``decode_fn`` runs ``encdec.decode_step``; ``deploy`` does not list
    it among the LM models."""
    from repro_torch.serve import runtime

    arch = ARCHS[ARCH_ID]
    cfg = arch.make_smoke()
    with pytest.raises(NotImplementedError, match="non-token inputs"):
        cbase.serve_fns(arch, cfg, max_len=32)
    with pytest.raises(NotImplementedError, match="non-token inputs"):
        cbase.forward_fn(arch, cfg)
    assert ARCH_ID not in runtime._lm_model_ids()
    p = nninit.materialize(cbase.model_spec(arch, cfg), torch.Generator().manual_seed(0))
    e = encdec.encode(p, cfg, torch.zeros(1, 5, cfg.d_model))
    caches = encdec.init_caches(p, cfg, e, 8, device="cpu")
    got, logits = cbase.decode_fn(arch, cfg)(p, caches, torch.zeros(1, dtype=torch.long), 0)
    assert got is caches and tuple(logits.shape) == (1, cfg.vocab)
    with pytest.raises(RuntimeError, match="CUDA"):
        encdec.init_caches(p, cfg, e, 8)
