"""Parity of the port's decoder LM (``repro_torch.models.lm``) and its arch
adapter (``configs.base``, ``configs.registry``) with the JAX reference.

The MoE / MLA archs (granite-moe-1b-a400m, deepseek-v3-671b, smoke width)
are held the same way: forward and decode logits within 1e-4 at f32
compute and 3e-2 of the logits' scale at bf16, the summed MoE aux loss,
greedy ``Engine`` streams identical at f32 compute, and at published width
the parameter tree (the MTP head's included), the parameter counts and the
cache shapes.

The four dense smoke archs (2-6 layers, d 64) with the reference's
parameters carried across: logits of the full-context forward
(``prefill_fn``, whose unwindowed layers call the flash_attn wrapper) and of
``decode_step`` within 1e-4 at ``compute_dtype=float32`` and, at each arch's
own bf16, within 3e-2 of the logits' scale (3e-2 x max(1, max |logit|)):
a bf16 step grows with the value, and stablelm's smoke logits reach 3, where
it is 0.016.  There the port's decode logits lie 0.039 from the
reference's, while the reference's own bf16 logits lie 0.058 from its f32
ones.

At f32 compute the decode check runs on f32 KV caches.  With the default
bf16 caches, f32 values of the two packages that differ in the last bit
round to neighbouring bf16 values now and then, and each such entry moves
later logits by ~1e-4; the engine tests hold that configuration to
identical greedy streams instead.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import base as jbase
from repro.models import lm as jlm
from repro.nn import init as jinit
from repro_torch import interop
from repro_torch.backend import registry
from repro_torch.configs import ARCHS, get_arch
from repro_torch.configs import base as cbase
from repro_torch.models import lm

DENSE_ARCHS = ("llama3.2-3b", "stablelm-3b", "gemma3-12b", "starcoder2-3b")
MOE_ARCHS = ("granite-moe-1b-a400m", "deepseek-v3-671b")
TOL = {"float32": 1e-4, "bfloat16": 3e-2}  # bf16: of the logits' scale


def _cfgs(arch_id: str, dtype: str):
    jcfg, cfg = JARCHS[arch_id].make_smoke(), ARCHS[arch_id].make_smoke()
    if dtype == "float32":
        jcfg = dataclasses.replace(jcfg, compute_dtype=jnp.float32)
        cfg = dataclasses.replace(cfg, compute_dtype=torch.float32)
    return jcfg, cfg


@pytest.fixture(scope="module")
def params():
    """The reference's smoke parameters of each arch, and the port's copy."""
    out = {}
    for i, arch_id in enumerate(DENSE_ARCHS):
        jarch = JARCHS[arch_id]
        jp = jinit.materialize(jbase.model_spec(jarch, jarch.make_smoke()),
                               jax.random.PRNGKey(10 + i))
        out[arch_id] = (jp, interop.from_reference(jax.tree.map(np.asarray, jp),
                                                   device="cpu"))
    return out


def _close(got: torch.Tensor, want, dtype: str):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert tuple(got.shape) == want.shape
    atol = TOL[dtype] * (1.0 if dtype == "float32" else max(1.0, np.abs(want).max()))
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=0)


def _tokens(vocab: int, b: int, s: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def test_registry_and_unported_archs():
    """Every reference arch is registered: the ``lm`` archs held field for
    field here, the recurrent and vlm archs in
    ``test_torch_{rwkv,griffin,vlm}.py``, and the enc-dec arch field for
    field (its model in ``test_torch_encdec.py``).  An unknown id raises."""
    assert sorted(ARCHS) == sorted(JARCHS) == sorted(DENSE_ARCHS + MOE_ARCHS + (
        "rwkv6-7b", "recurrentgemma-9b", "internvl2-26b", "seamless-m4t-large-v2"))
    for arch_id in DENSE_ARCHS + MOE_ARCHS:
        arch, jarch = get_arch(arch_id), JARCHS[arch_id]
        assert (arch.family, arch.kind, arch.source, arch.note) == \
            (jarch.family, jarch.kind, jarch.source, jarch.note)
        for make in ("make_full", "make_smoke"):
            jc, c = getattr(jarch, make)(), getattr(arch, make)()
            fields = {f.name for f in dataclasses.fields(c)} - {
                "param_dtype", "compute_dtype", "mla", "moe"}
            assert {f: getattr(c, f) for f in fields} == {f: getattr(jc, f) for f in fields}
            for sub in ("mla", "moe"):
                mine, theirs = getattr(c, sub), getattr(jc, sub)
                assert (mine is None) == (theirs is None), (arch_id, sub)
                if mine is not None:
                    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
            assert str(c.param_dtype).split(".")[-1] == jnp.dtype(jc.param_dtype).name
    arch, jarch = get_arch("seamless-m4t-large-v2"), JARCHS["seamless-m4t-large-v2"]
    assert (arch.family, arch.kind, arch.source, arch.note) == \
        (jarch.family, jarch.kind, jarch.source, jarch.note)
    for make in ("make_full", "make_smoke"):
        jc, c = getattr(jarch, make)(), getattr(arch, make)()
        for f in dataclasses.fields(c):   # the reference's without scan_unroll
            mine, theirs = getattr(c, f.name), getattr(jc, f.name)
            if f.name.endswith("dtype"):
                assert str(mine).split(".")[-1] == jnp.dtype(theirs).name
            else:
                assert mine == theirs, f.name
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("gpt-2")


def test_unported_kinds_and_options_raise():
    """Every kind resolves: ``model_spec`` takes the enc-dec kind, and
    ``serve_fns`` / ``lm_engine`` refuse the vlm and enc-dec kinds as the
    reference's do (they need patch embeddings / encoder frames); the
    recurrent kinds serve with stateful prefill; an unknown attention kind
    and an unknown model kind are refused."""
    arch = ARCHS["llama3.2-3b"]
    cfg = arch.make_smoke()
    seamless = ARCHS["seamless-m4t-large-v2"]
    spec = cbase.model_spec(seamless, seamless.make_smoke())
    assert set(spec) == {"embed", "enc", "dec", "enc_norm", "dec_norm"}
    with pytest.raises(ValueError, match="linear"):
        cbase.model_spec(dataclasses.replace(arch, kind="linear"), cfg)
    with pytest.raises(ValueError, match="unknown attn_kind"):
        lm.lm_spec(dataclasses.replace(cfg, attn_kind="linear"))
    for arch_id in ("internvl2-26b", "seamless-m4t-large-v2"):
        other = ARCHS[arch_id]
        with pytest.raises(NotImplementedError, match="non-token inputs"):
            cbase.serve_fns(other, other.make_smoke(), max_len=32)
        with pytest.raises(NotImplementedError, match="non-token inputs"):
            cbase.lm_engine(arch_id, device="cpu")
    for arch_id in ("rwkv6-7b", "recurrentgemma-9b"):
        eng, _ = cbase.lm_engine(arch_id, device="cpu")
        assert eng.cfg.stateful_prefill


@pytest.mark.parametrize("arch_id", DENSE_ARCHS)
def test_stage_plan_and_cache_shapes(arch_id):
    for make in ("make_full", "make_smoke"):
        jcfg, cfg = getattr(JARCHS[arch_id], make)(), getattr(ARCHS[arch_id], make)()
        jplan, plan = jlm.stage_plan(jcfg), lm.stage_plan(cfg)
        assert (plan.prefix, plan.unit, plan.repeats, plan.tail) == \
            (jplan.prefix, jplan.unit, jplan.repeats, jplan.tail)
        jshapes = jax.tree.leaves(jlm.cache_shapes(jcfg, 3, 40))
        shapes = jax.tree.leaves(lm.cache_shapes(cfg, 3, 40))
        assert [tuple(t.shape) for t in shapes] == [s.shape for s in jshapes]


@pytest.mark.parametrize("arch_id", DENSE_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_fn_logits(params, arch_id, dtype):
    """Last-token logits of the full-context forward; one flash_attn call
    per unwindowed layer (none for starcoder2, all local; one of gemma3's
    six)."""
    jp, p = params[arch_id]
    jcfg, cfg = _cfgs(arch_id, dtype)
    toks = _tokens(cfg.vocab, 2, 37, seed=1)
    want = jbase.prefill_fn(JARCHS[arch_id], jcfg)(jp, jnp.asarray(toks))
    with registry.record_kernels() as rec:
        got = cbase.prefill_fn(ARCHS[arch_id], cfg)(p, torch.from_numpy(toks).long())
    n_global = sum(cfg.attn_cfg(cfg.pattern[i % len(cfg.pattern)]).window is None
                   for i in range(cfg.n_layers))
    assert rec == [("flash_attn", "kernel")] * n_global
    assert got.dtype == cfg.compute_dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("arch_id", DENSE_ARCHS)
def test_forward_hidden_and_lm_prefill(params, arch_id):
    jp, p = params[arch_id]
    jcfg, cfg = _cfgs(arch_id, "float32")
    toks = _tokens(cfg.vocab, 1, 21, seed=2)
    jh, _ = jlm.forward(jp, jcfg, jnp.asarray(toks))
    h, aux = lm.forward(p, cfg, torch.from_numpy(toks).long())
    assert aux == 0.0
    _close(h, jh, "float32")
    _close(lm.lm_logits(p, cfg, h), jlm.lm_logits(jp, jcfg, jh), "float32")
    jlast, jcaches = jlm.prefill(jp, jcfg, jnp.asarray(toks), max_len=32)
    last, caches = lm.prefill(p, cfg, torch.from_numpy(toks).long(), max_len=32)
    _close(last, jlast, "float32")
    # the reference hands back zeroed caches (ROADMAP Queue 3); so does the port
    assert [tuple(t.shape) for t in jax.tree.leaves(caches)] == \
        [c.shape for c in jax.tree.leaves(jcaches)]
    assert not any(bool(t.any()) for t in jax.tree.leaves(caches))


def _zeros_like_tree(tree, jdtype, dtype):
    return (jax.tree.map(lambda s: jnp.zeros(s.shape, jdtype), tree[0]),
            jax.tree.map(lambda t: torch.zeros(t.shape, dtype=dtype), tree[1]))


@pytest.mark.parametrize("arch_id", DENSE_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_logits(params, arch_id, dtype):
    """``decode_fn``, slots at different depths, driven past gemma3's and
    starcoder2's window of 16 (their ring caches wrap); logits at every
    step.  f32 compute runs on f32 caches, bf16 on the default bf16 caches
    of ``serve_fns``."""
    jp, p = params[arch_id]
    jcfg, cfg = _cfgs(arch_id, dtype)
    jstep, jinit_caches = jbase.serve_fns(JARCHS[arch_id], jcfg, max_len=48)
    jstep = jax.jit(jstep)
    step, init_caches = cbase.serve_fns(ARCHS[arch_id], cfg, max_len=48)
    if dtype == "float32":
        jcaches, caches = _zeros_like_tree(
            (jlm.cache_shapes(jcfg, 2, 48), lm.cache_shapes(cfg, 2, 48)),
            jnp.float32, torch.float32)
    else:
        jcaches, caches = jinit_caches(2), init_caches(2, "cpu")
    toks = _tokens(cfg.vocab, 22, 2, seed=3)
    start = np.array([0, 7], np.int32)
    for t in range(22):
        pos = start + t
        jcaches, want = jstep(jp, jcaches, jnp.asarray(toks[t]), jnp.asarray(pos))
        caches, got = step(p, caches, torch.from_numpy(toks[t]).long(),
                           torch.from_numpy(pos).long())
        _close(got, want, dtype)


def test_decode_matches_forward_on_a_prefix(params):
    """Decoding a prompt token by token gives the forward's logits at every
    position (f32 compute; the bf16 KV cache is the only rounding between
    them)."""
    _, p = params["gemma3-12b"]
    _, cfg = _cfgs("gemma3-12b", "float32")
    toks = torch.from_numpy(_tokens(cfg.vocab, 1, 30, seed=4)).long()
    full = lm.lm_logits(p, cfg, lm.forward(p, cfg, toks)[0])[0]
    caches = lm.init_caches(cfg, 1, 32, device="cpu")
    for t in range(30):
        caches, got = lm.decode_step(p, cfg, caches, toks[:, t], t)
        assert float((got[0] - full[t]).abs().max()) < 2e-2
        assert int(got[0].argmax()) == int(full[t].argmax())


def test_param_count_and_device_default():
    arch = ARCHS["llama3.2-3b"]
    # llama3.2-3b at its published width: 3.21e9 parameters, tied head
    assert cbase.param_count(arch, arch.make_full()) == 3_212_749_824
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            lm.init_caches(arch.make_smoke(), 1, 8)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cbase.lm_engine("llama3.2-3b")


# -- the MoE / MLA archs ---------------------------------------------------------


@pytest.fixture(scope="module")
def moe_params():
    """The reference's smoke parameters of each MoE / MLA arch (MTP head
    included), and the port's copy."""
    out = {}
    for i, arch_id in enumerate(MOE_ARCHS):
        jarch = JARCHS[arch_id]
        jp = jinit.materialize(jbase.model_spec(jarch, jarch.make_smoke()),
                               jax.random.PRNGKey(30 + i))
        out[arch_id] = (jp, interop.from_reference(jax.tree.map(np.asarray, jp),
                                                   device="cpu"))
    return out


@pytest.mark.parametrize("arch_id", MOE_ARCHS)
def test_moe_archs_at_published_width(arch_id):
    """The parameter tree of the published config, the MTP head's
    included, leaf for leaf (shape, dtype); the total and active parameter
    counts; the stage plan and cache shapes."""
    jarch, arch = JARCHS[arch_id], ARCHS[arch_id]
    jcfg, cfg = jarch.make_full(), arch.make_full()
    jleaves = jax.tree_util.tree_flatten_with_path(
        jbase.model_spec(jarch, jcfg), is_leaf=lambda x: isinstance(x, jinit.P))[0]
    leaves = jax.tree_util.tree_flatten_with_path(
        cbase.model_spec(arch, cfg), is_leaf=lambda x: isinstance(x, lm.P))[0]
    assert [(jax.tree_util.keystr(k), p.shape, p.axes) for k, p in leaves] == \
        [(jax.tree_util.keystr(k), p.shape, p.axes) for k, p in jleaves]
    assert {str(p.dtype).split(".")[-1] for _, p in leaves if "router" not in str(_)} \
        == {jnp.dtype(p.dtype).name for _, p in jleaves if "router" not in str(_)}
    assert cbase.param_count(arch, cfg) == jbase.param_count(jarch, jcfg)
    assert cbase.active_param_count(arch, cfg) == jbase.active_param_count(jarch, jcfg)
    jplan, plan = jlm.stage_plan(jcfg), lm.stage_plan(cfg)
    assert (plan.prefix, plan.unit, plan.repeats, plan.tail) == \
        (jplan.prefix, jplan.unit, jplan.repeats, jplan.tail)
    jshapes = jax.tree.leaves(jlm.cache_shapes(jcfg, 3, 40))
    assert [tuple(t.shape) for t in jax.tree.leaves(lm.cache_shapes(cfg, 3, 40))] == \
        [s.shape for s in jshapes]


@pytest.mark.parametrize("arch_id", MOE_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_archs_prefill_fn_logits(moe_params, arch_id, dtype):
    """Last-token logits of the full-context forward.  granite-moe's GQA
    layers call the flash_attn wrapper; deepseek-v3's MLA layers do not."""
    jp, p = moe_params[arch_id]
    jcfg, cfg = _cfgs(arch_id, dtype)
    toks = _tokens(cfg.vocab, 2, 37, seed=5)
    want = jbase.prefill_fn(JARCHS[arch_id], jcfg)(jp, jnp.asarray(toks))
    with registry.record_kernels() as rec:
        got = cbase.prefill_fn(ARCHS[arch_id], cfg)(p, torch.from_numpy(toks).long())
    n_flash = 0 if cfg.attn_kind == "mla" else cfg.n_layers
    assert rec == [("flash_attn", "kernel")] * n_flash
    _close(got, want, dtype)


@pytest.mark.parametrize("arch_id", MOE_ARCHS)
def test_moe_archs_forward_and_aux(moe_params, arch_id):
    jp, p = moe_params[arch_id]
    jcfg, cfg = _cfgs(arch_id, "float32")
    toks = _tokens(cfg.vocab, 2, 21, seed=6)
    jh, jaux = jlm.forward(jp, jcfg, jnp.asarray(toks))
    h, aux = lm.forward(p, cfg, torch.from_numpy(toks).long())
    _close(h, jh, "float32")
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-5, rtol=0)
    assert float(aux) > 0.0


@pytest.mark.parametrize("arch_id", MOE_ARCHS)
def test_moe_archs_decode_steps_logits(moe_params, arch_id):
    """``decode_fn`` at f32 compute on f32 caches (MLA: the compressed
    cache), slots at different depths, logits at every step."""
    jp, p = moe_params[arch_id]
    jcfg, cfg = _cfgs(arch_id, "float32")
    jstep, _ = jbase.serve_fns(JARCHS[arch_id], jcfg, max_len=40)
    jstep = jax.jit(jstep)
    step, _ = cbase.serve_fns(ARCHS[arch_id], cfg, max_len=40)
    jcaches, caches = _zeros_like_tree(
        (jlm.cache_shapes(jcfg, 2, 40), lm.cache_shapes(cfg, 2, 40)),
        jnp.float32, torch.float32)
    toks = _tokens(cfg.vocab, 18, 2, seed=7)
    start = np.array([0, 11], np.int32)
    for t in range(18):
        pos = start + t
        jcaches, want = jstep(jp, jcaches, jnp.asarray(toks[t]), jnp.asarray(pos))
        caches, got = step(p, caches, torch.from_numpy(toks[t]).long(),
                           torch.from_numpy(pos).long())
        _close(got, want, "float32")


@pytest.mark.parametrize("arch_id", MOE_ARCHS)
def test_moe_archs_engine_greedy_streams(moe_params, arch_id):
    """The slot-pool ``Engine`` at f32 compute with the default caches:
    greedy streams identical to the reference engine's, ragged prompts,
    fewer slots than requests."""
    from repro.serve import engine as jengine
    from repro_torch.serve import engine as pengine

    jp, p = moe_params[arch_id]
    jcfg, cfg = _cfgs(arch_id, "float32")
    serve = dict(max_new_tokens=6, max_slots=3, max_len=48, decode_block=4)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, 256, int(rng.integers(3, 30))).astype(np.int32)
               for _ in range(5)]
    jstep, jinit_c = jbase.serve_fns(JARCHS[arch_id], jcfg, max_len=48)
    step, init_c = cbase.serve_fns(ARCHS[arch_id], cfg, max_len=48)
    want = jengine.Engine(jstep, jinit_c, jengine.ServeConfig(**serve), params=jp).run(
        [jengine.Request(uid=i, prompt=q) for i, q in enumerate(prompts)])
    got = pengine.Engine(step, init_c, pengine.ServeConfig(**serve), params=p).run(
        [pengine.Request(uid=i, prompt=q) for i, q in enumerate(prompts)])
    assert sorted(got) == sorted(want) == list(range(5))
    for uid, res in want.items():
        assert got[uid].tokens.tolist() == np.asarray(res.tokens).tolist(), uid
