"""Tensor parallelism of the kinds beyond the dense and MoE GQA ``lm``
kind (``repro_torch.distributed.world``) on the CPU, against the
single-process port and the reference.

One gloo world per size (2 and 4 ranks) shared by the module's models,
as in ``tests/test_torch_tp.py``.  At f32 compute and smoke width, with
the reference's parameters carried across by ``interop.from_reference``:

- rwkv6-7b, recurrentgemma-9b and deepseek-v3-671b (MLA, MoE) served
  through ``TPEngine`` at tp 2, and recurrentgemma-9b at tp 4, where its
  one kv head does not divide the group: ``Engine.run`` token streams equal
  the single-process port's and the reference's single-device engine's
  (the reference's TP path fails on this host, ``tests/test_serve_tp.py``);
  forward logits within 1e-5 of the single process's, the same bits on
  every rank.  The fallback's cuts (MLA's ``wq_a`` on the embed dim, rwkv's
  ``decay_b`` / ``mu`` on it, the RG-LRU's ``wa`` on its input dim) and the
  decode state each rank holds (its WKV heads, its RG-LRU channels, the
  whole MLA latent) are asserted.
- internvl2-26b's prefill at tp 2 and at tp 4 (its 2 kv heads do not
  divide 4), and seamless-m4t-large-v2's encode, ``decode_train`` and
  decode steps at tp 2 through ``TPModel``: within 1e-5 of the
  single-process port and 1e-4 of the reference.  The decode steps run
  from the reference's caches of each step, loaded into every rank's
  share, as ``tests/test_torch_encdec.py`` steps the port: the caches are
  bf16, which an f32 last bit can round either way.

About 60 s alone in one process.
"""

import dataclasses

import _torch_tp_ranks as ranks
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import base as jbase
from repro.models import encdec as jed
from repro.nn import init as jinit
from repro.nn import layers as jlayers
from repro.serve import engine as jengine
from repro_torch import interop
from repro_torch.common.tree import tree_map
from repro_torch.configs import ARCHS
from repro_torch.configs import base as cbase
from repro_torch.distributed import world as W
from repro_torch.models import encdec
from repro_torch.nn import layers
from repro_torch.serve import engine as pengine

torch.set_num_threads(2)

MAX_LEN = 64
SERVE = dict(max_new_tokens=4, max_slots=3, max_len=MAX_LEN, decode_block=4)
TIMEOUT_S = 30.0
BF16_STEP = 2.0 ** -7


def _f32(cfg, dtype):
    if hasattr(cfg, "lm"):
        return dataclasses.replace(cfg, lm=dataclasses.replace(cfg.lm, compute_dtype=dtype))
    return dataclasses.replace(cfg, compute_dtype=dtype)


def _models(arch_id: str, seed: int):
    """The f32-compute configs, the reference's params and the port's copy."""
    jcfg = _f32(JARCHS[arch_id].make_smoke(), jnp.float32)
    cfg = _f32(ARCHS[arch_id].make_smoke(), torch.float32)
    jp = jinit.materialize(jbase.model_spec(JARCHS[arch_id], jcfg), jax.random.PRNGKey(seed))
    return jcfg, cfg, jp, interop.from_reference(jax.tree.map(np.asarray, jp), device="cpu")


def _prompts(n: int, seed: int) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 256, int(rng.integers(3, 15))).astype(np.int32)
            for _ in range(n)]


def _tokens(results) -> dict:
    return {u: r.tokens.tolist() for u, r in results.items()}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


@pytest.fixture(scope="module")
def worlds():
    opened: dict[int, W.World] = {}

    def get(tp: int) -> W.World:
        if tp not in opened:
            opened[tp] = W.World(("cpu",) * tp, timeout_s=TIMEOUT_S)
        return opened[tp]

    yield get
    for w in opened.values():
        procs = list(w._procs)
        w.close()
        assert not any(p.is_alive() for p in procs)


@pytest.fixture(scope="module")
def served():
    """Per arch, once: the port's params and config, the requests and the
    streams of the reference's single-device engine, which the
    single-process port's equal."""
    cache = {}

    def get(arch_id: str):
        if arch_id not in cache:
            jcfg, cfg, jp, p = _models(arch_id, seed=17)
            prompts = _prompts(4, seed=len(cache) + 3)
            step, init = jbase.serve_fns(JARCHS[arch_id], jcfg, max_len=MAX_LEN)
            ref = jengine.Engine(step, init, jengine.ServeConfig(**SERVE), params=jp).run(
                [jengine.Request(uid=i, prompt=q) for i, q in enumerate(prompts)])
            step, init = cbase.serve_fns(ARCHS[arch_id], cfg, max_len=MAX_LEN)
            reqs = [pengine.Request(uid=i, prompt=q) for i, q in enumerate(prompts)]
            want = _tokens(pengine.Engine(step, init, pengine.ServeConfig(**SERVE),
                                          params=p).run(reqs))
            assert want == _tokens(ref)
            cache[arch_id] = cfg, p, reqs, want
        return cache[arch_id]

    return get


#: (path, stacked cut dim) of the leaves the fallback cuts, per arch
FALLBACK_CUTS = {
    "rwkv6-7b": [(("body", "tm", "decay_b"), 2), (("body", "tm", "mu"), 2),
                 (("body", "tm", "shift_b"), 3), (("body", "tm", "wr"), 2),
                 (("body", "tm", "wo"), 1), (("body", "tm", "u"), 1)],
    "recurrentgemma-9b": [(("body", "u0", "lru", "wa"), 1), (("body", "u0", "lru", "wx"), 1),
                          (("body", "u0", "in_x", "w"), 2), (("body", "u0", "conv", "w"), 2),
                          (("body", "u2", "attn", "wk"), 1)],
    "deepseek-v3-671b": [(("prefix", 0, "attn", "wq_a"), 0), (("body", "u0", "attn", "wq_a"), 1),
                         (("body", "u0", "attn", "wkv_a"), 1), (("body", "u0", "attn", "wq_b"), 2),
                         (("body", "u0", "attn", "wk_b"), 2), (("body", "u0", "attn", "wo"), 1)],
}
#: the leaves a rank keeps whole beside its cut, and those it does not
KEEPS_WHOLE = {("body", "tm", "mu"), ("body", "tm", "shift_b"), ("body", "tm", "decay_b"),
               ("body", "tm", "u"), ("body", "u0", "conv", "w")}


def _state_held(arch_id: str, cfg, tp: int, shapes: dict) -> None:
    """The decode state a rank holds: its WKV heads, its RG-LRU channels,
    the whole MLA latent."""
    b = SERVE["max_slots"]
    if arch_id == "rwkv6-7b":
        h = cfg.d_model // cfg.head_dim
        assert shapes["wkv"] == (cfg.n_layers, b, h // tp, cfg.head_dim, cfg.head_dim)
        assert shapes["tm_x"] == shapes["cm_x"] == (cfg.n_layers, b, cfg.d_model)
    elif arch_id == "recurrentgemma-9b":
        r = cfg.rnn_d // tp
        assert shapes["body/u0/lru"] == (1, b, r)
        assert shapes["body/u0/conv"] == (1, b, cfg.conv_width - 1, r)
        # MQA: the one kv head, kept by every rank
        assert shapes["body/u2/k"] == (1, b, cfg.window, 1, cfg.hd)
    else:
        r = cfg.mla.kv_lora_rank
        assert shapes["prefix/0/ckv"] == (b, MAX_LEN, r)
        assert shapes["body/u0/ckv"][-1] == r and shapes["body/u0/kpe"][-1] == cfg.mla.qk_rope_dim


@pytest.mark.parametrize("arch_id, tp", [("rwkv6-7b", 2), ("recurrentgemma-9b", 2),
                                         ("deepseek-v3-671b", 2), ("recurrentgemma-9b", 4)])
def test_tp_engine_streams_and_logits_equal_single_device(worlds, served, arch_id, tp):
    cfg, p, reqs, want = served(arch_id)
    spec = W.EngineSpec(arch_id, cfg, W.GivenParams(p), pengine.ServeConfig(**SERVE))
    eng = W.TPEngine(worlds(tp), spec, owns_world=False)
    assert _tokens(eng.run(reqs)) == want

    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 24)))
    forward, readout = cbase.forward_fn(ARCHS[arch_id], cfg)
    got = eng.forward(toks)          # raises unless every rank has these bits
    torch.testing.assert_close(got, readout(p, forward(p, toks)), atol=1e-5, rtol=0)

    if tp == 2:
        paths = [path for path, _ in FALLBACK_CUTS[arch_id]]
        dims, theirs = eng.on_every_rank(ranks.leaf_dims, paths)
        assert all(d == dims for d in theirs)
        assert [d for d, _ in dims] == [dim for _, dim in FALLBACK_CUTS[arch_id]]
        assert [w for _, w in dims] == [path in KEEPS_WHOLE for path in paths]
    shapes, theirs = eng.on_every_rank(ranks.pool_shapes)
    assert all(s == shapes for s in theirs)
    _state_held(arch_id, cfg, tp, shapes)
    counts = {op: n for op, (n, _) in eng.collectives.items()}
    assert counts["reduce_partial"] > 0
    eng.close()


@pytest.mark.parametrize("tp", [2, 4])
def test_vlm_prefill(worlds, tp):
    """internvl2-26b's partitioned ``prefill_fn`` (patch embeddings and
    tokens to last-token logits): at tp 4 its 2 kv heads do not divide, so
    ``wk`` / ``wv`` are cut on the embed dim and each rank keeps the kv
    head its q head reads."""
    arch_id = "internvl2-26b"
    jcfg, cfg, jp, p = _models(arch_id, seed=50)
    rng = np.random.default_rng(tp)
    patches = rng.normal(size=(2, cfg.n_img_tokens, cfg.lm.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.lm.vocab, (2, 12)).astype(np.int32)
    batch = {"patch_embeds": torch.from_numpy(patches), "tokens": torch.from_numpy(toks)}
    model = W.TPModel(worlds(tp), W.EngineSpec(arch_id, cfg, W.GivenParams(p), None),
                      owns_world=False)
    assert model.rank0.engine is None
    got = model.same(W.model_prefill, batch)
    single = cbase.prefill_fn(ARCHS[arch_id], cfg)(p, batch)
    torch.testing.assert_close(got, single, atol=1e-5, rtol=0)
    want = jbase.prefill_fn(JARCHS[arch_id], jcfg)(
        jp, {"patch_embeds": jnp.asarray(patches), "tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=0)
    dims, _ = model.on_every_rank(ranks.leaf_dims, [("body", "u0", "attn", "wq"),
                                                   ("body", "u0", "attn", "wk")])
    assert dims[0][0] == 2 and dims[1][0] == (2 if tp == 2 else 1)
    model.close()


def test_encdec_encode_decode_train_and_steps(worlds):
    arch_id = "seamless-m4t-large-v2"
    jcfg, cfg, jp, p = _models(arch_id, seed=31)
    rng = np.random.default_rng(4)
    frames = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    tgt = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    model = W.TPModel(worlds(2), W.EngineSpec(arch_id, cfg, W.GivenParams(p), None),
                      owns_world=False)

    def kept(fn, *args):      # an enc-dec serving step on every rank, the bits compared
        return model.same(W.model_call, fn, *args)

    enc = kept(encdec.kept_encode, torch.from_numpy(frames))
    single = encdec.encode(p, cfg, torch.from_numpy(frames))
    torch.testing.assert_close(enc, single, atol=1e-5, rtol=0)
    je = jed.encode(jp, jcfg, jnp.asarray(frames))
    np.testing.assert_allclose(_np(enc), _np(je), atol=1e-4, rtol=0)
    mean = model.same(W.model_prefill, torch.from_numpy(frames))
    torch.testing.assert_close(mean, single.mean(dim=1), atol=1e-5, rtol=0)

    logits = kept(encdec.kept_decode_train, torch.from_numpy(tgt))
    hidden = encdec.decode_train(p, cfg, single, torch.from_numpy(tgt))
    torch.testing.assert_close(logits, layers.logits(p["embed"], hidden, cfg.compute_dtype),
                               atol=1e-5, rtol=0)
    jl = jlayers.logits(jp["embed"], jed.decode_train(jp, jcfg, je, jnp.asarray(tgt)),
                        jcfg.compute_dtype)
    np.testing.assert_allclose(_np(logits), _np(jl), atol=1e-4, rtol=0)

    # the caches every rank builds: its kv heads of the cross K/V, each
    # within one bf16 step of the single process's
    kept(encdec.kept_init_caches, 32)
    shapes, theirs = model.on_every_rank(ranks.model_cache_shapes)
    assert all(s == shapes for s in theirs)
    kv_local = cfg.n_kv_heads // 2
    assert shapes["cross/k"] == (cfg.n_dec_layers, 2, 24, kv_local, cfg.hd)
    assert shapes["self/k"] == (cfg.n_dec_layers, 2, 32, kv_local, cfg.hd)
    mine = model.rank0.state["caches"]["cross"]["k"].float()
    want = encdec.init_caches(p, cfg, single, 32, device="cpu")["cross"]["k"].float()
    want = want[:, :, :, :kv_local]
    assert (mine - want).abs().le(BF16_STEP * want.abs()).all()

    # decode steps from the reference's caches of each step, on every rank
    jc = jed.init_caches(jp, jcfg, je, 32)
    tok = np.zeros(2, np.int32)
    for t in range(4):
        host = tree_map(lambda a: torch.from_numpy(_np(a)).to(torch.bfloat16), jc)
        model.on_every_rank(ranks.load_caches, host)
        got = kept(encdec.kept_decode_step, torch.from_numpy(tok), t)
        _, want_port = encdec.decode_step(p, cfg, tree_map(torch.clone, host),
                                          torch.from_numpy(tok), t)
        jc, jl = jed.decode_step(jp, jcfg, jc, jnp.asarray(tok), jnp.int32(t))
        torch.testing.assert_close(got, want_port, atol=1e-5, rtol=0)
        np.testing.assert_allclose(_np(got), _np(jl), atol=1e-4, rtol=0)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    model.close()
