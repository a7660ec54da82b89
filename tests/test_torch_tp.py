"""Tensor-parallel LM serving (``repro_torch.distributed.world``) on the
CPU, against the single-process port and the reference.

One gloo world per size (2 and 4 ranks, each a spawned process beside this
one), shared by the module's engines, with a join timeout.  At f32 compute
and smoke width, with the reference's parameters carried across by
``interop.from_reference``:

- stablelm-3b at tp 2 and 4 (every leaf cut on its preferred axis),
  llama3.2-3b at tp 4 (its 2 kv heads do not divide 4: the rules cut
  ``wk`` / ``wv`` along the embed dim, and each rank keeps the kv head its
  q head reads) and gemma3-12b at tp 2 (sliding-window and global layers,
  q/k norms cut on the head dim and read whole, the (1 + w) norm offset,
  the embedding scale and the logit soft cap): ``Engine.run`` token
  streams equal the single-process port's and the reference's
  single-device engine's; forward logits within 1e-5 of the
  single-process port's, the same bits on every rank.
- granite-moe at tp 2: each shard's ``moe_gather(expert_shard=)`` equals
  the reference's, the world's reduced block equals the unsharded one,
  and the served decode is the forward's argmax.
- the refusals of ``lm_engine`` / ``lm_engine_pool`` / ``deploy``; a call
  that every rank refuses before any collective leaves the world up, one
  that raises after a collective closes it; and a worker killed mid-run,
  which makes rank 0 raise within the timeout.

The reference's TP path fails on this host (``tests/test_serve_tp.py``:
its vocab-sharded gather raises), so TP is held against its single-device
engine.  About 50 s alone in one process.
"""

import dataclasses
import importlib
import time

import _torch_tp_ranks as ranks
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import base as jbase
from repro.nn import init as jinit
from repro.nn import moe as jmoe
from repro.serve import engine as jengine
from repro_torch import interop
from repro_torch.configs import ARCHS
from repro_torch.configs import base as cbase
from repro_torch.distributed import world as W
from repro_torch.nn import moe
from repro_torch.serve import engine as pengine
from repro_torch.serve.replica import ReplicaPool

torch.set_num_threads(2)

MAX_LEN = 64
SERVE = dict(max_new_tokens=4, max_slots=3, max_len=MAX_LEN, decode_block=4)
TIMEOUT_S = 30.0
KILL_TIMEOUT_S = 10.0


def _prompts(n: int, seed: int) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 256, int(rng.integers(3, 15))).astype(np.int32)
            for _ in range(n)]


def _models(arch_id: str, seed: int):
    """The f32-compute configs, the reference's params and the port's copy."""
    jcfg = dataclasses.replace(JARCHS[arch_id].make_smoke(), compute_dtype=jnp.float32)
    cfg = dataclasses.replace(ARCHS[arch_id].make_smoke(), compute_dtype=torch.float32)
    jp = jinit.materialize(jbase.model_spec(JARCHS[arch_id], jcfg), jax.random.PRNGKey(seed))
    return jcfg, cfg, jp, interop.from_reference(jax.tree.map(np.asarray, jp), device="cpu")


def _tokens(results) -> dict:
    return {u: r.tokens.tolist() for u, r in results.items()}


@pytest.fixture(scope="module")
def worlds():
    """One world of each size, opened on first use, closed (joined with a
    timeout) after the module."""
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


def _tp_engine(world, arch_id, cfg, params, **serve):
    spec = W.EngineSpec(arch_id, cfg, W.GivenParams(params),
                        pengine.ServeConfig(**{**SERVE, **serve}))
    return W.TPEngine(world, spec, owns_world=False)


@pytest.fixture(scope="module")
def expected():
    """Per arch, computed once: the models, the prompts, and the streams of
    the reference's single-device engine and the single-process port."""
    cache = {}

    def get(arch_id: str):
        if arch_id not in cache:
            jcfg, cfg, jp, p = _models(arch_id, seed=7)
            prompts = _prompts(4, seed=len(cache))
            step, init = jbase.serve_fns(JARCHS[arch_id], jcfg, max_len=MAX_LEN)
            ref = jengine.Engine(step, init, jengine.ServeConfig(**SERVE), params=jp).run(
                [jengine.Request(uid=i, prompt=q) for i, q in enumerate(prompts)])
            step, init = cbase.serve_fns(ARCHS[arch_id], cfg, max_len=MAX_LEN)
            single = pengine.Engine(step, init, pengine.ServeConfig(**SERVE), params=p)
            reqs = [pengine.Request(uid=i, prompt=q) for i, q in enumerate(prompts)]
            want = _tokens(single.run(reqs))
            assert want == _tokens(ref)
            cache[arch_id] = cfg, p, reqs, want
        return cache[arch_id]

    return get


@pytest.mark.parametrize("arch_id, tp", [("stablelm-3b", 2), ("stablelm-3b", 4),
                                         ("llama3.2-3b", 4), ("gemma3-12b", 2)])
def test_tp_streams_and_logits_equal_single_device(worlds, expected, arch_id, tp):
    cfg, p, reqs, want = expected(arch_id)
    eng = _tp_engine(worlds(tp), arch_id, cfg, p)
    assert eng.tp == tp and eng.devices == (torch.device("cpu"),) * tp
    assert _tokens(eng.run(reqs)) == want
    if tp == 2:
        # the same uids online: one admission group at a time
        eng.submit(reqs[:3])
        online = dict(eng.drain_ready())
        eng.submit(reqs[3:])
        online.update(eng.drain_all())
        assert _tokens(online) == want

    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 24)))
    forward, readout = cbase.forward_fn(ARCHS[arch_id], cfg)
    whole = readout(p, forward(p, toks))
    got = eng.forward(toks)          # raises unless every rank has these bits
    assert got.shape == whole.shape
    torch.testing.assert_close(got, whole, atol=1e-5, rtol=0)

    dims, theirs = eng.on_every_rank(ranks.cut_dims)
    assert all(d == dims for d in theirs)
    heads, _ = eng.on_every_rank(ranks.kv_cache_heads)
    if arch_id == "llama3.2-3b":
        # the fallback engaged: wq cut on its heads, wk / wv on the embed dim
        # (stacked leaves: (layers, d, heads, hd)), one kv head per rank
        assert dims["wq"] == 2 and dims["wk"] == dims["wv"] == 1 and heads == 1
    else:
        assert dims["wq"] == dims["wk"] == 2 and heads == cfg.n_kv_heads // tp
    assert dims["wo"] == 1
    counts = {op: n for op, (n, _) in eng.collectives.items()}
    assert counts["reduce_partial"] > 0 and counts["gather_last"] > 0
    eng.close()


def test_heads_that_do_not_divide_the_group(worlds):
    """starcoder2's smoke width with 6 heads at tp 4: the heads do not
    divide, so the rules cut ``wq`` and ``wk`` along the embed dim (every
    rank attends over all heads) and ``wo`` along its head dim, and the q /
    k biases along theirs; the windowed attention, the biased GELU MLP and
    the decode cache take those cuts.  Streams and f32 logits equal the
    single process's."""
    cfg = dataclasses.replace(ARCHS["starcoder2-3b"].make_smoke(), n_heads=6,
                              compute_dtype=torch.float32)
    arch = ARCHS["starcoder2-3b"]
    p = cbase.nninit.materialize(cbase.model_spec(arch, cfg),
                                 torch.Generator().manual_seed(9))
    reqs = [pengine.Request(uid=i, prompt=q) for i, q in enumerate(_prompts(3, seed=5))]
    step, init = cbase.serve_fns(arch, cfg, max_len=MAX_LEN)
    want = _tokens(pengine.Engine(step, init, pengine.ServeConfig(**SERVE), params=p).run(reqs))
    eng = _tp_engine(worlds(4), "starcoder2-3b", cfg, p)
    assert _tokens(eng.run(reqs)) == want
    dims, _ = eng.on_every_rank(ranks.cut_dims)
    assert (dims["wq"], dims["wk"], dims["wo"], dims["bq"]) == (1, 1, 2, 2)
    assert eng.on_every_rank(ranks.kv_cache_heads)[0] == cfg.n_kv_heads
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (2, 20)))
    forward, readout = cbase.forward_fn(arch, cfg)
    torch.testing.assert_close(eng.forward(toks), readout(p, forward(p, toks)),
                               atol=1e-5, rtol=0)
    eng.close()


def test_moe_expert_shards_and_decode(worlds):
    jcfg, cfg, jp, p = _models("granite-moe-1b-a400m", seed=3)
    layer = jax.tree.map(lambda a: a[0], jp["body"])["u0"]["ffn"]
    player = interop.from_reference(jax.tree.map(np.asarray, layer), device="cpu")
    x = np.random.default_rng(0).standard_normal((9, cfg.d_model)).astype(np.float32)
    e = cfg.moe.n_experts
    whole, _ = moe.moe_gather(player, cfg.moe, torch.from_numpy(x), torch.float32)
    parts = []
    for shard in ((0, e // 2), (e // 2, e // 2)):
        got, aux = moe.moe_gather(player, cfg.moe, torch.from_numpy(x), torch.float32,
                                  expert_shard=shard)
        want, jaux = jmoe.moe_gather(layer, jcfg.moe, jnp.asarray(x), jnp.float32,
                                     expert_shard=shard)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
        np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6)
        parts.append(got)
    torch.testing.assert_close(parts[0] + parts[1], whole, atol=1e-5, rtol=0)

    eng = _tp_engine(worlds(2), "granite-moe-1b-a400m", cfg, p)
    block, theirs = eng.on_every_rank(ranks.first_moe_block, torch.from_numpy(x)[None])
    want, _ = moe.moe_block(player, cfg.moe, torch.from_numpy(x)[None], torch.float32)
    torch.testing.assert_close(block, want, atol=1e-5, rtol=0)
    assert all(torch.equal(t, block) for t in theirs)

    prompts = _prompts(3, seed=11)
    served = eng.run([pengine.Request(uid=i, prompt=q) for i, q in enumerate(prompts)])
    forward, readout = cbase.forward_fn(ARCHS["granite-moe-1b-a400m"], cfg)
    held = 0
    for uid, q in enumerate(prompts):
        toks = served[uid].tokens
        seq = torch.from_numpy(np.concatenate([q, toks[:-1]]).astype(np.int64))[None]
        logits = readout(p, forward(p, seq))[0, len(q) - 1:]
        top2 = logits.topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > 1e-4      # outside near ties
        assert torch.equal(logits.argmax(-1)[sure], torch.from_numpy(toks).long()[sure])
        held += int(sure.sum())
    assert held >= 12
    eng.close()


def test_refusals_name_their_escape():
    with pytest.raises(ValueError, match="devices="):
        cbase.lm_engine("llama3.2-3b", tp=2, devices=("cpu",))
    with pytest.raises(ValueError, match="exceeds the device pool"):
        cbase.lm_engine("llama3.2-3b", tp=2)           # no CUDA here: an empty pool
    with pytest.raises(ValueError, match="not both"):
        cbase.lm_engine("llama3.2-3b", tp=2, device="cpu")
    # experts that do not divide the group (granite's 4 at tp 3), and heads
    # a cut would split (rwkv's 4 heads of 16 at tp 8), are #9's remainder
    for arch_id, tp in (("granite-moe-1b-a400m", 3), ("rwkv6-7b", 8)):
        with pytest.raises(NotImplementedError, match="#9"):
            cbase.lm_engine(arch_id, tp=tp, devices=("cpu",) * tp)
    with pytest.raises(ValueError, match="pick one axis"):
        cbase.lm_engine_pool("llama3.2-3b", replicas=2, tp=2)
    deploy_mod = importlib.import_module("repro_torch.serve.deploy")
    with pytest.raises(ValueError, match=r"Budget\(devices=\)"):
        deploy_mod.deploy(["llama3.2-3b"], budget=deploy_mod.Budget(tp=2), device="cpu",
                          preflight="off")
    with pytest.raises(ValueError, match="tp must be"):
        cbase.lm_engine("llama3.2-3b", tp=0)
    # replicas of one device: the same parameters, so the same streams
    pool, cfg = cbase.lm_engine_pool("llama3.2-3b", pengine.ServeConfig(**SERVE),
                                     key=torch.Generator().manual_seed(5), replicas=2,
                                     device="cpu")
    assert isinstance(pool, ReplicaPool) and len(pool) == 2
    a, b = pool.replicas
    prompts = _prompts(2, seed=2)
    assert _tokens(a.run([pengine.Request(uid=i, prompt=q) for i, q in enumerate(prompts)])) \
        == _tokens(b.run([pengine.Request(uid=i, prompt=q) for i, q in enumerate(prompts)]))


def test_a_dead_worker_breaks_the_world_within_the_timeout():
    _, cfg, _, p = _models("llama3.2-3b", seed=1)
    spec = W.EngineSpec("llama3.2-3b", cfg, W.GivenParams(p), pengine.ServeConfig(**SERVE))
    world = W.World(("cpu", "cpu"), timeout_s=KILL_TIMEOUT_S)
    eng = W.TPEngine(world, spec)
    reqs = [pengine.Request(uid=i, prompt=q) for i, q in enumerate(_prompts(3, seed=4))]
    eng.submit(reqs)
    world._procs[0].kill()
    t0 = time.monotonic()
    with pytest.raises(W.WorldError, match="rank 1"):
        eng.drain_all()
    assert time.monotonic() - t0 < KILL_TIMEOUT_S
    assert world.closed and not world._procs[0].is_alive()
    with pytest.raises(W.WorldError, match="closed"):
        eng.drain_all()


def test_a_call_raised_after_a_collective_breaks_the_world():
    """Every rank raising the same type leaves the world up only when no
    collective had started: the ranks' engines are then as they were."""
    _, cfg, _, p = _models("llama3.2-3b", seed=1)
    spec = W.EngineSpec("llama3.2-3b", cfg, W.GivenParams(p), pengine.ServeConfig(**SERVE))
    eng = W.TPEngine(W.World(("cpu", "cpu"), timeout_s=KILL_TIMEOUT_S), spec)
    with pytest.raises(ValueError, match="before any collective"):
        eng.on_every_rank(ranks.refuse_before_any_collective)
    assert not eng.world.closed
    reqs = [pengine.Request(uid=i, prompt=q) for i, q in enumerate(_prompts(2, seed=6))]
    assert len(eng.run(reqs)) == 2
    with pytest.raises(W.WorldError, match="after a collective") as e:
        eng.on_every_rank(ranks.raise_after_a_collective)
    assert isinstance(e.value.__cause__, ValueError)
    assert eng.world.closed and not any(proc.is_alive() for proc in eng.world._procs)
