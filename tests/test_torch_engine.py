"""The port's slot-pool LM ``Engine`` (``repro_torch.serve.engine``) against
the reference ``Engine``, and its own invariants.

At ``compute_dtype=float32``, with the reference's smoke parameters carried
across, greedy token streams are identical to the reference engine's: ragged
prompts, fewer slots than requests (refill at block boundaries), ring caches
wrapping during prefill (gemma3 and starcoder2, window 16), EOS retirement
at a token the reference itself emits, and the slot-step counts.  Sampled
streams are the port's own (``torch.Generator`` per draw, not
``jax.random``): online equals offline, they do not depend on
``max_slots``, and ``top_k`` bounds the support.
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
from repro.serve import engine as jengine
from repro_torch import interop
from repro_torch.configs import ARCHS
from repro_torch.configs import base as cbase
from repro_torch.data.tokens import SyntheticTokens, TokenPipelineConfig
from repro_torch.serve import engine as pengine
from repro_torch.serve.runtime import GroupRecord

MAX_LEN = 64
DENSE_ARCHS = ("llama3.2-3b", "stablelm-3b", "gemma3-12b", "starcoder2-3b")
SERVE = dict(max_new_tokens=8, max_slots=3, max_len=MAX_LEN, decode_block=4)


def _prompts(n: int, seed: int, lo: int = 3, hi: int = 40) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 256, int(rng.integers(lo, hi))).astype(np.int32)
            for _ in range(n)]


@pytest.fixture(scope="module")
def models():
    """Per arch: the f32-compute configs, the reference's params and the
    port's copy."""
    out = {}
    for i, arch_id in enumerate(DENSE_ARCHS):
        jcfg = dataclasses.replace(JARCHS[arch_id].make_smoke(), compute_dtype=jnp.float32)
        cfg = dataclasses.replace(ARCHS[arch_id].make_smoke(), compute_dtype=torch.float32)
        jp = jinit.materialize(jbase.model_spec(JARCHS[arch_id], jcfg),
                               jax.random.PRNGKey(20 + i))
        out[arch_id] = (jcfg, cfg, jp,
                        interop.from_reference(jax.tree.map(np.asarray, jp), device="cpu"))
    return out


def _ref_engine(models, arch_id, **kw):
    jcfg, _, jp, _ = models[arch_id]
    step, init = jbase.serve_fns(JARCHS[arch_id], jcfg, max_len=MAX_LEN)
    return jengine.Engine(step, init, jengine.ServeConfig(**{**SERVE, **kw}), params=jp)


def _engine(models, arch_id, **kw):
    _, cfg, _, p = models[arch_id]
    step, init = cbase.serve_fns(ARCHS[arch_id], cfg, max_len=MAX_LEN)
    return pengine.Engine(step, init, pengine.ServeConfig(**{**SERVE, **kw}), params=p)


def _run(eng, prompts, module, **kw):
    return eng.run([module.Request(uid=i, prompt=p, **kw) for i, p in enumerate(prompts)])


def _streams(results) -> dict:
    return {u: (r.tokens.tolist(), r.finished_by_eos, r.prompt_len)
            for u, r in results.items()}


@pytest.fixture(scope="module")
def greedy(models):
    """Each arch's reference and port greedy run of the same 7 ragged
    requests on 3 slots, with both engines' stats."""
    out = {}
    prompts = _prompts(7, seed=1)
    for arch_id in DENSE_ARCHS:
        jeng, eng = _ref_engine(models, arch_id), _engine(models, arch_id)
        out[arch_id] = (_run(jeng, prompts, jengine), jeng.stats,
                        _run(eng, prompts, pengine), eng.stats)
    return prompts, out


@pytest.mark.parametrize("arch_id", DENSE_ARCHS)
def test_greedy_streams_match_reference(greedy, arch_id):
    _, runs = greedy
    jres, jstats, res, stats = runs[arch_id]
    assert _streams(res) == _streams(jres)
    assert {u: r.slot for u, r in res.items()} == {u: r.slot for u, r in jres.items()}
    for key in ("requests", "tokens", "decode_blocks", "slot_steps",
                "active_slot_steps", "prefills", "slots_served"):
        assert stats[key] == jstats[key], key


def test_eos_retirement_matches_reference(models, greedy):
    """EOS at a token the reference's greedy run emits mid-stream: the same
    requests stop at the same place, with the same slot steps."""
    prompts, runs = greedy
    jres = runs["llama3.2-3b"][0]
    eos = next(int(t) for u in sorted(jres) for t in jres[u].tokens[2:5])
    jeng = _ref_engine(models, "llama3.2-3b", eos_id=eos, pad_id=7)
    eng = _engine(models, "llama3.2-3b", eos_id=eos, pad_id=7)
    want, got = _run(jeng, prompts, jengine), _run(eng, prompts, pengine)
    assert _streams(got) == _streams(want)
    assert any(r.finished_by_eos for r in got.values())
    assert all(r.tokens[-1] == eos for r in got.values() if r.finished_by_eos)
    for key in ("slot_steps", "active_slot_steps", "decode_blocks", "prefills"):
        assert eng.stats[key] == jeng.stats[key], key


def test_online_submit_drain_equals_run(models):
    """``submit`` / ``drain_ready`` in groups as traffic arrives gives the
    streams of the offline ``run``, greedy and sampled; records are
    stamped."""
    prompts = _prompts(7, seed=2)
    for kw in ({}, dict(temperature=0.8, top_k=20, seed=3)):
        offline = _streams(_run(_engine(models, "gemma3-12b", **kw), prompts, pengine))
        eng = _engine(models, "gemma3-12b", **kw)
        reqs = [pengine.Request(uid=i, prompt=p) for i, p in enumerate(prompts)]
        recs, got = [], {}
        for i in range(0, len(reqs), 2):
            recs.append(eng.submit(reqs[i:i + 2]))
            got.update(eng.drain_ready())
        got.update(eng.drain_all())
        assert _streams(got) == offline
        assert all(isinstance(r, GroupRecord) and r.dispatch_t is not None
                   and r.done_t is not None and r.variant == "lm" for r in recs)
        assert eng.inflight == 0 and eng.accepting


def test_sampled_streams_do_not_depend_on_slots_or_order(models):
    prompts = _prompts(6, seed=4)
    kw = dict(temperature=1.0, top_k=None, seed=11)
    a = _streams(_run(_engine(models, "llama3.2-3b", **kw), prompts, pengine))
    b = _streams(_run(_engine(models, "llama3.2-3b", max_slots=5, **kw), prompts,
                      pengine))
    eng = _engine(models, "llama3.2-3b", max_slots=2, **kw)
    c = _streams(eng.run([pengine.Request(uid=i, prompt=prompts[i])
                          for i in reversed(range(len(prompts)))]))
    assert a == b == c
    greedy = _streams(_run(_engine(models, "llama3.2-3b"), prompts, pengine))
    assert a != greedy
    d = _streams(_run(_engine(models, "llama3.2-3b", **{**kw, "seed": 12}), prompts,
                      pengine))
    assert a != d


def test_top_k_bounds_the_support():
    """Draws from the sampler stay inside each row's k best logits and, over
    many draws, reach all of them."""
    eng = pengine.Engine.__new__(pengine.Engine)
    eng.cfg = pengine.ServeConfig(temperature=0.7, top_k=4, seed=0)
    logits = torch.from_numpy(np.random.default_rng(5).standard_normal((3, 50))
                              .astype(np.float32))
    top = torch.topk(logits, 4).indices
    seen = [set() for _ in range(3)]
    for index in range(200):
        draw = eng._sample(logits, [(7, index), (8, index), (9, index)])
        for row in range(3):
            seen[row].add(int(draw[row]))
    assert seen == [set(top[row].tolist()) for row in range(3)]
    again = eng._sample(logits, [(7, 5), (8, 5), (9, 5)])
    assert torch.equal(again, eng._sample(logits, [(7, 5), (8, 5), (9, 5)]))
    assert pengine.stream_seed(0, 1, 2) != pengine.stream_seed(0, 1 + 2 ** 32, 2)
    assert pengine.stream_seed(0, -1, 0) != pengine.stream_seed(0, 2 ** 64 - 2, 0)


def test_budgets_validation_and_stats(models):
    eng = _engine(models, "starcoder2-3b")
    prompts = _prompts(4, seed=6)
    res = eng.run([pengine.Request(uid=i, prompt=p, max_new_tokens=i + 1)
                   for i, p in enumerate(prompts)])
    assert [len(res[i].tokens) for i in range(4)] == [1, 2, 3, 4]
    assert eng.runs[-1]["warmup"] and eng.tokens_per_s() > 0
    eng.run([pengine.Request(uid=9, prompt=prompts[0], max_new_tokens=2)])
    assert eng.stats["measured"]["work"] == 2 and not eng.runs[-1]["warmup"]
    assert 0.0 < eng.utilization() <= 1.0
    bad = [(pengine.Request(uid=1, prompt=np.zeros(0, np.int32)), "empty prompt"),
           (pengine.Request(uid=1, prompt=prompts[0], max_new_tokens=0), ">= 1"),
           (pengine.Request(uid=1, prompt=np.ones(60, np.int32)), "exceeds max_len")]
    for req, match in bad:
        with pytest.raises(ValueError, match=match):
            eng.run([req])
    with pytest.raises(ValueError, match="duplicate"):
        eng.run([pengine.Request(uid=1, prompt=prompts[0])] * 2)
    with pytest.raises(ValueError, match="exceeds the 3-slot pool"):
        eng.submit([pengine.Request(uid=i, prompt=prompts[0]) for i in range(4)])
    unbound = pengine.Engine(*cbase.serve_fns(ARCHS["starcoder2-3b"],
                                              ARCHS["starcoder2-3b"].make_smoke(),
                                              MAX_LEN),
                             pengine.ServeConfig(max_len=MAX_LEN))
    with pytest.raises(ValueError, match="no params bound"):
        unbound.submit([pengine.Request(uid=0, prompt=prompts[0])])


def test_lm_engine_on_the_cpu_with_synthetic_tokens():
    """``lm_engine`` draws a smoke arch on the device it is given and
    serves ``SyntheticTokens`` prompts (the reference's generator, copied:
    the same streams from the same seed)."""
    from repro.data.tokens import SyntheticTokens as JTokens
    from repro.data.tokens import TokenPipelineConfig as JConfig

    eng, cfg = cbase.lm_engine("llama3.2-3b", pengine.ServeConfig(max_len=48,
                                                                  max_new_tokens=4),
                               device="cpu")
    assert eng.device.type == "cpu" and cfg.vocab == 256
    pipe = TokenPipelineConfig(vocab_size=cfg.vocab, seq_len=12, global_batch=5, seed=2)
    toks, targets = SyntheticTokens(pipe).batch(0)
    jtoks, jtargets = JTokens(JConfig(**dataclasses.asdict(pipe))).batch(0)
    assert np.array_equal(toks, jtoks) and np.array_equal(targets, jtargets)
    out = eng.generate(list(toks))
    assert out.shape == (5, 4) and ((0 <= out) & (out < cfg.vocab)).all()


# ---------------------------------------------------------------------------
# the recurrent kinds: exact-length (stateful) prefill
# ---------------------------------------------------------------------------

RECURRENT = ("rwkv6-7b", "recurrentgemma-9b")
# three distinct lengths, two past griffin's smoke window of 16, so its ring
# caches wrap during prefill
RAGGED = (5, 21, 9, 21, 5, 18)


@pytest.fixture(scope="module")
def recurrent():
    """Per recurrent arch: the f32-compute configs, the reference's params
    and the port's copy."""
    out = {}
    for i, arch_id in enumerate(RECURRENT):
        jcfg = dataclasses.replace(JARCHS[arch_id].make_smoke(), compute_dtype=jnp.float32)
        cfg = dataclasses.replace(ARCHS[arch_id].make_smoke(), compute_dtype=torch.float32)
        jp = jinit.materialize(jbase.model_spec(JARCHS[arch_id], jcfg),
                               jax.random.PRNGKey(60 + i))
        out[arch_id] = (jcfg, cfg, jp,
                        interop.from_reference(jax.tree.map(np.asarray, jp), device="cpu"))
    return out


def test_serve_fns_tag_forces_stateful_prefill():
    """rwkv / griffin served with a default ServeConfig must not run
    bucketed pad steps through cumulative state: ``serve_fns`` tags
    ``init_caches`` and the Engine turns the flag on by itself; positional
    KV caches keep bucketed prefill (the reference's test, for both
    recurrent kinds)."""
    for arch_id in RECURRENT:
        arch = ARCHS[arch_id]
        step, init_caches = cbase.serve_fns(arch, arch.make_smoke(), max_len=MAX_LEN)
        assert init_caches.stateful_prefill
        eng = pengine.Engine(step, init_caches, pengine.ServeConfig(max_len=MAX_LEN))
        assert eng.cfg.stateful_prefill
    arch = ARCHS["llama3.2-3b"]
    step, init_caches = cbase.serve_fns(arch, arch.make_smoke(), max_len=MAX_LEN)
    assert not init_caches.stateful_prefill
    eng = pengine.Engine(step, init_caches, pengine.ServeConfig(max_len=MAX_LEN))
    assert not eng.cfg.stateful_prefill


@pytest.mark.parametrize("arch_id", RECURRENT)
def test_stateful_prefill_ragged_matches_reference(recurrent, arch_id):
    """Six ragged requests of three distinct lengths on four slots at f32
    compute: greedy streams, slots and stats identical to the reference
    ``Engine``'s (one exact-length prefill per distinct length of each
    admission group, in ascending length), and each stream equal to the
    request served alone."""
    jcfg, cfg, jp, p = recurrent[arch_id]
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in RAGGED]
    kw = dict(max_new_tokens=6, max_slots=4, max_len=MAX_LEN, decode_block=4)
    jstep, jinit_ = jbase.serve_fns(JARCHS[arch_id], jcfg, max_len=MAX_LEN)
    jeng = jengine.Engine(jstep, jinit_, jengine.ServeConfig(**kw), params=jp)
    step, init_ = cbase.serve_fns(ARCHS[arch_id], cfg, max_len=MAX_LEN)
    eng = pengine.Engine(step, init_, pengine.ServeConfig(**kw), params=p)
    want, got = _run(jeng, prompts, jengine), _run(eng, prompts, pengine)
    assert _streams(got) == _streams(want)
    assert {u: r.slot for u, r in got.items()} == {u: r.slot for u, r in want.items()}
    # first group: lengths 5, 21, 9, 21 -> three scans; the refills (5, 18)
    # come one request at a time as slots free
    assert eng.stats["prefills"] == jeng.stats["prefills"] >= 3
    for key in ("requests", "tokens", "decode_blocks", "slot_steps",
                "active_slot_steps", "slots_served"):
        assert eng.stats[key] == jeng.stats[key], key
    for i, prompt in enumerate(prompts):
        alone = eng.run([pengine.Request(uid=100 + i, prompt=prompt)])[100 + i]
        np.testing.assert_array_equal(alone.tokens, got[i].tokens)


def test_stateful_prefill_runs_one_scan_per_distinct_length(recurrent):
    """Admission under ``stateful_prefill`` scans each distinct prompt
    length once, in ascending length, at exactly that length: no pad step
    reaches the recurrent state."""
    _, cfg, _, p = recurrent["rwkv6-7b"]
    step, init_ = cbase.serve_fns(ARCHS["rwkv6-7b"], cfg, max_len=MAX_LEN)
    eng = pengine.Engine(step, init_, pengine.ServeConfig(
        max_new_tokens=2, max_slots=4, max_len=MAX_LEN, decode_block=2), params=p)
    scans = []
    prefill = eng._prefill
    eng._prefill = lambda caches, tokens, plens: (
        scans.append((tokens.shape[1], sorted(set(plens.tolist()) - {0}))),
        prefill(caches, tokens, plens))[1]
    rng = np.random.default_rng(8)
    eng.run([pengine.Request(uid=i, prompt=rng.integers(0, 256, n).astype(np.int32))
             for i, n in enumerate((12, 3, 12, 7))])
    assert scans == [(3, [3]), (7, [7]), (12, [12])]
    assert eng.stats["prefills"] == 3


def test_stateful_prefill_set_by_the_caller_on_positional_caches(models):
    """``ServeConfig.stateful_prefill`` set by the caller, as a ``deploy()``
    option (an LM's ``ServeConfig`` overrides) and so a golden trace's
    recorded options can carry it, on a positional KV arch at f32 compute:
    greedy streams and stats equal to the reference ``Engine``'s under the
    same flag, one prefill scan per distinct length of each admission
    group, and the streams equal to bucketed prefill's."""
    prompts = _prompts(7, seed=4)
    jeng = _ref_engine(models, "llama3.2-3b", stateful_prefill=True)
    eng = _engine(models, "llama3.2-3b", stateful_prefill=True)
    got = _run(eng, prompts, pengine)
    assert _streams(got) == _streams(_run(jeng, prompts, jengine))
    for key in ("prefills", "requests", "tokens", "decode_blocks", "slot_steps",
                "active_slot_steps"):
        assert eng.stats[key] == jeng.stats[key], key
    plain = _engine(models, "llama3.2-3b")
    bucketed = _run(plain, prompts, pengine)
    assert not plain.cfg.stateful_prefill
    # the first group's three prompts have three lengths: three scans for one
    assert eng.stats["prefills"] > plain.stats["prefills"]
    assert {u: r.tokens.tolist() for u, r in got.items()} == \
        {u: r.tokens.tolist() for u, r in bucketed.items()}


def test_rwkv_beside_nvsa_through_deploy_and_trace(tmp_path, monkeypatch):
    """``deploy(["nvsa", "rwkv6-7b"])`` on the CPU behind one front door on a
    virtual clock, the LM at f32 compute: every request answered, the rwkv
    streams equal to the reference ``Engine``'s over the same parameters,
    and a golden trace of the serve replays bit-exact through the same and
    a fresh deployment (tokens and answers exact)."""
    import importlib

    from repro_torch.backend import registry
    from repro_torch.serve import trace as p_trace

    p_deploy = importlib.import_module("repro_torch.serve.deploy")

    arch_id = "rwkv6-7b"
    arch = ARCHS[arch_id]
    monkeypatch.setitem(ARCHS, arch_id, dataclasses.replace(
        arch, make_smoke=lambda: dataclasses.replace(arch.make_smoke(),
                                                     compute_dtype=torch.float32)))
    t = [0.0]

    def sleep(dt):
        t[0] += dt

    budget = dict(max_pes=1024, max_batch=4, max_slots=2, max_len=MAX_LEN,
                  max_new_tokens=6)
    dep = p_deploy.deploy(["nvsa", arch_id],
                          p_deploy.Traffic(rate_rps=50.0, deadline_s=0.01),
                          p_deploy.Budget(**budget), seed=3,
                          options={"nvsa": {"variant": "oracle", "d": 128}},
                          clock=lambda: t[0], sleep=sleep,
                          device="cpu")
    assert dep.classes == {"nvsa": "reason", arch_id: "lm"}
    assert dep.engines[arch_id].cfg.stateful_prefill
    arrivals = list(dep.synthetic_traffic(6)[0])
    path = str(tmp_path / "rwkv.jsonl")
    report, trace = p_trace.record(dep, arrivals, path)
    assert {m: sorted(r) for m, r in report.results.items()} == \
        {"nvsa": list(range(6)), arch_id: list(range(6))}
    assert {g.model for g in report.groups} == {"nvsa", arch_id}

    jcfg = dataclasses.replace(JARCHS[arch_id].make_smoke(), compute_dtype=jnp.float32)
    jp = jax.tree.map(lambda x: jnp.asarray(x.numpy()), dep.engines[arch_id].params)
    jstep, jinit_ = jbase.serve_fns(JARCHS[arch_id], jcfg, max_len=MAX_LEN)
    jeng = jengine.Engine(jstep, jinit_, jengine.ServeConfig(
        max_slots=2, max_len=MAX_LEN, max_new_tokens=6), params=jp)
    want = jeng.run([jengine.Request(uid=a.request.uid, prompt=a.request.prompt)
                     for a in arrivals if a.model == arch_id])
    for uid, res in want.items():
        np.testing.assert_array_equal(report.results[arch_id][uid].tokens, res.tokens)

    for kw in ({"deployment": dep}, {"backend": registry.negotiate("cpu")}):
        diff = p_trace.GoldenTrace.load(path).replay_and_diff(**kw)
        assert diff.tolerance == 0.0 and diff.n_compared == 12
        assert diff.ok, diff.describe()
