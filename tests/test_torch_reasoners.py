"""Parity of the port's LVRF and PrAE modules, and of the three new served
workloads, with the JAX reference on the CPU.

LVRF's stages and PrAE's solver on the same numpy PMFs and the reference's
constants (carried across by ``interop.from_reference``), then the port's
engine against the reference's engine for ``mimonet``, ``lvrf`` and
``prae``.  The reference runs under the negotiated CPU plan (Pallas in
interpret mode).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_mimonet import CPU_PLAN, draw_spec, ref_keys

from repro.backend import registry as jregistry
from repro.configs import base as jcb
from repro.models import lvrf as jlv
from repro.models import mimonet as jmm
from repro.models import nvsa as jnv
from repro.models import prae as jpr
from repro.serve import reason as jreason
from repro_torch import interop
from repro_torch.backend import registry
from repro_torch.configs import base as cb
from repro_torch.data import raven
from repro_torch.models import lvrf as lv
from repro_torch.models import prae as pr
from repro_torch.serve.reason import ReasonConfig, ReasonRequest

torch.set_num_threads(2)

SIZES = raven.RavenConfig().attr_sizes


def _pmfs(n: int, seed: int, one_hot: bool = False):
    """Per-attribute (N, 8, V) PMFs from numpy: softmaxed normals, or the
    one-hot PMFs of random attribute values."""
    rng = np.random.default_rng(seed)
    out = []
    for v in SIZES:
        if one_hot:
            out.append(np.eye(v, dtype=np.float32)[rng.integers(0, v, (n, 8))])
        else:
            z = rng.standard_normal((n, 8, v)) * 2
            e = np.exp(z - z.max(-1, keepdims=True))
            out.append((e / e.sum(-1, keepdims=True)).astype(np.float32))
    return out


def _t(tree):
    return [torch.from_numpy(np.array(x)) for x in tree]


@functools.lru_cache(maxsize=None)
def lvrf_consts(d: int):
    """The reference LVRF's learned params (numpy draw of its spec) and
    its FPE books (``jax.random`` key 1)."""
    jcfg = jlv.LVRFConfig(d=d)
    books = [np.asarray(b) for b in jlv.lvrf_codebooks(jcfg, jax.random.PRNGKey(1))]
    return {"params": draw_spec(jlv.lvrf_spec(jcfg), seed=d), "books": books}


# -- LVRF ---------------------------------------------------------------------


@pytest.mark.parametrize("d", [64, 128])
def test_lvrf_stages_match_reference(d):
    """encode_codes, abduce and execute, each on the reference's previous
    output: codes, rule posteriors and answer log-probs within 1e-4.  At
    d = 128 the binds take the circ_conv route (plain version here, Pallas
    interpret in the reference)."""
    cfg, jcfg = lv.LVRFConfig(d=d), jlv.LVRFConfig(d=d)
    consts = lvrf_consts(d)
    tc = interop.from_reference(consts, "cpu")
    ctx, cand = _pmfs(3, seed=d), _pmfs(3, seed=d + 1)
    jp = jax.tree.map(jnp.asarray, consts["params"])
    jb = [jnp.asarray(b) for b in consts["books"]]
    with jregistry.use_plan(CPU_PLAN):
        codes = jlv.encode_codes(jb, jcfg, [jnp.asarray(x) for x in ctx])
        posts = jlv.abduce(jp, jcfg, codes)
        logp = jlv.execute(jp, jb, jcfg, codes, posts, [jnp.asarray(x) for x in cand])
    got_codes = lv.encode_codes(tc["books"], cfg, _t(ctx))
    np.testing.assert_allclose(got_codes.numpy(), np.asarray(codes), atol=1e-5, rtol=0)
    got_posts = lv.abduce(tc["params"], cfg, torch.from_numpy(np.array(codes)))
    assert got_posts.shape == (3, 3, cfg.n_rules)
    np.testing.assert_allclose(got_posts.numpy(), np.asarray(posts), atol=1e-4, rtol=0)
    got_logp = lv.execute(tc["params"], tc["books"], cfg,
                          torch.from_numpy(np.array(codes)),
                          torch.from_numpy(np.array(posts)), _t(cand))
    assert got_logp.shape == (3, 8)
    np.testing.assert_allclose(got_logp.numpy(), np.asarray(logp), atol=1e-4, rtol=0)
    before = dict(registry.LAUNCHES)
    with registry.record_kernels() as rec:
        solved, _ = lv.solve_from_pmfs(tc["params"], tc["books"], cfg, _t(ctx), _t(cand))
    assert registry.LAUNCHES == before
    route = "kernel" if d >= 128 else "gather"
    assert rec.count(("circ_conv", route)) == 27  # 6 + 3 binds per attribute
    np.testing.assert_allclose(solved.numpy(), np.asarray(logp), atol=1e-4, rtol=0)


def test_lvrf_rule_codebook_keeps_its_layout():
    """interop converts 4-D leaves under "w" (conv kernels) only: LVRF's
    (A, R, B, d) rule codebook arrives unpermuted."""
    consts = lvrf_consts(64)
    tc = interop.from_reference(consts, "cpu")
    np.testing.assert_array_equal(tc["params"]["rules"].numpy(),
                                  consts["params"]["rules"])


# -- PrAE ---------------------------------------------------------------------


@pytest.mark.parametrize("one_hot", [True, False], ids=["oracle", "soft"])
def test_prae_solve_matches_reference(one_hot):
    """Answer log-probs and rule posteriors within 1e-4, on one-hot
    (oracle) and soft PMFs; no kernel call."""
    ctx, cand = _pmfs(4, seed=7, one_hot=one_hot), _pmfs(4, seed=8, one_hot=one_hot)
    want_logp, want_posts = jpr.solve_from_pmfs(
        jpr.PrAEConfig(), [jnp.asarray(x) for x in ctx], [jnp.asarray(x) for x in cand])
    with registry.record_kernels() as rec:
        logp, posts = pr.solve_from_pmfs(pr.PrAEConfig(), _t(ctx), _t(cand))
    assert rec == []
    np.testing.assert_allclose(logp.numpy(), np.asarray(want_logp), atol=1e-4, rtol=0)
    np.testing.assert_allclose(posts.numpy(), np.asarray(want_posts), atol=1e-4, rtol=0)


@pytest.mark.parametrize("rule", range(5))
def test_prae_rules_match_reference(rule):
    """Each rule's PMF transform (roll, circular conv and corr gathers)."""
    p1, p2 = (x[:, 0] for x in _pmfs(5, seed=rule)[:2])
    p1, p2 = p1[:, :5], p2[:, :5]
    want = np.asarray(jpr.rule_execute(rule, jnp.asarray(p1), jnp.asarray(p2)))
    got = pr.rule_execute(rule, torch.from_numpy(p1), torch.from_numpy(p2))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


# -- the served workloads -----------------------------------------------------


def _consts(model: str, d: int):
    """Reference constants (numpy) for ``model`` at block dim ``d``."""
    if model == "mimonet":
        jcfg = jcb.REASON_WORKLOADS["mimonet"].make_config(d=d)
        return {"params": draw_spec(jmm.mimonet_spec(jcfg), seed=1),
                "keys": ref_keys(d, jcfg.blocks, jcfg.n_channels)}
    frontend = draw_spec(jnv.nvsa_spec(jnv.NVSAConfig()), seed=2)
    if model == "lvrf":
        return {**lvrf_consts(d), "frontend": frontend}
    jcfg = jnv.NVSAConfig(d=d)
    books = jax.jit(jnv.nvsa_codebooks, static_argnums=0)(jcfg, jax.random.PRNGKey(1))
    return {"params": frontend, "books": jax.tree.map(np.asarray, books)}


@pytest.mark.parametrize("model,variant", [
    ("mimonet", "default"), ("lvrf", "oracle"), ("lvrf", "cnn"),
    ("prae", "oracle"), ("prae", "cnn")])
def test_engine_matches_reference_engine(model, variant):
    """The port's ``reason_engine`` against the reference's, same requests
    and constants at d = 128 (the kernel route), groups of 4 and 2 with
    buckets (2, 4): equal answers, log-probs (and LVRF / PrAE rule
    posteriors) within 1e-3, the registry epsilon; the port's overlap and
    sequential schedules agree bitwise."""
    d = 128
    entry, jentry = cb.REASON_WORKLOADS[model], jcb.REASON_WORKLOADS[model]
    cfg, jcfg = entry.make_config(d=d), jentry.make_config(d=d)
    consts = _consts(model, d)
    factory, _ = entry.make_requests(cfg, 6, seed=5)
    reqs = list(factory())
    rcfg = dict(batch_size=4, buckets=(2, 4))
    eng = cb.reason_engine(model, cfg, ReasonConfig(**rcfg),
                           consts=interop.from_reference(consts, "cpu"),
                           variants=(variant,), device="cpu")
    got = eng.run(reqs, schedule="overlap")
    seq = eng.run(reqs, schedule="sequential")
    with jregistry.use_plan(CPU_PLAN):
        jeng = jcb.reason_engine(model, jcfg, jreason.ReasonConfig(**rcfg),
                                 consts=consts, variants=(variant,),
                                 trace_graph=False)
        want = jeng.run([jreason.ReasonRequest(**vars(r)) for r in reqs])
    assert sorted(got) == sorted(want) == list(range(6))
    for uid, w in want.items():
        g = got[uid]
        np.testing.assert_array_equal(np.asarray(g.answer), np.asarray(w.answer))
        np.testing.assert_allclose(g.answer_logprobs, w.answer_logprobs,
                                   atol=1e-3, rtol=0)
        np.testing.assert_array_equal(seq[uid].answer_logprobs, g.answer_logprobs)
        if w.rule_posteriors is None:
            assert g.rule_posteriors is None
        else:
            np.testing.assert_allclose(g.rule_posteriors, w.rule_posteriors,
                                       atol=1e-3, rtol=0)


def test_requests_match_reference_requests():
    """The mimonet traffic is the reference's: the same panels per request
    and the same truth."""
    for model in ("mimonet", "lvrf"):
        entry, jentry = cb.REASON_WORKLOADS[model], jcb.REASON_WORKLOADS[model]
        f, truth = entry.make_requests(entry.make_config(), 5, seed=3)
        jf, jtruth = jentry.make_requests(jentry.make_config(), 5, seed=3)
        for r, jr in zip(f(), jf()):
            assert isinstance(r, ReasonRequest) and r.uid == jr.uid
            for field in ("images", "context", "candidates", "context_attrs"):
                a, b = getattr(r, field), getattr(jr, field)
                assert (a is None) == (b is None), field
                if a is not None:
                    np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(truth(), jtruth())
