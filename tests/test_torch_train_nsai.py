"""Parity of the port's NSAI training halves with the JAX reference, on the
CPU: NVSA's frontend loss, gradients, BN statistics, bf16 frontend, Tab. IV
memory and the ``train_nvsa_raven`` twin; MIMONet's and LVRF's losses and
gradients (through circ_conv's backward at d >= 128); the four models'
``accuracy``.

Inputs come from numpy seeds, or from the reference's ``jax.random``
constants carried over by ``repro_torch.interop`` (HWIO -> OIHW).  The
reference runs its Pallas kernels in interpret mode (the negotiated CPU
plan), the port its plain versions.
"""

import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.backend import registry as jregistry
from repro.data import raven as jraven
from repro.models import lvrf as jlvrf
from repro.models import mimonet as jmimo
from repro.models import nvsa as jnvsa
from repro.models import prae as jprae
from repro.nn import init as jinit
from repro_torch import interop
from repro_torch.backend import registry
from repro_torch.common.tree import tree_map
from repro_torch.kernels.circ_conv import ops as circ_ops
from repro_torch.models import lvrf, mimonet, nvsa, prae
from repro_torch.train import optimizer as opt

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU_PLAN = jregistry.negotiate(platform="cpu", override="")
SMALL = dict(d=64, cnn_width=8, cnn_feat=32)   # test_bn_ema_updates_running_stats'


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(tree):
    return interop.from_reference(_np(tree), "cpu")


def _draw(spec, seed: int):
    """A numpy tree for a reference spec: normal leaves at their std, BN
    scale / var in [0.5, 1.5], bias / mean around 0 (non-trivial running
    stats for eval mode)."""
    rng = np.random.default_rng(seed)

    def draw(p):
        if p.init == "normal":
            std = p.scale or 1.0 / np.sqrt(np.prod(p.shape[:-1]))
            return (rng.standard_normal(p.shape) * std).astype(np.float32)
        if p.init == "ones":
            return rng.uniform(0.5, 1.5, p.shape).astype(np.float32)
        return (rng.standard_normal(p.shape) * 0.1).astype(np.float32)

    return jax.tree.map(draw, spec, is_leaf=lambda x: isinstance(x, jinit.P))


def _grads_close(got, want, rel: float):
    """Each leaf of the port's grads within ``rel`` of the reference
    leaf's max |grad|; a port ``None`` where the reference has zeros."""
    def one(g, w):
        w = w.numpy()
        if g is None:
            assert not w.any()
            return
        np.testing.assert_allclose(g.numpy(), w, atol=rel * max(np.abs(w).max(), 1e-30))
    tree_map(one, got, interop.from_reference(_np(want), "cpu"))


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def nvsa_small():
    jcfg, cfg = jnvsa.NVSAConfig(**SMALL), nvsa.NVSAConfig(**SMALL)
    jparams = jax.jit(lambda k: jinit.materialize(jnvsa.nvsa_spec(jcfg), k))(
        jax.random.PRNGKey(0))
    imgs, attrs = jraven.panel_dataset(jcfg.raven, seed=1, n_problems=1)
    return jcfg, cfg, jparams, imgs, attrs


@pytest.fixture(scope="module")
def oracle16():
    """16 problems (seed 5) as oracle PMFs, numpy."""
    rcfg = jraven.RavenConfig()
    batch = jraven.generate_batch(rcfg, seed=5, n=16)
    cfg = jnvsa.NVSAConfig()
    ctx = [np.asarray(x) for x in jnvsa.oracle_pmfs(cfg, jnp.asarray(batch["context_attrs"]))]
    cand = [np.asarray(x) for x in jnvsa.oracle_pmfs(cfg, jnp.asarray(batch["candidate_attrs"]))]
    return batch, ctx, cand


# -- NVSA ----------------------------------------------------------------------


def test_frontend_loss_value_grads_and_bn_stats(nvsa_small):
    """``frontend_loss`` on 8 panels against the jitted reference
    ``value_and_grad``: the loss within 1e-6, each grad leaf within 2e-5 of
    its max |grad|, the BN running-stat leaves None (zeros there), the 20
    stats paths equal and each (mean, var) within 1e-5 of its scale.  At
    8 panels the last stage's BN normalises over 8 values, and each
    package's f32 grads lie ~1e-5 of the scale from an f64 evaluation, on
    opposite sides, so 1e-5 between the two is below their rounding."""
    jcfg, cfg, jparams, imgs, attrs = nvsa_small
    fn = jax.jit(jax.value_and_grad(jnvsa.frontend_loss, has_aux=True), static_argnums=1)
    (jloss, jstats), jgrads = fn(jparams, jcfg, jnp.asarray(imgs[:8]), jnp.asarray(attrs[:8]))
    (loss, stats), grads = opt.value_and_grad(nvsa.frontend_loss, has_aux=True)(
        _port(jparams), cfg, torch.from_numpy(imgs[:8]), torch.from_numpy(attrs[:8]))
    np.testing.assert_allclose(float(loss), float(jloss), atol=1e-6)
    assert grads["frontend"]["stem_bn"]["mean"] is None
    assert grads["frontend"]["stages"][3][1]["bn2"]["var"] is None
    _grads_close(grads, jgrads, 2e-5)
    assert sorted(stats, key=str) == sorted(jstats, key=str) and len(stats) == 20
    for k, (m, v) in stats.items():
        for g, w in ((m, jstats[k][0]), (v, jstats[k][1])):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, atol=1e-5 * np.abs(w).max())
    new = nvsa.frontend_apply_bn_stats(_port(jparams), stats, momentum=0.5)
    want = jnvsa.frontend_apply_bn_stats(jparams, jstats, momentum=0.5)
    for path in (("stem_bn",), ("stages", 1, 0, "bn1"), ("stages", 3, 0, "proj_bn")):
        t, j = new["frontend"], want["frontend"]
        for k in path:
            t, j = t[k], j[k]
        for leaf in ("mean", "var"):
            w = np.asarray(j[leaf])
            np.testing.assert_allclose(t[leaf].numpy(), w, atol=1e-5 * np.abs(w).max())
        assert torch.equal(t["scale"], torch.from_numpy(np.array(j["scale"])))


def test_frontend_pmfs_bf16(nvsa_small):
    """``nn_precision="bf16"`` computes the frontend in bf16, as the
    reference: eval-mode PMFs (non-trivial running stats) within one bf16
    step (2^-8) of the PMF scale of the reference's op by op, and f32
    outputs.  (Under ``jax.jit`` XLA fuses away some of the reference's
    own bf16 roundings, and its PMFs move by up to 5e-3.)"""
    jcfg, cfg, _, imgs, _ = nvsa_small
    jcfg, cfg = (dataclasses.replace(c, nn_precision="bf16") for c in (jcfg, cfg))
    jparams = _draw(jnvsa.nvsa_spec(jcfg), 3)
    want, _ = jnvsa.frontend_pmfs(jparams, jcfg, jnp.asarray(imgs[:16]))
    got, logits = nvsa.frontend_pmfs(_port(jparams), cfg, torch.from_numpy(imgs[:16]))
    for g, w, lg in zip(got, want, logits):
        assert g.dtype == torch.float32 and lg.dtype == torch.float32
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, atol=2 ** -8 * np.abs(w).max())


def test_nvsa_memory_bytes_all_precisions(nvsa_small):
    """Tab. IV's memory column: equal to the reference's for the five
    labels, and the mp / fp32 ratio inside the reference test's range."""
    jcfg, cfg, jparams, _, _ = nvsa_small
    tparams = _port(jparams)
    got = {}
    for label, nn_p, sy_p in _load("train_nvsa_raven_torch").PRECISIONS:
        mem = nvsa.nvsa_memory_bytes(
            dataclasses.replace(cfg, nn_precision=nn_p, symb_precision=sy_p), tparams)
        assert mem == jnvsa.nvsa_memory_bytes(
            dataclasses.replace(jcfg, nn_precision=nn_p, symb_precision=sy_p), jparams)
        got[label] = mem
    assert 3.5 < got["fp32"] / got["mp"] < 8.5


def test_twin_train_frontend_three_steps(nvsa_small, capsys):
    """Three steps of the twin's ``train_frontend`` from the reference's
    initial parameters against the reference example's (its jitted
    ``step_fn``: AdamW, then the BN EMA fold): every element within 1e-4,
    but for at most one in 10^4, which must lie within the three steps'
    summed lr.  Adam's first steps move an element by about ±lr whatever
    its gradient's size, so an element whose gradient is f32 rounding
    away from zero may step the other way (one of 36864 here)."""
    jcfg, cfg, jparams, _, _ = nvsa_small
    want = _load("train_nvsa_raven").train_frontend(jcfg, steps=3, n_problems=4)
    got, losses, _ = _load("train_nvsa_raven_torch").train_frontend(
        cfg, steps=3, n_problems=4, device="cpu", params=_port(jparams))
    assert losses.shape == (3,) and bool(torch.isfinite(losses).all())
    ocfg = opt.AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=3)
    lr_sum = sum(float(opt.schedule(ocfg, torch.tensor(s))) for s in range(3))
    diffs = []
    tree_map(lambda g, w: diffs.append((g - w).abs().reshape(-1)), got, _port(want))
    diffs = torch.cat(diffs)
    assert int((diffs > 1e-4).sum()) <= diffs.numel() // 10 ** 4
    assert float(diffs.max()) <= lr_sum
    out = capsys.readouterr().out
    assert "[nvsa] step    0 loss" in out and "[nvsa] step    2 loss" in out


def test_twin_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    twin = _load("train_nvsa_raven_torch")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        twin.train_frontend(nvsa.NVSAConfig(**SMALL), steps=1, n_problems=1)


# -- MIMONet and LVRF: losses through circ_conv's backward ----------------------


def _mimonet(d: int, n: int, seed: int):
    kw = dict(d=d, cnn_width=4, trunk_hidden=128)
    jcfg, cfg = jmimo.MIMONetConfig(**kw), mimonet.MIMONetConfig(**kw)
    jparams = _draw(jmimo.mimonet_spec(jcfg), seed)
    keys = np.array(jmimo.mimonet_keys(jcfg, jax.random.PRNGKey(1)))
    imgs, attrs = jraven.panel_dataset(jcfg.raven, seed=seed, n_problems=1)
    k = jcfg.n_channels
    images = imgs[: n * k].reshape(n, k, *imgs.shape[1:])
    labels = attrs[: n * k, 0].reshape(n, k)
    return jcfg, cfg, jparams, keys, images, labels


@pytest.mark.parametrize("d", [64, 128])
def test_mimonet_loss_and_grads(d):
    """``loss_fn`` (staged unbind + classify, train-mode BN) and its grads
    against ``jax.value_and_grad``: the loss within 1e-5, each grad leaf
    within 1e-4 of its max |grad|, BN stats equal in paths.  At d = 128
    both packages go through circ_conv (the reference's Pallas kernel in
    interpret mode with its custom VJP), the port's backward with one
    product per operand that needs a gradient: the keys are constants."""
    jcfg, cfg, jparams, keys, images, labels = _mimonet(d, 4, 7)
    fn = jax.jit(jax.value_and_grad(jmimo.loss_fn, has_aux=True), static_argnums=2)
    with jregistry.use_plan(CPU_PLAN):
        (jloss, jstats), jgrads = fn(jparams, jnp.asarray(keys), jcfg, jnp.asarray(images),
                                     jnp.asarray(labels))
    with registry.record_kernels() as rec:
        (loss, stats), grads = opt.value_and_grad(mimonet.loss_fn, has_aux=True)(
            _port(jparams), torch.from_numpy(keys), cfg, torch.from_numpy(images),
            torch.from_numpy(labels))
    np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5)
    _grads_close(grads, jgrads, 1e-4)
    assert sorted(stats, key=str) == sorted(jstats, key=str)
    # forward: superpose's bind and unbind; backward: one product each
    assert rec.count(("circ_conv", "kernel")) == (4 if d >= 128 else 0)
    new = mimonet.apply_bn_stats(_port(jparams), stats, momentum=0.5)
    want = jmimo.apply_bn_stats(jparams, jstats, momentum=0.5)
    w = np.asarray(want["encoder"]["stem_bn"]["var"])
    np.testing.assert_allclose(new["encoder"]["stem_bn"]["var"].numpy(), w,
                               atol=1e-5 * np.abs(w).max())


def _lvrf(d: int, oracle):
    batch, ctx, cand = oracle
    jcfg, cfg = jlvrf.LVRFConfig(d=d), lvrf.LVRFConfig(d=d)
    jparams = jinit.materialize(jlvrf.lvrf_spec(jcfg), jax.random.PRNGKey(0))
    books = _np(jlvrf.lvrf_codebooks(jcfg, jax.random.PRNGKey(1)))
    return jcfg, cfg, jparams, books, batch["answer"].astype(np.int32), ctx, cand


@pytest.mark.parametrize("d", [64, 128])
def test_lvrf_loss_and_grads(d, oracle16):
    """``loss_fn`` on 16 oracle problems and its grads in the learned
    rules and roles against ``jax.value_and_grad``: the loss within 1e-5,
    each grad leaf within 1e-4 of its max |grad|.  At d = 128 the rules
    and roles are bound by circ_conv, whose backward skips the constant
    codes' cotangent."""
    jcfg, cfg, jparams, books, answers, ctx, cand = _lvrf(d, oracle16)
    fn = jax.jit(jax.value_and_grad(jlvrf.loss_fn), static_argnums=2)
    with jregistry.use_plan(CPU_PLAN):
        jloss, jgrads = fn(
            jparams, [jnp.asarray(b) for b in books], jcfg, [jnp.asarray(x) for x in ctx],
            [jnp.asarray(x) for x in cand], jnp.asarray(answers))
    tc = [torch.from_numpy(x) for x in ctx]
    with registry.record_kernels() as rec:
        loss, grads = opt.value_and_grad(lvrf.loss_fn)(
            _port(jparams), [torch.from_numpy(b) for b in books], cfg, tc,
            [torch.from_numpy(x) for x in cand], torch.from_numpy(answers))
    np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5)
    _grads_close(grads, jgrads, 1e-4)
    # forward 27 binds; backward: the 18 role binds of a constant code need
    # one product, the 9 rule binds two
    assert rec.count(("circ_conv", "kernel")) == (27 + 18 + 18 if d >= 128 else 0)


# -- accuracy ---------------------------------------------------------------------


def test_accuracy_of_the_four_models(nvsa_small, oracle16):
    """Each model's ``accuracy`` equals the reference's on the same inputs:
    NVSA on 16 problems' images (small config, answer and rule accuracy),
    MIMONet on 8 panel pairs, LVRF and PrAE on 16 oracle problems."""
    jcfg, cfg, _, _, _ = nvsa_small
    jparams = _draw(jnvsa.nvsa_spec(jcfg), 4)
    batch = jraven.generate_batch(jcfg.raven, seed=777, n=16)
    jbooks = jnvsa.nvsa_codebooks(jcfg, jax.random.PRNGKey(1))
    assert nvsa.accuracy(_port(jparams), _port(jbooks), cfg, batch) == \
        jnvsa.accuracy(jparams, jbooks, jcfg, batch)

    jmcfg, mcfg, mparams, keys, images, labels = _mimonet(64, 8, 9)
    assert mimonet.accuracy(_port(mparams), torch.from_numpy(keys), mcfg,
                            torch.from_numpy(images), torch.from_numpy(labels)) == \
        jmimo.accuracy(mparams, jnp.asarray(keys), jmcfg, jnp.asarray(images),
                       jnp.asarray(labels))

    jlcfg, lcfg, lparams, books, answers, ctx, cand = _lvrf(64, oracle16)
    assert lvrf.accuracy(_port(lparams), [torch.from_numpy(b) for b in books], lcfg,
                         [torch.from_numpy(x) for x in ctx],
                         [torch.from_numpy(x) for x in cand], torch.from_numpy(answers)) == \
        jlvrf.accuracy(lparams, [jnp.asarray(b) for b in books], jlcfg,
                       [jnp.asarray(x) for x in ctx], [jnp.asarray(x) for x in cand],
                       jnp.asarray(answers))

    rules = oracle16[0]["rules"]
    got = prae.accuracy(prae.PrAEConfig(), [torch.from_numpy(x) for x in ctx],
                        [torch.from_numpy(x) for x in cand], torch.from_numpy(answers), rules)
    want = jprae.accuracy(jprae.PrAEConfig(), [jnp.asarray(x) for x in ctx],
                          [jnp.asarray(x) for x in cand], jnp.asarray(answers), rules)
    assert got == want and got[0] >= 0.9


# -- circ_conv's backward skips a constant operand --------------------------------


@pytest.mark.parametrize("mode", ["conv", "corr"])
@pytest.mark.parametrize("need", ["x", "y", "both"])
def test_circ_elem_backward_skips_constant_operand(mode, need):
    """An operand that needs no grad gets ``None`` from the backward and
    costs no product; the other's gradient is the one computed when both
    need grads."""
    rng = np.random.default_rng(11)
    x, y, w = (torch.from_numpy(rng.standard_normal((5, 2, 128)).astype(np.float32))
               for _ in range(3))
    xx = x.clone().requires_grad_(need in ("x", "both"))
    yy = y.clone().requires_grad_(need in ("y", "both"))
    out = circ_ops.circ_elem(xx, yy, mode)
    with registry.record_kernels() as rec:  # grad_fn is the backward's ctx
        gx, gy = circ_ops._CircElem.backward(out.grad_fn, w)[:2]
    assert (gx is None) == (need == "y") and (gy is None) == (need == "x")
    assert rec.count(("circ_conv", "kernel")) == (2 if need == "both" else 1)
    bx, by = (t.clone().requires_grad_() for t in (x, y))
    fx, fy = torch.autograd.grad((w * circ_ops.circ_elem(bx, by, mode)).sum(), (bx, by))
    if gx is not None:
        torch.testing.assert_close(gx, fx, rtol=0, atol=0)
    if gy is not None:
        torch.testing.assert_close(gy, fy, rtol=0, atol=0)
