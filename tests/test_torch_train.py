"""Parity of the port's training substrate with the JAX reference, on the
CPU: train-mode batchnorm and its EMA fold, the ResNet in train mode, and
AdamW (schedule, clip, decay, f32 and blockwise 8-bit moments).

Every input is drawn with numpy from a fixed seed and given to both
packages; conv weights cross as HWIO -> OIHW through
``repro_torch.interop``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import init as jinit
from repro.nn import layers as jlayers
from repro.nn import resnet as jresnet
from repro.train import optimizer as jopt
from repro_torch import interop
from repro_torch.common.tree import tree_map
from repro_torch.nn import layers, resnet
from repro_torch.train import optimizer as opt

torch.set_num_threads(2)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _draw(spec, seed: int):
    """A numpy tree for a reference spec: normal leaves at their std, BN
    scale / var around 1, bias / mean around 0."""
    rng = np.random.default_rng(seed)

    def draw(p):
        if p.init == "normal":
            std = p.scale or 1.0 / np.sqrt(np.prod(p.shape[:-1]))
            return (rng.standard_normal(p.shape) * std).astype(np.float32)
        if p.init == "ones":
            return rng.uniform(0.5, 1.5, p.shape).astype(np.float32)
        return (rng.standard_normal(p.shape) * 0.1).astype(np.float32)

    return jax.tree.map(draw, spec, is_leaf=lambda x: isinstance(x, jinit.P))


def _close_trees(got, want, atol, rtol=0.0):
    """``got`` a port tree, ``want`` a numpy tree of the reference."""
    want = interop.from_reference(want, "cpu")
    tree_map(lambda g, w: np.testing.assert_allclose(
        g.detach().numpy(), w.numpy(), atol=atol, rtol=rtol), got, want)


# -- batchnorm -------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(6, 5, 5, 8), (16, 1, 1, 4)])
def test_batchnorm_train_mode_and_stats(shape):
    """Batch mean and population variance in f32, the normalised output
    and the sink's (mean, var) under its key, within 1e-6 (and 1e-6
    relative: a variance of ~9 sums in a different order)."""
    rng = np.random.default_rng(len(shape) + shape[0])
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    params = _draw(jlayers.batchnorm_spec(shape[-1]), 1)
    jsink, tsink = {}, {}
    want = jlayers.batchnorm(params, jnp.asarray(x), train=True,
                             stats_sink=jsink, stats_key=("stem_bn",))
    got = layers.batchnorm(interop.from_reference(params, "cpu"), torch.from_numpy(x),
                           train=True, stats_sink=tsink, stats_key=("stem_bn",))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert list(tsink) == list(jsink) == [("stem_bn",)]
    for g, w in zip(tsink[("stem_bn",)], jsink[("stem_bn",)]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=1e-6)
    # eval mode (the default) uses the running stats
    np.testing.assert_allclose(
        layers.batchnorm(interop.from_reference(params, "cpu"), torch.from_numpy(x)).numpy(),
        np.asarray(jlayers.batchnorm(params, jnp.asarray(x))), atol=1e-6)


def test_bn_apply_stats_walks_dicts_and_lists():
    """The EMA fold at a stem path and at list-indexed block paths; every
    other leaf is the same object."""
    rcfg = jresnet.ResNetConfig(width=4, out_dim=8)
    params = _draw(jresnet.resnet_spec(rcfg), 2)
    rng = np.random.default_rng(3)
    paths = [("stem_bn",), ("stages", 0, 1, "bn1"), ("stages", 1, 0, "proj_bn")]
    stats = {}
    for p in paths:
        c = 4 * (2 ** p[1]) if len(p) > 1 else 4
        stats[p] = (rng.standard_normal(c).astype(np.float32),
                    rng.uniform(0.1, 2, c).astype(np.float32))
    want = _np(jlayers.bn_apply_stats(params, {k: tuple(map(jnp.asarray, v))
                                               for k, v in stats.items()}, momentum=0.7))
    tparams = interop.from_reference(params, "cpu")
    got = layers.bn_apply_stats(tparams, {k: tuple(map(torch.from_numpy, v))
                                          for k, v in stats.items()}, momentum=0.7)
    _close_trees(got, want, atol=1e-6)
    assert got["stages"][0][1]["bn1"]["mean"] is not tparams["stages"][0][1]["bn1"]["mean"]
    assert got["stages"][0][1]["bn1"]["scale"] is tparams["stages"][0][1]["bn1"]["scale"]
    assert got["stages"][0][0] is tparams["stages"][0][0]
    assert got["head"] is tparams["head"]


def test_resnet_train_mode_and_bn_stats():
    """``resnet(train=True)`` at f32: features within 1e-5 of their scale
    (max |feature|), the same stats paths (ints included), each mean and
    var within 1e-5 of its own scale.  With 6 images the last stage's BN
    normalises over 6 values, so f32 rounding there reaches ~8e-6 of the
    scale."""
    rcfg = jresnet.ResNetConfig(width=4, out_dim=16)
    params = _draw(jresnet.resnet_spec(rcfg), 4)
    x = np.random.default_rng(5).uniform(0, 1, (6, 32, 32, 1)).astype(np.float32)
    jstats, tstats = {}, {}
    want = jresnet.resnet(params, rcfg, jnp.asarray(x), train=True,
                          compute_dtype=jnp.float32, bn_stats=jstats)
    got = resnet.resnet(interop.from_reference(params, "cpu"),
                        resnet.ResNetConfig(width=4, out_dim=16), torch.from_numpy(x),
                        train=True, bn_stats=tstats)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max())
    assert list(tstats) == list(jstats)
    assert ("stages", 1, 0, "proj_bn") in tstats and len(tstats) == 20
    for k in jstats:
        for g, w in zip(tstats[k], jstats[k]):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, atol=1e-5 * np.abs(w).max())


# -- AdamW ------------------------------------------------------------------------


@pytest.mark.parametrize("step", [0, 19, 20, 55, 99, 100, 150])
def test_schedule_matches_reference(step):
    """Warmup (steps 0 and 19), its end, the cosine's middle and end, and
    past the end, within 1e-7."""
    cfg = opt.AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=100)
    jcfg = jopt.AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=100)
    got = opt.schedule(cfg, torch.tensor(step, dtype=torch.int32))
    want = jopt.schedule(jcfg, jnp.asarray(step, jnp.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), atol=1e-7, rtol=0)


def _tree(seed: int, scale: float = 1.0):
    """dicts, a list, a leaf of 100 elements (not a multiple of the 64
    block) and a BN-like pair the loss does not reach."""
    rng = np.random.default_rng(seed)

    def n(*s):
        return (rng.standard_normal(s) * scale).astype(np.float32)
    return {"a": {"k": n(7, 5, 3, 2), "b": n(5)},
            "layers": [{"w": n(10, 10)}, {"w": n(3, 64)}],
            "bn": {"mean": n(6), "var": n(6)}}


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "q8"])
@pytest.mark.parametrize("clip", [0.5, 1e3], ids=["clipped", "unclipped"])
def test_apply_updates_five_steps(quantized, clip):
    """Five AdamW steps on fixed grads (the BN pair's grads are zeros in
    the reference and None in the port).  Parameters and f32 moments
    within 1e-6; 8-bit codes equal and their scales within 1e-7."""
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=5, weight_decay=0.05,
              grad_clip=clip, quantized_state=quantized, qblock=64)
    cfg, jcfg = opt.AdamWConfig(**kw), jopt.AdamWConfig(**kw)
    params = _tree(0)
    jgrads = _tree(1, scale=0.3)
    jgrads["bn"] = {k: np.zeros_like(v) for k, v in jgrads["bn"].items()}
    tgrads = interop.from_reference(jgrads, "cpu")
    tgrads["bn"] = {"mean": None, "var": None}
    jp, jstate = jax.tree.map(jnp.asarray, params), jopt.init_state(params, jcfg)
    tp = interop.from_reference(params, "cpu")
    tstate = opt.init_state(tp, cfg)
    gnorm = float(jopt.global_norm(jgrads))
    assert (gnorm > clip) == (clip == 0.5)
    for _ in range(5):
        jp, jstate, jm = jopt.apply_updates(jp, jax.tree.map(jnp.asarray, jgrads), jstate, jcfg)
        tp, tstate, tm = opt.apply_updates(tp, tgrads, tstate, cfg)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), atol=1e-9)
    assert int(tstate["step"]) == int(jstate["step"]) == 5
    _close_trees(tp, _np(jp), atol=1e-6)
    for path in (("a", "k"), ("a", "b"), ("layers", 0, "w"), ("layers", 1, "w"),
                 ("bn", "mean")):
        t, j = tstate["mu"], jstate["mu"]
        for k in path:
            t, j = t[k], j[k]
        if quantized:
            for q in ("m_q", "v_q"):
                np.testing.assert_array_equal(t[q].numpy(), np.asarray(j[q]))
            for s in ("m_s", "v_s"):
                np.testing.assert_allclose(t[s].numpy(), np.asarray(j[s]), atol=1e-7, rtol=0)
        else:
            for m in ("m", "v"):
                np.testing.assert_allclose(t[m].numpy(), np.asarray(j[m]), atol=1e-6)


def test_q8_rounds_half_to_even_and_pads():
    """``_q8`` on values that land on .5 ties after scaling, and a size that
    pads: the codes equal the reference's, the padding codes 0."""
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.0], np.float32)
    q, s = opt._q8(torch.from_numpy(x), 4)
    jq, js = jopt._q8(jnp.asarray(x), 4)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0, atol=0)
    assert q.shape == (2, 4) and int(q[1, 3]) == 0
    assert q[0].tolist() == [127, 0, 2, 2]
    back = opt._dq8(q, s, (7,), 7)
    np.testing.assert_allclose(back.numpy(), np.asarray(jopt._dq8(jq, js, (7,), 7)), atol=0)


def test_value_and_grad_gives_none_for_unreached_leaves():
    """The port's ``value_and_grad``: the reached leaves' grads, None for
    a leaf the value does not use, nothing left requiring grad."""
    params = {"w": torch.randn(3, 2, generator=torch.Generator().manual_seed(0)),
              "unused": torch.ones(4), "count": torch.tensor(3)}
    x = torch.ones(5, 3)
    (val, aux), grads = opt.value_and_grad(
        lambda p, x: ((x @ p["w"]).square().sum(), 7), has_aux=True)(params, x)
    assert aux == 7 and not val.requires_grad
    torch.testing.assert_close(grads["w"], 2 * x.T @ (x @ params["w"]))
    assert grads["unused"] is None and grads["count"] is None
    assert not params["w"].requires_grad
