"""Parity of the port's NVSA modules with the JAX reference, on the CPU.

Constants are drawn once by the reference (``jax.random``) and carried into
the port through ``repro_torch.interop``; inputs come from numpy seeds.
The reference runs its Pallas kernels in interpret mode (the negotiated
CPU plan), the port its plain versions.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import raven as jraven
from repro.models import nvsa as jnv
from repro.nn import init as jinit
from repro.nn import layers as jlayers
from repro.vsa import fpe as jfpe
from repro_torch import interop
from repro_torch.data import raven
from repro_torch.models import nvsa
from repro_torch.nn import init as nninit
from repro_torch.nn import layers
from repro_torch.vsa import fpe

torch.set_num_threads(2)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfg(**kw):
    return nvsa.NVSAConfig(**kw), jnv.NVSAConfig(**kw)


@functools.lru_cache(maxsize=None)
def ref_books(d: int, blocks: int = 2):
    """The reference's codebooks (``jax.random`` key 1) as numpy."""
    jcfg = jnv.NVSAConfig(d=d, blocks=blocks)
    fn = jax.jit(jnv.nvsa_codebooks, static_argnums=0)
    return _np(fn(jcfg, jax.random.PRNGKey(1)))


def ref_params(cfg, seed: int = 0):
    """Frontend params for the reference's spec tree, drawn with numpy:
    convs and heads at the spec's std, batchnorm with non-trivial running
    stats so eval-mode BN is exercised."""
    rng = np.random.default_rng(seed)

    def draw(p):
        if p.init == "normal":
            std = p.scale or 1.0 / np.sqrt(np.prod(p.shape[:-1]))
            return (rng.standard_normal(p.shape) * std).astype(np.float32)
        if p.init == "ones":  # BN scale, var
            return rng.uniform(0.5, 1.5, p.shape).astype(np.float32)
        return (rng.standard_normal(p.shape) * 0.1).astype(np.float32)

    return jax.tree.map(draw, jnv.nvsa_spec(cfg),
                        is_leaf=lambda x: isinstance(x, jinit.P))


# -- data ---------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 17])
def test_raven_same_problems_as_reference(seed):
    cfg = raven.RavenConfig()
    got = raven.generate_problem(cfg, seed)
    want = jraven.generate_problem(jraven.RavenConfig(), seed)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_raven_batch_same_as_reference():
    got = raven.generate_batch(raven.RavenConfig(), seed=4, n=3)
    want = jraven.generate_batch(jraven.RavenConfig(), seed=4, n=3)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# -- layers: the asymmetric "SAME" padding --------------------------------------


@pytest.mark.parametrize("k,stride", [(7, 2), (3, 1), (1, 2), (3, 2)])
def test_conv2d_same_padding_matches_reference(k, stride):
    """XLA's SAME pads (2, 3) for the 7x7/2 stem on 32x32 inputs; a
    symmetric torch padding would be off by tens."""
    rng = np.random.default_rng(k * 10 + stride)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    w = rng.standard_normal((k, k, 3, 4)).astype(np.float32)
    want = np.asarray(jlayers.conv2d({"w": jnp.asarray(w)}, jnp.asarray(x),
                                     stride=stride, compute_dtype=jnp.float32))
    got = layers.conv2d(interop.from_reference({"w": w}, "cpu"),
                        torch.from_numpy(x), stride=stride)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)


def test_maxpool_same_padding_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    want = np.asarray(jlayers.maxpool2d(jnp.asarray(x), 3, 2))
    got = layers.maxpool2d(torch.from_numpy(x), 3, 2)
    np.testing.assert_array_equal(got.numpy(), want)


def test_param_tree_matches_reference_spec():
    """The port's spec tree has the reference's keys and shapes (conv
    weights OIHW for HWIO); its own draw is finite and seed-stable."""
    cfg, jcfg = _cfg(cnn_width=8, cnn_feat=32)
    shapes = interop.from_reference(jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype), jinit.shapes(jnv.nvsa_spec(jcfg))), "cpu")
    p1 = nninit.materialize(nvsa.nvsa_spec(cfg), torch.Generator().manual_seed(3))
    p2 = nninit.materialize(nvsa.nvsa_spec(cfg), torch.Generator().manual_seed(3))
    flat = []
    jax.tree.map(lambda a, b, c: flat.append((a, b, c)), shapes, p1, p2)
    assert len(flat) > 50
    for a, b, c in flat:
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.isfinite(b).all() and torch.equal(b, c)


# -- codebooks ----------------------------------------------------------------


@pytest.mark.parametrize("d", [64, 130])
def test_fpe_codebook_carried_across(d):
    phase = jfpe.fpe_base_phase(jax.random.PRNGKey(d), 2, d)
    want = np.asarray(jfpe.fpe_codebook(phase, 9, d))
    got = fpe.fpe_codebook(torch.tensor(np.asarray(phase)), 9, d)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    own = fpe.fpe_base_phase(torch.Generator().manual_seed(0), 2, d)
    assert own.shape == phase.shape and float(own[:, 0].abs().max()) == 0.0


def test_nvsa_codebooks_carried_across():
    """The reference's codebooks rebuilt by the port from the reference's
    own base phases; roles carry across exactly."""
    cfg, jcfg = _cfg(d=128, blocks=2)
    want = ref_books(128)
    keys = jax.random.split(jax.random.PRNGKey(1), jcfg.raven.n_attrs + 1)
    for i, n in enumerate(cfg.raven.attr_sizes):
        phase = torch.tensor(np.asarray(jfpe.fpe_base_phase(keys[i], 2, 128)))
        np.testing.assert_allclose(fpe.fpe_codebook(phase, 2 * n - 1, 128).numpy(),
                                   want["books"][i], atol=1e-5, rtol=0)
        np.testing.assert_allclose(fpe.fpe_encode(phase, [1.0, -1.0], 128).numpy(),
                                   want["shifts"][i], atol=1e-5, rtol=0)
    carried = interop.from_reference(want, "cpu")
    np.testing.assert_array_equal(carried["roles"].numpy(), want["roles"])
    own = nvsa.nvsa_codebooks(cfg, torch.Generator().manual_seed(1))
    assert [b.shape for b in own["books"]] == [b.shape for b in carried["books"]]


# -- frontend -----------------------------------------------------------------


@pytest.fixture(scope="module")
def frontend_case():
    _, jcfg = _cfg(cnn_width=8, cnn_feat=32)
    params = ref_params(jcfg, seed=2)
    batch = jraven.generate_batch(jcfg.raven, seed=2, n=2)
    images = batch["context"].reshape(16, 32, 32, 1).astype(np.float32)
    return params, images


@pytest.mark.parametrize("prec", ["fp32", "int8", "int4"])
def test_frontend_pmfs_match_reference(frontend_case, prec):
    """PMFs atol 1e-4 at cnn_width=8, cnn_feat=32; int8/int4 run the heads
    through qdense (the qmatmul kernel's path).

    The reference runs op by op (not under ``jax.jit``): at int4 the heads
    are quantised twice (``quant_tree``, then per column in ``qdense``), so
    w/scale lands exactly on .5 ties, and the jitted reference rounds some
    of those differently from its own op-by-op run.  Op by op, the
    reference and the port divide alike."""
    params, images = frontend_case
    kw = dict(cnn_width=8, cnn_feat=32, nn_precision=prec,
              use_qmatmul=prec != "fp32")
    cfg, jcfg = _cfg(**kw)
    want, _ = jnv.frontend_pmfs(jax.tree.map(jnp.asarray, params), jcfg,
                                jnp.asarray(images))
    got, _ = nvsa.frontend_pmfs(interop.from_reference(params, "cpu"), cfg,
                                torch.from_numpy(images))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0)


def test_quant_tree_matches_reference(frontend_case):
    params, _ = frontend_case
    want = _np(jnv.quant_tree(jax.tree.map(jnp.asarray, params), "int4"))
    got = nvsa.quant_tree(interop.from_reference(params, "cpu"), "int4")
    want = interop.from_reference(want, "cpu")
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a.numpy(), b.numpy()),
                 got, want)


# -- symbolic stage -------------------------------------------------------------


@pytest.mark.parametrize("symb", ["fp32", "int4"])
@pytest.mark.parametrize("d", [64, 128])
def test_reason_matches_reference(d, symb):
    """Soft PMFs through rule scoring, execution and candidate matching:
    log-probs atol 1e-3 (circ_conv's registry epsilon) and equal argmax.
    d=64 takes the gather route, d=128 the kernel route."""
    cfg, jcfg = _cfg(d=d, blocks=2, symb_precision=symb)
    books = ref_books(d)
    rng = np.random.default_rng(d)

    def pmfs():
        out = []
        for n in cfg.raven.attr_sizes:
            logits = rng.standard_normal((3, 8, n)) * 3
            p = np.exp(logits)
            out.append((p / p.sum(-1, keepdims=True)).astype(np.float32))
        return out

    ctx, cand = pmfs(), pmfs()
    jbooks = jnv.quantize_codebooks(jcfg, jax.tree.map(jnp.asarray, books))
    want_lp, want_rules = jnv.reason(jcfg, jbooks, [jnp.asarray(x) for x in ctx],
                                     [jnp.asarray(x) for x in cand])
    tbooks = nvsa.quantize_codebooks(cfg, interop.from_reference(books, "cpu"))
    got_lp, got_rules = nvsa.reason(cfg, tbooks, [torch.from_numpy(x) for x in ctx],
                                    [torch.from_numpy(x) for x in cand])
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_lp), atol=1e-3, rtol=0)
    np.testing.assert_allclose(got_rules.numpy(), np.asarray(want_rules),
                               atol=1e-3, rtol=0)
    np.testing.assert_array_equal(got_lp.numpy().argmax(-1),
                                  np.asarray(want_lp).argmax(-1))


def test_oracle_pmfs_and_solve_on_oracle_grid():
    """One-hot PMFs equal the reference's, and reasoning on them solves
    unambiguous grids."""
    cfg, jcfg = _cfg(d=64, blocks=2)
    batch = raven.generate_batch(cfg.raven, seed=5, n=6)
    attrs = torch.from_numpy(batch["context_attrs"])
    for g, w in zip(nvsa.oracle_pmfs(cfg, attrs),
                    jnv.oracle_pmfs(jcfg, jnp.asarray(batch["context_attrs"]))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    books = interop.from_reference(ref_books(64), "cpu")
    logp, _ = nvsa.reason(cfg, books, nvsa.oracle_pmfs(cfg, attrs),
                          nvsa.oracle_pmfs(cfg, torch.from_numpy(batch["candidate_attrs"])))
    assert (logp.argmax(-1).numpy() == batch["answer"]).all()


def test_solve_matches_reference(frontend_case):
    params, _ = frontend_case
    cfg, jcfg = _cfg(d=64, blocks=2, cnn_width=8, cnn_feat=32)
    books = ref_books(64)
    batch = jraven.generate_batch(jcfg.raven, seed=6, n=2)
    want, _ = jnv.solve(jax.tree.map(jnp.asarray, params),
                        jax.tree.map(jnp.asarray, books), jcfg,
                        jnp.asarray(batch["context"]), jnp.asarray(batch["candidates"]))
    got, _ = nvsa.solve(interop.from_reference(params, "cpu"),
                        interop.from_reference(books, "cpu"), cfg,
                        torch.from_numpy(batch["context"]),
                        torch.from_numpy(batch["candidates"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=0)


def test_fake_quant_per_problem_axes():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 8, 2, 16)).astype(np.float32)
    for prec in ("int8", "int4", "bf16"):
        want = np.asarray(jnv.fake_quant(jnp.asarray(x), prec, axes=(1, 2, 3)))
        got = nvsa.fake_quant(torch.from_numpy(x), prec, axes=(1, 2, 3))
        np.testing.assert_array_equal(got.numpy(), want)
