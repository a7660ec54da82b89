"""The port's MoE (``repro_torch.nn.moe``) against the reference's
``repro.nn.moe`` on the CPU.

The same numpy tokens through both packages, the reference's parameters
carried across: routing (weights, expert ids, probabilities), the
capacity, the queue positions and the kept / dropped pairs, ``moe_dense``
(the one-hot oracle), ``moe_gather`` (capacity drops and the overflow
slot), ``moe_block`` and the load-balance loss, all within 1e-5 at f32
compute and within 3e-2 of the outputs' scale at bf16.  The configs are
granite-moe's and deepseek-v3's smoke MoEs, and one whose capacity factor
drops pairs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import init as jinit
from repro.nn import moe as jmoe
from repro_torch import interop
from repro_torch.nn import moe

CONFIGS = {
    # granite-moe's smoke MoE: 4 experts, top-2, capacity factor 2
    "granite": dict(d_model=64, d_ff=32, n_experts=4, top_k=2, capacity_factor=2.0),
    # deepseek-v3's: with a shared expert
    "deepseek": dict(d_model=64, d_ff=32, n_experts=4, top_k=2, n_shared=1,
                     shared_d_ff=32, capacity_factor=2.0),
    # 8 experts, top-3, a capacity that drops pairs
    "drops": dict(d_model=48, d_ff=24, n_experts=8, top_k=3, n_shared=1,
                  shared_d_ff=16, capacity_factor=0.5),
}
N_TOKENS = 45
TOL = {"float32": 1e-5, "bfloat16": 3e-2}  # bf16: of the outputs' scale


def _setup(name: str, seed: int = 0):
    kw = CONFIGS[name]
    jcfg, cfg = jmoe.MoEConfig(**kw), moe.MoEConfig(**kw)
    jp = jinit.materialize(jmoe.moe_spec(jcfg), jax.random.PRNGKey(seed))
    p = interop.from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    x = np.random.default_rng(seed).standard_normal(
        (N_TOKENS, kw["d_model"])).astype(np.float32)
    return jcfg, cfg, jp, p, x


def _close(got, want, dtype: str = "float32"):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    scale = 1.0 if dtype == "float32" else max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=TOL[dtype] * scale, rtol=0)


def _queue_positions(idx: np.ndarray, n_experts: int) -> np.ndarray:
    """Each (token, slot) pair's place in its expert's queue, counted in
    token order: the rule both packages' sorts implement."""
    seen = np.zeros(n_experts, np.int64)
    pos = np.empty(idx.size, np.int64)
    for i, e in enumerate(idx.reshape(-1)):
        pos[i], seen[e] = seen[e], seen[e] + 1
    return pos


def test_spec_and_capacity_equal_the_reference():
    for name, kw in CONFIGS.items():
        jcfg, cfg = jmoe.MoEConfig(**kw), moe.MoEConfig(**kw)
        jspec = jax.tree.leaves(jmoe.moe_spec(jcfg),
                                is_leaf=lambda x: isinstance(x, jinit.P))
        spec = [p for p in jax.tree.leaves(moe.moe_spec(cfg),
                                           is_leaf=lambda x: isinstance(x, moe.P))]
        assert [(p.shape, p.axes, p.scale) for p in spec] == \
            [(p.shape, p.axes, p.scale) for p in jspec], name
        for t in (1, 2, 7, 45, 512, 2048):
            assert moe._capacity(cfg, t) == jmoe._capacity(jcfg, t), (name, t)
            assert moe._capacity(cfg, t) >= 4 and moe._capacity(cfg, t) % 4 == 0


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_route_and_dispatch(name):
    """Routing within 1e-5, the same expert ids, and the kept / dropped
    pairs of the reference's sort-based queue positions."""
    jcfg, cfg, jp, p, x = _setup(name)
    jw, jidx, jprobs = jmoe.route(jp, jcfg, jnp.asarray(x))
    w, idx, probs = moe.route(p, cfg, torch.from_numpy(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _close(w, jw)
    _close(probs, jprobs)
    cap = moe._capacity(cfg, N_TOKENS)
    pos, keep = moe.dispatch(idx, cfg.n_experts, cap)
    want = _queue_positions(np.asarray(jidx), cfg.n_experts)
    np.testing.assert_array_equal(pos.numpy(), want)
    np.testing.assert_array_equal(keep.numpy(), want < cap)
    if name == "drops":
        assert not keep.all()
    _close(moe.aux_load_balance_loss(probs, idx, cfg.n_experts),
           jmoe.aux_load_balance_loss(jprobs, jidx, jcfg.n_experts))


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_and_gather_paths(name, dtype):
    """``moe_dense`` and ``moe_gather`` against the reference's, and the
    two paths against each other (the same pairs dropped)."""
    jcfg, cfg, jp, p, x = _setup(name, seed=1)
    jdt, dt = getattr(jnp, dtype), getattr(torch, dtype)
    xt = torch.from_numpy(x)
    for jfn, fn in ((jmoe.moe_dense, moe.moe_dense), (jmoe.moe_gather, moe.moe_gather)):
        jy, jaux = jfn(jp, jcfg, jnp.asarray(x), jdt)
        y, aux = fn(p, cfg, xt, dt)
        assert y.dtype == dt
        _close(y, jy, dtype)
        _close(aux, jaux)
    if dtype == "float32":
        yd, _ = moe.moe_dense(p, cfg, xt, dt)
        yg, _ = moe.moe_gather(p, cfg, xt, dt)
        _close(yg, yd.numpy())


@pytest.mark.parametrize("impl", ["gather", "dense"])
def test_moe_block(impl):
    jcfg, cfg, jp, p, x = _setup("drops", seed=2)
    jcfg, cfg = dataclasses.replace(jcfg, impl=impl), dataclasses.replace(cfg, impl=impl)
    x3 = x[:44].reshape(4, 11, -1)
    jy, jaux = jmoe.moe_block(jp, jcfg, jnp.asarray(x3), jnp.float32)
    y, aux = moe.moe_block(p, cfg, torch.from_numpy(x3), torch.float32)
    assert tuple(y.shape) == x3.shape
    _close(y, jy)
    _close(aux, jaux)


def test_expert_parallelism_raises():
    _, cfg, _, p, x = _setup("granite")
    with pytest.raises(NotImplementedError, match="#6"):
        moe.moe_gather(p, cfg, torch.from_numpy(x), expert_shard=(0, 2))
    with pytest.raises(NotImplementedError, match="#6"):
        moe.moe_block(p, dataclasses.replace(cfg, ep_constraint=True),
                      torch.from_numpy(x)[None])
