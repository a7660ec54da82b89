"""The port's LM training substrate on the CPU: ``train/trainer.py`` and
``train/checkpoint.py``, the twins of ``tests/test_train_substrate.py``'s
trainer tests (loss falling, checkpoint round trip, bit-exact restart, the
atomic save, grad accumulation, 8-bit moments, the straggler hook), the
async save and the donated AdamW step; then 10 ``Trainer`` steps against
the JAX reference's.  ``test_torch_trainer_parity.py`` holds checkpoints
and the example against the reference's.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.tokens import SyntheticTokens as JTokens
from repro.data.tokens import TokenPipelineConfig as JTokenCfg
from repro.models import lm as jlm
from repro.nn import init as jinit
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch import interop
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.data.tokens import SyntheticTokens, TokenPipelineConfig
from repro_torch.models import lm
from repro_torch.nn import init as nninit
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt
from repro_torch.train.trainer import (FailureInjector, Trainer, TrainerConfig,
                                       run_with_restarts)

torch.set_num_threads(2)
TINY = dict(name="tiny", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
            d_ff=64, vocab=64, remat=False)


def _tiny_lm(**kw):
    cfg = lm.LMConfig(**{**TINY, **kw})
    return cfg, nninit.materialize(lm.lm_spec(cfg), torch.Generator().manual_seed(0))


def _make_trainer(tmp, fail_at=None, seed=0, accum=1, quantized=False, params=None,
                  async_ckpt=False, **cfg_kw):
    cfg, drawn = _tiny_lm(**cfg_kw)
    loader = SyntheticTokens(TokenPipelineConfig(vocab_size=64, seq_len=16,
                                                 global_batch=8, seed=seed))
    return Trainer(
        loss_fn=lambda p, b: lm.loss_fn(p, cfg, b),
        params=drawn if params is None else params,
        tcfg=TrainerConfig(total_steps=12, ckpt_every=4, ckpt_dir=str(tmp),
                           grad_accum=accum, async_checkpoint=async_ckpt),
        ocfg=opt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=12,
                             quantized_state=quantized),
        loader=loader,
        injector=FailureInjector(fail_at_step=fail_at) if fail_at else None,
        device="cpu")


def _equal_trees(a, b) -> bool:
    """Leaf for leaf, dict entries matched by key."""
    assert len(tree_leaves(a)) == len(tree_leaves(b))
    return all(tree_leaves(tree_map(torch.equal, a, b)))


# -- the substrate (twins of tests/test_train_substrate.py) ------------------------


def test_loss_decreases(tmp_path):
    hist = _make_trainer(tmp_path).run(12)
    assert np.mean([h["loss"] for h in hist[-3:]]) < np.mean([h["loss"] for h in hist[:3]])
    assert [h["step"] for h in hist] == list(range(1, 13))


def test_checkpoint_roundtrip(tmp_path):
    t = _make_trainer(tmp_path)
    t.run(4)
    t2 = _make_trainer(tmp_path)
    assert t2.try_restore() and t2.step == 4
    assert _equal_trees(t.state_tree(), t2.state_tree())


@pytest.mark.parametrize("quantized,async_ckpt", [(False, False), (True, False),
                                                  (False, True)])
def test_restart_bitexact(tmp_path, quantized, async_ckpt):
    """An uninterrupted run equals one failed at step 6 and restarted from
    step 4's checkpoint, bit for bit: parameters, moments and the losses of
    the replayed steps.  With ``async_checkpoint`` the failed run's saves
    run on a thread while training goes on, and the uninterrupted run
    saves synchronously."""
    ref = _make_trainer(tmp_path / "ref", quantized=quantized)
    ref.run(12)
    calls = {"n": 0}

    def make():
        calls["n"] += 1
        return _make_trainer(tmp_path / "ft", fail_at=6 if calls["n"] == 1 else None,
                             quantized=quantized, async_ckpt=async_ckpt)

    t = run_with_restarts(make, total_steps=12)
    assert calls["n"] == 2 and t.step == 12 and len(t.metrics_history) == 8
    assert [h["loss"] for h in t.metrics_history] == [h["loss"] for h in ref.metrics_history[4:]]
    assert _equal_trees(ref.state_tree(), t.state_tree())
    assert ckpt.latest_step(tmp_path / "ft") == 12


def test_ckpt_atomic_under_midwrite_crash(tmp_path):
    _, params = _tiny_lm()
    tree = {"params": params}
    ckpt.save(tmp_path, 1, tree)
    with pytest.raises(RuntimeError, match="injected"):
        ckpt.save(tmp_path, 2, tree, _fail_after_files=3)
    assert ckpt.latest_step(tmp_path) == 1
    assert (tmp_path / "step_00000002.tmp").exists()
    restored, step = ckpt.restore(tmp_path, tree, device="cpu")
    assert step == 1 and _equal_trees(restored, tree)
    # LATEST naming an incomplete step falls back to the newest complete one
    (tmp_path / "LATEST").write_text("2")
    assert ckpt.latest_step(tmp_path) == 1


def test_async_checkpoint_copies_before_the_thread(tmp_path):
    """``AsyncCheckpointer`` saves the values of the moment it was called,
    though the caller updates its tensors in place right after."""
    _, params = _tiny_lm()
    want = tree_map(torch.clone, params)
    saver = ckpt.AsyncCheckpointer(tmp_path)
    saver.save(3, params)
    for t in tree_leaves(params):
        t.add_(1.0)
    saver.wait()
    restored, step = ckpt.restore(tmp_path, params, device="cpu")
    assert step == 3 and _equal_trees(restored, want)


def test_restore_checks_the_template(tmp_path):
    _, params = _tiny_lm()
    ckpt.save(tmp_path, 1, params)
    wrong = dict(params, embed={"table": params["embed"]["table"][:3]})
    with pytest.raises(ValueError, match="template"):
        ckpt.restore(tmp_path, wrong, device="cpu")
    with pytest.raises(ValueError, match="path"):
        ckpt.restore(tmp_path, dict(params, extra_norm=params.pop("final_norm")),
                     device="cpu")


def test_grad_accum_equivalence(tmp_path):
    """accum=2 with half microbatches == accum=1 on the same global batch:
    within 2e-2 at bf16 compute (the reference test's bound), within 1e-6
    at f32."""
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-6)):
        h1 = _make_trainer(tmp_path / f"a{tol}", accum=1, compute_dtype=dtype).run(3)
        h2 = _make_trainer(tmp_path / f"b{tol}", accum=2, compute_dtype=dtype).run(3)
        for a, b in zip(h1, h2):
            assert abs(a["loss"] - b["loss"]) < tol, (dtype, a["loss"], b["loss"])


def test_quantized_adam_close_to_fp32(tmp_path):
    h1 = _make_trainer(tmp_path / "a").run(10)
    h2 = _make_trainer(tmp_path / "b", quantized=True).run(10)
    assert h2[-1]["loss"] < h2[0]["loss"]
    assert abs(h1[-1]["loss"] - h2[-1]["loss"]) < 0.5


def test_straggler_hook(tmp_path):
    t = _make_trainer(tmp_path)
    t.tcfg.step_deadline_s = 0.0  # everything is a straggler
    t.run(2)
    assert len(t.straggler_log) == 2
    assert {"step", "latency_s"} <= set(t.straggler_log[0])


@pytest.mark.parametrize("quantized", [False, True])
def test_donated_adamw_step_is_the_functional_one(quantized):
    """``apply_updates(donate=True)`` writes into the same tensors, leaf
    by leaf, the values of the functional step bit for bit; a None grad
    counts as zeros in both."""
    _, params = _tiny_lm()
    rng = np.random.default_rng(4)
    grads = tree_map(lambda p: torch.from_numpy(
        rng.standard_normal(tuple(p.shape)).astype(np.float32)), params)
    grads["final_norm"]["scale"] = None
    ocfg = opt.AdamWConfig(lr=1e-2, warmup_steps=2, quantized_state=quantized)
    state = opt.init_state(params, ocfg)
    for _ in range(2):   # two steps: the second from non-zero moments
        want_p, want_s, want_m = opt.apply_updates(params, grads, state, ocfg)
        copies = tree_map(torch.clone, (params, state))
        got_p, got_s, got_m = opt.apply_updates(*copies[:1], grads, copies[1], ocfg,
                                                donate=True)
        assert all(a is b for a, b in zip(tree_leaves(got_p), tree_leaves(copies[0])))
        assert _equal_trees(got_p, want_p) and _equal_trees(got_s, want_s)
        assert torch.equal(got_m["grad_norm"], want_m["grad_norm"])
        params, state = want_p, want_s


# -- against the reference ----------------------------------------------------------


def test_trainer_matches_reference(tmp_path):
    """10 steps of the port's ``Trainer`` against the reference's on the
    tiny LM at f32 compute, the reference's parameters carried across, on
    the same ``SyntheticTokens`` batches: losses within 1e-4 relative at
    every step (measured: 1.2e-7), parameters within 2 lr everywhere and
    within 1e-6 at all but 1 element in 10^3 (the NSAI tests' AdamW
    bound; measured 12 of 22688, max 5.7e-6).  The reference runs op by op
    (``jax.disable_jit``): its jitted step fuses f32 arithmetic, and
    against it 40 of the 22688 elements (1.8 in 10^3) lie beyond 1e-6, max
    2.7e-5, where Adam's sign-like early steps carry a near-zero gradient's
    rounding to a move of lr's order."""
    jcfg = jlm.LMConfig(**{**TINY, "compute_dtype": jnp.float32})
    jparams = jinit.materialize(jlm.lm_spec(jcfg), jax.random.PRNGKey(0))
    tparams = interop.from_reference(jax.tree.map(np.asarray, jparams), "cpu")
    lr = 1e-2
    with jax.disable_jit():
        jt = jtrainer.Trainer(
            lambda p, b: jlm.loss_fn(p, jcfg, b), jparams,
            jtrainer.TrainerConfig(total_steps=10, ckpt_every=100, ckpt_dir=str(tmp_path / "j")),
            jopt.AdamWConfig(lr=lr, warmup_steps=2, total_steps=10),
            JTokens(JTokenCfg(vocab_size=64, seq_len=16, global_batch=8, seed=0)))
        jhist = jt.run(10)
    t = _make_trainer(tmp_path / "t", params=tparams, compute_dtype=torch.float32)
    t.tcfg.ckpt_every, t.ocfg = 100, opt.AdamWConfig(lr=lr, warmup_steps=2, total_steps=10)
    hist = t.run(10)
    for a, b in zip(jhist, hist, strict=True):
        assert abs(a["loss"] - b["loss"]) <= 1e-4 * abs(a["loss"])
    want = tree_leaves(interop.from_reference(jax.tree.map(np.asarray, jt.params), "cpu"))
    diffs = torch.cat([(g - w).abs().reshape(-1) for g, w in zip(tree_leaves(t.params), want,
                                                                  strict=True)])
    assert float(diffs.max()) <= 2 * lr
    assert int((diffs > 1e-6).sum()) <= diffs.numel() // 1000
