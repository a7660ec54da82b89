"""The port's LM training substrate against the JAX reference, on the
CPU: checkpoints restored across the two packages both ways (f32, int8,
int32 and bf16 leaves; the same ``index.json`` and the same bytes), and
``examples/train_lm_torch.py`` against ``examples/train_lm.py``.
(``test_torch_trainer.py`` holds 10 ``Trainer`` steps against the
reference's.)
"""

import importlib.util
import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as jlm
from repro.nn import init as jinit
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro_torch import interop
from repro_torch.common.tree import tree_leaves
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt
from test_torch_trainer import TINY, _equal_trees, _make_trainer, _tiny_lm

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parents[1]

def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _reference_state(quantized: bool):
    """The reference's tiny-LM train state ({params, opt}) after one step, as
    numpy: f32 params and moments, or int8 moments and f32 scales; the
    int32 step."""
    jcfg = jlm.LMConfig(**{**TINY, "compute_dtype": jnp.float32})
    params = jinit.materialize(jlm.lm_spec(jcfg), jax.random.PRNGKey(1))
    ocfg = jopt.AdamWConfig(lr=1e-2, warmup_steps=2, quantized_state=quantized)
    tokens = jnp.asarray(np.random.default_rng(2).integers(0, 64, (2, 16)), jnp.int32)
    grads = jax.jit(jax.grad(lambda p, b: jlm.loss_fn(p, jcfg, b)))(
        params, {"tokens": tokens, "targets": tokens})
    params, state, _ = jax.jit(jopt.apply_updates, static_argnums=3)(
        params, grads, jopt.init_state(params, ocfg), ocfg)
    return _np({"params": params, "opt": state})


def _port_template(quantized: bool):
    _, params = _tiny_lm()
    return {"params": params,
            "opt": opt.init_state(params, opt.AdamWConfig(quantized_state=quantized))}


@pytest.mark.parametrize("quantized", [False, True])
def test_reference_checkpoint_restores_in_the_port(tmp_path, quantized):
    """A train state saved by ``repro.train.checkpoint.save`` restores into
    the port's own state tree with the same arrays (f32, int8, int32), and
    the port's save of it writes the reference's index and bytes."""
    state = _reference_state(quantized)
    jckpt.save(tmp_path / "ref", 5, state)
    got, step = ckpt.restore(tmp_path / "ref", _port_template(quantized), device="cpu")
    assert step == 5
    want = interop.from_reference(state, "cpu")
    assert _equal_trees(got, want)
    dtypes = {t.dtype for t in tree_leaves(got)}
    assert dtypes == ({torch.float32, torch.int8, torch.int32} if quantized
                      else {torch.float32, torch.int32})
    ckpt.save(tmp_path / "port", 5, got)
    ref_dir, port_dir = tmp_path / "ref" / "step_00000005", tmp_path / "port" / "step_00000005"
    assert json.loads((ref_dir / "index.json").read_text()) == \
        json.loads((port_dir / "index.json").read_text())
    for i in range(len(tree_leaves(got))):
        assert (ref_dir / f"a_{i}.npy").read_bytes() == (port_dir / f"a_{i}.npy").read_bytes()


@pytest.mark.parametrize("quantized", [False, True])
def test_port_checkpoint_restores_in_the_reference(tmp_path, quantized):
    """The port's ``Trainer`` state after 3 steps, saved by the port,
    restores in the reference (into its own state tree) with the same
    arrays."""
    t = _make_trainer(tmp_path / "port", quantized=quantized)
    t.run(3)
    jparams = jinit.materialize(jlm.lm_spec(jlm.LMConfig(**TINY)), jax.random.PRNGKey(1))
    template = {"params": jparams, "opt": jopt.init_state(
        jparams, jopt.AdamWConfig(quantized_state=quantized))}
    restored, step = jckpt.restore(tmp_path / "port", template)
    assert step == 3
    assert _equal_trees(interop.from_reference(restored, "cpu"), t.state_tree())


def test_bf16_leaves_cross_both_ways(tmp_path):
    """The reference writes a bf16 leaf as raw 2-byte elements (``'<V2'``);
    the port reads it as bf16 and writes the same bytes back."""
    rng = np.random.default_rng(6)
    x = jnp.asarray(rng.standard_normal((5, 7)), jnp.bfloat16)
    jckpt.save(tmp_path / "ref", 1, {"w": x, "n": jnp.arange(3, dtype=jnp.int32)})
    template = {"w": torch.zeros(5, 7, dtype=torch.bfloat16),
                "n": torch.zeros(3, dtype=torch.int32)}
    got, _ = ckpt.restore(tmp_path / "ref", template, device="cpu")
    bits = np.asarray(x).view(np.int16)
    assert got["w"].dtype == torch.bfloat16
    assert np.array_equal(got["w"].view(torch.int16).numpy(), bits)
    ckpt.save(tmp_path / "port", 1, got)
    back, _ = jckpt.restore(tmp_path / "port", {"w": x, "n": jnp.arange(3, dtype=jnp.int32)})
    assert back["w"].dtype == np.dtype("V2") and np.array_equal(back["w"].view(np.int16), bits)
    assert json.loads((tmp_path / "port" / "step_00000001" / "index.json").read_text()) == \
        json.loads((tmp_path / "ref" / "step_00000001" / "index.json").read_text())


def _example(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_twin_matches_reference_example(tmp_path, monkeypatch):
    """``examples/train_lm_torch.py --device cpu`` against
    ``examples/train_lm.py`` for 4 steps of 4 x 32 tokens, both at a tiny
    width (patched into each example's ``WIDTHS``) with f32 compute, the
    port's initial parameters the reference example's (``PRNGKey(0)``):
    each step's loss within 1e-4 relative; both resume from their
    checkpoint with nothing to do."""
    width = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
                 d_ff=64, vocab=128)
    ref, twin = _example("train_lm"), _example("train_lm_torch")
    monkeypatch.setitem(ref.WIDTHS, "demo", dict(width, compute_dtype=jnp.float32))
    monkeypatch.setitem(twin.WIDTHS, "demo", dict(width, compute_dtype=torch.float32))
    jcfg = jlm.LMConfig(name="lm-demo", **ref.WIDTHS["demo"])
    jparams = _np(jinit.materialize(jlm.lm_spec(jcfg), jax.random.PRNGKey(0)))
    monkeypatch.setattr(twin.nninit, "materialize",
                        lambda spec, gen: interop.from_reference(jparams, "cpu"))
    args = ["--steps", "4", "--batch", "4", "--seq", "32"]
    monkeypatch.setattr(sys, "argv", ["train_lm.py", *args, "--ckpt-dir",
                                      str(tmp_path / "jc"), "--out", str(tmp_path / "j.json")])
    ref.main()
    twin.main(["--device", "cpu", *args, "--ckpt-dir", str(tmp_path / "tc"),
               "--out", str(tmp_path / "t.json")])
    want = json.loads((tmp_path / "j.json").read_text())["losses"]
    got = json.loads((tmp_path / "t.json").read_text())
    assert got["device"] == "cpu" and len(got["losses"]) == len(want) == 4
    for a, b in zip(want, got["losses"]):
        assert abs(a - b) <= 1e-4 * abs(a)
    assert json.loads((tmp_path / "tc" / "step_00000004" / "index.json").read_text())["paths"] == \
        json.loads((tmp_path / "jc" / "step_00000004" / "index.json").read_text())["paths"]
    (tmp_path / "t.json").unlink()
    twin.main(["--device", "cpu", *args, "--ckpt-dir", str(tmp_path / "tc"),
               "--out", str(tmp_path / "t.json")])
    assert not (tmp_path / "t.json").exists()   # resumed at step 4: nothing to do
