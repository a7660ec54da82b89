"""The training half of distribution on the CPU, against the JAX reference:
the pipeline (``distributed/gpipe.py``), error-feedback compression
(``distributed/compression.py``), mesh folding (``core/folding.py``) and
the elastic remesh (``checkpoint.restore(shardings=)`` and
``world.CheckpointParams``).

The SPMD bodies run on gloo worlds of CPU processes (``World.spmd``): one
of 4 ranks and one of 2, shared by the module.  The reference's
``shard_map`` programs run in one subprocess with 8 host devices, as
``tests/test_gpipe.py`` and ``test_core_dag.py`` run them, on the same
numpy inputs:

- GPipe: 4 stages x 8 microbatches of (2, 16), the reference test's tanh
  dense stage: outputs within 1e-5 and gradients within 1e-4 of the
  reference's ``make_pipelined_fn`` (and of the port's sequential loop);
- folding: the reference's ``FOLD_SCRIPT`` streams (8 devices, n_l = 6)
  against the port on 4 ranks (n_l = 3), within 1e-5; NVSA's frontend
  beside its symbolic back end at smoke width against the reference's
  unfolded ``frontend_pmfs`` / ``reason`` (1e-4 / 1e-3, as
  ``test_torch_nvsa.py`` holds them);
- compression: ``quantize`` / ``dequantize`` / the EF trees bit-equal to
  the reference, ``compressed_psum`` over 2 ranks equal to the reference's
  arithmetic on the same payloads;
- the remesh: a checkpoint restored onto (1,)-mesh specs and onto tp-2
  cuts, and a world built from a ``Trainer``'s checkpoint rank by rank
  giving the logits of one built from memory, bit for bit.

About 25 s alone (two worlds, one reference subprocess).
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import _torch_dist_ranks as ranks
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import compression as jcomp
from repro.models import nvsa as jnv
from repro.nn import init as jinit
from repro_torch import interop
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.configs import ARCHS
from repro_torch.configs import base as cbase
from repro_torch.distributed import compression as comp
from repro_torch.distributed import constraints as tpc
from repro_torch.distributed import gpipe
from repro_torch.distributed import sharding_rules as sr
from repro_torch.distributed import world as W
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.models import nvsa
from repro_torch.nn import init as nninit
from repro_torch.serve import engine as pengine
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt

torch.set_num_threads(2)

TIMEOUT_S = 30.0
SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

# the reference's programs over host devices, on the inputs of IN_NPZ
REF_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.core import folding
from repro.distributed import gpipe
from repro.common.util import mesh_context

inp = dict(np.load(sys.argv[1]))
out = {}
mesh = Mesh(np.array(jax.devices()[:4]), ("pod",))
params = {"w": jnp.asarray(inp["w"]), "b": jnp.asarray(inp["b"])}
x = jnp.asarray(inp["x"])

def stage_fn(p, h):
    return jnp.tanh(h @ p["w"] + p["b"])

piped = gpipe.make_pipelined_fn(stage_fn, 4, mesh, "pod")
with mesh_context(mesh):
    out["out"] = np.asarray(jax.jit(piped)(params, x))
    g = jax.jit(jax.grad(lambda p, x: jnp.sum(piped(p, x) ** 2)))(params, x)
out["gw"], out["gb"] = np.asarray(g["w"]), np.asarray(g["b"])

mesh8 = jax.make_mesh((8,), ("model",))
fw = jnp.asarray(inp["fw"])
f = folding.make_folded_fn(mesh8, "model", 6, lambda a: jnp.tanh(a @ fw),
                           lambda a: jnp.roll(a, 1, axis=-1) * 2.0, (12, 16), (4, 16))
with mesh_context(mesh8):
    nn_out, vsa_out = jax.jit(f)(jnp.asarray(inp["nn_x"]), jnp.asarray(inp["vsa_x"]))
out["nn_out"], out["vsa_out"] = np.asarray(nn_out), np.asarray(vsa_out)
np.savez(sys.argv[2], **out)
print("REF_OK")
"""


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    d = 16
    return {"w": (rng.standard_normal((4, d, d)) / np.sqrt(d)).astype(np.float32),
            "b": (rng.standard_normal((4, d)) * 0.1).astype(np.float32),
            "x": rng.standard_normal((8, 2, d)).astype(np.float32),
            "fw": rng.standard_normal((16, 16)).astype(np.float32),
            "nn_x": rng.standard_normal((12, 16)).astype(np.float32),
            "vsa_x": rng.standard_normal((4, 16)).astype(np.float32)}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The inputs and the reference's outputs (one subprocess)."""
    d = tmp_path_factory.mktemp("ref")
    inp = _inputs()
    np.savez(d / "in.npz", **inp)
    env = {"PYTHONPATH": str(SRC), "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": os.environ.get("HOME", str(d)), "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, "-c", REF_SCRIPT, str(d / "in.npz"),
                        str(d / "out.npz")], capture_output=True, text=True,
                       timeout=600, env=env)
    assert "REF_OK" in r.stdout, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr[-3000:]}"
    return inp, dict(np.load(d / "out.npz"))


@pytest.fixture(scope="module")
def worlds():
    """One world of each size, opened on first use, closed (joined with a
    timeout) after the module."""
    opened: dict[int, W.World] = {}

    def get(n: int) -> W.World:
        if n not in opened:
            opened[n] = W.World(("cpu",) * n, timeout_s=TIMEOUT_S)
        return opened[n]

    yield get
    for w in opened.values():
        procs = list(w._procs)
        w.close()
        assert not any(p.is_alive() for p in procs)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


# -- GPipe ----------------------------------------------------------------------


def test_gpipe_matches_reference_and_sequential(worlds, reference):
    inp, ref = reference
    w, b, x = _t(inp["w"]), _t(inp["b"]), _t(inp["x"])
    world = worlds(4)
    res = world.spmd(ranks.gpipe_dense, [(w, b, x)] * 4, axis="pod")
    outs = [r[0] for r in res]
    assert all(torch.equal(o, outs[0]) for o in outs)     # the psum is on every rank
    np.testing.assert_allclose(outs[0].numpy(), ref["out"], atol=1e-5, rtol=0)
    gw = torch.stack([r[1]["w"] for r in res])
    gb = torch.stack([r[1]["b"] for r in res])
    np.testing.assert_allclose(gw.numpy(), ref["gw"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(gb.numpy(), ref["gb"], atol=1e-4, rtol=0)

    # the port's sequential loop
    pw, pb = w.clone().requires_grad_(), b.clone().requires_grad_()
    h = x
    for s in range(4):
        h = ranks.tanh_dense({"w": pw[s], "b": pb[s]}, h)
    (h ** 2).sum().backward()
    torch.testing.assert_close(outs[0], h.detach(), atol=1e-5, rtol=0)
    torch.testing.assert_close(gw, pw.grad, atol=1e-4, rtol=0)
    torch.testing.assert_close(gb, pb.grad, atol=1e-4, rtol=0)

    # 11 ticks: a permute each forward, the reverse of each but the first
    # (whose input holds no gradient) backward, and one psum
    stats, nbytes = world.spmd_ctx.stats, world.spmd_ctx.nbytes
    assert stats["ppermute"][0] >= 11 + 10 and stats["psum"][0] >= 1
    assert nbytes["ppermute"] > 0
    assert gpipe.bubble_fraction(4, 8) == pytest.approx(3 / 11)


def test_spmd_body_needs_its_group():
    with pytest.raises(RuntimeError, match="no SPMD group"):
        gpipe.make_pipelined_fn(ranks.tanh_dense, 2, Mesh(("pod",), (2,)))(
            {}, torch.zeros(1, 1))
    with pytest.raises(ValueError, match="3 stages"):
        gpipe.make_pipelined_fn(ranks.tanh_dense, 3, Mesh(("pod",), (2,)))


# -- folding ---------------------------------------------------------------------


def test_folding_matches_reference(worlds, reference):
    inp, ref = reference
    args = (3, _t(inp["fw"]), _t(inp["nn_x"]), _t(inp["vsa_x"]))
    res = worlds(4).spmd(ranks.fold_dense, [args] * 4, axis="model")
    for nn_out, vsa_out in res:
        np.testing.assert_allclose(nn_out.numpy(), ref["nn_out"], atol=1e-5, rtol=0)
        np.testing.assert_allclose(vsa_out.numpy(), ref["vsa_out"], atol=1e-5, rtol=0)


def _ref_nvsa(jcfg, seed: int = 0):
    """Frontend params drawn with numpy on the reference's spec (BN with
    non-trivial running stats), and the reference's codebooks."""
    rng = np.random.default_rng(seed)

    def draw(p):
        if p.init == "normal":
            std = p.scale or 1.0 / np.sqrt(np.prod(p.shape[:-1]))
            return (rng.standard_normal(p.shape) * std).astype(np.float32)
        if p.init == "ones":
            return rng.uniform(0.5, 1.5, p.shape).astype(np.float32)
        return (rng.standard_normal(p.shape) * 0.1).astype(np.float32)

    params = jax.tree.map(draw, jnv.nvsa_spec(jcfg), is_leaf=lambda x: isinstance(x, jinit.P))
    books = jax.tree.map(np.asarray, jnv.nvsa_codebooks(jcfg, jax.random.PRNGKey(1)))
    return params, books


def test_folded_nvsa_matches_reference_unfolded(worlds):
    """NVSA at smoke width on 2 ranks (n_l = 1): the frontend on 8 panels
    on rank 0, the symbolic back end on 2 problems' PMFs on rank 1."""
    kw = dict(d=64, blocks=2, cnn_width=8, cnn_feat=32)
    cfg, jcfg = nvsa.NVSAConfig(**kw), jnv.NVSAConfig(**kw)
    jp, jbooks = _ref_nvsa(jcfg)
    rng = np.random.default_rng(3)
    images = rng.random((8, 32, 32, 1)).astype(np.float32)

    def pmfs():
        out = []
        for n in cfg.raven.attr_sizes:
            p = np.exp(rng.standard_normal((2, 8, n)) * 3)
            out.append((p / p.sum(-1, keepdims=True)).astype(np.float32))
        return out

    ctx, cand = pmfs(), pmfs()
    want_pmfs, _ = jnv.frontend_pmfs(jax.tree.map(jnp.asarray, jp), jcfg, jnp.asarray(images))
    want_lp, _ = jnv.reason(jcfg, jax.tree.map(jnp.asarray, jbooks),
                            [jnp.asarray(a) for a in ctx], [jnp.asarray(a) for a in cand])
    params, books = interop.from_reference(jp, "cpu"), interop.from_reference(jbooks, "cpu")
    packed = ranks.pack_pmfs([_t(a) for a in ctx], [_t(a) for a in cand])
    res = worlds(2).spmd(ranks.fold_nvsa, [(1, cfg, params, books, _t(images), packed)] * 2,
                         axis="model")
    for nn_out, vsa_out in res:
        np.testing.assert_allclose(nn_out.numpy(),
                                   np.concatenate([np.asarray(p) for p in want_pmfs], -1),
                                   atol=1e-4, rtol=0)
        np.testing.assert_allclose(vsa_out.numpy(), np.asarray(want_lp), atol=1e-3, rtol=0)
    # and bit for bit the port's own unfolded calls
    nn_fn, vsa_fn = ranks.nvsa_streams(cfg, params, books)
    assert torch.equal(res[0][0], nn_fn(_t(images)))
    assert torch.equal(res[0][1], vsa_fn(packed))


# -- compression -----------------------------------------------------------------


def test_quantize_and_ef_trees_bit_equal_reference():
    rng = np.random.default_rng(5)
    g = {"a": (rng.standard_normal((256,)) * 0.1).astype(np.float32),
         "b": [(rng.standard_normal((4, 33)) * 3).astype(np.float32)]}
    q, s = comp.quantize(_t(g["a"]))
    jq, js = jcomp.quantize(jnp.asarray(g["a"]))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.dim() == 0
    assert float(s) == float(js)
    np.testing.assert_array_equal(comp.dequantize(q, s).numpy(),
                                  np.asarray(jcomp.dequantize(jq, js)))
    assert float((comp.dequantize(q, s) - _t(g["a"])).abs().max()) <= float(s) * 0.5 + 1e-7

    tg = {"a": _t(g["a"]), "b": [_t(g["b"][0])]}
    res, jres = comp.init_residuals(tg), jcomp.init_residuals(jax.tree.map(jnp.asarray, g))
    for i in range(5):
        step = {"a": tg["a"] * (i + 1), "b": [tg["b"][0] - i]}
        payload, res = comp.ef_compress_tree(step, res)
        jpayload, jres = jcomp.ef_compress_tree(jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                                                             step), jres)
        deq, jdeq = comp.ef_decompress_tree(payload), jcomp.ef_decompress_tree(jpayload)
        for got, want in zip(tree_leaves(deq), jax.tree.leaves(jdeq)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for got, want in zip(tree_leaves(res), jax.tree.leaves(jres)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_compressed_psum_over_two_ranks(worlds):
    rng = np.random.default_rng(6)
    g = (rng.standard_normal((2, 300)) * np.array([[1.0], [0.01]])).astype(np.float32)
    res = worlds(2).spmd(ranks.compressed_sum, [(_t(g),)] * 2, axis="data")
    assert torch.equal(res[0], res[1])
    # the reference's arithmetic on the same payloads
    qs = [jcomp.quantize(jnp.asarray(x)) for x in g]
    want = np.asarray(jnp.tensordot(jnp.stack([s for _, s in qs]),
                                    jnp.stack([q for q, _ in qs]).astype(jnp.float32), axes=1))
    np.testing.assert_allclose(res[0].numpy(), want, atol=1e-6, rtol=0)
    bound = sum(float(s) for _, s in qs) / 2
    assert float(np.abs(res[0].numpy() - g.sum(0)).max()) <= bound * (1 + 1e-5)


# -- the elastic remesh ----------------------------------------------------------------


def _llama():
    arch = ARCHS["llama3.2-3b"]
    cfg = arch.make_smoke()
    spec = cbase.model_spec(arch, cfg)
    return arch, cfg, spec, nninit.materialize(spec, torch.Generator().manual_seed(4))


def test_unsharded_checkpoint_restores_onto_specs(tmp_path):
    _, _, spec, params = _llama()
    ckpt.save(tmp_path, 1, params)
    mesh = Mesh(("data",), (1,))
    shardings = tree_map(lambda p: (), spec)      # PartitionSpec() everywhere
    got, step = ckpt.restore(tmp_path, nninit.shapes(spec), device="cpu",
                             shardings=shardings, mesh=mesh)
    assert step == 1
    for a, b in zip(tree_leaves(params), tree_leaves(got), strict=True):
        assert torch.equal(a, b) and not hasattr(b, "tp_dim")
    with pytest.raises(ValueError, match="mesh="):
        ckpt.restore(tmp_path, nninit.shapes(spec), device="cpu", shardings=shardings)


@pytest.mark.parametrize("rank", [0, 1])
def test_checkpoint_restores_each_ranks_cut(tmp_path, rank):
    _, _, spec, params = _llama()
    ckpt.save(tmp_path, 3, params)
    mesh = make_host_mesh(1, 2)
    shardings = sr.param_shardings(spec, mesh, min_shard_elems=0)
    got, _ = ckpt.restore(tmp_path, nninit.shapes(spec), device="cpu",
                          shardings=shardings, rank=rank, mesh=mesh)
    want = sr.param_shards(params, spec, rank, mesh)
    n_cut = 0
    for a, b in zip(tree_leaves(want), tree_leaves(got), strict=True):
        assert torch.equal(a, b)
        assert getattr(a, "tp_dim", None) == getattr(b, "tp_dim", None)
        n_cut += hasattr(b, "tp_dim")
    assert n_cut > 0
    # a cut along data stays refused
    with pytest.raises(NotImplementedError, match="model axis"):
        ckpt.restore(tmp_path, nninit.shapes(spec), device="cpu",
                     shardings=sr.param_shardings(spec, make_host_mesh(2, 1), fsdp=True,
                                                  min_shard_elems=0),
                     mesh=make_host_mesh(2, 1))


@pytest.mark.parametrize("rank", [0, 1])
def test_checkpoint_params_never_read_the_moments(tmp_path, rank):
    """``CheckpointParams`` over a ``Trainer`` checkpoint whose moment files
    are gone: the moments are checked against the index only (a restore of
    the whole tree fails for want of them), and each rank of a dry tp-2
    context gets ``param_shards``' cut of the parameters."""
    arch, _, spec, _ = _llama()
    launch_train.main(["--arch", "llama3.2-3b", "--device", "cpu", "--steps", "2",
                       "--batch", "2", "--seq", "8", "--ckpt-dir", str(tmp_path)])
    shapes = nninit.shapes(spec)
    template = {"opt": opt.state_shapes(shapes, opt.AdamWConfig(quantized_state=arch.opt_8bit)),
                "params": shapes}
    whole, _ = ckpt.restore(tmp_path, template, device="cpu")
    d = tmp_path / "step_00000002"
    paths = json.loads((d / "index.json").read_text())["paths"]
    n_opt = 0
    for i, path in enumerate(paths):
        if path.startswith("['opt']"):
            (d / f"a_{i}.npy").unlink()
            n_opt += 1
    assert n_opt > 0
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmp_path, template, device="cpu")
    ctx = tpc.TPContext(None, rank, 2)
    with tpc.tp_group(ctx):
        got = W.CheckpointParams(str(tmp_path), template, key="params")(
            spec, lambda p, t: sr.cut_leaf(p, t, rank, ctx.mesh), torch.device("cpu"))
    want = sr.param_shards(whole["params"], spec, rank, ctx.mesh)
    for a, b in zip(tree_leaves(want), tree_leaves(got), strict=True):
        assert torch.equal(a, b)
        assert getattr(a, "tp_dim", None) == getattr(b, "tp_dim", None)
    # a moment the index disagrees with is refused without reading it
    bad = {"opt": {**template["opt"],
                   "step": torch.empty((2,), dtype=torch.int32, device="meta")},
           "params": shapes}
    with pytest.raises(ValueError, match=r"\['opt'\]\['step'\]: checkpoint \(\) int32"):
        ckpt.restore(tmp_path, bad, device="cpu", mesh=ctx.mesh, rank=rank,
                     shardings={"opt": ckpt.SKIP, "params": tree_map(lambda p: (), spec)})


def test_world_from_a_trainer_checkpoint_equals_one_from_memory(worlds, tmp_path):
    """``launch.train`` writes a Trainer checkpoint ({"opt", "params"});
    each rank of a tp-2 world restores its cut of the parameters from it
    (``CheckpointParams``), and its logits are those of a world given the
    restored parameters whole, bit for bit."""
    arch, cfg, spec, _ = _llama()
    launch_train.main(["--arch", "llama3.2-3b", "--device", "cpu", "--steps", "2",
                       "--batch", "2", "--seq", "8", "--ckpt-dir", str(tmp_path)])
    shapes = nninit.shapes(spec)
    template = {"opt": opt.state_shapes(shapes, opt.AdamWConfig(quantized_state=arch.opt_8bit)),
                "params": shapes}
    restored, step = ckpt.restore(tmp_path, template, device="cpu")
    assert step == 2
    serve = pengine.ServeConfig(max_slots=2, max_len=32, max_new_tokens=2, decode_block=2)
    cfg = dataclasses.replace(cfg, compute_dtype=torch.float32)
    world = worlds(2)
    from_ckpt = W.TPEngine(world, W.EngineSpec(
        "llama3.2-3b", cfg, W.CheckpointParams(str(tmp_path), template, key="params"), serve),
        owns_world=False)
    from_memory = W.TPEngine(world, W.EngineSpec(
        "llama3.2-3b", cfg, W.GivenParams(restored["params"]), serve), owns_world=False)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (2, 12)))
    a, b = from_ckpt.forward(toks), from_memory.forward(toks)
    assert torch.equal(a, b)
    forward, readout = cbase.forward_fn(arch, cfg)
    p = restored["params"]
    torch.testing.assert_close(a, readout(p, forward(p, toks)), atol=1e-4, rtol=0)
    from_ckpt.close()
    from_memory.close()
