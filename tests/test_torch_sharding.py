"""The port's sharding policy, mesh DSE and small helpers against the
reference's, on the CPU, without processes.

- ``sharding_rules.spec_to_pspec`` / ``param_shardings`` against the
  reference's ``spec_to_pspec`` for every leaf of every arch's smoke and
  published spec, at model in {1, 2, 4, 16} x data in {1, 16}, under the
  TP and FSDP rules, with ``min_shard_elems`` at 0 and at the default.
  The reference's function reads only ``mesh.shape`` (and
  ``mesh.axis_names``), so it gets a stub mesh.
- ``cache_pspec`` / ``tree_cache_shardings`` on the cache shapes of every
  servable kind (the reference's ``NamedSharding`` is swapped for its
  spec by a fixture, so a stub mesh serves there too).
- ``meshdse.search`` / ``serving_search`` and ``deploy._mesh_plan``
  against the reference's under one table: the port's H100 ``HW``,
  patched into ``repro.core.meshdse`` by a fixture.
- ``SHAPES`` and ``common/util.py``.
- ``shard_leaf`` / ``param_shards``: the cuts tile each leaf.

About 3 s.
"""

import dataclasses
import importlib
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import util as jutil
from repro.configs import ARCHS as JARCHS
from repro.configs import base as jbase
from repro.configs import shapes as jshapes
from repro.core import meshdse as jmeshdse
from repro.distributed import sharding_rules as jsr
from repro.nn import init as jinit
from repro_torch.common import util
from repro_torch.common.tree import keystr, tree_flatten_with_path
from repro_torch.configs import ARCHS
from repro_torch.configs import base as cbase
from repro_torch.configs import shapes
from repro_torch.core import meshdse
from repro_torch.distributed import sharding_rules as sr
from repro_torch.launch import mesh as pmesh
from repro_torch.models import griffin, lm, rwkv6
from repro_torch.nn.init import P

# the modules (each package's ``serve`` exports the ``deploy`` function under
# the module's name)
jdeploy = importlib.import_module("repro.serve.deploy")
pdeploy = importlib.import_module("repro_torch.serve.deploy")

MESHES = [(d, m) for m in (1, 2, 4, 16) for d in (1, 16)]


def _stub(data: int, model: int):
    return types.SimpleNamespace(shape={"data": data, "model": model},
                                 axis_names=("data", "model"))


def _jax_leaves(spec) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        spec, is_leaf=lambda x: isinstance(x, jinit.P))
    return {jax.tree_util.keystr(path): leaf for path, leaf in flat}


def _port_leaves(tree) -> dict:
    return {keystr(path): leaf for path, leaf in tree_flatten_with_path(tree)}


def _spec_leaves(tree, path: tuple = ()) -> dict:
    """A tree of specs flattened with each spec (a tuple) as one leaf."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _spec_leaves(sub, path + (key,)).items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _spec_leaves(sub, path + (i,)).items()}
    return {keystr(path): tree}


@pytest.fixture(scope="module")
def specs():
    """Per (arch, size): the reference's leaves and the port's spec tree."""
    out = {}
    for arch_id, arch in ARCHS.items():
        for size in ("smoke", "full"):
            make = "make_smoke" if size == "smoke" else "make_full"
            jspec = jbase.model_spec(JARCHS[arch_id], getattr(JARCHS[arch_id], make)())
            out[arch_id, size] = (_jax_leaves(jspec),
                                  cbase.model_spec(arch, getattr(arch, make)()))
    return out


@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("arch_id", sorted(ARCHS))
def test_param_shardings_equal_the_references(specs, arch_id, size):
    jleaves, spec = specs[arch_id, size]
    assert set(_port_leaves(spec)) == set(jleaves)
    for data, model in MESHES:
        mesh = pmesh.make_host_mesh(data, model)
        for fsdp in (False, True):
            rules, jrules = (sr.FSDP_RULES, jsr.FSDP_RULES) if fsdp else \
                (sr.TP_RULES, jsr.TP_RULES)
            assert rules == jrules
            for floor in (0, None):
                got = _spec_leaves(sr.param_shardings(spec, mesh, fsdp=fsdp,
                                                      min_shard_elems=floor))
                for path, jp in jleaves.items():
                    want = tuple(jsr.spec_to_pspec(jp.axes, jp.shape, _stub(data, model),
                                                   jrules, floor))
                    assert got[path] == want, (arch_id, size, path, data, model, fsdp,
                                               floor)


def test_rule_tables_equal_the_references():
    assert sr.TP_RULES == jsr.TP_RULES and sr.FSDP_RULES == jsr.FSDP_RULES
    assert sr.FALLBACK_TP_AXES == jsr.FALLBACK_TP_AXES
    assert sr._MIN_SHARD_ELEMS == jsr._MIN_SHARD_ELEMS
    for multi in (False, True):
        m = pmesh.make_production_mesh(multi_pod=multi)
        assert sr.data_axes(m) == jsr.data_axes(types.SimpleNamespace(
            axis_names=m.axis_names))


def _servable_caches():
    """(label, the port's cache shapes, the reference's) of every servable
    kind at batch 4, 256 tokens: smoke and published dense, MoE, MLA and the
    two recurrent kinds."""
    from repro.models import griffin as jgriffin
    from repro.models import lm as jlm
    from repro.models import rwkv6 as jrwkv

    for arch_id in ("llama3.2-3b", "stablelm-3b", "starcoder2-3b", "gemma3-12b",
                    "granite-moe-1b-a400m", "deepseek-v3-671b", "rwkv6-7b",
                    "recurrentgemma-9b"):
        for make in ("make_smoke", "make_full"):
            cfg, jcfg = getattr(ARCHS[arch_id], make)(), getattr(JARCHS[arch_id], make)()
            kind = ARCHS[arch_id].kind
            if kind == "lm":
                yield arch_id, lm.cache_shapes(cfg, 4, 256), jlm.cache_shapes(jcfg, 4, 256)
            elif kind == "rwkv":
                yield arch_id, rwkv6.state_shapes(cfg, 4), jrwkv.state_shapes(jcfg, 4)
            else:
                yield (arch_id, griffin.state_shapes(cfg, 4, 256),
                       jgriffin.state_shapes(jcfg, 4, 256))


def test_cache_shardings_equal_the_references(monkeypatch):
    monkeypatch.setattr(jsr, "NamedSharding", lambda mesh, spec: tuple(spec))
    n = 0
    for arch_id, shapes_tree, jshapes_tree in _servable_caches():
        for data, model in MESHES:
            mesh, stub = pmesh.make_host_mesh(data, model), _stub(data, model)
            got = _spec_leaves(sr.tree_cache_shardings(shapes_tree, mesh))
            flat, _ = jax.tree_util.tree_flatten_with_path(
                jsr.tree_cache_shardings(jshapes_tree, stub),
                is_leaf=lambda x: isinstance(x, tuple))
            want = {jax.tree_util.keystr(p): s for p, s in flat}
            assert got == want, (arch_id, data, model)
            for path, leaf in _port_leaves(shapes_tree).items():
                shape = tuple(leaf.shape)
                for kv, seq in ((None, None), (len(shape) - 2, 1)):
                    assert sr.cache_pspec(shape, mesh, kv, seq) == tuple(
                        jsr.cache_pspec(shape, stub, kv, seq)), (arch_id, path)
                n += 1
    assert n > 100


@pytest.fixture
def h100(monkeypatch):
    """The port's hardware table in the reference's mesh DSE."""
    monkeypatch.setattr(jmeshdse, "HW", dict(pmesh.HW))
    return pmesh.HW


def _records(points) -> list:
    return [(p.data, p.model, p.remat, p.accum, p.record(), p.tag()) for p in points]


def test_h100_table():
    assert pmesh.HW.keys() == jmeshdse.HW.keys()
    assert pmesh.HW["peak_flops_bf16"] == 989e12 and pmesh.HW["hbm_bw"] == 3.35e12
    assert pmesh.HW["hbm_bytes"] == 80e9
    assert pmesh.HW["ici_bw_per_link"] * pmesh.HW["ici_links"] == 450e9
    assert pmesh.HW["vmem_bytes"] == 227 * 1024
    m = pmesh.make_host_mesh(2, 4)
    assert m.shape == {"data": 2, "model": 4} and m.axis_names == ("data", "model")
    assert pmesh.make_production_mesh(multi_pod=True).shape == \
        {"pod": 2, "data": 16, "model": 16}


@pytest.mark.parametrize("arch_id", ["llama3.2-3b", "granite-moe-1b-a400m",
                                     "gemma3-12b", "deepseek-v3-671b"])
def test_meshdse_equals_the_references(h100, arch_id):
    arch = ARCHS[arch_id]
    cfg = arch.make_full()
    n, act = float(cbase.param_count(arch, cfg)), float(cbase.active_param_count(arch, cfg))
    assert n == jbase.param_count(JARCHS[arch_id], JARCHS[arch_id].make_full())
    for shape in shapes.SHAPES.values():
        kw = dict(kv_bytes_per_tok=2.0 * cfg.n_layers * cfg.d_model, train=shape.kind == "train")
        for chips in (1, 8, 256):
            args = (n, act, cfg.d_model, cfg.n_layers, shape.seq_len, shape.global_batch)
            assert _records(meshdse.search(*args, chips=chips, **kw)) == \
                _records(jmeshdse.search(*args, chips=chips, **kw))
            assert meshdse.best(*args, chips=chips).record() == \
                jmeshdse.best(*args, chips=chips).record()
        for devices in (1, 2, 4, 8):
            for max_model in (None, 1, 2):
                args = (n, act, cfg.d_model, cfg.n_layers, 2048, 8, devices)
                kw = dict(kv_bytes_per_tok=1e5, max_model=max_model)
                assert _records(meshdse.serving_search(*args, **kw)) == \
                    _records(jmeshdse.serving_search(*args, **kw))
                assert meshdse.serving_best(*args, **kw).record() == \
                    jmeshdse.serving_best(*args, **kw).record()
    with pytest.raises(ValueError, match="devices must be"):
        meshdse.serving_search(n, act, 8, 2, 16, 4, devices=0)


@pytest.mark.parametrize("replicas", [None, 1, 2, 3, "auto"])
@pytest.mark.parametrize("ndev, tp", [(1, 1), (2, 1), (2, 2), (4, 2), (8, 4)])
def test_mesh_plan_equals_the_references(h100, ndev, tp, replicas):
    for args in ((2.1e6, 128, 3, 1, 8), (5.2e5, 64, 2, 128, 4), (3.2e9, 3072, 28, 512, 8)):
        got = pdeploy._mesh_plan(*args, ndev=ndev, replicas=replicas, tp=tp,
                                 kv_bytes_per_tok=1024.0)
        want = jdeploy._mesh_plan(*args, ndev=ndev, replicas=replicas, tp=tp,
                                  kv_bytes_per_tok=1024.0)
        assert got[0] == want[0] and got[1].record() == want[1].record()


def test_shapes_and_util_equal_the_references():
    assert {k: dataclasses.asdict(v) for k, v in shapes.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jshapes.SHAPES.items()}
    for a, b in ((7, 2), (8, 2), (1, 5), (0, 3), (-7, 2)):
        assert util.cdiv(a, b) == jutil.cdiv(a, b)
    for n in (0, 1, 2, 3, 5, 1000, 1 << 20, 3e6):
        assert util.round_up_pow2(int(n)) == jutil.round_up_pow2(int(n))
        assert util.human_bytes(n) == jutil.human_bytes(n)
        assert util.human_flops(n) == jutil.human_flops(n)
    x = np.random.default_rng(0).standard_normal((3, 5, 7)).astype(np.float32)
    for axis, multiple in ((0, 4), (1, 5), (2, 8), (-1, 3)):
        np.testing.assert_array_equal(
            util.pad_to_multiple(torch.from_numpy(x), multiple, axis).numpy(),
            np.asarray(jutil.pad_to_multiple(jnp.asarray(x), multiple, axis)))
    spec = cbase.model_spec(ARCHS["granite-moe-1b-a400m"],
                            ARCHS["granite-moe-1b-a400m"].make_full())
    jspec = jbase.model_spec(JARCHS["granite-moe-1b-a400m"],
                             JARCHS["granite-moe-1b-a400m"].make_full())
    from repro_torch.nn import init as nninit

    meta = nninit.shapes(spec)
    jmeta = jinit.shapes(jspec)
    assert util.tree_count(meta) == jutil.tree_count(jmeta)
    assert util.tree_bytes(meta) == jutil.tree_bytes(jmeta)


@pytest.mark.parametrize("model", [1, 2, 4])
def test_param_shards_tile_every_leaf(model):
    arch = ARCHS["stablelm-3b"]
    spec = cbase.model_spec(arch, arch.make_smoke())
    params = cbase.nninit.materialize(spec, torch.Generator().manual_seed(0))
    mesh = pmesh.make_host_mesh(1, model)
    cuts = [sr.param_shards(params, spec, r, mesh) for r in range(model)]
    specs_tree = sr.param_shardings(spec, mesh, min_shard_elems=0)
    for path, whole in _port_leaves(params).items():
        pspec = _spec_leaves(specs_tree)[path]
        parts = [_port_leaves(c)[path] for c in cuts]
        if "model" not in pspec:
            assert all(p is whole for p in parts) and not hasattr(parts[0], "tp_dim")
            continue
        dim = pspec.index("model")
        assert all(p.tp_dim == dim for p in parts)
        assert math.prod(parts[0].shape) * model == whole.numel()
        torch.testing.assert_close(torch.cat(parts, dim), whole, rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="model axis"):
        sr.shard_leaf(torch.zeros(4, 4), ("data",), 0, pmesh.make_host_mesh(2, 1))
    assert sr.spec_to_pspec(("embed", "mlp"), (64, 96), mesh, sr.TP_RULES, 0) == \
        (None, "model")
    p = P((64, 96), ("embed", "mlp"))
    assert sr.param_shardings({"w": p}, mesh)["w"] == \
        tuple(jsr.spec_to_pspec(p.axes, p.shape, _stub(1, model), jsr.TP_RULES))


def test_reads_whole_keeps_what_the_layers_read_whole():
    """The leaves a world's cut keeps whole beside it (``tp_whole``): the
    vectors, the biases over heads and the per-channel tables whose only
    named axis is ``embed`` (rwkv's token-shift mixes, its decay LoRA, a
    conv's taps), which the fallback cuts on the model width; not the
    weight matrices, MLA's up-projections (a LoRA rank, heads) among them."""
    whole = [P((64,), ("embed",)), P((2, 64), ("layers", "embed")),
             P((4, 16), ("heads", "hd")), P((2, 5, 64), ("layers", None, "embed")),
             P((5, 32, 64), (None, None, "embed")), P((64, 32), ("embed", None)),
             P((4, 64), (None, "embed"))]
    cut = [P((64, 64), ("embed", "heads_flat")), P((64, 64), ("embed", "embed2")),
           P((32, 4, 24), ("qlora", "heads", "hd")), P((16, 4, 16), ("kvlora", "heads", "hd")),
           P((64, 32), ("embed", "qlora")), P((4, 64, 32), ("experts", "embed", "mlp"))]
    assert all(sr.reads_whole(p) for p in whole)
    assert not any(sr.reads_whole(p) for p in cut)
    mesh = pmesh.make_host_mesh(1, 2)
    spec = rwkv6.rwkv_spec(ARCHS["rwkv6-7b"].make_smoke())
    params = cbase.nninit.materialize(spec, torch.Generator().manual_seed(0))
    mine = sr.param_shards(params, spec, 1, mesh)
    mu, shift_b, wr = (mine["body"]["tm"][k] for k in ("mu", "shift_b", "wr"))
    assert mu.tp_dim == 2 and mu.shape[-1] == 32
    torch.testing.assert_close(mu.tp_whole, params["body"]["tm"]["mu"], rtol=0, atol=0)
    assert shift_b.tp_dim == 3 and shift_b.tp_whole.shape[-1] == 64
    assert wr.tp_dim == 2 and not hasattr(wr, "tp_whole")
