"""The launchers and the dry-run on the CPU, against the JAX reference:
the shape specs (``configs/base.py:train_batch_specs`` /
``prefill_input_specs`` / ``decode_state_specs``), ``optimizer.
state_shapes``, the training launcher (``launch/train.py``), the dry-run
(``launch/dryrun.py``), its roofline (``launch/roofline.py``) and the
memory plan (``core/memplan.py``).

The specs are held to the reference's ``ShapeDtypeStruct``s leaf by leaf
(path, shape, dtype) for every arch at every shape the reference does not
skip, on ``meta``; nothing is drawn.  About 15 s alone.
"""

import dataclasses
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.configs import base as jbase
from repro.core import memplan as jmemplan
from repro.core import workloads as jworkloads
from repro.core.analytical import memory_plan as jmemory_plan

# the reference's dry-run module asks for 512 host devices in XLA_FLAGS when
# it is imported; put the flags back, or every later test of this process
# that starts JAX would see 512 devices
_XLA_FLAGS = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jdryrun  # noqa: E402

if _XLA_FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _XLA_FLAGS
from repro.launch import roofline as jrl  # noqa: E402
from repro.launch.mesh import HW as JHW
from repro.nn import init as jinit
from repro.train import optimizer as jopt
from repro_torch.common.tree import keystr, tree_flatten_with_path, tree_map
from repro_torch.configs import ARCHS
from repro_torch.configs import base as cbase
from repro_torch.configs.shapes import SHAPES, ShapeSpec
from repro_torch.core import memplan, workloads
from repro_torch.core.analytical import memory_plan
from repro_torch.distributed import sharding_rules as sr
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as rl
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import HW, make_production_mesh
from repro_torch.nn import init as nninit
from repro_torch.train import optimizer as opt

torch.set_num_threads(2)


def _leaves(tree) -> list:
    """(keystr, shape, dtype name) of a port tree of tensors."""
    return [(keystr(p), tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for p, t in tree_flatten_with_path(tree)]


def _jleaves(tree) -> list:
    """The same of a reference tree of ShapeDtypeStructs, in the port's
    order (dicts in insertion order)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return sorted((jax.tree_util.keystr(p), tuple(s.shape), str(s.dtype)) for p, s in flat)


def _same(got, want) -> None:
    assert sorted(_leaves(got)) == _jleaves(want)


# -- specs ------------------------------------------------------------------------


@pytest.mark.parametrize("arch_id", sorted(ARCHS))
def test_specs_match_reference(arch_id):
    arch, jarch = ARCHS[arch_id], JARCHS[arch_id]
    cfg, jcfg = arch.make_full(), jarch.make_full()
    n = 0
    for name, shape in SHAPES.items():
        jshape = JSHAPES[name]
        if jdryrun._skip_reason(jarch, jshape):
            assert dryrun._skip_reason(arch, shape)
            continue
        n += 1
        _same(cbase.train_batch_specs(arch, cfg, shape),
              jbase.train_batch_specs(jarch, jcfg, jshape))
        _same(list(cbase.prefill_input_specs(arch, cfg, shape)),
              list(jbase.prefill_input_specs(jarch, jcfg, jshape)))
        _same(list(cbase.decode_state_specs(arch, cfg, shape)),
              list(jbase.decode_state_specs(jarch, jcfg, jshape)))
    assert n >= 3
    shapes = nninit.shapes(cbase.model_spec(arch, cfg))
    jshapes = jinit.shapes(jbase.model_spec(jarch, jcfg))
    for q in (False, True):
        got = opt.state_shapes(shapes, opt.AdamWConfig(quantized_state=q))
        _same(got, jopt.state_shapes(jshapes, jopt.AdamWConfig(quantized_state=q)))
        built = opt.init_state(shapes, opt.AdamWConfig(quantized_state=q))
        assert _leaves(got) == _leaves(built)
        assert all(t.is_meta for _, t in tree_flatten_with_path(got))


# -- the training launcher --------------------------------------------------------------


def _main(ckpt_dir, *extra) -> list[dict]:
    return launch_train.main(["--arch", "llama3.2-3b", "--device", "cpu", "--steps", "20",
                              "--batch", "4", "--seq", "32", "--lr", "3e-3",
                              "--ckpt-dir", str(ckpt_dir), *extra])


def test_launcher_trains_and_resumes(tmp_path):
    """20 steps (checkpoints at 10 and 20) with the loss falling; a run
    resumed from step 10's checkpoint gives steps 11-20 of the
    uninterrupted run, bit for bit."""
    full = _main(tmp_path / "a", "--metrics-out", str(tmp_path / "m.json"))
    losses = [m["loss"] for m in full]
    assert len(full) == 20 and np.mean(losses[-5:]) < np.mean(losses[:5])
    assert json.loads((tmp_path / "m.json").read_text())[-1]["loss"] == full[-1]["loss"]
    b = tmp_path / "b"
    b.mkdir()
    shutil.copytree(tmp_path / "a" / "step_00000010", b / "step_00000010")
    (b / "LATEST").write_text("10")
    resumed = _main(b, "--resume")
    assert [m["step"] for m in resumed] == list(range(11, 21))
    assert [m["loss"] for m in resumed] == [m["loss"] for m in full[10:]]
    assert [m["grad_norm"] for m in resumed] == [m["grad_norm"] for m in full[10:]]


def test_launcher_refuses_what_the_reference_refuses(tmp_path):
    with pytest.raises(SystemExit, match="token-LM training only"):
        launch_train.main(["--arch", "internvl2-26b", "--device", "cpu",
                           "--ckpt-dir", str(tmp_path)])
    with pytest.raises(SystemExit):       # argparse: --ckpt-dir is required
        launch_train.main(["--arch", "llama3.2-3b", "--device", "cpu"])


# -- the dry-run -----------------------------------------------------------------------


@pytest.mark.parametrize("arch_id, shape", [("llama3.2-3b", "train_4k"),
                                            ("rwkv6-7b", "decode_32k"),
                                            ("seamless-m4t-large-v2", "prefill_32k"),
                                            ("recurrentgemma-9b", "prefill_32k"),
                                            ("deepseek-v3-671b", "decode_32k"),
                                            ("internvl2-26b", "train_4k"),
                                            ("seamless-m4t-large-v2", "decode_32k")])
def test_build_cell_wires_every_kind(arch_id, shape):
    fn, args, in_sh, out_sh, donate, meta, mesh, cfg, arch, sh = \
        dryrun.build_cell(arch_id, shape, multi_pod=False)
    assert meta["params"] > 0 and mesh.shape == {"data": 16, "model": 16}
    assert len(args) == len(in_sh)
    for a, s in zip(args, in_sh):
        # the same structure: a spec tuple at every tensor of the arguments
        pairs = []
        tree_map(lambda t, spec: pairs.append((t, spec)), a, s)
        assert pairs and all(isinstance(t, torch.Tensor) and t.is_meta and
                             isinstance(spec, tuple) for t, spec in pairs)


def test_run_cell_llama_train_4k(tmp_path):
    assert dryrun.main(["--arch", "llama3.2-3b", "--shape", "train_4k", "--mesh", "pod",
                        "--out", str(tmp_path)]) == 0
    r = json.loads((tmp_path / "llama3.2-3b__train_4k__pod16x16.json").read_text())
    assert r["status"] == "ok" and r["chips"] == 256
    arch = ARCHS["llama3.2-3b"]
    cfg = arch.make_full()
    spec = cbase.model_spec(arch, cfg)
    mesh = make_production_mesh()
    specs = sr.param_shardings(spec, mesh, fsdp=arch.fsdp)
    want = []
    tree_map(lambda p, s: want.append(
        int(np.prod(p.shape)) * p.dtype.itemsize
        // int(np.prod([mesh.shape[a] for a in s if a is not None]))), spec, specs)
    assert r["bytes_per_device"]["params"] == sum(want)
    # every f32 moment like its parameter, the batch over data
    assert r["bytes_per_device"]["state"] == 2 * sum(want) + 4
    assert r["bytes_per_device"]["batch"] == 2 * 256 * 4096 * 4 // 16
    model_dev = 6 * cbase.active_param_count(arch, cfg) * 256 * 4096 / 256
    assert r["model_flops_per_device"] == model_dev
    assert r["flops_per_device"] >= 0.9 * model_dev
    assert 0 < r["useful_flops_ratio"] <= 1 / 0.9
    assert r["collective_counts"]["all-reduce"] > 0
    # the gradient of every parameter, copied on all 16 data shards, is
    # all-reduced over data, beside the forward's tensor-parallel reduces
    assert r["grad_sync_bytes_per_device"] == {"all-reduce": sum(want),
                                               "reduce-scatter": 0.0}
    assert r["collective_bytes_per_device"]["all-reduce"] > sum(want)
    assert "gradient" in r["collective_note"]
    assert r["roofline"]["bound_s"] == max(r["roofline"][k] for k in
                                           ("compute_s", "memory_s", "collective_s"))
    table = rl.summarize(tmp_path)
    assert "| llama3.2-3b | train_4k |" in table


def test_run_cell_without_a_tensor_parallel_path(tmp_path):
    """rwkv6-7b's decode cell traces the rank's cut and records its
    collectives (each layer's row-parallel reduces, the vocab-cut
    embedding's); a config tensor parallelism refuses (ROADMAP Queue 1
    #9's remainder: granite with 24 experts on the model axis of 16) is
    traced whole, with bytes and FLOPs and no collectives, with the
    reason."""
    r = dryrun.run_cell("rwkv6-7b", "decode_32k", False, out_dir=tmp_path, verbose=False)
    assert r["status"] == "ok", r.get("error")
    cfg = ARCHS["rwkv6-7b"].make_full()
    assert r["collective_counts"]["all-reduce"] == 3 * cfg.n_layers + 1
    assert r["collective_counts"]["all-gather"] == 1
    assert r["collective_bytes_per_device"]["all-reduce"] > 0
    assert "tensor-parallel collectives" in r["collective_note"]
    assert r["flops_per_device"] > 0 and r["bytes_per_device"]["caches"] > 0
    arch = ARCHS["granite-moe-1b-a400m"]
    full = arch.make_full()
    refused = dataclasses.replace(full, moe=dataclasses.replace(full.moe, n_experts=24))
    m = dryrun.measure_cell(arch.id, SHAPES["decode_32k"], make_production_mesh(), cfg=refused)
    assert m["collective_bytes_per_device"] is None and m["collective_counts"] is None
    assert "#9" in m["collective_note"] and m["flops_per_device"] > 0
    skip = dryrun.run_cell("llama3.2-3b", "long_500k", False, out_dir=tmp_path, verbose=False)
    assert skip["status"] == "skip"


def test_train_cell_counts_the_backward_collectives():
    """llama3.2-3b's training cell records its backward's tensor-parallel
    collectives (the column-parallel inputs' gradient sums, the gathers of
    narrowed tensors' gradients) and the optimizer's global norm beside
    the forward's: more tensor-parallel all-reduces than the same arch's
    prefill cell, and its note names the backward."""
    mesh = make_production_mesh()
    train = dryrun.measure_cell("llama3.2-3b", SHAPES["train_4k"], mesh)
    prefill = dryrun.measure_cell("llama3.2-3b", ShapeSpec("prefill_4k", "prefill", 4096, 32),
                                  mesh)

    def tp_all_reduces(m):
        return sum(v["count"] for ops in m["collective_phases"].values()
                   for op, v in ops.items() if rl.PORT_KINDS[op] == "all-reduce")

    phases = train["collective_phases"]
    assert phases["backward"]["copy_in"]["count"] > 0
    assert phases["backward"]["take_local"]["count"] > 0
    assert phases["optimizer"]["global_norm"]["count"] == 1
    assert phases["forward"]["reduce_partial"]["count"] == \
        prefill["collective_phases"]["forward"]["reduce_partial"]["count"]
    assert tp_all_reduces(train) > tp_all_reduces(prefill) > 0
    assert "backward" in train["collective_note"]
    assert "backward" not in prefill["collective_note"]


# -- roofline and memplan ----------------------------------------------------------------


@pytest.mark.parametrize("arch_id", ["rwkv6-7b", "recurrentgemma-9b", "deepseek-v3-671b",
                                     "internvl2-26b", "seamless-m4t-large-v2"])
def test_every_kind_traces_its_cut_with_collectives(arch_id):
    """Each kind's prefill traces one rank's cut under the dry context at
    the production mesh's model axis of 16, at a cut sequence: collectives
    recorded, FLOPs counted over the rank's cut (no even split)."""
    shape = ShapeSpec("prefill_256", "prefill", 256, 16)
    m = dryrun.measure_cell(arch_id, shape, make_production_mesh())
    assert m["collective_counts"]["all-reduce"] > 0
    assert m["collective_bytes_per_device"]["all-reduce"] > 0
    assert m["flops_note"].startswith("FlopCounterMode over one rank")
    assert m["flops_per_device"] > 0


@pytest.mark.parametrize("args", [(197e12, 0, 0, 1), (0, 819e9, 0, 1), (0, 0, 200e9 * 4, 4),
                                  (3.1e15, 2.4e9, 5.8e10 * 256, 256)])
def test_roofline_terms_equal_reference(args):
    assert rl.roofline_terms(*args, hw=JHW) == jrl.roofline_terms(*args)
    t = rl.roofline_terms(*args)
    assert t["compute_s"] == args[0] / HW["peak_flops_bf16"]
    assert t["memory_s"] == args[1] / HW["hbm_bw"]


def test_collective_record_maps_to_reference_kinds():
    stats = {"reduce_partial": (3, 0.0), "gather_last": (1, 0.0), "ppermute": (2, 0.0),
             "all_gather": (2, 0.0), "psum": (1, 0.0)}
    nbytes = {"reduce_partial": 300, "gather_last": 50, "ppermute": 20, "all_gather": 8,
              "psum": 4}
    b, c = rl.collectives_of(stats, nbytes)
    assert set(b) == set(c) == set(jrl._COLLECTIVES)
    assert b["all-reduce"] == 304 and c["all-reduce"] == 4
    assert b["all-gather"] == 58 and c["all-gather"] == 3
    assert b["collective-permute"] == 20 and c["reduce-scatter"] == 0


@pytest.mark.parametrize("vmem", [None, int(JHW["vmem_bytes"])])
def test_plan_tiles_equal_reference(vmem):
    g, jg = workloads.nvsa_graph(), jworkloads.nvsa_graph()
    mem, jmem = memory_plan(g, t_parallel=10**6), jmemory_plan(jg, t_parallel=10**6)
    assert (mem.mem_a1, mem.mem_a2, mem.mem_b, mem.mem_c) == \
        (jmem.mem_a1, jmem.mem_a2, jmem.mem_b, jmem.mem_c)
    v = vmem or int(HW["vmem_bytes"])
    for concurrent in (True, False):
        got = memplan.plan_tiles(mem, d=256, vmem=vmem, concurrent=concurrent)
        want = jmemplan.plan_tiles(jmem, d=256, vmem=v, concurrent=concurrent)
        assert got.__dict__ == want.__dict__
    tiles = memplan.plan_tiles(mem, d=256)
    assert tiles.vmem_budget == 227 * 2 ** 10 and tiles.qmm_bm % 128 == 0
