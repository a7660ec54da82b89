"""Multi-pod dry-run: build and trace every (arch x shape x mesh) cell on
``meta``.

The port of ``repro.launch.dryrun``.  It shows the distribution config is
coherent without hardware: each cell is the step of its shape (the
training step with AdamW, the prefill or the decode step) over the
production mesh (``launch/mesh.py:make_production_mesh``, (16, 16) or (2,
16, 16)), with every argument's spec from the sharding rules, and its
record goes to ``results/dryrun_torch/`` for the roofline
(``launch/roofline.py``):

- **bytes per device**, exact, from the specs: each leaf's bytes over the
  sizes of the mesh axes its spec names (``sharding_rules.param_shardings``
  for the parameters, the moments after them, the batch over the data
  axes, the caches by ``tree_cache_shardings``);
- **FLOPs per device** from ``torch.utils.flop_counter.FlopCounterMode``
  over one rank's step traced on ``meta``: the data shard of the batch
  and the rank's cut of the parameters (``sharding_rules.param_shards``)
  under a dry ``TPContext`` (``group=None``, ``size`` = the model axis),
  for every kind.  The counter sees every layer, so the reference's
  reps-1 / reps-2 calibration (XLA CPU's cost analysis counts a scan body
  once) has no counterpart.  Only a config tensor parallelism refuses
  (``world.refuse_uncovered``: experts that do not divide the model axis,
  ROADMAP Queue 1 #9's remainder; no registry arch at the production
  mesh's 16) is traced whole on its data shard, its FLOPs split evenly
  over the model axis;
- **collectives** from the dry context's record (``roofline.
  collectives_of``): a prefill's or decode step's forward collectives; a
  training step's forward, its backward's (each combine's transpose:
  ``copy_in``'s sums of column-parallel inputs' gradients, the gathers of
  narrowed tensors' gradients, and remat's replay of the forward's), the
  optimizer's global norm and its refresh of the wholes kept beside a cut,
  and the data-parallel gradient reduction, worked out from the parameter
  specs (``grad_sync``).  ``collective_phases`` splits the tensor-parallel
  record by phase (``constraints.TPContext.phases``).  Null, with the
  reason, for a refused config.

There is no ``memory_analysis``: the record holds the argument and output
bytes per device, and a step's peak is measured on the card only.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape train_4k
  python -m repro_torch.launch.dryrun --arch all --shape all [--mesh pod]
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import time
import traceback

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.configs import base as cbase
from repro_torch.configs.shapes import SHAPES, ShapeSpec
from repro_torch.distributed import constraints as tpc
from repro_torch.distributed import sharding_rules as rules
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.nn import init as nninit
from repro_torch.train import optimizer as opt

RESULTS_DIR = pathlib.Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"


def _archs():
    from repro_torch.configs.registry import ARCHS

    return ARCHS


def _skip_reason(arch, shape) -> str | None:
    if shape.name == "long_500k" and not arch.supports_long:
        return ("skipped: pure full-attention arch at 524k context "
                "(sub-quadratic required; see DESIGN.md §4)")
    return None


def _lead(axes: tuple):
    """A spec entry for ``axes`` as ``PartitionSpec`` canonicalises it."""
    return axes if len(axes) > 1 else axes[0]


def _opt_state_shardings(state_shapes, param_specs, mesh: Mesh):
    """Moments inherit the parameter's spec; quantised blocks shard their
    leading (blocks) dim over as many of data, model, pod as divide it."""
    def for_param(mu, ps):
        if "m" in mu:
            return {"m": ps, "v": ps}
        nb = mu["m_q"].shape[0]
        best, size = (), 1
        for a in ("data", "model", "pod"):
            if a in mesh.shape and nb % (size * mesh.shape[a]) == 0:
                best, size = best + (a,), size * mesh.shape[a]
        spec = (_lead(best),) if best else ()
        return {"m_q": spec, "m_s": spec, "v_q": spec, "v_s": spec}

    mu = _over(state_shapes["mu"], param_specs, for_param)
    return {"mu": mu, "step": ()}


def _over(tree, specs, fn):
    """``fn(node, spec)`` at each place of ``specs`` (a tree of spec tuples)
    that ``tree`` (the same nesting, a moment dict where ``specs`` holds a
    tuple) has a node for."""
    if isinstance(specs, dict):
        return {k: _over(tree[k], v, fn) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_over(t, s, fn) for t, s in zip(tree, specs)]
    return fn(tree, specs)


def _batch_shardings(batch_specs, mesh: Mesh):
    """The batch dim over the data axes where it divides (batch-1 cells
    replicate it)."""
    daxes = rules.data_axes(mesh)
    dsize = math.prod(mesh.shape[a] for a in daxes)
    return tree_map(lambda s: (_lead(daxes),) if s.shape and s.shape[0] % dsize == 0
                    else (), batch_specs)


def _divisor(spec: tuple, mesh: Mesh) -> int:
    return math.prod(rules._axis_size(mesh, a) for a in spec if a is not None)


def bytes_per_device(tree, specs, mesh: Mesh) -> int:
    """The bytes one device holds of ``tree`` (tensors) under ``specs``
    (spec tuples at its leaves): each leaf's bytes over the sizes of the
    axes its spec names."""
    total = []
    tree_map(lambda t, s: total.append(t.numel() * t.element_size() // _divisor(s, mesh)),
             tree, specs)
    return sum(total)


def grad_sync(param_shapes, specs, mesh: Mesh) -> tuple[dict, dict]:
    """The data-parallel gradient reduction of one training step, from the
    parameter specs: ({kind: bytes per device}, {kind: count}).  Each
    leaf's gradient, as one device holds it, is all-reduced over the data
    axes the leaf is copied on; a leaf whose spec cuts it over data (FSDP)
    has its gradient, gathered over those axes, reduce-scattered."""
    daxes = set(rules.data_axes(mesh))
    out = {"all-reduce": 0.0, "reduce-scatter": 0.0}
    counts = {"all-reduce": 0, "reduce-scatter": 0}

    def one(t, spec):
        named = {a for e in spec if e is not None
                 for a in (e if isinstance(e, tuple) else (e,))}
        nbytes = t.numel() * t.element_size() // _divisor(spec, mesh)
        cut = named & daxes
        if cut:
            kind, nbytes = "reduce-scatter", nbytes * math.prod(mesh.shape[a] for a in cut)
        elif math.prod(mesh.shape[a] for a in daxes) > 1:
            kind = "all-reduce"
        else:
            return
        out[kind] += float(nbytes)
        counts[kind] += 1

    tree_map(one, param_shapes, specs)
    return out, counts


def build_cell(arch_id: str, shape_name: str, multi_pod: bool, cfg=None,
               mesh: Mesh | None = None, shape: ShapeSpec | None = None):
    """Returns (fn, example_args (``meta``), in_specs, out_specs, donate,
    meta, mesh, cfg, arch, shape), as the reference's ``build_cell``; the
    specs are plain tuples.  ``mesh`` and ``shape`` override the production
    mesh and ``SHAPES[shape_name]`` (a cell at another size)."""
    arch = _archs()[arch_id]
    shape = shape or SHAPES[shape_name]
    cfg = cfg or arch.make_full()
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    spec = cbase.model_spec(arch, cfg)
    param_shapes = nninit.shapes(spec)
    param_shard = rules.param_shardings(spec, mesh, fsdp=arch.fsdp)
    meta = {"params": nninit.param_count(spec),
            "active_params": cbase.active_param_count(arch, cfg),
            "param_bytes": nninit.param_bytes(spec)}
    if shape.kind == "train":
        ocfg = opt.AdamWConfig(quantized_state=arch.opt_8bit)
        state_shapes = opt.state_shapes(param_shapes, ocfg)
        state_shard = _opt_state_shardings(state_shapes, param_shard, mesh)
        batch_specs = cbase.train_batch_specs(arch, cfg, shape)
        batch_shard = _batch_shardings(batch_specs, mesh)
        loss = cbase.loss_fn(arch, cfg)

        def train_step(params, state, batch):
            lv, grads = opt.value_and_grad(loss)(params, batch)
            params, state, metrics = opt.apply_updates(params, grads, state, ocfg)
            return params, state, {"loss": lv, **metrics}

        fn = train_step
        args = (param_shapes, state_shapes, batch_specs)
        in_sh = (param_shard, state_shard, batch_shard)
        out_sh = (param_shard, state_shard, {"loss": (), "grad_norm": (), "lr": ()})
        donate = (0, 1)
    elif shape.kind == "prefill":
        fn = cbase.prefill_fn(arch, cfg)
        inp = cbase.prefill_input_specs(arch, cfg, shape)
        in_sh = (param_shard, *(_batch_shardings(i, mesh) for i in inp))
        args = (param_shapes, *inp)
        out_sh = None
        donate = ()
    else:  # decode
        caches, token, pos = cbase.decode_state_specs(arch, cfg, shape)
        cache_shard = rules.tree_cache_shardings(caches, mesh)
        fn = cbase.decode_fn(arch, cfg)
        args = (param_shapes, caches, token, pos)
        in_sh = (param_shard, cache_shard, _batch_shardings(token, mesh), ())
        out_sh = (cache_shard, None)
        donate = (1,)
    return fn, args, in_sh, out_sh, donate, meta, mesh, cfg, arch, shape


def _loop_trips(arch, cfg) -> int:
    if arch.kind in ("lm", "vlm"):
        from repro_torch.models.lm import stage_plan

        return stage_plan(cfg.lm if arch.kind == "vlm" else cfg).repeats
    if arch.kind == "rwkv":
        return cfg.n_layers
    if arch.kind == "griffin":
        return cfg.plan()[1]
    if arch.kind == "encdec":
        return cfg.n_dec_layers
    return 1


def _local_shape(shape: ShapeSpec, mesh: Mesh) -> ShapeSpec:
    """``shape`` with its batch cut to one data shard (whole where it does
    not divide, as ``_batch_shardings`` replicates it)."""
    dsize = math.prod(mesh.shape[a] for a in rules.data_axes(mesh))
    b = shape.global_batch
    return ShapeSpec(shape.name, shape.kind, shape.seq_len, b // dsize if b % dsize == 0 else b)


def _tp_refusal(arch, cfg, model: int) -> str | None:
    """Why the config has no tensor-parallel path at this model size."""
    from repro_torch.distributed import world

    try:
        world.refuse_uncovered(arch, cfg, model)
    except NotImplementedError as e:
        return str(e)
    return None


def _rank_args(arch, cfg, shape: ShapeSpec, params):
    """One rank's arguments after the parameters, on ``meta``, at the
    local ``shape`` (built inside the rank's context, so caches hold the
    rank's kv heads)."""
    if shape.kind == "train":
        ocfg = opt.AdamWConfig(quantized_state=arch.opt_8bit)
        return (opt.state_shapes(params, ocfg), cbase.train_batch_specs(arch, cfg, shape))
    if shape.kind == "prefill":
        return cbase.prefill_input_specs(arch, cfg, shape)
    return cbase.decode_state_specs(arch, cfg, shape)


def trace_step(fn, arch, cfg, shape: ShapeSpec, mesh: Mesh):
    """One rank's step on ``meta`` under ``FlopCounterMode``: (FLOPs per
    device, the step's collective record (stats, nbytes, phases) or None,
    the reason for None, output bytes per device)."""
    spec = cbase.model_spec(arch, cfg)
    local = _local_shape(shape, mesh)
    model = mesh.shape.get("model", 1)
    reason = _tp_refusal(arch, cfg, model)
    whole = nninit.shapes(spec)
    ctx = tpc.TPContext(None, 0, model) if reason is None else None
    counter = FlopCounterMode(display=False)
    if ctx is not None:
        with tpc.tp_group(ctx):
            params = rules.param_shards(whole, spec, 0, ctx.mesh)
            args = _rank_args(arch, cfg, local, params)
            with counter:
                out = fn(params, *args)
        flops = counter.get_total_flops()
    else:
        params = whole
        args = _rank_args(arch, cfg, local, params)
        with counter:
            out = fn(params, *args)
        flops = counter.get_total_flops() / model
    out_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(out)
                    if isinstance(t, torch.Tensor))
    record = None if ctx is None else (dict(ctx.stats), dict(ctx.nbytes), dict(ctx.phases))
    return float(flops), record, reason, out_bytes


def measure_cell(arch_id: str, shape: ShapeSpec, mesh: Mesh, cfg=None) -> dict:
    """The measurements of one cell (``run_cell`` writes them down): bytes
    per device of each argument class, FLOPs and collectives of one rank's
    traced step, the roofline terms."""
    t0 = time.time()
    fn, args, in_sh, _, _, meta, mesh, cfg, arch, shape = build_cell(
        arch_id, shape.name, False, cfg=cfg, mesh=mesh, shape=shape)
    chips = mesh.size
    names = {"train": ("params", "state", "batch"), "prefill": ("params", "inputs"),
             "decode": ("params", "caches", "token", "pos")}[shape.kind]
    arg_bytes = {n: bytes_per_device(a, s, mesh) for n, a, s in zip(names, args, in_sh)}
    arguments = sum(arg_bytes.values())
    flops_dev, coll, reason, out_bytes = trace_step(fn, arch, cfg, shape, mesh)
    grad_bytes = phases = None
    if coll is None:
        coll_bytes = coll_counts = None
        total_coll = 0.0
    else:
        coll_bytes, coll_counts = rl.collectives_of(*coll[:2])
        phases = {ph: {op: {"count": n, "bytes": b} for op, (n, _, b) in ops.items()}
                  for ph, ops in coll[2].items()}
        if shape.kind == "train":
            grad_bytes, grad_counts = grad_sync(args[0], in_sh[0], mesh)
            for kind in grad_bytes:
                coll_bytes[kind] += grad_bytes[kind]
                coll_counts[kind] += grad_counts[kind]
        total_coll = sum(coll_bytes.values())
    # every argument read once and every output written once per step
    bytes_dev = float(arguments + out_bytes)
    terms = rl.roofline_terms(flops_dev, bytes_dev, total_coll * chips, chips)
    tokens = shape.global_batch * (shape.seq_len if shape.kind in ("train", "prefill") else 1)
    mult = 6 if shape.kind == "train" else 2
    model_flops = mult * meta["active_params"] * tokens
    return {
        "chips": chips,
        "trace_s": round(time.time() - t0, 1),
        "meta": meta,
        "bytes_per_device": {**arg_bytes, "arguments": arguments, "outputs": out_bytes},
        "peak_bytes": "measured on the card only (no memory_analysis)",
        "flops_per_device": flops_dev,
        "flops_note": ("FlopCounterMode over one rank's step on meta" if reason is None
                       else "the data shard's step over the model axis, split evenly"),
        "collective_bytes_per_device": coll_bytes,
        "collective_counts": coll_counts,
        "grad_sync_bytes_per_device": grad_bytes,
        "collective_phases": phases,
        "collective_note": (reason if reason is not None else
                            "the forward's tensor-parallel collectives" +
                            (", the backward's (each combine's transpose and remat's "
                             "replay of the forward's), the optimizer's global norm and "
                             "refresh of the kept wholes, and the data-parallel gradient "
                             "reduction (grad_sync)" if shape.kind == "train" else "")),
        "loop_trips": _loop_trips(arch, cfg),
        "roofline": terms,
        "model_flops_total": model_flops,
        "model_flops_per_device": model_flops / chips,
        "useful_flops_ratio": (model_flops / chips) / max(1.0, flops_dev),
    }


def run_cell(arch_id: str, shape_name: str, multi_pod: bool,
             out_dir: pathlib.Path = RESULTS_DIR, verbose: bool = True) -> dict:
    """Measure one cell at the arch's full config on the production mesh
    and write its record to ``out_dir``."""
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    cell = f"{arch_id}__{shape_name}__{mesh_name}"
    out_path = pathlib.Path(out_dir) / f"{cell}.json"
    arch, shape = _archs()[arch_id], SHAPES[shape_name]
    reason = _skip_reason(arch, shape)
    record: dict = {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
                    "status": "skip", "skip_reason": reason}
    if not reason:
        try:
            record.update(status="ok", **measure_cell(
                arch_id, shape, make_production_mesh(multi_pod=multi_pod)))
            if verbose:
                t = record["roofline"]
                print(f"[dryrun] {cell}: OK trace {record['trace_s']:.0f}s | flops/dev "
                      f"{record['flops_per_device']:.3e} bytes/dev "
                      f"{record['bytes_per_device']['arguments']:.3e} | "
                      f"dominant={t['dominant']} bound={t['bound_s'] * 1e3:.2f}ms")
        except Exception as e:  # noqa: BLE001 -- record and continue the sweep
            record.update({"status": "error", "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-4000:]})
            if verbose:
                print(f"[dryrun] {cell}: ERROR {type(e).__name__}: {e}")
    elif verbose:
        print(f"[dryrun] {cell}: SKIP ({reason})")
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(record, indent=1))
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"], default="both")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    args = ap.parse_args(argv)
    out_dir = pathlib.Path(args.out)
    archs = sorted(_archs()) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"pod": [False], "multipod": [True], "both": [False, True]}[args.mesh]
    n_ok = n_err = 0
    for a in archs:
        for s in shapes:
            for mp in meshes:
                rec = run_cell(a, s, mp, out_dir)
                n_ok += rec["status"] in ("ok", "skip")
                n_err += rec["status"] == "error"
    print(f"[dryrun] done: {n_ok} ok/skip, {n_err} errors")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
