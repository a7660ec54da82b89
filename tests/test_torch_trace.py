"""The torch trace twin (``repro_torch.core.trace``) against the jaxpr walk.

Each stage of each served variant runs through ``repro.core.trace.extract``
(the reference's jaxpr, its kernels under the default CPU plan, i.e.
Pallas interpret mode at and above the dispatch floor) and through the
port's ``meta`` run under ``core.trace`` (``serve.schedule.meta_run``),
at d = 128 and 256.  What the DSE reads must be equal:

- the nn nodes ``(m, n, k, flops)`` and the vsa nodes ``(nvec, d,
  flops)``, in order (Phase II of ``core.dse`` walks them in order, so
  equal sequences, which imply equal multisets);
- the per-stage nn and vsa flops of ``_graph_stats`` (the schedule's
  ``stage_costs``);
- the per-node bytes ``memory_plan`` reads: the largest nn ``param_bytes``
  (MemA1), vsa ``in_bytes`` (MemA2), nn ``in_bytes - param_bytes``
  (MemB) and nn / vsa / simd ``out_bytes`` (MemC);
- ``explore`` on the composed pipeline.

The simd and mem nodes are aten's ops, not XLA's, so they are held to a
tolerance rather than equality:

- **simd elements within 10%, per stage and for the pipeline.**  The trace
  rebuilds jax's decomposition of the fused aten ops it meets
  (``linalg_vector_norm``, ``mean``, ``softmax``, ``log_softmax``,
  ``clamp``, ``gelu``, ``remainder``, and jnp's index wrapping before a
  gather); the CNN and VSA stages then agree within 0.03%.  What remains
  is in PrAE's PMF-table arithmetic (``torch.roll`` against jnp's, the
  port's stage counts 5.2-6.8% more elements).  10% is below the margin at which
  ``memory_plan``'s SIMD lane count would change on the four deploys
  (the total would have to move by about 15%: PrAE at 4096 PEs, MIMONet
  at 16384), so the DSE's SIMD sizing is the same.
- **mem bytes of the whole pipeline within a factor of 2.5.**  Data
  movement is expressed differently by the two compilers: the reference
  pads each kernel operand to its Pallas tile and slices the result back
  outside the ``pallas_call``; jnp broadcasts (``broadcast_in_dim``) where
  aten expands a view; aten's einsum permutes and views its operands
  into a batched matmul, where XLA's dot_general takes them as they are
  (PrAE's symbolic stage, 2.0x).  The observed range is 0.44 to 1.87.  No
  quantity of the DSE reads a mem node.
"""

import collections
import dataclasses

import jax
import pytest
import torch

from repro.configs import base as jcb
from repro.core import dse as r_dse
from repro.core import dataflow as r_dfl
from repro.core import trace as r_trace
from repro.serve import schedule as r_sch
from repro_torch.backend import registry
from repro_torch.configs import base as cb
from repro_torch.core import dataflow as p_dfl
from repro_torch.core import dse as p_dse
from repro_torch.core import trace as p_trace
from repro_torch.kernels.circ_conv import ops as circ_ops
from repro_torch.serve import schedule as p_sch
from repro_torch.vsa import ops as vsa

torch.set_num_threads(2)

# (model, variant, nn_precision, batch): every served variant, the
# fp32 and int8 NVSA frontends, at d = 128 and 256
VARIANTS = [("nvsa", "cnn", "fp32", 8), ("nvsa", "cnn", "int8", 4),
            ("nvsa", "oracle", "fp32", 8), ("mimonet", "default", None, 4),
            ("lvrf", "cnn", None, 4), ("lvrf", "oracle", None, 8),
            ("prae", "cnn", None, 4), ("prae", "oracle", None, 8)]
CASES = [v + (d,) for v in VARIANTS for d in (128, 256)]
SIMD_RTOL = 0.10
MEM_FACTOR = 2.5


def _ids(case):
    model, variant, prec, batch, d = case
    return f"{model}-{variant}-{prec or 'fp32'}-b{batch}-d{d}"


def _cfg_kw(model, prec, d):
    kw = {"d": d}
    if prec is not None:
        kw["nn_precision"] = prec
    return kw


def _ref_stage_graphs(model, variant, prec, batch, d):
    entry = jcb.REASON_WORKLOADS[model]
    cfg = entry.make_config(**_cfg_kw(model, prec, d))
    consts = jax.eval_shape(lambda k: entry.make_consts(cfg, k),
                            jax.random.PRNGKey(0))
    spec = entry.input_specs(cfg, batch, variant)
    graphs = []
    for stage in entry.stage_specs(cfg, variant):
        graphs.append(r_trace.extract(stage.fn, consts, spec))
        spec = jax.eval_shape(stage.fn, consts, spec)
    return graphs


@pytest.fixture(scope="module", params=CASES, ids=_ids)
def traced(request):
    """The reference's per-stage graphs (traced once per case) and the
    port's compiled schedule with its traced per-stage graphs."""
    model, variant, prec, batch, d = request.param
    ref = _ref_stage_graphs(model, variant, prec, batch, d)
    entry = cb.REASON_WORKLOADS[model]
    cfg = entry.make_config(**_cfg_kw(model, prec, d))
    sched = cb.compile_reason_schedule(model, cfg, variant=variant,
                                       batch_size=batch, device="cpu")
    run = p_sch.meta_run(sched.stages, sched.consts_spec, sched.input_specs,
                         trace=True)
    return request.param, ref, sched, run


def _nn(g):
    return [(n.dims.get("m"), n.dims.get("n"), n.dims.get("k"), n.flops)
            for n in g if n.kind == "nn"]


def _vsa(g):
    return [(n.dims["nvec"], n.dims["d"], n.flops) for n in g if n.kind == "vsa"]


def _mem_plan_bytes(g):
    nn = [n for n in g if n.kind == "nn"]
    return (max((n.param_bytes for n in nn), default=0),
            max((n.in_bytes for n in g if n.kind == "vsa"), default=0),
            max((n.in_bytes - n.param_bytes for n in nn), default=0),
            max((n.out_bytes for n in g if n.kind in ("nn", "vsa", "simd")),
                default=0))


def _simd_elems(graphs):
    return sum(n.dims.get("elems", 1) for g in graphs for n in g
               if n.kind == "simd")


def _mem_bytes(graphs):
    return sum(n.out_bytes for g in graphs for n in g if n.kind == "mem")


def test_nn_and_vsa_nodes_equal_per_stage(traced):
    case, ref, sched, run = traced
    assert len(run.stage_graphs) == len(ref) == len(sched.stages)
    for i, (want, got) in enumerate(zip(ref, run.stage_graphs)):
        stage = sched.stages[i].name
        assert _nn(got) == _nn(want), (case, stage)
        assert _vsa(got) == _vsa(want), (case, stage)
        assert _mem_plan_bytes(got) == _mem_plan_bytes(want), (case, stage)


def test_stage_costs_equal_in_nn_and_vsa(traced):
    """``stage_costs`` (the stream-tag audit) carries the reference's
    ``_graph_stats`` nn and vsa flops for every stage."""
    case, ref, sched, run = traced
    assert sched.source == "declared" and not sched.stage_costs
    p_sch.ensure_graph(sched)
    assert sched.source == "trace" and len(sched.stage_costs) == len(ref)
    for got, g in zip(sched.stage_costs, ref):
        want = r_sch._graph_stats(g)
        for kind in ("nn", "vsa"):
            assert got["flops"][kind] == want["flops"][kind], (case, kind)
        assert got["has_vsa_nodes"] == want["has_vsa_nodes"], case
    # the composed graph is the stages' nodes, in stage order
    assert [n.name for g in run.stage_graphs for n in g] == run.graph.order


def test_simd_and_mem_totals_within_tolerance(traced):
    """simd elements within 10% per stage and for the pipeline, mem bytes
    of the pipeline within a factor of 2.5 (see the module docstring)."""
    case, ref, sched, run = traced
    for want, got in zip(ref, run.stage_graphs):
        w, g = _simd_elems([want]), _simd_elems([got])
        assert abs(g - w) <= SIMD_RTOL * w, (case, g, w)
    w, g = _simd_elems(ref), _simd_elems(run.stage_graphs)
    assert abs(g - w) <= SIMD_RTOL * w, (case, g, w)
    w, g = _mem_bytes(ref), _mem_bytes(run.stage_graphs)
    assert w / MEM_FACTOR <= g <= w * MEM_FACTOR, (case, g, w)


def test_explore_equal_on_the_composed_graph(traced):
    """Algorithm 1 and the memory / SIMD sizing over the composed pipeline.
    A qmatmul node carries only ``out_shape`` and ``flops`` in both
    packages (the reference's quirk, kept), so Eq. 1 cannot cost the int8
    heads: both raise the same KeyError."""
    (model, variant, prec, batch, d), ref, sched, run = traced
    want_g = r_dfl.build(_compose(ref))
    got_g = p_dfl.build(run.graph)
    if prec == "int8":
        for mod, g in ((r_dse, want_g), (p_dse, got_g)):
            with pytest.raises(KeyError, match="'m'"):
                mod.explore(g, max_pes=4096)
        return
    want = r_dse.explore(want_g, max_pes=4096)
    got = p_dse.explore(got_g, max_pes=4096)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def _compose(graphs):
    """The reference's per-stage graphs as one graph (node names made
    unique per stage; only kinds, dims and bytes matter to the DSE)."""
    from repro.core.opgraph import OpGraph

    out = OpGraph()
    for i, g in enumerate(graphs):
        for n in g:
            out.add(dataclasses.replace(
                n, name=f"s{i}.{n.name}", deps=[f"s{i}.{x}" for x in n.deps]))
    return out


# -- the kernel-call region ------------------------------------------------------


def _meta(*shape):
    return torch.empty(shape, device="meta")


def test_kernel_call_is_one_node_and_gather_stays_plain():
    """A bind at the floor is one ``circ_conv_kernel`` node whose dims are
    the reference's padded Pallas operands; below the floor the exact
    gather route stays plain ops (a batched matmul, as XLA's einsum)."""
    a, b = _meta(8, 4, 256), _meta(8, 4, 256)
    g = p_trace.extract(vsa.bind, a, b)
    kernels = [n for n in g if n.label == "circ_conv_kernel"]
    assert len(kernels) == 1 and kernels[0].kind == "vsa"
    # the reference's circ_elem tiles 12 rows at d = 256: 8 rows pad to 12
    assert kernels[0].dims["nvec"] == 12 * 4 and kernels[0].dims["d"] == 256
    assert kernels[0].in_bytes == 2 * 12 * 4 * 256 * 4
    small = p_trace.extract(vsa.bind, _meta(8, 4, 64), _meta(8, 4, 64))
    assert not [n for n in small if n.kind == "vsa"]
    assert [(n.dims["m"], n.dims["n"], n.dims["k"]) for n in small
            if n.kind == "nn"] == [(32, 64, 64)]
    assert registry.TRACE is None and p_trace.Tracer not in map(
        type, registry._RECORDERS)


def test_nested_kernel_calls_fold_into_the_outer_one():
    """A kernel wrapper whose plain version calls another wrapper is still
    one node (the inner call folds into it)."""

    @registry.kernel_call("circ_conv")
    def outer(x, y):
        return circ_ops.circ_elem(x, y) + 1

    g = p_trace.extract(outer, _meta(4, 2, 128), _meta(4, 2, 128))
    assert [n.label for n in g] == ["circ_conv_kernel"]


def test_unreported_kernel_call_raises():
    def broken(x):
        registry.note_call("circ_conv")
        return x * 2

    with pytest.raises(RuntimeError, match="never reported"):
        p_trace.extract(broken, _meta(4))
    assert registry.TRACE is None


def test_kernel_calls_counted_per_stage():
    """NVSA's symbolic stage at d = 256 makes 42 circ_conv calls per group
    (the count ``chip_smoke.py`` checks on the card); the trace holds 42
    vsa nodes and no op of their plain versions."""
    entry = cb.REASON_WORKLOADS["nvsa"]
    cfg = entry.make_config(d=256)
    sched = cb.compile_reason_schedule("nvsa", cfg, variant="oracle",
                                       batch_size=8, device="cpu")
    labels = collections.Counter(n.label for n in p_sch.ensure_graph(sched).graph)
    assert labels["circ_conv_kernel"] == 42
    assert "index" not in labels   # the gather of circ_elem_ref
    assert sched.describe().startswith("oracle[simd] --")
    assert "graph (trace)" in sched.describe()
    ovl = p_sch.predicted_overlap(sched, n_batches=4)
    want = r_sch.predicted_overlap(jcb.compile_reason_schedule(
        "nvsa", jcb.REASON_WORKLOADS["nvsa"].make_config(d=256),
        variant="oracle", batch_size=8), n_batches=4)
    assert ovl == pytest.approx(want, rel=1e-3)
