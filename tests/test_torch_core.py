"""The port's DSE core (``repro_torch.core``) against ``repro.core``.

The core is pure Python in both packages; the port keeps its own copy
(it imports nothing of ``repro``).  On the paper-scale graphs of
``core.workloads`` and the matmul-heavy graph, every result must be
equal: the graphs themselves, ``dataflow.build``, ``explore`` (Algorithm
1 and the memory / SIMD sizing), ``serving_plan``, ``memory_plan``,
``interloop_overlap`` and ``search_space``.
"""

import dataclasses

import pytest
from _hypothesis_compat import given, settings, st

from repro.configs import base as jcb
from repro.core import analytical as r_ana
from repro.core import dataflow as r_dfl
from repro.core import dse as r_dse
from repro.core import opgraph as r_og
from repro.core import workloads as r_wl
from repro_torch.configs import base as cb
from repro_torch.core import analytical as p_ana
from repro_torch.core import dataflow as p_dfl
from repro_torch.core import dse as p_dse
from repro_torch.core import opgraph as p_og
from repro_torch.core import workloads as p_wl

GRAPHS = sorted(r_wl.WORKLOADS) + ["matmul_heavy"]


def _build(mod, name):
    return mod.matmul_heavy_graph() if name == "matmul_heavy" \
        else mod.WORKLOADS[name]()


def _nodes(g):
    return [(n.name, n.kind, n.dims, n.deps, n.out_bytes, n.in_bytes,
             n.param_bytes, n.flops, n.label) for n in g]


def _df(df):
    return (df.critical_path, df.depth, df.parallel_groups, df.nn_span,
            df.vsa_span,
            [(n.depth, n.on_critical_path, n.attached_to) for n in df.graph])


@pytest.fixture(scope="module")
def graphs():
    """Each paper graph built by both packages, with its DataflowGraph."""
    return {name: (r_dfl.build(_build(r_wl, name)),
                   p_dfl.build(_build(p_wl, name))) for name in GRAPHS}


@pytest.mark.parametrize("name", GRAPHS)
def test_paper_graphs_and_dataflow_equal(graphs, name):
    want, got = graphs[name]
    assert _nodes(got.graph) == _nodes(want.graph)
    assert _df(got) == _df(want)
    assert p_og.format_trace(got.graph) == r_og.format_trace(want.graph)
    for kind in (None, "nn", "vsa", "simd", "mem"):
        assert got.graph.total_bytes(kind) == want.graph.total_bytes(kind)
        assert got.graph.total_flops(kind) == want.graph.total_flops(kind)


@pytest.mark.parametrize("name", GRAPHS)
@pytest.mark.parametrize("max_pes", [256, 4096, 16384])
def test_explore_and_serving_plan_equal(graphs, name, max_pes):
    want_df, got_df = graphs[name]
    want = r_dse.explore(want_df, max_pes=max_pes)
    got = p_dse.explore(got_df, max_pes=max_pes)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.summary() == want.summary() and got.tag() == want.tag()
    assert got.t_best == want.t_best
    for kw in ({}, {"max_batch": 4, "inflight_cap": 2}, {"min_bucket": 1}):
        assert dataclasses.asdict(p_dse.serving_plan(got, **kw)) == \
            dataclasses.asdict(r_dse.serving_plan(want, **kw))
    t = got.t_best
    assert dataclasses.asdict(p_ana.memory_plan(got_df.graph, t)) == \
        dataclasses.asdict(r_ana.memory_plan(want_df.graph, t))
    for n in (1, 2, 8):
        assert p_dfl.interloop_overlap(got_df, t, t // 3 + 1, n) == \
            r_dfl.interloop_overlap(want_df, t, t // 3 + 1, n)


@settings(max_examples=12, deadline=None)
@given(max_pes=st.integers(16, 65536), iter_max=st.integers(1, 8),
       name=st.sampled_from(["nvsa", "matmul_heavy"]))
def test_explore_equal_over_budgets(max_pes, iter_max, name):
    """Hypothesis sweep of the PE budget (and Phase II's iteration cap)."""
    want = r_dse.explore(r_dfl.build(_build(r_wl, name)), max_pes, iter_max)
    got = p_dse.explore(p_dfl.build(_build(p_wl, name)), max_pes, iter_max)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("m", [8, 12, 14, 16])
@pytest.mark.parametrize("n_layers", [0, 18])
def test_search_space_equal(m, n_layers):
    assert p_dse.search_space(m, 42, n_layers=n_layers) == \
        r_dse.search_space(m, 42, n_layers=n_layers)


def test_serving_plan_refuses_bad_batches():
    design = p_dse.explore(p_dfl.build(p_wl.nvsa_graph()), 4096)
    for kw in ({"max_batch": 0}, {"min_bucket": 0}):
        with pytest.raises(ValueError, match="must be >= 1"):
            p_dse.serving_plan(design, **kw)
        with pytest.raises(ValueError, match="must be >= 1"):
            r_dse.serving_plan(r_dse.explore(
                r_dfl.build(r_wl.nvsa_graph()), 4096), **kw)


@pytest.mark.parametrize("model", ["nvsa", "prae", "mimonet", "lvrf"])
def test_registry_paper_graphs_equal(model):
    """``ReasonWorkload.paper_graph`` of both registries: the same paper
    graph for nvsa, mimonet and lvrf, none for prae."""
    want = jcb.REASON_WORKLOADS[model].paper_graph
    got = cb.REASON_WORKLOADS[model].paper_graph
    assert (got is None) == (want is None)
    if want is not None:
        assert _nodes(got()) == _nodes(want())
