"""Dataflow-graph generation — paper Sec V-B, Fig. 4.

Steps (paper numbering):
  ① critical-path identification  — longest path through the op graph (DFS)
  ② inner-loop parallelism        — BFS depth assignment; off-path nodes
                                    attach to the critical-path node at the
                                    same depth (earliest legal start)
  ③ inter-loop parallelism        — steady-state overlap: the next loop's
                                    first NN layer starts when the NN stream
                                    frees, running alongside this loop's
                                    symbolic tail
  ④ runtime functions             — attached per node via analytical.py
  ⑤ memory cost                   — per-node bytes for the memory planner

Graph -> schedule correspondence: the same DataflowGraph that drives the
DSE also drives *execution*.  ``serve.schedule.compile_schedule`` lowers a
workload's stage list into an executable ``StagedSchedule`` and traces the
composed pipeline back into this IR (``core.trace`` on a ``meta`` run): stage
boundaries land on the nn/vsa/simd stream transitions modeled here, the
per-stage buffer specs realize step ⑤, and the serving engine's
double-buffered overlap of consecutive admission batches is the host/device
realization of step ③ — ``interloop_overlap`` predicts the speedup
(``serve.schedule.predicted_overlap``) that ``chip_smoke.py``'s deploy
phase prints beside the rates it measures.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import analytical
from repro_torch.core.opgraph import OpGraph, OpNode


@dataclasses.dataclass
class DataflowGraph:
    graph: OpGraph
    critical_path: list[str]
    depth: dict[str, int]
    parallel_groups: dict[str, list[str]]  # critical node -> attached nodes
    nn_span: tuple[int, int]               # depth range of the NN stream
    vsa_span: tuple[int, int]

    @property
    def nn_nodes(self) -> list[OpNode]:
        return self.graph.nn_nodes()

    @property
    def vsa_nodes(self) -> list[OpNode]:
        return self.graph.vsa_nodes()


def _node_weight(n: OpNode) -> int:
    """Unit-array runtime estimate used only to pick the critical path."""
    if n.kind == "nn":
        if all(k in n.dims for k in ("m", "n", "k")):
            return analytical.t_layer(32, 32, 1, n.dims["m"], n.dims["n"],
                                      n.dims["k"])
        # matmul-class kernel node (e.g. traced Pallas qmatmul) without
        # factored dims: fall back to MACs over a 32x32 array
        return analytical.cdiv(n.flops, 2 * 32 * 32) or 1
    if n.kind == "vsa":
        return analytical.t_vsa_node(32, 32, 1, n)
    if n.kind == "simd":
        return analytical.cdiv(n.dims.get("elems", 1), 64)
    return 0


def build(graph: OpGraph) -> DataflowGraph:
    # ① longest (weighted) path via DP over the topological order
    dist: dict[str, int] = {}
    pred: dict[str, str | None] = {}
    for name in graph.order:
        n = graph.nodes[name]
        best, bp = 0, None
        for d in n.deps:
            if d in dist and dist[d] > best:
                best, bp = dist[d], d
        dist[name] = best + _node_weight(n)
        pred[name] = bp
    end = max(dist, key=dist.get)
    path = []
    cur: str | None = end
    while cur is not None:
        path.append(cur)
        cur = pred[cur]
    path.reverse()
    on_path = set(path)

    # ② BFS depth assignment + attachment of same-depth off-path nodes
    depth: dict[str, int] = {}
    for name in graph.order:
        n = graph.nodes[name]
        depth[name] = 1 + max((depth[d] for d in n.deps if d in depth), default=-1)
    path_at_depth = {depth[p]: p for p in path}
    groups: dict[str, list[str]] = {p: [] for p in path}
    for name in graph.order:
        n = graph.nodes[name]
        n.depth = depth[name]
        n.on_critical_path = name in on_path
        if name not in on_path:
            # attach to the critical-path node at the same (or nearest lower)
            # depth — its earliest legal concurrent slot
            d = depth[name]
            while d >= 0 and d not in path_at_depth:
                d -= 1
            anchor = path_at_depth.get(max(d, 0), path[0])
            n.attached_to = anchor
            groups[anchor].append(name)

    nn_d = [depth[n.name] for n in graph.nn_nodes()] or [0]
    vsa_d = [depth[n.name] for n in graph.vsa_nodes()] or [0]
    return DataflowGraph(graph, path, depth, groups,
                         (min(nn_d), max(nn_d)), (min(vsa_d), max(vsa_d)))


def interloop_overlap(df: DataflowGraph, t_nn_stream: int, t_vsa_stream: int,
                      n_loops: int = 2) -> dict:
    """③ steady-state pipelined runtime for ``n_loops`` iterations.

    With folding, loop i+1's NN stream starts as soon as the NN resource
    frees (after this loop's NN stream), overlapping loop i's symbolic tail:
        t_total = t_nn + (n-1)·max(t_nn, t_vsa) + t_vsa  [pipeline formula]
    Without folding (sequential array): t_total = n·(t_nn + t_vsa).

    ``bubble`` is the idle fraction of the two streams over the (n-1)
    steady-state slots — pipelined vs the ideal where each slot carries one
    NN and one symbolic stream with no slack: a slot lasts max(t_nn, t_vsa)
    of the 2·max capacity, of which t_nn + t_vsa is busy.  A single loop
    (n_loops=1) has no pipeline slots and hence no bubble by definition,
    and balanced streams (t_nn == t_vsa) pipeline bubble-free.
    """
    stage = max(t_nn_stream, t_vsa_stream)
    pipelined = t_nn_stream + (n_loops - 1) * stage + t_vsa_stream
    sequential = n_loops * (t_nn_stream + t_vsa_stream)
    if n_loops <= 1 or stage <= 0:
        bubble = 0.0
    else:
        bubble = min(1.0, max(
            0.0, 1.0 - (t_nn_stream + t_vsa_stream) / (2 * stage)))
    return {
        "pipelined": pipelined,
        "sequential": sequential,
        "speedup": sequential / max(1, pipelined),
        "bubble": bubble,
    }
