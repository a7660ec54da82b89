"""Paper-scale NSAI workload graphs (OpGraph builders).

The paper evaluates NVSA / MIMONet / LVRF at their published scales
(ResNet-18 frontends on RAVEN-size inputs, 4×256-block codes). Tracing our
runnable-on-CPU reduced models would under-size the graphs, so the Tab. III
/ Fig. 5 / Fig. 6 benchmarks build the published-scale graphs directly;
system tests separately validate that ``core.trace`` extracts equivalent
structure from the executable models.
"""

from __future__ import annotations

from repro_torch.core.opgraph import OpGraph, OpNode

DT = 4  # fp32 bytes (device models quantize separately)


def _conv_node(g: OpGraph, name: str, dep: str | None, batch: int, hw: int,
               cin: int, cout: int, k: int, stride: int = 1) -> str:
    out_hw = hw // stride
    m = batch * out_hw * out_hw
    kk = k * k * cin
    node = OpNode(name, "nn", {"m": m, "n": cout, "k": kk,
                               "out_shape": (batch, out_hw, out_hw, cout)},
                  deps=[dep] if dep else [],
                  out_bytes=m * cout * DT, in_bytes=batch * hw * hw * cin * DT,
                  param_bytes=kk * cout * DT, flops=2 * m * cout * kk,
                  label=f"conv{k}x{k}")
    g.add(node)
    return name


def resnet18_graph(g: OpGraph, batch: int = 16, img: int = 160, cin: int = 64,
                   prefix: str = "nn") -> str:
    """ResNet-18 body as in paper Listing 1 ([16, 64, 160, 160] activations)."""
    last = _conv_node(g, f"{prefix}_stem", None, batch, img, 3, cin, 7, 2)
    hw = img // 2
    c = cin
    for stage, (cout, stride) in enumerate([(cin, 1), (cin * 2, 2),
                                            (cin * 4, 2), (cin * 8, 2)]):
        for blk in range(2):
            s = stride if blk == 0 else 1
            a = _conv_node(g, f"{prefix}_s{stage}b{blk}c1", last, batch, hw, c,
                           cout, 3, s)
            hw = hw // s
            c = cout
            last = _conv_node(g, f"{prefix}_s{stage}b{blk}c2", a, batch, hw, c,
                              cout, 3, 1)
    head = OpNode(f"{prefix}_head", "nn",
                  {"m": batch, "n": 512, "k": c, "out_shape": (batch, 512)},
                  deps=[last], out_bytes=batch * 512 * DT,
                  in_bytes=batch * c * DT, param_bytes=c * 512 * DT,
                  flops=2 * batch * 512 * c, label="fc")
    g.add(head)
    return head.name


def _vsa_node(g: OpGraph, name: str, deps: list[str], nvec: int, d: int,
              label: str = "circ_conv") -> str:
    node = OpNode(name, "vsa", {"nvec": nvec, "d": d, "out_shape": (nvec, d)},
                  deps=deps, out_bytes=nvec * d * DT, in_bytes=2 * nvec * d * DT,
                  flops=2 * nvec * d * d, label=label)
    g.add(node)
    return name


def _simd_node(g: OpGraph, name: str, deps: list[str], elems: int,
               label: str = "similarity") -> str:
    node = OpNode(name, "simd", {"elems": elems, "out_shape": (elems,)},
                  deps=deps, out_bytes=elems * DT, in_bytes=2 * elems * DT,
                  flops=elems, label=label)
    g.add(node)
    return name


def nvsa_graph(batch: int = 1, blocks: int = 4, d: int = 256,
               symbolic_scale: int = 48) -> OpGraph:
    """NVSA end-to-end: ResNet-18 perception + VSA abduction/execution.

    One graph = ONE reasoning task (the paper's "single loop"); batching is
    expressed as inter-loop pipelining (Fig. 4 step ③). ``symbolic_scale``
    multiplies the symbolic vector quantity (the Fig. 6 x-axis); the default
    reproduces the paper's Fig. 1 profile of symbolic ≈ 19% of FLOPs
    (NVSA's published codebook/query batches are far larger than one
    row-triple per attribute).
    """
    g = OpGraph()
    feat = resnet18_graph(g, batch=batch)
    # symbolic stage (per batch item: 8 context + 8 candidate panels,
    # 3 attrs × 5 rules × 2 rows abduction + execution + panel composition)
    nv = batch * blocks * symbolic_scale
    last = feat
    for r in range(5):
        last = _vsa_node(g, f"abduct_rule{r}", [last], nv * 6, d)
        _simd_node(g, f"sim_rule{r}", [last], nv * 6 * d // 8)
    ex = _vsa_node(g, "execute_row3", [last], nv * 5, d)
    comp = _vsa_node(g, "compose_panel", [ex], nv * 3, d)
    cand = _vsa_node(g, "compose_cands", [feat], nv * 8 * 3, d)
    _simd_node(g, "match_prob", [comp, cand], batch * 8 * blocks * d,
               label="match_prob")
    return g


def mimonet_graph(batch: int = 4, channels: int = 4, blocks: int = 4,
                  d: int = 512) -> OpGraph:
    g = OpGraph()
    feat = resnet18_graph(g, batch=batch * channels, img=128)
    b = _vsa_node(g, "bind_keys", [feat], batch * channels * blocks * 128, d)
    _simd_node(g, "bundle", [b], batch * blocks * d, label="bundle")
    # trunk on superposed codes
    t1 = OpNode("trunk1", "nn", {"m": batch, "n": 4 * blocks * d,
                                 "k": blocks * d, "out_shape": (batch, 4 * blocks * d)},
                deps=["bundle"], out_bytes=batch * 4 * blocks * d * DT,
                in_bytes=batch * blocks * d * DT,
                param_bytes=4 * (blocks * d) ** 2 * DT,
                flops=2 * batch * 4 * (blocks * d) ** 2, label="trunk_fc")
    g.add(t1)
    t2 = OpNode("trunk2", "nn", {"m": batch, "n": blocks * d,
                                 "k": 4 * blocks * d, "out_shape": (batch, blocks * d)},
                deps=["trunk1"], out_bytes=batch * blocks * d * DT,
                in_bytes=batch * 4 * blocks * d * DT,
                param_bytes=4 * (blocks * d) ** 2 * DT,
                flops=2 * batch * 4 * (blocks * d) ** 2, label="trunk_fc")
    g.add(t2)
    u = _vsa_node(g, "unbind_keys", ["trunk2"], batch * channels * blocks * 128, d,
                  label="circ_corr")
    _simd_node(g, "classify", [u], batch * channels * 64, label="head")
    return g


def lvrf_graph(batch: int = 1, blocks: int = 4, d: int = 256,
               n_rules: int = 8, symbolic_scale: int = 48) -> OpGraph:
    g = OpGraph()
    feat = resnet18_graph(g, batch=batch)
    last = feat
    for r in range(n_rules):
        last = _vsa_node(g, f"rule_vec{r}", [last], batch * blocks * 3 * symbolic_scale, d)
        _simd_node(g, f"posterior{r}", [last], batch * blocks * d // 4)
    ex = _vsa_node(g, "execute", [last], batch * blocks * n_rules * symbolic_scale, d)
    _simd_node(g, "answer", [ex], batch * 8 * blocks * d, label="match_prob")
    return g


WORKLOADS = {
    "nvsa": nvsa_graph,
    "mimonet": mimonet_graph,
    "lvrf": lvrf_graph,
}


def matmul_heavy_graph(n_layers: int = 12, m: int = 64, d: int = 2048,
                       symbolic_scale: int = 256, blocks: int = 4,
                       dv: int = 512) -> OpGraph:
    """MLP-heavy + symbolic workload where Eq. 1 is N_l-sensitive (d2 large,
    m small) — surfaces the Phase II mapping gains (paper Fig. 6's 44%
    claim regime; our conv workloads are stream-bound, see EXPERIMENTS)."""
    g = OpGraph()
    last = None
    for i in range(n_layers):
        node = OpNode(f"fc{i}", "nn", {"m": m, "n": d, "k": d,
                                       "out_shape": (m, d)},
                      deps=[last] if last else [],
                      out_bytes=m * d * DT, in_bytes=m * d * DT,
                      param_bytes=d * d * DT, flops=2 * m * d * d,
                      label="fc")
        g.add(node)
        last = node.name
        if i % 3 == 1:
            last_v = _vsa_node(g, f"vsa{i}", [last],
                               blocks * symbolic_scale * (1 + i % 4), dv)
    return g
