"""Two-phase design-space exploration — paper Sec V-C, Algorithm 1, Tab. II.

Phase I  : grid over (H, W) with the paper's aspect-ratio pruning
           (1/4 ≤ H/W ≤ 16), N = ⌊M / (H·W)⌋ sub-arrays, and a *static*
           partition N̄_l : N̄_v swept over [1, N). Also evaluates the
           sequential (unfolded) mode and returns it when it wins (Alg. 1
           line 14).
Phase II : per-node refinement around (N̄_l, N̄_v): for each layer node i the
           concurrent VSA window [j', j''] is located via the dataflow
           graph, and ±1 sub-array moves are applied in the direction that
           reduces t_para = max(t_nn, t_vsa), up to Iter_max sweeps.
           (The printed pseudocode's move condition is degenerate —
           ``t_seq < t_para`` does not depend on i — so we implement the
           evident intent: shift capacity toward the slower stream, greedy
           with revert. Recorded in DESIGN.md §7.)

Search-space accounting reproduces Tab. II's reduction claim.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core import analytical as ana
from repro_torch.core.dataflow import DataflowGraph


@dataclasses.dataclass
class DesignConfig:
    H: int
    W: int
    N: int
    mode: str                 # parallel | sequential
    n_l: list[int]            # per NN node sub-array assignment
    n_v: list[int]            # per VSA node sub-array assignment
    nl_bar: int
    nv_bar: int
    t_para: int
    t_seq: int
    t_phase1: int
    mem: ana.MemoryPlan | None = None
    searched_points: int = 0

    @property
    def t_best(self) -> int:
        return min(self.t_para, self.t_seq) if self.mode == "parallel" else self.t_seq

    def tag(self) -> str:
        """Compact comma-free provenance tag (``HxWxN/nl:nv/mode``) —
        recorded in BENCH_*.json rows and deployment reports so every
        measurement says which DSE point served it."""
        return (f"{self.H}x{self.W}x{self.N}"
                f"/{self.nl_bar}:{self.nv_bar}/{self.mode}")

    def summary(self) -> dict:
        return {
            "AdArray (H, W, N)": (self.H, self.W, self.N),
            "partition": f"{self.nl_bar}:{self.nv_bar}",
            "mode": self.mode,
            "t_para_cycles": self.t_para,
            "t_seq_cycles": self.t_seq,
            "SIMD": self.mem.simd_lanes if self.mem else None,
            "MemA1": self.mem.mem_a1 if self.mem else None,
            "MemA2": self.mem.mem_a2 if self.mem else None,
            "MemB": self.mem.mem_b if self.mem else None,
            "MemC": self.mem.mem_c if self.mem else None,
            "cache": self.mem.cache if self.mem else None,
        }


#: FPGA-placeable sub-array bounds. The paper's deployed configs (Tab. III)
#: top out at 32×32 — a monolithic wide array does not route/time on an
#: FPGA fabric, which is exactly why AdArray scales out via N sub-arrays.
RANGE_H = (4, 32)
RANGE_W = (4, 32)


def _hw_candidates(max_pes: int, range_h=RANGE_H, range_w=RANGE_W):
    """(H, W) grid with the paper's pruning: 1/4 <= H/W <= 16."""
    out = []
    h = range_h[0]
    while h <= range_h[1]:
        w = range_w[0]
        while w <= range_w[1]:
            if h * w <= max_pes and 0.25 <= h / w <= 16.0:
                out.append((h, w))
            w *= 2
        h *= 2
    return out


def phase1(df: DataflowGraph, max_pes: int) -> DesignConfig:
    layers = df.nn_nodes
    vnodes = df.vsa_nodes
    L, V = len(layers), len(vnodes)
    best_para = None  # (t, H, W, N, nl_bar)
    best_seq = None   # (t, H, W, N)
    searched = 0
    for H, W in _hw_candidates(max_pes):
        N = max_pes // (H * W)
        if N < 1:
            continue
        # parallel candidates: static split
        if N >= 2 and L and V:
            for nl_bar in range(1, N):
                searched += 1
                tp = max(ana.t_nn(H, W, [nl_bar] * L, layers),
                         ana.t_vsa(H, W, [N - nl_bar] * V, vnodes))
                if best_para is None or tp < best_para[0]:
                    best_para = (tp, H, W, N, nl_bar)
        # sequential: every node gets the whole array (Alg. 1 line 12)
        searched += 1
        ts = (ana.t_nn(H, W, [N] * L, layers) if L else 0) + \
             (ana.t_vsa(H, W, [N] * V, vnodes) if V else 0)
        if best_seq is None or ts < best_seq[0]:
            best_seq = (ts, H, W, N)

    if best_para is None or (best_seq is not None and best_seq[0] < best_para[0]):
        t, H, W, N = best_seq
        return DesignConfig(H, W, N, "sequential", [N] * L, [N] * V, N, N,
                            t, t, t, searched_points=searched)
    t, H, W, N, nl_bar = best_para
    ts = (ana.t_nn(H, W, [N] * L, layers) if L else 0) + \
         (ana.t_vsa(H, W, [N] * V, vnodes) if V else 0)
    return DesignConfig(H, W, N, "parallel", [nl_bar] * L,
                        [N - nl_bar] * V, nl_bar, N - nl_bar, t, ts, t,
                        searched_points=searched)


def _vsa_window(i: int, L: int, V: int) -> tuple[int, int]:
    """VSA node index range concurrent with layer i (span-proportional)."""
    j0 = (i * V) // max(1, L)
    j1 = ((i + 1) * V) // max(1, L)
    return j0, max(j0 + 1, j1)


def phase2(df: DataflowGraph, cfg: DesignConfig, iter_max: int = 8) -> DesignConfig:
    if cfg.mode == "sequential":
        return cfg
    layers, vnodes = df.nn_nodes, df.vsa_nodes
    L, V = len(layers), len(vnodes)
    H, W, N = cfg.H, cfg.W, cfg.N
    n_l, n_v = list(cfg.n_l), list(cfg.n_v)
    best = max(ana.t_nn(H, W, n_l, layers), ana.t_vsa(H, W, n_v, vnodes))
    searched = cfg.searched_points
    for _ in range(iter_max):
        improved = False
        for i in range(L):
            j0, j1 = _vsa_window(i, L, V)
            t_layer_i = ana.t_layer(H, W, n_l[i], layers[i].dims["m"],
                                    layers[i].dims["n"], layers[i].dims["k"])
            t_vsa_win = max(ana.t_vsa_node(H, W, n_v[j], vnodes[j])
                            for j in range(j0, min(j1, V)))
            # shift sub-arrays toward the slower stream; Eq. 1's ceilings
            # plateau at large N, so sweep move sizes (paper uses ±1 at
            # N=16; at N=64 single steps sit inside a ceil() plateau)
            direction = 1 if t_layer_i >= t_vsa_win else -1
            steps = sorted({max(1, N // 8), max(1, N // 16), 8, 4, 2, 1},
                           reverse=True)
            for step in steps:
                trial_l = n_l[i] + direction * step
                if not (1 <= trial_l <= N - 1):
                    continue
                trial_nv = list(n_v)
                ok = True
                for j in range(j0, min(j1, V)):
                    trial_nv[j] -= direction * step
                    if not (1 <= trial_nv[j] <= N - 1):
                        ok = False
                if not ok:
                    continue
                trial_nl = list(n_l)
                trial_nl[i] = trial_l
                searched += 1
                t = max(ana.t_nn(H, W, trial_nl, layers),
                        ana.t_vsa(H, W, trial_nv, vnodes))
                if t < best:
                    best = t
                    n_l, n_v = trial_nl, trial_nv
                    improved = True
                    break
        if not improved:
            break
    out = dataclasses.replace(cfg, n_l=n_l, n_v=n_v, t_para=best,
                              searched_points=searched)
    return out


def explore(df: DataflowGraph, max_pes: int = 16384, iter_max: int = 8,
            simd_lanes=(16, 32, 64, 128, 256)) -> DesignConfig:
    """Full Algorithm 1 + memory/SIMD sizing."""
    cfg = phase1(df, max_pes)
    cfg = phase2(df, cfg, iter_max)
    mem = ana.memory_plan(df.graph, cfg.t_best, simd_lanes)
    return dataclasses.replace(cfg, mem=mem)


# ---------------------------------------------------------------------------
# Generator -> serving architecture (the deploy() loop)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ServingPlan:
    """Serving-runtime knobs derived from one explored :class:`DesignConfig`.

    This is the software half of the paper's generator->architecture loop:
    ``repro_torch.serve.deploy`` traces a workload's dataflow graph, runs
    :func:`explore` over it, and configures the serving runtime from the
    winning design point instead of hand-set config fields.
    """

    batch_size: int               # admission-group ceiling
    buckets: tuple[int, ...]      # compiled batch-size buckets, ascending
    max_inflight: int             # depth of the pipelined in-flight window
    schedule: str                 # overlap | sequential (ReasonConfig knob)
    design: DesignConfig          # the DSE point the knobs derive from


def serving_plan(design: DesignConfig, max_batch: int = 8,
                 inflight_cap: int = 4, min_bucket: int = 2) -> ServingPlan:
    """Map an explored design point onto the serving runtime's knobs.

    - **schedule**: Algorithm 1's mode decision carries over directly —
      a ``parallel`` design (concurrent nn/vsa streams win analytically)
      serves with the ``overlap`` pipelined schedule; a ``sequential``
      design (unfolded array wins) serves with the synchronous schedule.
    - **batch buckets**: the admission width maps requests across the
      ``N`` sub-arrays, so the group ceiling is the largest power of two
      <= N (clamped to [min_bucket, max_batch]); the covering-bucket
      ladder below it comes from ``serve.frontdoor.pow2_buckets`` (whose
      ``min_bucket=2`` default carries the XLA batch-1 bit-equality
      caveat — documented there, not re-derived here).
    - **max_inflight**: the in-flight window depth is the analytical
      folded-vs-unfolded gain ``t_seq / t_para`` rounded (clamped to
      [1, inflight_cap]) — the deeper the array's concurrency win, the
      more groups the host keeps resident; a sequential design pipelines
      nothing (depth 1).
    """
    # lazy import: serve.frontdoor does not import core,
    # so borrowing its bucket ladder keeps one source of bucket policy
    from repro_torch.serve.frontdoor import pow2_buckets

    if max_batch < 1 or min_bucket < 1:
        raise ValueError("max_batch and min_bucket must be >= 1")
    min_bucket = min(min_bucket, max_batch)
    schedule = "overlap" if design.mode == "parallel" else "sequential"
    batch = 1
    while batch * 2 <= max(1, design.N):
        batch *= 2
    batch = max(min_bucket, min(max_batch, batch))
    buckets = pow2_buckets(batch, min_bucket=min_bucket)
    if schedule == "sequential":
        depth = 1
    else:
        depth = max(1, min(inflight_cap,
                           round(design.t_seq / max(1, design.t_para))))
    return ServingPlan(batch_size=batch, buckets=buckets, max_inflight=depth,
                       schedule=schedule, design=design)


# ---------------------------------------------------------------------------
# Search-space accounting (Tab. II)
# ---------------------------------------------------------------------------


def search_space(m: int, n_nodes: int, iter_max: int = 8, n_layers: int = 0) -> dict:
    """Tab. II: original vs two-phase search-space sizes, #PEs = 2^m.

    Original: every (H, W) with H·W ≤ 2^m (m(m+1)/2 power-of-two configs),
    times (N-1)^k per-node mapping choices. DAG: Phase I is the pruned
    (H, W) grid × (N-1) static splits; Phase II is Iter × #layers moves.
    """
    hw_orig = m * (m + 1) // 2
    log10_orig = 0.0
    for i in range(1, m + 1):
        for j in range(1, m - i + 1 + 1):
            n = 2 ** m // (2 ** i * 2 ** j)
            if n >= 2:
                log10_orig += 0  # accumulate in log-space below
    # total = sum over configs of (N-1)^k  — dominated by the largest N
    best_log = 0.0
    for i in range(1, m + 1):
        for j in range(1, m + 1):
            if i + j > m:
                continue
            n = 2 ** (m - i - j)
            if n >= 2:
                best_log = max(best_log, n_nodes * math.log10(n - 1 if n > 2 else 2))
    pruned = [(h, w) for h, w in _hw_candidates(2 ** m)]
    phase1_points = sum(max(1, (2 ** m) // (h * w) - 1) for h, w in pruned)
    phase2_points = iter_max * (n_layers or n_nodes)
    return {
        "original_hw_configs": hw_orig,
        "original_log10_total": best_log + math.log10(max(1, hw_orig)),
        "dag_phase1_points": phase1_points,
        "dag_phase2_points": phase2_points,
        "dag_total_points": phase1_points + phase2_points,
        "reduction_log10": best_log + math.log10(max(1, hw_orig))
                           - math.log10(max(1, phase1_points + phase2_points)),
    }
