"""Mesh DSE: the retargeting of NSFlow Phase I to a device mesh.

The port of ``repro.core.meshdse``, with the same formulas and the same
sort.  The paper's Phase I searches (H, W, N) for an FPGA array; its mesh
analogue searches the *mesh factorization* (data x model parallel sizes)
and per-node knobs (remat, microbatch) against the same style of
analytical cost model, built from the roofline terms of
``launch.mesh.HW`` (the H100 here; the reference's table holds a TPU's):

  compute    = step FLOPs / (chips x peak)
  memory     = (param reads + activation traffic) / (chips x HBM bw)
  collective = TP reduces + DP grad reduce (+EP) / (link bw x links)
  (+ a per-device HBM capacity constraint: params + moments + activations)

``serving_search`` is the serving-mode search ``deploy()`` co-searches:
its winner's ``data`` axis is the replica count, its ``model`` axis the
tensor-parallel degree (``distributed.world``).
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.launch.mesh import HW


@dataclasses.dataclass(frozen=True)
class MeshPoint:
    data: int
    model: int
    remat: bool
    accum: int
    compute_s: float
    memory_s: float
    collective_s: float
    hbm_gb: float
    feasible: bool

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def tag(self) -> str:
        """Comma-free provenance tag for BENCH rows / deploy summaries."""
        return (f"mesh={self.data}x{self.model} "
                f"bound={self.bound_s:.2e}s")

    def record(self) -> dict:
        """Plain-dict record (``Deployment.report()`` embeds this)."""
        return {"data": self.data, "model": self.model,
                "bound_s": self.bound_s, "compute_s": self.compute_s,
                "memory_s": self.memory_s,
                "collective_s": self.collective_s,
                "hbm_gb": self.hbm_gb, "feasible": self.feasible}


def _divisors(n: int):
    return [d for d in range(1, n + 1) if n % d == 0]


def search(n_params: float, n_active: float, d_model: int, n_layers: int,
           seq: int, global_batch: int, chips: int = 256,
           bytes_per_param: float = 2.0, moment_bytes: float = 8.0,
           kv_bytes_per_tok: float = 0.0, train: bool = True) -> list[MeshPoint]:
    """Rank mesh factorizations for one (arch × shape).

    Analytic; no compile. Returns points sorted by bound_s (feasible first).
    """
    tokens = global_batch * seq
    passes = 3 if train else 1
    flops = 2 * n_active * tokens * passes
    points = []
    for model in _divisors(chips):
        data = chips // model
        if global_batch % data and global_batch >= data:
            continue
        for remat in ((False, True) if train else (False,)):
          for accum in ((1, 4, 16) if train else (1,)):
            eff_passes = passes + (1 if remat else 0)
            f = 2 * n_active * tokens * eff_passes
            compute = f / (chips * HW["peak_flops_bf16"])
            # memory: weights stream once per pass per chip-shard per
            # microbatch + activations (residual stream, halved by remat)
            w_bytes = n_params * bytes_per_param / model
            act = tokens / data * d_model * 2.0 * n_layers * (2 if not remat else 1)
            memory = (w_bytes * eff_passes * accum + act) / HW["hbm_bw"]
            # collectives: TP psum of activations per layer (2×), DP grad
            # reduce-scatter+all-gather of the model shard
            tp = 0.0 if model == 1 else \
                2 * n_layers * (tokens / data) * d_model * 2.0
            dp = 0.0 if (data == 1 or not train) else \
                2 * n_params * bytes_per_param / model
            collective = (tp + dp) / (HW["ici_bw_per_link"] * HW["ici_links"])
            # live activations: one microbatch's layer boundaries, sharded
            # over the model axis too (sequence-sharded saves)
            act_live = act / (accum * model)
            hbm = (n_params * (bytes_per_param + (moment_bytes if train else 0))
                   / (model * (data if train else 1))  # ZeRO moments over data
                   + act_live * 2 + tokens / data * kv_bytes_per_tok)
            points.append(MeshPoint(data, model, remat, accum, compute, memory,
                                    collective, hbm / 1e9,
                                    hbm < HW["hbm_bytes"]))
    points.sort(key=lambda p: (not p.feasible, p.bound_s))
    return points


def best(n_params, n_active, d_model, n_layers, seq, global_batch,
         chips: int = 256, **kw) -> MeshPoint:
    return search(n_params, n_active, d_model, n_layers, seq, global_batch,
                  chips, **kw)[0]


def serving_search(n_params: float, n_active: float, d_model: int,
                   n_layers: int, seq: int, batch: int, devices: int,
                   kv_bytes_per_tok: float = 0.0,
                   bytes_per_param: float = 4.0,
                   max_model: int | None = None) -> list[MeshPoint]:
    """Mesh DSE in **serving mode**: the factorization deploy() co-searches.

    Serving differs from training everywhere the cost model cares: one
    pass (no backward), no remat/accum sweep, no optimizer moments, no DP
    gradient reduce — and the per-device HBM constraint gains the KV-cache
    term (``kv_bytes_per_tok`` from the arch config).  The ``data`` axis
    of the winner is the *engine replica count* (data parallelism over
    whole engines — :class:`~repro_torch.serve.replica.ReplicaPool`), the
    ``model`` axis the tensor-parallel degree of each replica.

    ``max_model`` caps the model axis: NSAI staged pipelines are served
    data-parallel only (pass 1 — every device hosts a whole pipeline),
    while LM decode may take a real TP axis through
    ``distributed.sharding_rules``.  Points are sorted feasible-first then
    by ``bound_s``; ``serving_best`` returns the winner.
    """
    if devices < 1:
        raise ValueError(f"devices must be >= 1, got {devices}")
    pts = search(n_params, n_active, d_model, n_layers, seq,
                 global_batch=batch, chips=devices,
                 bytes_per_param=bytes_per_param, moment_bytes=0.0,
                 kv_bytes_per_tok=kv_bytes_per_tok, train=False)
    if max_model is not None:
        pts = [p for p in pts if p.model <= max_model]
    if not pts:
        raise ValueError(f"no mesh point for devices={devices} "
                         f"max_model={max_model}")
    return pts


def serving_best(n_params, n_active, d_model, n_layers, seq, batch,
                 devices: int, **kw) -> MeshPoint:
    return serving_search(n_params, n_active, d_model, n_layers, seq, batch,
                          devices, **kw)[0]
