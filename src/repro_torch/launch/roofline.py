"""Roofline terms of a dry-run cell.

The port of ``repro.launch.roofline``:

    compute    = FLOPs per device / peak            (``FlopCounterMode``)
    memory     = bytes per device / HBM rate        (the cell's arguments)
    collective = collective bytes per device / (link rate x links)

over ``launch/mesh.py:HW``, the H100's table (989 TFLOP/s bf16, 3.35 TB/s,
18 NVLink-4 links of 25 GB/s).

The reference reads its collectives out of XLA's partitioned HLO text
(``parse_collectives``, ``_shape_bytes``).  The port has no HLO, so those
two have no counterpart by design; their place is taken by
``collectives_of``, which reads the port's own record of a step's
collectives (``constraints.TPContext``'s ``stats`` and ``nbytes``) and
maps each op onto the reference's collective kinds.  The bytes are those
each rank hands gloo's all_reduce: for the port's gathers, the whole
zero-filled buffer (``constraints.whole``), where the reference counts the
operand shard; for a reduce-scatter, the slice each rank receives.
"""

from __future__ import annotations

import json
import pathlib

from repro_torch.launch.mesh import HW

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")

#: the port's collective ops (``distributed/constraints.py``) by the
#: reference's kind: the row-parallel reduce, ``psum``, the backward's sum
#: of a column-parallel input's gradient (``copy_in``) and the global
#: norm's are all-reduces; the gathers (``gather_last``, ``whole``, the
#: compressed reduction's ``all_gather``, the backward's gathers of a
#: narrowed or reduce-scattered tensor's gradient, the optimizer's refresh
#: of the wholes kept beside a cut) all-gathers; the RG-LRU gate's
#: ``reduce_scatter`` a reduce-scatter; the pipeline's ``ppermute`` a permute
PORT_KINDS = {"reduce_partial": "all-reduce", "psum": "all-reduce",
              "copy_in": "all-reduce", "global_norm": "all-reduce",
              "gather_last": "all-gather", "whole": "all-gather",
              "all_gather": "all-gather", "take_local": "all-gather",
              "reduce_scatter_grad": "all-gather", "refresh_whole": "all-gather",
              "reduce_scatter": "reduce-scatter", "ppermute": "collective-permute"}


def collectives_of(stats: dict, nbytes: dict) -> tuple[dict, dict]:
    """({kind: bytes}, {kind: count}) of a context's collective record
    (``stats``: op -> (count, seconds); ``nbytes``: op -> bytes), in the
    reference's kinds."""
    out = {k: 0.0 for k in _COLLECTIVES}
    counts = {k: 0 for k in _COLLECTIVES}
    for op, (n, _) in stats.items():
        kind = PORT_KINDS[op]
        out[kind] += float(nbytes.get(op, 0))
        counts[kind] += n
    return out, counts


def roofline_terms(flops_per_device: float, bytes_per_device: float,
                   collective_bytes_total: float, chips: int, hw: dict | None = None) -> dict:
    """All three terms in seconds (per-device quantities in, seconds out),
    over ``hw`` (None: ``HW``, the H100's)."""
    hw = HW if hw is None else hw
    compute = flops_per_device / hw["peak_flops_bf16"]
    memory = bytes_per_device / hw["hbm_bw"]
    collective = (collective_bytes_total / chips) / \
        (hw["ici_bw_per_link"] * hw["ici_links"])
    dominant = max(("compute", compute), ("memory", memory),
                   ("collective", collective), key=lambda kv: kv[1])[0]
    return {
        "compute_s": compute,
        "memory_s": memory,
        "collective_s": collective,
        "dominant": dominant,
        "bound_s": max(compute, memory, collective),
    }


# ---------------------------------------------------------------------------
# Report generation
# ---------------------------------------------------------------------------


def summarize(dryrun_dir=None) -> str:
    """A markdown roofline table from the dry-run JSONs (the pod cells, then
    the multi-pod ones).  A kind without a tensor-parallel path has no
    collective record: its collective column reads "n/a"."""
    d = pathlib.Path(dryrun_dir) if dryrun_dir else \
        pathlib.Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
    lines = [
        "| arch | shape | dom | compute | memory | collective | "
        "MODEL/FLOPs | coll. mix |",
        "|---|---|---|---|---|---|---|---|",
    ]
    multi = ["", "### Multi-pod (2×16×16) deltas", "",
             "| arch | shape | status | compute | collective | note |",
             "|---|---|---|---|---|---|"]
    for p in sorted(d.glob("*.json")):
        r = json.loads(p.read_text())
        if r["status"] == "skip":
            if r["mesh"] == "pod16x16":
                lines.append(f"| {r['arch']} | {r['shape']} | SKIP | — | — | — "
                             f"| — | {r['skip_reason'][:40]}… |")
            continue
        if r["status"] != "ok":
            tgt = lines if r["mesh"] == "pod16x16" else multi
            tgt.append(f"| {r['arch']} | {r['shape']} | ERROR | — | — | — | — "
                       f"| {r.get('error', '')[:50]} |")
            continue
        t = r["roofline"]
        cb = r["collective_bytes_per_device"]
        mix = "n/a" if cb is None else (",".join(
            f"{k.split('-')[-1][:4]}:{v / 1e9:.1f}G" for k, v in cb.items() if v > 0)
            or "none")
        coll = "n/a" if cb is None else f"{t['collective_s'] * 1e3:.2f}ms"
        if r["mesh"] == "pod16x16":
            lines.append(
                f"| {r['arch']} | {r['shape']} | **{t['dominant'][:4]}** | "
                f"{t['compute_s'] * 1e3:.1f}ms | {t['memory_s'] * 1e3:.1f}ms | "
                f"{coll} | {r['useful_flops_ratio']:.2f} | {mix} |")
        else:
            multi.append(
                f"| {r['arch']} | {r['shape']} | ok | "
                f"{t['compute_s'] * 1e3:.1f}ms | {coll} | {t['dominant']} |")
    return "\n".join(lines + multi)


if __name__ == "__main__":
    print(summarize())
