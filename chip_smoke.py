#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. Device: the card's name and power limit (``nvidia-smi``), the torch and
   CUDA versions, and the build of every CUDA kernel from
   ``src/repro_torch/csrc/`` (one ``nvcc`` per source, all started
   together).
2. Kernels: each kernel against its plain PyTorch version on the card, at
   the serving path's shapes and around them, with times (CUDA events,
   warm, median of 21 samples): ``circ_conv`` conv/corr within 1e-3
   absolute (the registry epsilon), ``qmatmul`` int8/int4 with exact int32
   accumulators and f32 outputs within 1e-6 relative.
3. Serve: NVSA at ``make_config(d=256)`` (4 blocks x 256, cnn_width 16,
   cnn_feat 128, 32x32 images, the model's own width) through
   ``reason_engine``, with constants from ``nn/init.py`` on a seeded
   ``torch.Generator``: the ``oracle`` variant, then ``cnn`` at fp32, int8
   and int4, each under the sequential, overlap and fused schedules.  It
   checks oracle accuracy 1.0, identical answers across schedules, GPU
   log-probs within 1e-3 of the same engine on the CPU (at int8/int4, on
   every problem whose int8 activation codes agree on both devices), and
   the kernel launch counts: 42 circ_conv launches per symbolic-stage
   call, 6 qmatmul launches per int8/int4 frontend call and none at fp32.
4. The ``kernels`` JSON line: every ported kernel with its launches in
   phase 3 and its times at the path's largest shape.
5. The last line: ``{"ok": true, "device": {...}}``.

It needs the repository's ``src/`` beside it and a CUDA device; without
either it exits with code 2.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12       # CUDA cores, outside the tensor cores
INT8_OPS = 1979e12      # tensor cores

N_REQUESTS = 34         # groups of 8 at batch_size 8: 8, 8, 8, 8, 2
BUCKETS = (2, 4, 8)
SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def cuda_ms(fn, reps: int = 10, samples: int = 21) -> float:
    """Median per-call time of ``fn`` in ms over ``samples`` windows of
    ``reps`` back-to-back calls, after a warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def graph_ms(fn, reps: int = 20, samples: int = 21) -> float:
    """Median per-call device time of ``fn`` in ms: ``reps`` calls captured
    in one CUDA graph and replayed, so the host's per-call cost (Python,
    the wrapper's checks, the launch itself) drops out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, reps=1, samples=samples) / reps


# -- phase 1 ------------------------------------------------------------------


def phase_device():
    import torch

    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    emit({"phase": "device", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s, "build_s_per_source": _build.BUILD_SECONDS})


# -- phase 2 ------------------------------------------------------------------


def circ_bound(n: int, b: int, d: int) -> tuple[float, str]:
    """Least time (ms) for (N, B, d) f32 circ_elem: each input read once
    and the output written once, against 2·d multiply-adds per output on
    the f32 CUDA cores."""
    t_bytes = 3 * n * b * d * 4 / HBM_BYTES_PER_S
    t_ops = 2 * n * b * d * d / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes > t_ops else "operations"


def qmm_bound(m: int, k: int, n: int, int4: bool) -> tuple[float, str]:
    w_bytes = k * n // 2 if int4 else k * n
    t_bytes = (m * k + w_bytes + 4 * m + 4 * n + 4 * m * n) / HBM_BYTES_PER_S
    t_ops = 2 * m * n * k / INT8_OPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes > t_ops else "operations"


def phase_kernels() -> dict:
    """Returns the rows at the serving path's largest shapes, keyed by
    kernel name, for the ``kernels`` line."""
    import torch

    from repro_torch.kernels.circ_conv import ops as circ_ops
    from repro_torch.kernels.circ_conv import ref as circ_ref
    from repro_torch.kernels.qmatmul import ops as qops
    from repro_torch.kernels.qmatmul import ref as qref

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    main = {}
    for mode in ("conv", "corr"):
        for d in (128, 256, 512):
            for n in (8, 64, 67):
                x = torch.randn(n, 4, d, device="cuda", generator=gen)
                y = torch.randn(n, 4, d, device="cuda", generator=gen)
                got = circ_ops.circ_elem(x, y, mode)
                want = circ_ref.circ_elem_ref(x, y, mode)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                check(err <= 1e-3, f"circ_conv {mode} {(n, 4, d)}: max abs "
                                   f"err {err} > 1e-3")

                def fft_chain(x=x, y=y, mode=mode):
                    fx = torch.fft.rfft(x, dim=-1)
                    fy = torch.fft.rfft(y, dim=-1)
                    return torch.fft.irfft((fx if mode == "conv" else fx.conj()) * fy,
                                           n=d, dim=-1)

                bound, by = circ_bound(n, 4, d)
                row = {"kernel": "circ_conv", "mode": mode, "shape": [n, 4, d],
                       "max_abs_err": err,
                       "kernel_ms": cuda_ms(lambda: circ_ops.circ_elem(x, y, mode)),
                       "kernel_device_ms": graph_ms(
                           lambda: circ_ops.circ_elem(x, y, mode)),
                       "plain_ms": cuda_ms(lambda: circ_ref.circ_elem_ref(x, y, mode)),
                       "library_ms": cuda_ms(fft_chain),
                       "library": "rfft, rfft, irfft (3 calls)",
                       "bound_ms": bound, "bound_by": by}
                emit(row)
                if (mode, n, d) == ("conv", 64, 256):
                    main["circ_conv"] = row
    for int4 in (False, True):
        for m, k, n in ((16, 128, 5), (64, 128, 6), (64, 128, 8), (67, 130, 7)):
            lim = 8 if int4 else 128
            xq = torch.randint(-128, 128, (m, k), device="cuda", generator=gen,
                               dtype=torch.int8)
            wq = torch.randint(-lim, lim, (k, n), device="cuda", generator=gen,
                               dtype=torch.int8)
            w_full = wq
            if int4:  # an odd N is padded for packing, as qdense does
                wq = qops.pack_int4(wq)
                w_full = qref.unpack_int4_ref(wq)
            n_out = w_full.shape[1]
            xs = torch.rand(m, device="cuda", generator=gen) + 0.01
            ws = torch.rand(n_out, device="cuda", generator=gen) + 0.01
            acc = qops.qmatmul(xq, wq, torch.ones_like(xs), torch.ones_like(ws), int4)
            acc_want = qref.qmatmul_acc_ref(xq, wq, int4)
            got = qops.qmatmul(xq, wq, xs, ws, int4)
            want = qref.qmatmul_ref(xq, wq, xs, ws, int4)
            torch.cuda.synchronize()
            check(torch.equal(acc, acc_want.float()),
                  f"qmatmul int4={int4} {(m, k, n)}: int32 accumulators differ")
            rel = float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())
            check(rel <= 1e-6, f"qmatmul int4={int4} {(m, k, n)}: rel err {rel}")
            library_ms, library = None, "n/a: torch._int_mm needs M > 16, K and N % 8"
            if m > 16 and k % 8 == 0 and n_out % 8 == 0:
                library_ms = cuda_ms(lambda: torch._int_mm(xq, w_full))
                library = "torch._int_mm (int32 accumulator only)"
            bound, by = qmm_bound(m, k, n_out, int4)
            row = {"kernel": "qmatmul", "int4": int4, "shape": [m, k, n],
                   "max_abs_err": float((got - want).abs().max()),
                   "max_rel_err": rel,
                   "kernel_ms": cuda_ms(lambda: qops.qmatmul(xq, wq, xs, ws, int4)),
                   "kernel_device_ms": graph_ms(
                       lambda: qops.qmatmul(xq, wq, xs, ws, int4)),
                   "plain_ms": cuda_ms(lambda: qref.qmatmul_ref(xq, wq, xs, ws, int4)),
                   "library_ms": library_ms, "library": library,
                   "bound_ms": bound, "bound_by": by}
            emit(row)
            if (int4, m, k, n) == (False, 64, 128, 8):
                main["qmatmul"] = row
    return main


# -- phase 3 ------------------------------------------------------------------


def run_recording_codes(eng, requests):
    """One sequential run of ``eng`` that records, on the host, the int8
    activation codes of every ``qdense`` call (the quantised inputs of the
    attribute heads).  Returns ``(results, codes in call order)``."""
    from repro_torch.kernels.qmatmul import ops as qops

    plain = qops.quantize_rows
    codes = []

    def recording(x, bits=8):
        q, scale = plain(x, bits)
        codes.append(q.cpu())
        return q, scale

    qops.quantize_rows = recording
    try:
        return eng.run(requests, schedule="sequential"), codes
    finally:
        qops.quantize_rows = plain


def uids_with_other_codes(codes_a, codes_b, batch: int) -> set[int]:
    """Requests whose int8 activation codes differ between two runs.  A
    group makes 6 qdense calls (context and candidates x 3 heads); row r of
    a call in group g is image r of the group, i.e. request
    ``g * batch + r // 8``."""
    check(len(codes_a) == len(codes_b), "the runs made different qdense calls")
    moved = set()
    for c, (a, b) in enumerate(zip(codes_a, codes_b)):
        rows = (a != b).any(dim=1).nonzero().flatten().tolist()
        moved.update((c // 6) * batch + r // 8 for r in rows)
    return {u for u in moved if u < N_REQUESTS}


def phase_serve() -> dict[str, int]:
    """Drives the port's main path; returns the launch counts of the run."""
    import numpy as np
    import torch

    from repro_torch.backend import registry
    from repro_torch.configs import base as cb
    from repro_torch.serve.reason import ReasonConfig

    entry = cb.REASON_WORKLOADS["nvsa"]
    base_cfg = entry.make_config(d=256)
    consts = entry.make_consts(base_cfg, torch.Generator().manual_seed(SEED))
    factory, truth = entry.make_requests(base_cfg, N_REQUESTS, SEED)
    requests = list(factory())
    answers = truth()
    groups = math.ceil(N_REQUESTS / 8)
    rcfg = ReasonConfig(batch_size=8, buckets=BUCKETS, max_inflight=2)
    rows = [("oracle", "fp32"), ("cnn", "fp32"), ("cnn", "int8"), ("cnn", "int4")]

    registry.reset_launches()
    for variant, prec in rows:
        cfg = entry.make_config(d=256, nn_precision=prec)
        eng = cb.reason_engine("nvsa", cfg, rcfg, consts=consts, variants=(variant,))
        logps = {}
        for schedule in ("sequential", "overlap", "fused"):
            for _ in range(2):  # the first run of a shape is warmup
                before = dict(registry.LAUNCHES)
                res = eng.run(requests, schedule=schedule)
                run = eng.last_run
                circ = registry.LAUNCHES["circ_conv"] - before["circ_conv"]
                qmm = registry.LAUNCHES["qmatmul"] - before["qmatmul"]
                want_qmm = 6 * groups if variant == "cnn" and prec != "fp32" else 0
                check(circ == 42 * groups, f"{variant}/{prec}/{schedule}: "
                      f"{circ} circ_conv launches for {groups} groups")
                check(qmm == want_qmm, f"{variant}/{prec}/{schedule}: {qmm} "
                      f"qmatmul launches, want {want_qmm}")
                logps[schedule] = np.stack(
                    [res[u].answer_logprobs for u in range(N_REQUESTS)])
                check(bool(np.isfinite(logps[schedule]).all()),
                      f"{variant}/{prec}/{schedule}: non-finite log-probs")
            check(not run["warmup"], f"{variant}/{prec}/{schedule}: no measured run")
            acc = entry.score(res, answers)
            emit({"phase": "serve", "variant": variant, "nn_precision": prec,
                  "schedule": schedule, "requests": N_REQUESTS, "groups": groups,
                  "problems_per_s": run["problems_per_s"],
                  "wall_time_s": run["wall_time_s"], "warmup": run["warmup"],
                  "stage_time_s": run["stage_time_s"],
                  "circ_conv_launches": circ, "qmatmul_launches": qmm,
                  "accuracy": acc})
            if variant == "oracle":
                check(acc == 1.0, f"oracle accuracy {acc} != 1.0")
        for schedule in ("overlap", "fused"):
            check(np.array_equal(logps[schedule], logps["sequential"]),
                  f"{variant}/{prec}: {schedule} answers differ from sequential")
        # GPU against the CPU engine on the same constants.  At int8/int4
        # the heads quantise their input rows to int8; a ~1e-6 difference
        # between cuDNN's and the CPU's conv sums can move a value across a
        # rounding tie and change one int8 code, which moves that problem's
        # log-probs by a few 1e-3.  So the 1e-3 bound holds every problem
        # whose int8 codes agree on both devices; the others are counted.
        gpu_res, gpu_codes = run_recording_codes(eng, requests)
        cpu = cb.reason_engine("nvsa", cfg, rcfg, consts=consts,
                               variants=(variant,), device="cpu")
        cpu_res, cpu_codes = run_recording_codes(cpu, requests)
        gpu_logp = np.stack([gpu_res[u].answer_logprobs for u in range(N_REQUESTS)])
        check(np.array_equal(gpu_logp, logps["sequential"]),
              f"{variant}/{prec}: a repeated sequential run changed its answers")
        cpu_logp = np.stack([cpu_res[u].answer_logprobs for u in range(N_REQUESTS)])
        moved = uids_with_other_codes(gpu_codes, cpu_codes, rcfg.batch_size)
        held = [u for u in range(N_REQUESTS) if u not in moved]
        diff = np.abs(cpu_logp - gpu_logp).max(axis=1)
        same = int(sum(cpu_res[u].answer == gpu_res[u].answer
                       for u in range(N_REQUESTS)))
        emit({"phase": "serve_vs_cpu", "variant": variant, "nn_precision": prec,
              "requests": N_REQUESTS, "int8_codes_moved": len(moved),
              "max_abs_logp_diff": float(diff[held].max()),
              "max_abs_logp_diff_codes_moved":
                  float(diff[sorted(moved)].max()) if moved else None,
              "same_answers": same})
        check(len(held) >= N_REQUESTS // 2,
              f"{variant}/{prec}: int8 codes moved in {len(moved)} problems")
        check(float(diff[held].max()) <= 1e-3,
              f"{variant}/{prec}: GPU vs CPU log-probs differ by "
              f"{float(diff[held].max())} > 1e-3")
    counts = dict(registry.LAUNCHES)
    for name, n in counts.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.backend import registry

    t0 = time.perf_counter()
    phase_device()
    main_rows = phase_kernels()
    launches = phase_serve()
    kernels = []
    for name, spec in registry.KERNELS.items():
        row = main_rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{spec.source}",
            "replaces": spec.replaces, "launches": launches[name],
            "shape": row["shape"], "max_abs_err": row["max_abs_err"],
            "ms": row["kernel_ms"], "device_ms": row["kernel_device_ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]})
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
