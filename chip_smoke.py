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
   the serving paths' shapes and around them, with times (CUDA events,
   warm, median of 21 samples): ``circ_conv`` conv/corr within 1e-3
   absolute (the registry epsilon), and on the strided and broadcast
   operands of NVSA's served binds at (8, 4, 256) and (64, 4, 256), f32
   and bf16 (row slices, keys broadcast over one and two lead dims, an
   unaligned row slice): one launch and one allocation each (no copy), bit
   for bit the call on contiguous copies; ``qmatmul`` int8/int4 with exact
   int32 accumulators and f32 outputs equal to the plain version, up to
   (512, 1024, 256), beside ``torch._int_mm`` with the same epilogue (the
   whole function); ``unbind_classify``
   within 1e-3 absolute and bit-identical from launch to launch; then
   ``circ_dict`` (``circ_bind_dict`` at (N, M, B, d) = (256, 16, 4, 256),
   conv/corr, and around it, within 1e-3; bf16 within 1e-3 + one bf16
   step), ``simd_fused`` (``fused_match_prob`` at (512, 16, 4, 256), bf16,
   (67, 5, 4, 128) and M = 1024 split over a cluster of 8 CTAs, within
   1e-6 + 1e-4 relative, bit-identical repeats, one launch a call; each
   row with its cluster size S and, where S > 1, the device time of the
   same launch at S = 1) and ``flash_attn`` (``flash_mha`` at
   llama3.2-3b's (1, 2048, 24, 128), causal, within 2e-5 at f32 and 1e-3 +
   one bf16 step at bf16, both on the tensor cores; also Sq = 100 against
   Skv = 300 and S = 1000 at both dtypes; at S = 2048 f32 also the error
   of one tf32 product per f32 product, the split dropped, which must
   exceed the 2e-5), each beside its library call (FFT chain;
   normalize, matmul, softmax; PyTorch's scaled_dot_product_attention,
   with the backend it chose) and its bound: bytes over the HBM rate or
   operations over the peak of the units that do them (the f32 CUDA
   cores for circ_conv, unbind_classify and simd_fused, the int8 tensor
   cores for qmatmul; for circ_dict and flash_attn the bf16 tensor cores
   at bf16 and, at f32, three products on the TF32 tensor cores).
   Then the host time of each step of the circ_elem, qmatmul,
   circ_bind_dict, fused_unbind_classify and fused_match_prob wrappers
   (``host_breakdown``: host clock, µs per call).
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
4. MIMONet at ``make_config()`` (K = 2 channels, 4 blocks x 128,
   cnn_width 8, two trunk layers of width 1024, 5 classes): a schedule
   compiled with ``fused=True`` under sequential, overlap and fused (2
   circ_conv launches per staged group, 1 circ_conv and 1 unbind_classify
   per fused group, fused logits within 1e-3 of staged); the schedule
   ``reason_engine`` negotiates (epsilon, so ``fused`` falls back stage by
   stage, counted, with no unbind_classify launch); GPU within 1e-3 of the
   CPU; unbinding a superposition with the port's keys on the card
   recovers each channel (similarity > 0.6).
5. LVRF and PrAE at ``make_config()`` (d = 128), ``oracle`` and ``cnn`` at
   fp32: 27 circ_conv launches per LVRF group and none for PrAE, the same
   answers under the three schedules, GPU within 1e-3 of the CPU, PrAE
   oracle accuracy >= 0.90.
6. Deploy: ``serve.deploy.deploy`` of nvsa (d = 256), mimonet, lvrf and
   prae at ``Budget(max_pes=4096, max_batch=8)`` on the card, the
   generator -> architecture loop: each pipeline traced on ``meta``
   (``core.trace``), explored by Algorithm 1 (``core.dse``) and served
   from the derived plan (buckets, window, schedule, overlap upgraded to
   fused where exact) behind one ``FrontDoor``.  One ``deploy_plan`` row
   per model (design summary, buckets, window, schedule, the traced
   graph and ``predicted_overlap``), whose design must equal the
   reference's on the CPU (``DEPLOY_TABLE``).  Then ``warmup()`` and two
   windows of 64 requests per model in one Poisson feed (the streams of
   ``synthetic_traffic``), each model offered first half, then a
   sixteenth of its sequential problems/s of phases 3-5, on the real
   clock: one ``deploy_serve`` row per window and model (problems/s,
   p50/p95 queue and service latency, bucket use, groups closed full /
   deadline / flush, launches per group).  Every request answered, nothing shed, circ_conv launched
   42 / 2 / 27 / 0 times per group (nvsa / mimonet / lvrf / prae), and
   nvsa's served log-probs within 1e-3 of an offline ``run`` of the same
   engine.
7. Ops: the kernel-level entry points at full width, one more path.
   ``vsa.match_prob`` at NVSA's 4 x 256 against 16 entries (f32, bf16),
   at the floor d = 128 (one launch) and below it (d = 64, none): rows sum
   to 1 within 1e-5, the card within 1e-3 of the CPU, the gradient within
   1e-4.  ``circ_bind_dict`` conv/corr within 1e-3 of the plain version and
   of the ``codebook_circulant`` einsum.  ``flash_mha`` at llama3.2-3b's
   attention (24 heads of 128, k/v drawn as 8 heads and repeated), causal
   at S = 2048 (f32, bf16), Sq = 100 against Skv = 300 (causal and not,
   f32; not causal, bf16) and S = 1000, within 2e-5 of the plain version
   at f32 and 1e-3 + one bf16 step at bf16.  Gradients on the card:
   ``vsa.bind`` and ``vsa.unbind`` at 4 x 256 (two circ_conv launches per
   backward) and ``fused_unbind_classify`` at MIMONet's width, within 1e-4
   of the CPU; ``flash_mha`` refusing grad and taking a transposed view
   bit for bit as its contiguous copy.
8. The ``kernels`` JSON line: every ported kernel with its launches on the
   paths (each path's counts set to 0 just before it runs and read just
   after) and its times at its path's shape, its bound and the units the
   bound counts; entries carry other rows (``SUB_ROWS``): ``circ_conv``
   the (8, 4, 256) bucket under ``served`` (39 of NVSA's 42 calls),
   ``circ_dict`` corr and bf16 at (256, 16, 4, 256), ``unbind_classify``
   (8, 2, 4, 256, 5) under ``d256``, ``simd_fused`` bf16, (67, 5, 4, 128)
   under ``d128`` and (64, 1024, 4, 256) under ``m1024``, ``flash_attn``
   bf16 at the same shape
   (ms, device_ms, library_ms, bound_ms, bound_units, max_abs_err).
9. The last line: ``{"ok": true, "device": {...}}``.

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
BF16_FLOPS = 989e12     # tensor cores
TF32_FLOPS = 495e12     # tensor cores

N_REQUESTS = 34         # groups of 8 at batch_size 8: 8, 8, 8, 8, 2
BUCKETS = (2, 4, 8)
SEED = 0
# measured problems/s of each (workload label, schedule) served in phases
# 3-5; the deploy phase offers each model half its sequential rate
RATES: dict[tuple[str, str], float] = {}


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


def uc_bound(n: int, k: int, b: int, d: int, c: int) -> tuple[float, str, str]:
    """Least time (ms) for f32 fused_unbind_classify: keys, x, w and b read
    once and the logits written once, against 2·N·K·B·(d² + d·C) flops
    (the correlation, then the head) on the units the kernel uses, the f32
    CUDA cores.  Returns (ms, "bytes" or "operations", the units)."""
    t_bytes = 4 * (k * b * d + n * b * d + b * d * c + c + n * k * c) / HBM_BYTES_PER_S
    t_ops = 2 * n * k * b * (d * d + d * c) / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes > t_ops else "operations",
            "f32 CUDA cores")


def dict_bound(n: int, m: int, b: int, d: int, elt: int) -> tuple[float, str, str]:
    """Least time (ms) for circ_dict: x and the dictionary read once and the
    (N, M, B, d) output written once, against 2·N·M·B·d² flops on the units
    the kernel uses: for f32 three TF32 products per f32 product (3xTF32) on
    the TF32 tensor cores, for bf16 one product on the bf16 tensor cores.
    Returns (ms, "bytes" or "operations", the units)."""
    t_bytes = elt * (n * b * d + m * b * d + n * m * b * d) / HBM_BYTES_PER_S
    flops = 2 * n * m * b * d * d
    if elt == 2:
        t_ops, units = flops / BF16_FLOPS, "bf16 tensor cores"
    else:
        t_ops = 3 * flops / TF32_FLOPS
        units = "TF32 tensor cores, 3 products per f32 product"
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes > t_ops else "operations",
            units)


def match_bound(n: int, m: int, b: int, d: int, elt: int) -> tuple[float, str]:
    """Least time (ms) for fused_match_prob: q and the dictionary read once,
    the (N, M) f32 probabilities written once, against the dot products
    (2·N·M·B·d) and the normalisations (3·(N + M)·B·d) in f32."""
    t_bytes = (elt * (n + m) * b * d + 4 * n * m) / HBM_BYTES_PER_S
    t_ops = (2 * n * m * b * d + 3 * (n + m) * b * d) / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes > t_ops else "operations"


def flash_flops(b: int, sq: int, skv: int, h: int, hd: int, causal: bool) -> int:
    """4·hd flops (q·k and p·v) per visible (query, key) pair: with the
    causal mask aligned at 0, query i sees min(i + 1, Skv) keys."""
    if causal:
        full = min(sq, skv)
        pairs = full * (full + 1) // 2 + max(sq - skv, 0) * skv
    else:
        pairs = sq * skv
    return 4 * hd * pairs * b * h


def flash_bound(b: int, sq: int, skv: int, h: int, hd: int, causal: bool,
                elt: int) -> tuple[float, str, str]:
    """Least time (ms) for flash attention: q, k, v read once and the output
    written once, against the work on the units the kernel computes on:
    ``flash_flops`` on the bf16 tensor cores for bf16 inputs (``elt ==
    2``); for f32, three TF32 products per f32 product (3xTF32), 3 x
    ``flash_flops`` on the TF32 tensor cores.  Returns (ms, "bytes" or
    "operations", the units of the operations)."""
    t_bytes = elt * b * h * hd * (2 * sq + 2 * skv) / HBM_BYTES_PER_S
    if elt == 2:
        t_ops = flash_flops(b, sq, skv, h, hd, causal) / BF16_FLOPS
        units = "bf16 tensor cores"
    else:
        t_ops = 3 * flash_flops(b, sq, skv, h, hd, causal) / TF32_FLOPS
        units = "TF32 tensor cores, 3 products per f32 product"
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes > t_ops else "operations",
            units)


def phase_kernels() -> dict:
    """Returns the rows at the serving path's largest shapes, keyed by
    kernel name, for the ``kernels`` line."""
    import torch

    from repro_torch.kernels.circ_conv import ops as circ_ops
    from repro_torch.kernels.circ_conv import ref as circ_ref
    from repro_torch.kernels.qmatmul import ops as qops
    from repro_torch.kernels.qmatmul import ref as qref
    from repro_torch.kernels.unbind_classify import ops as uc_ops
    from repro_torch.kernels.unbind_classify import ref as uc_ref

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
                       "bound_ms": bound, "bound_by": by,
                       "bound_units": "f32 CUDA cores"}
                emit(row)
                if (mode, n, d) == ("conv", 64, 256):
                    main["circ_conv"] = row
                if (mode, n, d) == ("conv", 8, 256):  # 39 of NVSA's 42 calls
                    main["circ_conv_served"] = row
    strided_circ_rows(gen)
    for int4 in (False, True):
        for m, k, n in ((16, 128, 5), (64, 128, 6), (64, 128, 8), (67, 130, 7),
                        (512, 1024, 256)):
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
            check(torch.equal(got, want),
                  f"qmatmul int4={int4} {(m, k, n)}: output differs from the plain version")
            library_ms, library = None, "n/a: torch._int_mm needs M > 16, K and N % 8"
            if m > 16 and k % 8 == 0 and n_out % 8 == 0:
                def int_mm(xq=xq, w_full=w_full, xs=xs, ws=ws):
                    return torch._int_mm(xq, w_full).float() * (xs[:, None] * ws)

                check(torch.equal(int_mm(), want), "qmatmul library chain differs")
                library_ms = cuda_ms(int_mm)
                library = ("torch._int_mm(xq, w).float() * (xs[:, None] * ws): the "
                           "whole function, 4 calls")
            bound, by = qmm_bound(m, k, n_out, int4)
            row = {"kernel": "qmatmul", "int4": int4, "shape": [m, k, n],
                   "max_abs_err": float((got - want).abs().max()),
                   "max_rel_err": rel,
                   "kernel_ms": cuda_ms(lambda: qops.qmatmul(xq, wq, xs, ws, int4)),
                   "kernel_device_ms": graph_ms(
                       lambda: qops.qmatmul(xq, wq, xs, ws, int4)),
                   "plain_ms": cuda_ms(lambda: qref.qmatmul_ref(xq, wq, xs, ws, int4)),
                   "library_ms": library_ms, "library": library,
                   "bound_ms": bound, "bound_by": by,
                   "bound_units": "int8 tensor cores"}
            emit(row)
            if (int4, m, k, n) == (False, 64, 128, 8):
                main["qmatmul"] = row
    k, blocks, c = 2, 4, 5
    for d in (128, 256):
        for n in (1, 8, 13):
            keys = torch.randn(k, blocks, d, device="cuda", generator=gen) / d ** 0.5
            x = torch.randn(n, blocks, d, device="cuda", generator=gen)
            w = torch.randn(blocks, d, c, device="cuda", generator=gen) / (blocks * d) ** 0.5
            bias = torch.randn(1, c, device="cuda", generator=gen)
            got = uc_ops.fused_unbind_classify(keys, x, w, bias)
            again = uc_ops.fused_unbind_classify(keys, x, w, bias)
            want = uc_ref.fused_unbind_classify_ref(keys, x, w, bias)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            check(err <= 1e-3, f"unbind_classify {(n, k, blocks, d, c)}: max abs "
                               f"err {err} > 1e-3")
            check(torch.equal(got, again),
                  f"unbind_classify {(n, k, blocks, d, c)}: launches differ")

            def fft_chain(keys=keys, x=x, w=w, bias=bias, n=n, d=d):
                fk = torch.fft.rfft(keys, dim=-1)
                fx = torch.fft.rfft(x, dim=-1)
                u = torch.fft.irfft(fk.conj()[None] * fx[:, None], n=d, dim=-1)
                return torch.addmm(bias, u.reshape(n * k, blocks * d),
                                   w.reshape(blocks * d, c))

            lib_err = float((fft_chain().reshape(n, k, c) - want).abs().max())
            check(lib_err <= 1e-3, f"unbind_classify library chain err {lib_err}")
            bound, by, units = uc_bound(n, k, blocks, d, c)
            row = {"kernel": "unbind_classify", "shape": [n, k, blocks, d, c],
                   "max_abs_err": err,
                   "kernel_ms": cuda_ms(
                       lambda: uc_ops.fused_unbind_classify(keys, x, w, bias)),
                   "kernel_device_ms": graph_ms(
                       lambda: uc_ops.fused_unbind_classify(keys, x, w, bias)),
                   "plain_ms": cuda_ms(
                       lambda: uc_ref.fused_unbind_classify_ref(keys, x, w, bias)),
                   "library_ms": cuda_ms(fft_chain),
                   "library": "rfft, rfft, mul (conj), irfft, addmm (5 calls)",
                   "bound_ms": bound, "bound_by": by, "bound_units": units}
            emit(row)
            if (n, d) == (8, 128):
                main["unbind_classify"] = row
            if (n, d) == (8, 256):
                main["unbind_classify_d256"] = row
    main.update(dict_kernel_rows(gen))
    main.update(match_kernel_rows(gen))
    main.update(flash_kernel_rows(gen))
    return main


def strided_circ_rows(gen) -> None:
    """circ_elem on the operands NVSA's served binds hand it, at the served
    (8, 4, 256) and at (64, 4, 256), f32 and bf16: row slices ``codes[:,
    r0]`` of an (n, 8, 4, 256) tensor, a key broadcast over the batch
    (``circ_bind`` with ``key[None]``), a key broadcast over two lead dims
    (``key[None, None]`` against (n, 8, 4, 256), merged to stride 0), and a
    row slice one element past a 16-byte boundary (element loads).  Each:
    one launch and one allocation (no copy), bit for bit the call on
    contiguous copies and itself, within 1e-3 (bf16: + one bf16 step) of the
    plain version; timed as views and as the copies the parent made."""
    import torch

    from repro_torch.backend import registry
    from repro_torch.kernels.circ_conv import ops as circ_ops
    from repro_torch.kernels.circ_conv import ref as circ_ref

    for rows in (8, 64):
        for dtype in (torch.float32, torch.bfloat16):
            codes = torch.randn(rows, 8, 4, 256, device="cuda", generator=gen).to(dtype)
            odd = torch.randn(rows, 8, 4, 257, device="cuda", generator=gen).to(dtype)
            key = torch.randn(4, 256, device="cuda", generator=gen).to(dtype)
            cases = {"row slices": (circ_ops.circ_elem, codes[:, 1], codes[:, 0]),
                     "key over one lead dim": (circ_ops.circ_bind, codes[:, 1], key[None]),
                     "key over two lead dims": (circ_ops.circ_bind, codes[: rows // 8],
                                                key[None, None]),
                     "unaligned row slices": (circ_ops.circ_elem, odd[:, 1, :, 1:],
                                              odd[:, 2, :, 1:])}
            for case, (call, x, y) in cases.items():
                xx, yy = torch.broadcast_tensors(x, y)
                check(not (xx.is_contiguous() and yy.is_contiguous()), f"{case}: no view")
                torch.cuda.synchronize()
                launches = registry.LAUNCHES["circ_conv"]
                allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
                got = call(x, y, "conv")
                torch.cuda.synchronize()
                check(registry.LAUNCHES["circ_conv"] == launches + 1
                      and torch.cuda.memory_stats()["allocation.all.allocated"]
                      == allocs + 1, f"circ_elem {case}: a copy or another launch")
                xc, yc = xx.contiguous(), yy.contiguous()
                check(torch.equal(got, call(xc, yc, "conv"))
                      and torch.equal(got, call(x, y, "conv")),
                      f"circ_elem {case} {dtype}: not bit-identical to contiguous copies")
                rtol = BF16_STEP if dtype == torch.bfloat16 else 0.0
                err = close(got, circ_ref.circ_elem_ref(xx, yy, "conv"), 1e-3, rtol)
                emit({"kernel": "circ_conv", "operands": case,
                      "dtype": str(dtype).split(".")[1], "shape": [rows, 4, 256],
                      "launches": 1, "allocations": 1, "max_abs_err": err,
                      "bit_identical_to_contiguous": True,
                      "kernel_ms": cuda_ms(lambda: call(x, y, "conv")),
                      "kernel_device_ms": graph_ms(lambda: call(x, y, "conv")),
                      "with_copies_ms": cuda_ms(
                          lambda: call(xx.contiguous(), yy.contiguous(), "conv"))})


def unit_codes(gen, *shape, dtype=None):
    """Random block codes of unit norm per block, on the card."""
    import torch

    v = torch.randn(*shape, device="cuda", generator=gen)
    v = v / v.norm(dim=-1, keepdim=True)
    return v if dtype is None else v.to(dtype)


BF16_STEP = 2 ** -7  # one bf16 step, relative: where both round an f32 result to bf16
# f32 flash_attn's limit: its 3xTF32 products keep f32 accuracy (a few 1e-6
# at llama3.2-3b's width); products of operands rounded once to tf32 (the
# hi/lo split lost) miss it by far, which ``single_tf32_attention`` shows
FLASH_F32_ATOL = 2e-5


def close(got, want, atol: float, rtol: float = 0.0) -> float:
    """Checks |got - want| <= atol + rtol * |want| everywhere and returns the
    plain max abs error for the row."""
    err = (got.float() - want.float()).abs()
    check(bool((err <= atol + rtol * want.float().abs()).all()),
          f"max abs err {float(err.max())} beyond atol {atol} + rtol {rtol}")
    return float(err.max())


def dict_kernel_rows(gen) -> dict:
    import torch

    from repro_torch.kernels.circ_conv import ops as circ_ops
    from repro_torch.kernels.circ_conv import ref as circ_ref

    main = {}
    for mode, (n, m, b, d), dtype in (("conv", (256, 16, 4, 256), torch.float32),
                                      ("corr", (256, 16, 4, 256), torch.float32),
                                      ("conv", (67, 5, 4, 128), torch.float32),
                                      ("conv", (256, 16, 4, 256), torch.bfloat16)):
        x = unit_codes(gen, n, b, d, dtype=dtype)
        dic = unit_codes(gen, m, b, d, dtype=dtype)
        got = circ_ops.circ_bind_dict(x, dic, mode)
        want = circ_ref.circ_dict_ref(x, dic, mode).transpose(1, 2)
        torch.cuda.synchronize()
        err = close(got, want, 1e-3, BF16_STEP if dtype == torch.bfloat16 else 0.0)

        def fft_chain(x=x, dic=dic, mode=mode, d=d):
            fx = torch.fft.rfft(x, dim=-1)
            fd = torch.fft.rfft(dic, dim=-1)
            prod = (fx if mode == "conv" else fx.conj())[:, None] * fd[None]
            return torch.fft.irfft(prod, n=d, dim=-1)

        library_ms, library = None, "n/a: torch.fft takes no bfloat16"
        if dtype == torch.float32:
            lib_err = float((fft_chain() - want).abs().max())
            check(lib_err <= 1e-3, f"circ_dict library chain err {lib_err}")
            library_ms = cuda_ms(fft_chain)
            library = "rfft, rfft, broadcast mul, irfft (4 calls)"
        elt = x.element_size()
        bound, by, units = dict_bound(n, m, b, d, elt)
        row = {"kernel": "circ_dict", "mode": mode, "dtype": str(dtype).split(".")[1],
               "shape": [n, m, b, d], "max_abs_err": err,
               "kernel_ms": cuda_ms(lambda: circ_ops.circ_bind_dict(x, dic, mode)),
               "kernel_device_ms": graph_ms(
                   lambda: circ_ops.circ_bind_dict(x, dic, mode)),
               "plain_ms": cuda_ms(
                   lambda: circ_ref.circ_dict_ref(x, dic, mode).transpose(1, 2)),
               "library_ms": library_ms, "library": library,
               "bound_ms": bound, "bound_by": by, "bound_units": units}
        emit(row)
        if (n, dtype) == (256, torch.float32):
            main["circ_dict" if mode == "conv" else "circ_dict_corr"] = row
        if (n, dtype) == (256, torch.bfloat16):
            main["circ_dict_bf16"] = row
    return main


def match_kernel_rows(gen) -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.backend import registry
    from repro_torch.kernels import _build
    from repro_torch.kernels.simd_fused import ops as simd_ops
    from repro_torch.kernels.simd_fused import ref as simd_ref

    main = {}
    for (n, m, b, d), temp, dtype in (((512, 16, 4, 256), 0.1, torch.float32),
                                      ((512, 16, 4, 256), 0.1, torch.bfloat16),
                                      ((67, 5, 4, 128), 1.0, torch.float32),
                                      ((64, 1024, 4, 256), 0.1, torch.float32)):
        q = torch.randn(n, b, d, device="cuda", generator=gen).to(dtype)
        dic = torch.randn(m, b, d, device="cuda", generator=gen).to(dtype)
        before = registry.LAUNCHES["simd_fused"]
        got = simd_ops.fused_match_prob(q, dic, temp)
        launches = registry.LAUNCHES["simd_fused"] - before
        again = simd_ops.fused_match_prob(q, dic, temp)
        want = simd_ref.fused_match_prob_ref(q, dic, temp)
        torch.cuda.synchronize()
        check(launches == 1, f"match_prob {(n, m, b, d)}: {launches} launches a call")
        # far inside the registry epsilon (1e-3) and below a probability of
        # 1/M, so that a slice of the M = 1024 dictionary read at the wrong
        # offset shows
        err = close(got, want, 1e-6, 1e-4)
        check(torch.equal(got, again), f"match_prob {(n, m, b, d)}: launches differ")

        def lib_chain(q=q, dic=dic, temp=temp, n=n, m=m, b=b):
            qn = F.normalize(q, dim=-1).reshape(n, -1)
            dn = F.normalize(dic, dim=-1).reshape(m, -1)
            return torch.softmax((qn @ dn.T) / (b * temp), dim=-1)

        lib_err = float((lib_chain().float() - want).abs().max())
        check(lib_err <= 1e-3 or dtype == torch.bfloat16,
              f"match_prob library chain err {lib_err}")
        bound, by = match_bound(n, m, b, d, q.element_size())
        row = {"kernel": "simd_fused", "dtype": str(dtype).split(".")[1],
               "shape": [n, m, b, d], "temp": temp, "max_abs_err": err,
               "kernel_ms": cuda_ms(lambda: simd_ops.fused_match_prob(q, dic, temp)),
               "kernel_device_ms": graph_ms(
                   lambda: simd_ops.fused_match_prob(q, dic, temp)),
               "plain_ms": cuda_ms(lambda: simd_ref.fused_match_prob_ref(q, dic, temp)),
               "library_ms": cuda_ms(lib_chain),
               "library": "normalize, normalize, matmul, softmax (4 calls)",
               "bound_ms": bound, "bound_by": by,
               "bound_units": "f32 CUDA cores", "launches_per_call": launches,
               "splits": simd_ops.cluster_size(n, m, b, d)}
        if row["splits"] > 1:
            # the same launch with the dictionary left whole (S = 1): what
            # the cluster split buys
            one = torch.empty_like(got)

            def whole(q=q, dic=dic, one=one, n=n, m=m, b=b, d=d, temp=temp):
                _build.launch("simd_fused", q.get_device(), q.data_ptr(), dic.data_ptr(),
                              one.data_ptr(), n, m, b, d, 1, float(temp),
                              simd_ops._DTYPES[q.dtype])

            whole()
            torch.cuda.synchronize()
            row["max_abs_err_splits_1"] = close(one, want, 1e-6, 1e-4)
            row["device_ms_splits_1"] = graph_ms(whole)
        emit(row)
        key = {(512, torch.float32): "simd_fused", (512, torch.bfloat16): "simd_fused_bf16",
               (67, torch.float32): "simd_fused_d128", (64, torch.float32): "simd_fused_m1024"}
        main[key[n, dtype]] = row
    return main


def tf32(x):
    """x (f32) rounded to tf32, to nearest with ties away from zero, as the
    kernel's ``split_tf32`` rounds its hi part."""
    import torch

    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def single_tf32_attention(q, k, v, scale: float, causal: bool):
    """(BH, S, hd) f32: the f32 kernel's arithmetic with the hi/lo split
    dropped, one TF32 product for each f32 product.  q, k, the
    probabilities and v are rounded to tf32 before their products, which
    are then exact (f64), so the error against the plain version is the
    rounding's alone."""
    import torch

    from repro_torch.kernels.flash_attn import ref as flash_ref

    s = torch.einsum("bqd,bkd->bqk", tf32(q).double(), tf32(k).double()) * scale
    if causal:
        mask = torch.ones(q.shape[1], k.shape[1], dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, flash_ref.NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)).float()
    out = torch.einsum("bqk,bkd->bqd", tf32(p).double(), tf32(v).double())
    return (out / p.double().sum(dim=-1, keepdim=True)).float()


def flash_kernel_rows(gen) -> dict:
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend

    from repro_torch.kernels.flash_attn import ops as flash_ops
    from repro_torch.kernels.flash_attn import ref as flash_ref

    main = {}
    b, h, hd = 1, 24, 128
    scale = hd ** -0.5
    for sq, skv, causal, dtype in ((2048, 2048, True, torch.float32),
                                   (2048, 2048, True, torch.bfloat16),
                                   (100, 300, True, torch.float32),
                                   (100, 300, True, torch.bfloat16),
                                   (1000, 1000, True, torch.float32),
                                   (1000, 1000, True, torch.bfloat16)):
        q = torch.randn(b, sq, h, hd, device="cuda", generator=gen).to(dtype)
        k = torch.randn(b, skv, h, hd, device="cuda", generator=gen).to(dtype)
        v = torch.randn(b, skv, h, hd, device="cuda", generator=gen).to(dtype)
        flat = lambda t: t.transpose(1, 2).reshape(b * h, t.shape[1], hd)  # noqa: E731
        got = flash_ops.flash_mha(q, k, v, scale, causal)
        want = flash_ref.flash_attention_ref(flat(q), flat(k), flat(v), scale=scale,
                                             causal=causal)
        want = want.reshape(b, h, sq, hd).transpose(1, 2)
        torch.cuda.synchronize()
        f32 = dtype == torch.float32
        err = close(got, want, FLASH_F32_ATOL if f32 else 1e-3, 0.0 if f32 else BF16_STEP)
        # SDPA's is_causal is aligned at position 0 too (tril of ones(Sq, Skv))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def sdpa(qt=qt, kt=kt, vt=vt, causal=causal):
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                  scale=scale)

        lib_err = float((sdpa().transpose(1, 2).float() - want.float()).abs().max())
        check(lib_err <= (1e-3 if dtype == torch.float32 else 3e-2),
              f"flash library call err {lib_err}")
        backend = SDPBackend(torch._fused_sdp_choice(qt, kt, vt, is_causal=causal,
                                                     scale=scale)).name
        bound, by, units = flash_bound(b, sq, skv, h, hd, causal, q.element_size())
        row = {"kernel": "flash_attn", "dtype": str(dtype).split(".")[1],
               "shape": [b, sq, skv, h, hd], "causal": causal, "max_abs_err": err,
               "kernel_ms": cuda_ms(lambda: flash_ops.flash_mha(q, k, v, scale, causal)),
               "kernel_device_ms": graph_ms(
                   lambda: flash_ops.flash_mha(q, k, v, scale, causal)),
               "plain_ms": cuda_ms(lambda: flash_ref.flash_attention_ref(
                   flat(q), flat(k), flat(v), scale=scale, causal=causal)),
               "library_ms": cuda_ms(sdpa),
               "library": "scaled_dot_product_attention, is_causal aligned at 0 "
                          "like the kernel (1 call)",
               "library_backend": backend,
               "bound_ms": bound, "bound_by": by, "bound_units": units}
        if f32 and sq == 2048:
            single = single_tf32_attention(flat(q), flat(k), flat(v), scale, causal)
            single = single.reshape(b, h, sq, hd).transpose(1, 2)
            row["single_tf32_max_abs_err"] = float((single - want).abs().max())
            check(row["single_tf32_max_abs_err"] > FLASH_F32_ATOL,
                  f"one tf32 product per f32 product: err "
                  f"{row['single_tf32_max_abs_err']} is within the f32 limit "
                  f"{FLASH_F32_ATOL}, which so would not show a lost split")
        emit(row)
        if sq == 2048:
            main["flash_attn" if dtype == torch.float32 else "flash_attn_bf16"] = row
    return main


def host_us(fn, calls: int = 200, windows: int = 15) -> float:
    """Host time per call of ``fn`` in µs: the median over ``windows`` of
    the host clock around ``calls`` back-to-back calls, with no
    synchronisation inside a window (so the enqueue, not the device's work;
    200 launches stay well inside the launch queue), after a warm-up call."""
    import torch

    fn()
    per_call = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per_call.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return statistics.median(per_call)


def host_breakdown() -> list[dict]:
    """Host time of each step of the circ_elem, qmatmul, circ_bind_dict,
    fused_unbind_classify and fused_match_prob wrappers, at their paths'
    shapes: the whole call, its parts as the wrapper of the importable
    ``repro_torch`` makes them, and each torch or ctypes step on its own.
    The C entry point is called with the arguments its declared signature
    takes (``_build.ENTRY_POINTS``), so one function times this tree's
    wrappers and an earlier tree's alike.  Returns the rows."""
    import torch

    from repro_torch.backend import registry
    from repro_torch.kernels import _build
    from repro_torch.kernels.circ_conv import ops as circ_ops
    from repro_torch.kernels.qmatmul import ops as qops
    from repro_torch.kernels.simd_fused import ops as simd_ops
    from repro_torch.kernels.unbind_classify import ops as uc_ops

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    dev = torch.device("cuda", torch.cuda.current_device())
    idx = dev.index
    rows = []
    # circ_elem at (64, 4, 256) conv, then the served bind: a row slice of an
    # (n, 8, B, d) tensor against a key broadcast over the batch
    x = torch.randn(64, 4, 256, device="cuda", generator=gen)
    y = torch.randn(64, 4, 256, device="cuda", generator=gen)
    codes = torch.randn(8, 8, 4, 256, device="cuda", generator=gen)
    key = torch.randn(4, 256, device="cuda", generator=gen)
    out = torch.empty_like(x)
    fn = _build.entry("circ_conv")
    stream = torch.cuda.current_stream(dev).cuda_stream
    if len(_build.ENTRY_POINTS["circ_conv"][1]) == 8:   # (x, y, out, rows, d, ...)
        args = (x.data_ptr(), y.data_ptr(), out.data_ptr(), 256, 256, 0, 0, stream)
    else:                                                # with N, B and strides
        args = (x.data_ptr(), y.data_ptr(), out.data_ptr(), 64, 4, 256,
                1024, 256, 1024, 256, 0, 0, stream)
    def guarded(t):
        with torch.cuda.device(t.device):
            pass

    common = {
        "registry.note_call": lambda: registry.note_call("circ_conv"),
        "registry.count_launch": lambda: registry.count_launch("circ_conv"),
        "_build.entry": lambda: _build.entry("circ_conv"),
        "torch.empty_like": lambda: torch.empty_like(x),
        "torch.empty_like(x, memory_format=contiguous)":
            lambda: torch.empty_like(x, memory_format=torch.contiguous_format),
        "x.new_empty(x.shape)": lambda: x.new_empty(x.shape),
        "x.contiguous() (already contiguous)": lambda: x.contiguous(),
        "x.data_ptr()": lambda: x.data_ptr(),
        "x.device": lambda: x.device,
        "x.get_device()": lambda: x.get_device(),
        "x.stride()": lambda: x.stride(),
        "with torch.cuda.device(x.device): pass": lambda: guarded(x),
        "torch.cuda.current_stream(dev).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "torch._C._cuda_getCurrentRawStream(idx)":
            lambda: torch._C._cuda_getCurrentRawStream(idx),
        "torch._C._cuda_getDevice()": lambda: torch._C._cuda_getDevice(),
    }
    steps = {
        "circ_elem (whole call)": lambda: circ_ops.circ_elem(x, y, "conv"),
        "_CircElem.apply": lambda: circ_ops._CircElem.apply(x, y, "conv"),
        "_launch": lambda: circ_ops._launch(x, y, "conv"),
        "C entry point (ctypes, launch included)": lambda: fn(*args),
        **({"_build.launch (entry, raw stream, ctypes, check)":
            lambda: _build.launch("circ_conv", idx, *args[:-1])}
           if hasattr(_build, "launch") else {}),
        "circ_bind, served row slice x broadcast key":
            lambda: circ_ops.circ_bind(codes[:, 1], key[None], "conv"),
        "torch.broadcast_tensors (row slice, key)":
            lambda: torch.broadcast_tensors(codes[:, 1], key[None]),
        "row slice .contiguous() (a copy kernel)": lambda: codes[:, 1].contiguous(),
        **common,
    }
    us = {name: host_us(step) for name, step in steps.items()}
    rows.append({"phase": "host_breakdown", "kernel": "circ_conv",
                 "shape": [64, 4, 256], "us_per_call": us})

    xq = torch.randint(-128, 128, (64, 128), device="cuda", generator=gen,
                       dtype=torch.int8)
    wq = torch.randint(-128, 128, (128, 8), device="cuda", generator=gen,
                       dtype=torch.int8)
    xs = torch.rand(64, device="cuda", generator=gen) + 0.01
    ws = torch.rand(8, device="cuda", generator=gen) + 0.01
    feats = torch.randn(64, 128, device="cuda", generator=gen)
    w = torch.randn(128, 8, device="cuda", generator=gen)
    qout = torch.empty((64, 8), device="cuda")
    qfn = _build.entry("qmatmul")
    qargs = (xq.data_ptr(), wq.data_ptr(), xs.data_ptr(), ws.data_ptr(),
             qout.data_ptr(), 64, 8, 128, 0, stream)
    steps = {
        "qmatmul (whole call)": lambda: qops.qmatmul(xq, wq, xs, ws, False),
        "_launch": lambda: qops._launch(xq, wq, xs, ws, False),
        "C entry point (ctypes, launch included)": lambda: qfn(*qargs),
        "qdense (quantise x and w, then qmatmul)": lambda: qops.qdense(feats, w),
        "torch.empty((M, N), device=x.device)":
            lambda: torch.empty((64, 8), dtype=torch.float32, device=xq.device),
        "x.new_empty((M, N), dtype=float32)":
            lambda: xq.new_empty((64, 8), dtype=torch.float32),
    }
    us = {name: host_us(step) for name, step in steps.items()}
    rows.append({"phase": "host_breakdown", "kernel": "qmatmul",
                 "shape": [64, 128, 8], "us_per_call": us})

    # circ_bind_dict at the ops shape (256, 16, 4, 256) conv
    xd = torch.randn(256, 4, 256, device="cuda", generator=gen)
    dd = torch.randn(16, 4, 256, device="cuda", generator=gen)
    dout = torch.empty((256, 16, 4, 256), device="cuda")
    dfn = _build.entry("circ_dict")
    dargs = (xd.data_ptr(), dd.data_ptr(), dout.data_ptr(), 256, 16, 4, 256, 0, 0, stream)
    steps = {
        "circ_bind_dict (whole call)": lambda: circ_ops.circ_bind_dict(xd, dd),
        "_launch_dict": lambda: circ_ops._launch_dict(xd, dd, "conv"),
        "C entry point (ctypes, launch included)": lambda: dfn(*dargs),
        "registry.refuse_grad (two tensors)":
            lambda: registry.refuse_grad("circ_dict", xd, dd),
        "dictionary.device != x.device": lambda: dd.device != xd.device,
        "dictionary.get_device() != x.get_device()":
            lambda: dd.get_device() != xd.get_device(),
        "torch.empty((N, M, B, d), dtype=, device=x.device)":
            lambda: torch.empty((256, 16, 4, 256), dtype=xd.dtype, device=xd.device),
        "x.new_empty((N, M, B, d))": lambda: xd.new_empty((256, 16, 4, 256)),
    }
    us = {name: host_us(step) for name, step in steps.items()}
    rows.append({"phase": "host_breakdown", "kernel": "circ_dict",
                 "shape": [256, 16, 4, 256], "us_per_call": us})

    # fused_unbind_classify at MIMONet's (8, 2, 4, 128, 5)
    keys = torch.randn(2, 4, 128, device="cuda", generator=gen)
    xu = torch.randn(8, 4, 128, device="cuda", generator=gen)
    wu = torch.randn(4, 128, 5, device="cuda", generator=gen)
    bu = torch.randn(1, 5, device="cuda", generator=gen)
    uout = torch.empty((8, 2, 5), device="cuda")
    ufn = _build.entry("unbind_classify")
    uargs = (keys.data_ptr(), xu.data_ptr(), wu.data_ptr(), bu.data_ptr(),
             uout.data_ptr(), 8, 2, 4, 128, 5, stream)
    four = (keys, xu, wu, bu)
    steps = {
        "fused_unbind_classify (whole call)":
            lambda: uc_ops.fused_unbind_classify(keys, xu, wu, bu),
        "_FusedUnbindClassify.apply":
            lambda: uc_ops._FusedUnbindClassify.apply(keys, xu, wu, bu),
        "_launch": lambda: uc_ops._launch(keys, xu, wu, bu),
        "C entry point (ctypes, launch included)": lambda: ufn(*uargs),
        "four .contiguous() (already contiguous)":
            lambda: [t.contiguous() for t in four],
        "four t.device != x.device": lambda: [t.device != xu.device for t in four],
        "four t.get_device()": lambda: [t.get_device() for t in four],
        "torch.is_grad_enabled() and any(t.requires_grad)":
            lambda: torch.is_grad_enabled() and any(t.requires_grad for t in four),
        "torch.empty((N, K, C), device=x.device)":
            lambda: torch.empty((8, 2, 5), dtype=torch.float32, device=xu.device),
        "x.new_empty((N, K, C))": lambda: xu.new_empty((8, 2, 5)),
    }
    us = {name: host_us(step) for name, step in steps.items()}
    rows.append({"phase": "host_breakdown", "kernel": "unbind_classify",
                 "shape": [8, 2, 4, 128, 5], "us_per_call": us})

    # fused_match_prob at the ops shape (512, 16, 4, 256), temp 0.1
    qm = torch.randn(512, 4, 256, device="cuda", generator=gen)
    dm = torch.randn(16, 4, 256, device="cuda", generator=gen)
    mout = torch.empty((512, 16), device="cuda")
    mfn = _build.entry("simd_fused")
    if len(_build.ENTRY_POINTS["simd_fused"][1]) == 12:  # with an f32 scratch, chunk
        scratch = torch.empty((16, 4, 256), device="cuda")
        margs = (qm.data_ptr(), dm.data_ptr(), scratch.data_ptr(), mout.data_ptr(),
                 512, 16, 4, 256, 16, 0.1, 0, stream)
    else:                                                # with the cluster size
        margs = (qm.data_ptr(), dm.data_ptr(), mout.data_ptr(), 512, 16, 4, 256, 1, 0.1,
                 0, stream)
    steps = {
        "fused_match_prob (whole call)": lambda: simd_ops.fused_match_prob(qm, dm, 0.1),
        "_FusedMatchProb.apply": lambda: simd_ops._FusedMatchProb.apply(qm, dm, 0.1),
        "_launch": lambda: simd_ops._launch(qm, dm, 0.1),
        "C entry point (ctypes, launch included)": lambda: mfn(*margs),
        "registry.note_call": lambda: registry.note_call("simd_fused"),
        "two .contiguous() (already contiguous)": lambda: (qm.contiguous(), dm.contiguous()),
        "two .is_contiguous()": lambda: qm.is_contiguous() and dm.is_contiguous(),
        "torch.is_grad_enabled() and (q or dict).requires_grad":
            lambda: torch.is_grad_enabled() and (qm.requires_grad or dm.requires_grad),
        "max_entries(B, d)": lambda: simd_ops.max_entries(4, 256),
        **({"cluster_size(N, M, B, d)": lambda: simd_ops.cluster_size(512, 16, 4, 256)}
           if hasattr(simd_ops, "cluster_size") else {}),
        "torch.empty((N, M), device=q.device)":
            lambda: torch.empty((512, 16), dtype=torch.float32, device=qm.device),
        "q.new_empty((N, M), dtype=float32)":
            lambda: qm.new_empty((512, 16), dtype=torch.float32),
        "torch.empty((M, B, d)) (an f32 scratch of the dictionary)":
            lambda: torch.empty((16, 4, 256), dtype=torch.float32, device=qm.device),
    }
    us = {name: host_us(step) for name, step in steps.items()}
    rows.append({"phase": "host_breakdown", "kernel": "simd_fused",
                 "shape": [512, 16, 4, 256], "us_per_call": us})
    torch.cuda.synchronize()
    return rows


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
            RATES[(f"nvsa/{variant}/{prec}", schedule)] = run["problems_per_s"]
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
    for name in ("circ_conv", "qmatmul"):
        check(counts[name] > 0, f"kernel {name} was not launched on the NVSA path")
    return counts


# -- phases 4 and 5 -------------------------------------------------------------


def serve_three(eng, requests, label: str, want) -> dict:
    """Serve ``requests`` under the sequential, overlap and fused schedules,
    a warm-up run and a measured run each, checking each run's kernel
    launches against ``want(schedule) -> {kernel: count}``.  Returns
    ``{schedule: results of the measured run}``."""
    import numpy as np

    from repro_torch.backend import registry

    out = {}
    for schedule in ("sequential", "overlap", "fused"):
        fallback0 = eng.stats["fused_fallback_groups"]
        for _ in range(2):  # the first run of a shape is warmup
            before = dict(registry.LAUNCHES)
            res = eng.run(requests, schedule=schedule)
            run = eng.last_run
            got = {k: registry.LAUNCHES[k] - before[k] for k in before}
            expect = dict.fromkeys(before, 0) | want(schedule)
            check(got == expect, f"{label}/{schedule}: launches {got}, want {expect}")
        check(not run["warmup"], f"{label}/{schedule}: no measured run")
        RATES[(label, schedule)] = run["problems_per_s"]
        logp = np.stack([res[u].answer_logprobs for u in sorted(res)])
        check(bool(np.isfinite(logp).all()), f"{label}/{schedule}: non-finite output")
        emit({"phase": "serve", "workload": label, "schedule": schedule,
              "requests": len(res), "problems_per_s": run["problems_per_s"],
              "wall_time_s": run["wall_time_s"], "warmup": run["warmup"],
              "stage_time_s": run["stage_time_s"], "launches": got,
              "fused_fallback_groups": eng.stats["fused_fallback_groups"] - fallback0})
        out[schedule] = res
    return out


def stacked(res, field: str = "answer_logprobs"):
    import numpy as np

    return np.stack([getattr(res[u], field) for u in sorted(res)])


def phase_mimonet() -> dict[str, int]:
    """MIMONet served at make_config(); returns the path's launch counts."""
    import numpy as np
    import torch

    from repro_torch import interop
    from repro_torch.backend import registry
    from repro_torch.configs import base as cb
    from repro_torch.models import mimonet as mm
    from repro_torch.serve.reason import ReasonConfig, ReasonEngine
    from repro_torch.serve.schedule import compose_stages
    from repro_torch.vsa import ops as vsa

    entry = cb.REASON_WORKLOADS["mimonet"]
    cfg = entry.make_config()
    consts = entry.make_consts(cfg, torch.Generator().manual_seed(SEED))
    gpu_consts = interop.to_device(consts, "cuda")
    factory, truth = entry.make_requests(cfg, N_REQUESTS, SEED)
    requests = list(factory())
    groups = math.ceil(N_REQUESTS / 8)
    rcfg = ReasonConfig(batch_size=8, buckets=BUCKETS, max_inflight=2)

    registry.reset_launches()
    forced = cb.compile_reason_schedule("mimonet", cfg, consts=gpu_consts,
                                        batch_size=BUCKETS, fused=True)
    check(forced.fused_ok and forced.fused_forced, "forced fused schedule refused")
    eng = ReasonEngine(forced, rcfg, consts=gpu_consts)

    def want_forced(schedule):
        if schedule == "fused":
            return {"circ_conv": groups, "qmatmul": 0, "unbind_classify": groups}
        return {"circ_conv": 2 * groups, "qmatmul": 0, "unbind_classify": 0}

    runs = serve_three(eng, requests, "mimonet/forced-fused", want_forced)
    check(eng.stats["fused_fallback_groups"] == 0, "forced schedule fell back")
    check(np.array_equal(stacked(runs["overlap"]), stacked(runs["sequential"])),
          "mimonet: overlap answers differ from sequential")

    auto = cb.reason_engine("mimonet", cfg, rcfg, consts=consts)
    sched = auto.schedules["default"]
    check(sched.fused_equivalence == "epsilon" and not sched.fused_ok
          and "unbind_classify" in sched.fused_lowering_diff,
          f"negotiated {sched.fused_equivalence} {sched.fused_lowering_diff}")
    auto_runs = serve_three(
        auto, requests, "mimonet/negotiated",
        lambda s: {"circ_conv": 2 * groups, "qmatmul": 0, "unbind_classify": 0})
    check(auto.stats["fused_fallback_groups"] == 2 * groups,
          f"negotiated schedule: {auto.stats['fused_fallback_groups']} fallback "
          f"groups in two fused runs of {groups} groups")
    counts = dict(registry.LAUNCHES)
    for name in ("circ_conv", "unbind_classify"):
        check(counts[name] > 0, f"kernel {name} was not launched on the MIMONet path")

    # logits of one full group: staged stages, fused list, and the CPU
    batch = torch.from_numpy(np.stack([r.images for r in requests[:8]]))
    staged_logits = compose_stages(forced.stages)(gpu_consts, batch.cuda())
    fused_logits = forced.fused_fn(gpu_consts, batch.cuda())
    cpu_logits = compose_stages(forced.stages)(consts, batch)
    fused_vs_staged = float((fused_logits - staged_logits).abs().max())
    gpu_vs_cpu = float((staged_logits.cpu() - cpu_logits).abs().max())
    fused_vs_cpu = float((fused_logits.cpu() - cpu_logits).abs().max())
    cpu = cb.reason_engine("mimonet", cfg, rcfg, consts=consts, device="cpu")
    cpu_logp = stacked(cpu.run(requests, schedule="sequential"))
    served = {s: float(np.abs(stacked(r) - cpu_logp).max())
              for s, r in (("staged", runs["sequential"]), ("fused", runs["fused"]),
                           ("negotiated fused", auto_runs["fused"]))}
    check(np.array_equal(stacked(auto_runs["fused"]), stacked(runs["sequential"])),
          "mimonet: the fallback answers differ from the staged ones")

    # unbinding recovers each channel, on the card
    keys = mm.mimonet_keys(cfg, torch.Generator().manual_seed(3)).cuda()
    codes = vsa.random_codebook(torch.Generator().manual_seed(4), cfg.n_channels,
                                cfg.blocks, cfg.d).cuda()
    sup = vsa.bind(codes, keys).sum(dim=0, keepdim=True)
    sims = [vsa.similarity(vsa.unbind(keys[c][None], sup), codes).cpu().tolist()
            for c in range(cfg.n_channels)]
    emit({"phase": "mimonet_checks", "fused_vs_staged_logits": fused_vs_staged,
          "gpu_vs_cpu_logits": gpu_vs_cpu, "fused_vs_cpu_logits": fused_vs_cpu,
          "served_logp_vs_cpu": served, "channel_similarities": sims,
          "accuracy": entry.score(runs["sequential"], truth()),
          "negotiated": [sched.fused_equivalence, sched.fused_epsilon,
                         list(sched.fused_lowering_diff)]})
    check(fused_vs_staged <= 1e-3, f"fused logits {fused_vs_staged} from staged")
    check(max(gpu_vs_cpu, fused_vs_cpu) <= 1e-3,
          f"GPU logits {gpu_vs_cpu} / fused {fused_vs_cpu} from the CPU's")
    check(max(served.values()) <= 1e-3, f"served log-probs vs the CPU: {served}")
    for c, row in enumerate(sims):
        check(int(np.argmax(row)) == c and row[c] > 0.6,
              f"channel {c}: similarities {row}")
    return counts


def phase_reasoners() -> dict[str, dict[str, int]]:
    """LVRF and PrAE served at make_config(); returns each path's launch
    counts."""
    import numpy as np
    import torch

    from repro_torch.backend import registry
    from repro_torch.configs import base as cb
    from repro_torch.serve.reason import ReasonConfig

    groups = math.ceil(N_REQUESTS / 8)
    rcfg = ReasonConfig(batch_size=8, buckets=BUCKETS, max_inflight=2)
    per_group = {"lvrf": 27, "prae": 0}
    paths = {}
    for model in ("lvrf", "prae"):
        entry = cb.REASON_WORKLOADS[model]
        cfg = entry.make_config()
        consts = entry.make_consts(cfg, torch.Generator().manual_seed(SEED))
        factory, truth = entry.make_requests(cfg, N_REQUESTS, SEED)
        requests = list(factory())
        answers = truth()
        want = {"circ_conv": per_group[model] * groups, "qmatmul": 0,
                "unbind_classify": 0}
        registry.reset_launches()
        for variant in ("oracle", "cnn"):
            label = f"{model}/{variant}"
            eng = cb.reason_engine(model, cfg, rcfg, consts=consts, variants=(variant,))
            check(eng.schedules[variant].fused_ok, f"{label}: fused not exact")
            runs = serve_three(eng, requests, label, lambda s: want)
            for s in ("overlap", "fused"):
                for field in ("answer_logprobs", "rule_posteriors"):
                    check(np.array_equal(stacked(runs[s], field),
                                         stacked(runs["sequential"], field)),
                          f"{label}: {s} {field} differ from sequential")
            cpu = cb.reason_engine(model, cfg, rcfg, consts=consts,
                                   variants=(variant,), device="cpu")
            cpu_res = cpu.run(requests, schedule="sequential")
            diff = {f: float(np.abs(stacked(cpu_res, f)
                                    - stacked(runs["sequential"], f)).max())
                    for f in ("answer_logprobs", "rule_posteriors")}
            acc = entry.score(runs["sequential"], answers)
            emit({"phase": "serve_vs_cpu", "workload": label, "max_abs_diff": diff,
                  "same_answers": int(sum(cpu_res[u].answer == runs["sequential"][u].answer
                                          for u in cpu_res)),
                  "accuracy": acc})
            check(max(diff.values()) <= 1e-3, f"{label}: GPU vs CPU {diff}")
            if label == "prae/oracle":
                check(acc >= 0.90, f"prae oracle accuracy {acc} < 0.90")
        paths[model] = dict(registry.LAUNCHES)
    check(paths["lvrf"]["circ_conv"] > 0, "circ_conv was not launched on the LVRF path")
    return paths


# -- phase 6 ------------------------------------------------------------------

DEPLOY_MODELS = ("nvsa", "mimonet", "lvrf", "prae")
DEPLOY_REQUESTS = 64    # per model
# the reference's deploy() of the same call on the CPU: DesignConfig.summary()
DEPLOY_TABLE = {
    "nvsa": {"AdArray (H, W, N)": (8, 32, 16), "partition": "13:3",
             "mode": "parallel", "t_para_cycles": 409616, "t_seq_cycles": 437522,
             "SIMD": 32, "MemA1": 589824, "MemA2": 589824, "MemB": 262144,
             "MemC": 1048576, "cache": 4980736},
    "mimonet": {"AdArray (H, W, N)": (8, 32, 16), "partition": "16:16",
                "mode": "sequential", "t_para_cycles": 65408,
                "t_seq_cycles": 65408, "SIMD": 16, "MemA1": 2097152,
                "MemA2": 196608, "MemB": 65536, "MemC": 131072, "cache": 4980736},
    "lvrf": {"AdArray (H, W, N)": (8, 32, 16), "partition": "13:3",
             "mode": "parallel", "t_para_cycles": 405506, "t_seq_cycles": 408260,
             "SIMD": 32, "MemA1": 589824, "MemA2": 393216, "MemB": 262144,
             "MemC": 1048576, "cache": 4587520},
    "prae": {"AdArray (H, W, N)": (8, 32, 16), "partition": "16:16",
             "mode": "sequential", "t_para_cycles": 373820,
             "t_seq_cycles": 373820, "SIMD": 32, "MemA1": 589824, "MemA2": 0,
             "MemB": 262144, "MemC": 1048576, "cache": 3801088},
}
# circ_conv launches per served group: NVSA at d = 256, MIMONet's bind and
# unbind (sequential plan), LVRF at d = 128, PrAE none
DEPLOY_CIRC_PER_GROUP = {"nvsa": 42, "mimonet": 2, "lvrf": 27, "prae": 0}
# (name, fraction of each model's sequential rate offered, seed): half, as
# four engines on one host thread would be offered twice what it serves
# alone, then a sixteenth, a quarter of it in all, below what it serves
DEPLOY_WINDOWS = (("half", 0.5, 100), ("sixteenth", 0.0625, 200))
# the sequential rate each model's offered load is a fraction of (phases 3-5)
DEPLOY_RATE_FROM = {"nvsa": "nvsa/cnn/fp32", "mimonet": "mimonet/negotiated",
                    "lvrf": "lvrf/cnn", "prae": "prae/cnn"}


def deploy_arrivals(dep, rates: dict[str, float], seed: int):
    """``DEPLOY_REQUESTS`` requests per model in one merged Poisson feed,
    each model at its own offered rate: the request streams and arrival
    seeds of ``Deployment.synthetic_traffic(DEPLOY_REQUESTS, seed)``."""
    from repro_torch.configs import base as cb
    from repro_torch.serve.frontdoor import merge_arrivals, poisson_arrivals

    streams = []
    for i, m in enumerate(dep.engines):
        factory, _ = cb.REASON_WORKLOADS[m].make_requests(
            dep.configs[m], DEPLOY_REQUESTS, seed=seed + i)
        streams.append(poisson_arrivals(m, factory(), rates[m], seed=seed + i))
    return merge_arrivals(*streams)


def phase_deploy() -> dict[str, int]:
    """The generator -> architecture loop on the card: ``deploy()`` of the
    four reasoners (nvsa at d = 256) behind one front door, ``warmup()``,
    then two windows of ``DEPLOY_REQUESTS`` requests per model, each model
    offered a fraction of its sequential rate of phases 3-5
    (``DEPLOY_WINDOWS``).  Returns the path's launch counts."""
    import collections

    import numpy as np

    from repro_torch.backend import registry
    from repro_torch.configs import base as cb
    from repro_torch.serve import schedule as sch
    from repro_torch.serve.deploy import Budget, Traffic, deploy

    registry.reset_launches()
    t0 = time.perf_counter()
    dep = deploy(list(DEPLOY_MODELS), Traffic(deadline_s=0.02),
                 Budget(max_pes=4096, max_batch=8), options={"nvsa": {"d": 256}},
                 preflight="off")
    deploy_s = time.perf_counter() - t0
    for m, eng in dep.engines.items():
        sched = eng.schedules[dep.variants[m]]
        design = dep.designs[m].summary()
        emit({"phase": "deploy_plan", "model": m, "design": design,
              "buckets": list(eng.cfg.buckets), "max_inflight": eng.cfg.max_inflight,
              "plan_schedule": dep.plans[m].schedule, "schedule": eng.cfg.schedule,
              "fused": [sched.fused_equivalence, list(sched.fused_lowering_diff)],
              "predicted_overlap": sch.predicted_overlap(sched),
              "graph": sched.describe()})
        check(design == DEPLOY_TABLE[m], f"deploy {m}: design {design}, "
              f"want the reference's {DEPLOY_TABLE[m]}")
    check(registry.LAUNCHES == dict.fromkeys(registry.KERNELS, 0),
          f"deploy() launched kernels: {registry.LAUNCHES}")
    t0 = time.perf_counter()
    dep.warmup()
    warmup_s = time.perf_counter() - t0

    # launches of each model's served groups (an engine launches in submit)
    per_model: dict[str, collections.Counter] = {}

    def counted(m, submit):
        def wrapped(group, *args, **kw):
            before = dict(registry.LAUNCHES)
            rec = submit(group, *args, **kw)
            per_model[m].update({k: registry.LAUNCHES[k] - before[k] for k in before})
            return rec
        return wrapped

    for m, eng in dep.engines.items():
        eng.submit = counted(m, eng.submit)
    reports = {}
    for window, fraction, seed in DEPLOY_WINDOWS:
        rates = {m: RATES[(DEPLOY_RATE_FROM[m], "sequential")] * fraction
                 for m in DEPLOY_MODELS}
        per_model.update({m: collections.Counter() for m in DEPLOY_MODELS})
        report = reports[window] = dep.serve(deploy_arrivals(dep, rates, seed))
        for m in DEPLOY_MODELS:
            groups = [g for g in report.groups if g.model == m]
            q = report.percentiles("queue_s", m, qs=(50, 95))
            s = report.percentiles("service_s", m, qs=(50, 95))
            circ = per_model[m]["circ_conv"]
            lat = [x for x in report.latencies if x.model == m]
            span = max(x.done_s for x in lat) - min(x.arrival_s for x in lat)
            emit({"phase": "deploy_serve", "window": window, "model": m,
                  "offered_fraction_of_sequential": fraction, "offered_rps": rates[m],
                  "served": len(report.results[m]),
                  # over the serve's whole wall time (the report's own rate), and
                  # over this model's first arrival to its last answer
                  "problems_per_s": report.work_per_s(m),
                  "problems_per_s_own_span": len(lat) / span,
                  "queue_ms_p50_p95": [q["p50"] * 1e3, q["p95"] * 1e3],
                  "service_ms_p50_p95": [s["p50"] * 1e3, s["p95"] * 1e3],
                  "buckets": {str(b): c for b, c in report.bucket_histogram(m).items()},
                  "closed": dict(collections.Counter(g.close_reason for g in groups)),
                  "groups": len(groups), "launches": dict(+per_model[m]),
                  "circ_conv_per_group": circ / len(groups)})
            check(sorted(report.results[m]) == list(range(DEPLOY_REQUESTS)),
                  f"deploy {window} {m}: {len(report.results[m])} of "
                  f"{DEPLOY_REQUESTS} answered")
            check(circ == DEPLOY_CIRC_PER_GROUP[m] * len(groups),
                  f"deploy {window} {m}: {circ} circ_conv launches in {len(groups)} groups")
            if m != "prae":
                check(circ > 0, f"deploy {window} {m}: circ_conv was not launched")
        check(not report.shed, f"deploy {window}: {len(report.shed)} requests shed")
    counts = dict(registry.LAUNCHES)
    emit({"phase": "deploy", "deploy_s": deploy_s, "warmup_s": warmup_s,
          "serve_wall_s": {w: r.wall_time_s for w, r in reports.items()},
          "closed": {w: dict(collections.Counter(g.close_reason for g in r.groups))
                     for w, r in reports.items()},
          "summary": dep.summary()})

    # nvsa's served answers in the first window against an offline run of
    # the same engine on the same requests
    window, _, seed = DEPLOY_WINDOWS[0]
    factory, _ = cb.REASON_WORKLOADS["nvsa"].make_requests(
        dep.configs["nvsa"], DEPLOY_REQUESTS, seed=seed + DEPLOY_MODELS.index("nvsa"))
    offline = dep.engines["nvsa"].run(list(factory()))
    served = reports[window].results["nvsa"]
    diff = max(float(np.abs(served[u].answer_logprobs - offline[u].answer_logprobs).max())
               for u in offline)
    emit({"phase": "deploy_vs_offline", "model": "nvsa", "window": window,
          "max_abs_logp_diff": diff})
    check(diff <= 1e-3, f"deploy nvsa: served log-probs {diff} from the offline run")
    return counts


def phase_ops() -> dict[str, int]:
    """The three kernel-level entry points at full width, then the
    gradients and layouts of ``ops_gradients``, on the card; returns the
    path's launch counts."""
    import torch

    from repro_torch.backend import registry
    from repro_torch.kernels.circ_conv import ops as circ_ops
    from repro_torch.kernels.circ_conv import ref as circ_ref
    from repro_torch.kernels.flash_attn import ops as flash_ops
    from repro_torch.kernels.flash_attn import ref as flash_ref
    from repro_torch.vsa import ops as vsa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)

    def launched(fn, kernel: str, want: int):
        before = registry.LAUNCHES[kernel]
        out = fn()
        torch.cuda.synchronize()
        got = registry.LAUNCHES[kernel] - before
        check(got == want, f"{kernel}: {got} launches, want {want}")
        return out

    registry.reset_launches()
    # vsa.match_prob: NVSA's block codes (4 x 256) against a 16-entry
    # dictionary; the floor (d = 128) launches the kernel, d = 64 does not
    for (n, m, b, d), dtype, want in (((512, 16, 4, 256), torch.float32, 1),
                                      ((512, 16, 4, 256), torch.bfloat16, 1),
                                      ((67, 16, 4, 128), torch.float32, 1),
                                      ((67, 16, 4, 64), torch.float32, 0)):
        q = unit_codes(gen, n, b, d, dtype=dtype)
        dic = unit_codes(gen, m, b, d, dtype=dtype)
        probs = launched(lambda: vsa.match_prob(q, dic, 0.1), "simd_fused", want)
        cpu = vsa.match_prob(q.cpu(), dic.cpu(), 0.1)
        rows = float((probs.sum(dim=-1) - 1).abs().max())
        vs_cpu = float((probs.cpu() - cpu).abs().max())
        check(probs.dtype == torch.float32 and probs.shape == (n, m)
              and bool(probs.isfinite().all()), f"match_prob {(n, m, b, d)}: output")
        check(rows <= 1e-5, f"match_prob {(n, m, b, d)}: rows sum to 1 within {rows}")
        check(vs_cpu <= 1e-3, f"match_prob {(n, m, b, d)}: {vs_cpu} from the CPU")
        emit({"phase": "ops", "entry": "vsa.match_prob", "shape": [n, m, b, d],
              "dtype": str(dtype).split(".")[1], "launches": want,
              "max_abs_row_sum_err": rows, "max_abs_diff_vs_cpu": vs_cpu})
    q = unit_codes(gen, 512, 4, 256)
    dic = unit_codes(gen, 16, 4, 256)
    w = torch.randn(512, 16, device="cuda", generator=gen)
    grads = []
    for dev in ("cuda", "cpu"):
        qq = q.to(dev).clone().requires_grad_()
        dd = dic.to(dev).clone().requires_grad_()
        probs = launched(lambda: vsa.match_prob(qq, dd, 0.1), "simd_fused",
                         int(dev == "cuda"))
        (w.to(dev) * probs).sum().backward()
        grads.append((qq.grad.cpu(), dd.grad.cpu()))
    grad_err = max(float((a - b).abs().max()) for a, b in zip(*grads))
    check(grad_err <= 1e-4, f"match_prob gradient {grad_err} from the CPU's")
    emit({"phase": "ops", "entry": "vsa.match_prob backward", "shape": [512, 16, 4, 256],
          "max_abs_grad_diff_vs_cpu": grad_err})

    # circ_bind_dict: N queries bound to each of M static entries
    for mode, (n, m, b, d), dtype in (("conv", (256, 16, 4, 256), torch.float32),
                                      ("corr", (256, 16, 4, 256), torch.float32),
                                      ("conv", (67, 5, 4, 128), torch.float32),
                                      ("corr", (256, 16, 4, 256), torch.bfloat16)):
        x = unit_codes(gen, n, b, d, dtype=dtype)
        dic = unit_codes(gen, m, b, d, dtype=dtype)
        out = launched(lambda: circ_ops.circ_bind_dict(x, dic, mode), "circ_dict", 1)
        check(out.shape == (n, m, b, d) and out.dtype == dtype
              and bool(out.isfinite().all()), f"circ_bind_dict {(n, m, b, d)}: output")
        rtol = BF16_STEP if dtype == torch.bfloat16 else 0.0
        plain = close(out, circ_ref.circ_dict_ref(x, dic, mode).transpose(1, 2), 1e-3, rtol)
        circulant = vsa.codebook_circulant(dic.float(), mode)  # (M, B, d, d)
        via = torch.einsum("nbk,mbik->nmbi", x.float(), circulant)
        einsum = close(out, via, 1e-3, rtol)
        emit({"phase": "ops", "entry": "circ_bind_dict", "mode": mode,
              "shape": [n, m, b, d], "dtype": str(dtype).split(".")[1], "launches": 1,
              "max_abs_err_vs_plain": plain, "max_abs_err_vs_codebook_circulant": einsum})

    # flash_mha at llama3.2-3b's attention width: 24 query heads of 128, k/v
    # drawn as 8 heads and repeated (GQA) to 24
    for (sq, skv), causal, dtype in (((2048, 2048), True, torch.float32),
                                     ((2048, 2048), True, torch.bfloat16),
                                     ((100, 300), True, torch.float32),
                                     ((100, 300), False, torch.float32),
                                     ((100, 300), False, torch.bfloat16),
                                     ((1000, 1000), True, torch.float32)):
        b, h, kvh, hd = 1, 24, 8, 128
        q = torch.randn(b, sq, h, hd, device="cuda", generator=gen).to(dtype)
        k = torch.randn(b, skv, kvh, hd, device="cuda", generator=gen).to(dtype)
        v = torch.randn(b, skv, kvh, hd, device="cuda", generator=gen).to(dtype)
        k, v = (t.repeat_interleave(h // kvh, dim=2) for t in (k, v))
        scale = hd ** -0.5
        out = launched(lambda: flash_ops.flash_mha(q, k, v, scale, causal), "flash_attn", 1)
        check(out.shape == q.shape and out.dtype == dtype and bool(out.isfinite().all()),
              f"flash_mha {(sq, skv)}: output")
        flat = lambda t: t.transpose(1, 2).reshape(b * h, t.shape[1], hd)  # noqa: E731
        want = flash_ref.flash_attention_ref(flat(q), flat(k), flat(v), scale=scale,
                                             causal=causal)
        f32 = dtype == torch.float32
        err = close(out, want.reshape(b, h, sq, hd).transpose(1, 2),
                    FLASH_F32_ATOL if f32 else 1e-3, 0.0 if f32 else BF16_STEP)
        emit({"phase": "ops", "entry": "flash_mha", "shape": [b, sq, skv, h, hd],
              "kv_heads": kvh, "causal": causal, "dtype": str(dtype).split(".")[1],
              "launches": 1, "max_abs_err_vs_plain": err})
    ops_gradients(gen, launched)
    counts = dict(registry.LAUNCHES)
    for name in ("circ_conv", "unbind_classify", "circ_dict", "simd_fused", "flash_attn"):
        check(counts[name] > 0, f"kernel {name} was not launched on the ops path")
    return counts


def ops_gradients(gen, launched) -> None:
    """The ops phase's gradients and layouts on the card: vsa.bind and
    vsa.unbind at NVSA's 4 x 256 (512 codes against one broadcast key; the
    backward is two circ_conv launches) and fused_unbind_classify at
    MIMONet's width (backward through the plain chain, no launch), each
    within 1e-4 of the CPU; flash_mha refusing grad, and taking the (B, S,
    H, hd) view of a (B, H, S, hd) tensor bit for bit as its copy."""
    import torch

    from repro_torch.kernels.flash_attn import ops as flash_ops
    from repro_torch.kernels.unbind_classify import ops as uc_ops
    from repro_torch.vsa import ops as vsa

    codes, key = unit_codes(gen, 512, 4, 256), unit_codes(gen, 1, 4, 256)
    w = torch.randn(512, 4, 256, device="cuda", generator=gen)
    for op in ("bind", "unbind"):
        grads = []
        for dev in ("cuda", "cpu"):
            on_card = int(dev == "cuda")
            aa = codes.to(dev).clone().requires_grad_()
            kk = key.to(dev).clone().requires_grad_()
            out = launched(lambda: getattr(vsa, op)(aa, kk), "circ_conv", on_card)
            check(out.grad_fn is not None, f"vsa.{op} on {dev}: no grad_fn")
            loss = (w.to(dev) * out).sum()
            g = launched(lambda: torch.autograd.grad(loss, (aa, kk)), "circ_conv",
                         2 * on_card)
            grads.append([t.cpu() for t in g])
        err = max(float((x - y).abs().max()) for x, y in zip(*grads))
        check(err <= 1e-4, f"vsa.{op} gradient {err} from the CPU's")
        emit({"phase": "ops", "entry": f"vsa.{op} backward", "shape": [512, 4, 256],
              "key_shape": [1, 4, 256], "launches": {"forward": 1, "backward": 2},
              "max_abs_grad_diff_vs_cpu": err})

    n, k, blocks, d, c = 8, 2, 4, 128, 5
    args = (unit_codes(gen, k, blocks, d), torch.randn(n, blocks, d, device="cuda", generator=gen),
            torch.randn(blocks, d, c, device="cuda", generator=gen) / (blocks * d) ** 0.5,
            torch.randn(1, c, device="cuda", generator=gen))
    w = torch.randn(n, k, c, device="cuda", generator=gen)
    grads = []
    for dev in ("cuda", "cpu"):
        leaves = [t.to(dev).clone().requires_grad_() for t in args]
        out = launched(lambda: uc_ops.fused_unbind_classify(*leaves), "unbind_classify",
                       int(dev == "cuda"))
        loss = (w.to(dev) * out).sum()
        g = launched(lambda: torch.autograd.grad(loss, leaves), "unbind_classify", 0)
        grads.append([t.cpu() for t in g])
    err = max(float((x - y).abs().max()) for x, y in zip(*grads))
    check(err <= 1e-4, f"fused_unbind_classify gradient {err} from the CPU's")
    emit({"phase": "ops", "entry": "fused_unbind_classify backward",
          "shape": [n, k, blocks, d, c], "launches": {"forward": 1, "backward": 0},
          "max_abs_grad_diff_vs_cpu": err})

    b, sq, h, hd = 1, 2048, 24, 128
    q, kk, v = (torch.randn(b, h, sq, hd, device="cuda", generator=gen).transpose(1, 2)
                for _ in range(3))
    try:
        flash_ops.flash_mha(q.clone().requires_grad_(), kk, v, hd ** -0.5)
        raise AssertionError("flash_mha under grad: no error")
    except RuntimeError as err:
        check("no backward" in str(err), f"flash_mha under grad: {err}")
    view = launched(lambda: flash_ops.flash_mha(q, kk, v, hd ** -0.5), "flash_attn", 1)
    copy = launched(lambda: flash_ops.flash_mha(q.contiguous(), kk.contiguous(),
                                                v.contiguous(), hd ** -0.5), "flash_attn", 1)
    check(not q.is_contiguous() and torch.equal(view, copy),
          "flash_mha: the transposed view differs from its contiguous copy")
    emit({"phase": "ops", "entry": "flash_mha, (B, H, S, hd) transposed",
          "shape": [b, sq, sq, h, hd], "dtype": "float32", "launches": 2,
          "bit_identical_to_contiguous": True})


# the other rows a kernel's entry of the ``kernels`` line carries, under
# these keys: circ_conv at NVSA's served bucket, circ_dict corr and bf16,
# unbind_classify at d = 256, simd_fused bf16, at d = 128 and at M = 1024,
# flash_attn bf16
SUB_ROWS = {"circ_conv": (("served", "circ_conv_served"),),
            "circ_dict": (("corr", "circ_dict_corr"), ("bf16", "circ_dict_bf16")),
            "unbind_classify": (("d256", "unbind_classify_d256"),),
            "simd_fused": (("bf16", "simd_fused_bf16"), ("d128", "simd_fused_d128"),
                           ("m1024", "simd_fused_m1024")),
            "flash_attn": (("bf16", "flash_attn_bf16"),)}


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
    for row in host_breakdown():
        emit(row)
    paths = {"nvsa": phase_serve(), "mimonet": phase_mimonet(), **phase_reasoners(),
             "deploy": phase_deploy(), "ops": phase_ops()}
    emit({"phase": "launches_by_path", **paths})
    kernels = []
    for name, spec in registry.KERNELS.items():
        row = main_rows[name]
        launches = sum(p[name] for p in paths.values())
        check(launches > 0, f"kernel {name} was launched on no path")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{spec.source}",
            "replaces": spec.replaces, "launches": launches,
            "launches_by_path": {k: p[name] for k, p in paths.items() if p[name]},
            "shape": row["shape"], "max_abs_err": row["max_abs_err"],
            "ms": row["kernel_ms"], "device_ms": row["kernel_device_ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "bound_units": row["bound_units"], "library_ms": row["library_ms"]})
        for sub, key in SUB_ROWS.get(name, ()):
            other = main_rows[key]
            kernels[-1][sub] = {
                "shape": other["shape"], "ms": other["kernel_ms"],
                "device_ms": other["kernel_device_ms"], "plain_ms": other["plain_ms"],
                "library_ms": other["library_ms"], "bound_ms": other["bound_ms"],
                "bound_by": other["bound_by"], "bound_units": other["bound_units"],
                "max_abs_err": other["max_abs_err"]}
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
