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
   one bf16 step at bf16, both on the tensor cores, and at granite-moe's
   (1, 2048, 16, 64) at bf16; also Sq = 100 against Skv = 300 and S = 1000
   at both dtypes; at S = 2048 f32 also the error
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
7. Replica: NVSA (``cnn``, fp32, d = 256) through
   ``configs.base.reason_engine_pool`` with 1, 2 and 4 replicas on the
   card, each pool behind one port ``FrontDoor``, the same 64 requests
   offered at twice phase 3's sequential rate: on the door's virtual clock
   the groups, answers and log-probs must be bit-identical across the
   three pools; on the real clock one ``replica`` row per pool
   (problems/s, service p50/p95, the pool's ``per_replica`` split and the
   door's ``replica_breakdown``), circ_conv launched 42 times a group.
8. Trace: 16 requests a model through phase 6's deployment, recorded by
   ``serve.trace.record`` to a temporary file, then four replays, each a
   ``trace`` row (tolerance, max_abs_err, n_compared, tags, seconds):
   through the same deployment and a fresh card deployment rebuilt from
   the header (tolerance 0.0: bit-exact), through a fresh CPU deployment
   (the registry's tolerance of the changed kernels the replay called,
   circ_conv's 1e-3) and, on the card, the trace the JAX package recorded
   (``tests/golden/nvsa_oracle_d128.jsonl``, nvsa oracle at d = 128)
   through engines bound to the reference's constants of its ``.npz``
   (1e-3).  Every leg answers exactly.
9. Ops: the kernel-level entry points at full width, one more path.
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
10. LM: the LM substrate at published width.  llama3.2-3b
   (``make_full()``: 28 layers, d 3072, 24 heads and 8 KV heads of 128,
   d_ff 8192, vocab 128256; f32 parameters drawn on the card from a seeded
   ``torch.Generator``, bf16 compute): ``configs.base.prefill_fn`` at
   (B, S) = (1, 2048) and (4, 512), 28 flash_attn launches per forward, ms
   per forward and tokens/s; its last-token logits at two layers' depth and
   (1, 512) within 3e-2 of the logits' scale of the same function on the
   CPU with the same parameters.  The first ``flash_mha`` call of the path
   at each shape (the forwards', (4, 512, 24, 128) among them, and
   gemma3's global layer at head dim 256 below) is held against
   ``flash_attention_ref`` on its own inputs and output, and the same
   shapes on random inputs with k / v drawn as 8 heads and repeated, both
   within 1e-3 + one bf16 step.  Its slot-pool ``Engine``
   (``serve_fns``, ``ServeConfig(max_slots=8, max_len=512,
   max_new_tokens=32, decode_block=8, prefill_bucket=16)``) serving 16
   ``SyntheticTokens`` prompts of 16-128 tokens: greedy twice (the second
   run measured), online ``submit`` / ``drain_ready`` equal to ``run()``,
   the same streams at ``max_slots=3`` but where they leave at a near tie,
   sampled (temperature 0.8, top-k 50) offline equal to online, every
   request answered with its budget.  Decode against the full-context
   forward over prompt + generated tokens: at every generated position of
   every stream, the logits of ``decode_step`` scanned over the same
   tokens within 3e-2 of the forward's logits' scale there, and each
   greedy token the forward's argmax wherever the forward's top-2 margin
   exceeds twice that (near ties counted); the decode read one position
   late must lie beyond the tolerance somewhere.  Rows: tokens/s, ms per
   decode step and per admission, parameter and KV-cache bytes,
   ``max_memory_allocated``.  Then gemma3-12b at its width and one pattern
   unit of depth (a reduced depth: 6 of its 48 layers, 5 local with window
   1024 and 1 global, 2.35B parameters) serving 4 greedy prompts of
   1040-1120 tokens, so the local layers' ring caches wrap, with the same
   checks against its forward (plain windowed attention on the local
   layers, flash_attn on the global one).  Then the MoE / MLA archs:
   granite-moe-1b-a400m at its published width (24 layers, d 1024, 32
   experts top-8, GQA 16 / 8 heads of 64, 1.33B f32 parameters) and
   deepseek-v3-671b at its width cut to 4 layers (its 3 dense layers and
   its first MoE layer: 256 experts top-8 and a shared one, MLA, bf16
   parameters, the MTP head drawn): the forward at (1, 2048) (granite also
   (4, 512)) at the published capacity factor, flash_attn once per GQA
   layer (head dim 64, each shape held against its plain version) and
   none on MLA; the first MoE layer's routing of 2048 tokens on the card
   against the CPU (experts outside router near ties, queue positions and
   kept pairs exact) and its gather path against the one-hot oracle; then
   the slot-pool engine (granite 8 slots of 512, greedy and sampled;
   deepseek 4 of 256) on a dropless capacity (``dropless``), its greedy
   tokens the argmax of ``decode_step`` scanned as the engine runs it
   outside near ties, and that scan, each MoE layer's experts forced to
   those the forward chose (``RoutesHeld``), within 3e-2 of the forward's
   scale at every generated position (``lm_check_decode`` given the
   engine's ``serve``).  Parameter, KV and peak bytes.
11. Door LM: LM traffic behind the front door.  A door built by hand over
   llama3.2-3b at its published width and an nvsa cnn fp32 engine at
   d = 256, 16 LM requests (16-64-token prompts, 16 new tokens, greedy)
   and 64 nvsa requests in one Poisson feed, each model at half its
   sequential rate measured just before: every stream equal to the same
   engine's offline run, held against the forward as in phase 10, every
   nvsa answer equal to its group's replay at the same bucket; rows of
   tokens/s and problems/s, p50 / p95 queue and service ms, close
   reasons.  Then ``deploy(["nvsa", "llama3.2-3b"])`` at
   the reference's smoke scale, warmed up, 8 requests a model recorded as
   a golden trace and replayed through the same and a fresh card
   deployment, tokens and answers exact.  The path's launches are those
   of the door's serve, the recorded serve and the replays: circ_conv
   only, since the LM engine admits prompts through ``decode_step`` token
   by token, as the reference's does (the decode check's forwards launch
   flash_attn, uncounted).
12. The ``kernels`` JSON line: every ported kernel with its launches on the
   paths (each path's counts set to 0 just before it runs and read just
   after) and its times at its path's shape, its bound and the units the
   bound counts; entries carry other rows (``SUB_ROWS``): ``circ_conv``
   the (8, 4, 256) bucket under ``served`` (39 of NVSA's 42 calls),
   ``circ_dict`` corr and bf16 at (256, 16, 4, 256), ``unbind_classify``
   (8, 2, 4, 256, 5) under ``d256``, ``simd_fused`` bf16, (67, 5, 4, 128)
   under ``d128`` and (64, 1024, 4, 256) under ``m1024``, ``flash_attn``
   bf16 at the same shape and bf16 at (1, 2048, 16, 64) under ``hd64``
   (ms, device_ms, library_ms, bound_ms, bound_units, max_abs_err).
13. The last line: ``{"ok": true, "device": {...}}``.

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
    b = 1
    # llama3.2-3b's 24 heads of 128, and granite-moe's 16 heads of 64
    for sq, skv, causal, dtype, h, hd in ((2048, 2048, True, torch.float32, 24, 128),
                                          (2048, 2048, True, torch.bfloat16, 24, 128),
                                          (100, 300, True, torch.float32, 24, 128),
                                          (100, 300, True, torch.bfloat16, 24, 128),
                                          (1000, 1000, True, torch.float32, 24, 128),
                                          (1000, 1000, True, torch.bfloat16, 24, 128),
                                          (2048, 2048, True, torch.bfloat16, 16, 64)):
        scale = hd ** -0.5
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

        def sdpa(qt=qt, kt=kt, vt=vt, causal=causal, scale=scale):
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
        if sq == 2048 and hd == 64:
            main["flash_attn_hd64"] = row
        elif sq == 2048:
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


def phase_deploy() -> tuple:
    """The generator -> architecture loop on the card: ``deploy()`` of the
    four reasoners (nvsa at d = 256) behind one front door, ``warmup()``,
    then two windows of ``DEPLOY_REQUESTS`` requests per model, each model
    offered a fraction of its sequential rate of phases 3-5
    (``DEPLOY_WINDOWS``).  Returns the path's launch counts and
    the deployment, which the trace phase records through."""
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
    return counts, dep


# -- phase 7: replica pools ------------------------------------------------------

REPLICA_COUNTS = (1, 2, 4)
REPLICA_REQUESTS = 64
# offered twice nvsa cnn fp32's sequential rate of phase 3: above what one
# host thread serves, so each window reads a pool's capacity
REPLICA_OFFERED = 2.0


class VirtualClock:
    """A clock and sleep pair that only advance when the door sleeps."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def sleep(self, dt: float):
        self.t += dt


def phase_replica() -> dict[str, int]:
    """NVSA (``cnn``, fp32, d = 256) through ``reason_engine_pool`` with 1, 2
    and 4 replicas on the card, each pool behind one port ``FrontDoor``
    with the same ``REPLICA_REQUESTS`` requests: on the door's virtual
    clock the groups and the answers must be bit-identical across the
    pools; on the real clock one window per pool gives its problems/s,
    split and circ_conv launches (42 a group).  Returns the path's launch
    counts."""
    import numpy as np
    import torch

    from repro_torch.backend import registry
    from repro_torch.configs import base as cb
    from repro_torch.serve.frontdoor import (FrontDoor, FrontDoorConfig,
                                             poisson_arrivals)
    from repro_torch.serve.reason import ReasonConfig

    registry.reset_launches()
    t_phase = time.perf_counter()
    entry = cb.REASON_WORKLOADS["nvsa"]
    cfg = entry.make_config(d=256)
    consts = entry.make_consts(cfg, torch.Generator().manual_seed(SEED))
    factory, _ = entry.make_requests(cfg, REPLICA_REQUESTS, seed=300)
    requests = list(factory())
    rate = RATES[("nvsa/cnn/fp32", "sequential")] * REPLICA_OFFERED
    rcfg = ReasonConfig(batch_size=8, buckets=BUCKETS, max_inflight=2,
                        schedule="overlap", variant="cnn")
    pools, build_s = {}, {}
    for r in REPLICA_COUNTS:
        t0 = time.perf_counter()
        pool = pools[r] = cb.reason_engine_pool(
            "nvsa", cfg, rcfg, consts=consts, variants=("cnn",), replicas=r)
        for sub in (pool.replicas if r > 1 else [pool]):
            for b in BUCKETS:   # every replica's first run of each bucket
                sub.run(requests[:b])
        build_s[r] = time.perf_counter() - t0

    def door_serve(pool, seed, clock=None):
        kw = {} if clock is None else {"clock": clock, "sleep": clock.sleep}
        door = FrontDoor({"nvsa": pool}, FrontDoorConfig(deadline_s=0.02), **kw)
        return door.serve(poisson_arrivals("nvsa", requests, rate, seed=seed))

    virtual = {r: door_serve(pool, 301, VirtualClock()) for r, pool in pools.items()}
    want = virtual[REPLICA_COUNTS[0]]
    for r, rep in virtual.items():
        check([g.uids for g in rep.groups] == [g.uids for g in want.groups],
              f"replica {r}: groups differ from 1 replica on the virtual clock")
        res, ref = rep.results["nvsa"], want.results["nvsa"]
        check(sorted(res) == list(range(REPLICA_REQUESTS)),
              f"replica {r}: {len(res)} of {REPLICA_REQUESTS} answered")
        same = all(int(res[u].answer) == int(ref[u].answer)
                   and np.array_equal(res[u].answer_logprobs, ref[u].answer_logprobs)
                   for u in ref)
        check(same, f"replica {r}: answers differ from 1 replica on the virtual clock")
    for r, pool in pools.items():
        pool.reset_stats()
        before = registry.LAUNCHES["circ_conv"]
        rep = door_serve(pool, 302)
        circ = registry.LAUNCHES["circ_conv"] - before
        lat = rep.latencies
        span = max(x.done_s for x in lat) - min(x.arrival_s for x in lat)
        s = rep.percentiles("service_s", "nvsa", qs=(50, 95))
        emit({"phase": "replica", "replicas": r, "offered_rps": rate,
              "served": len(rep.results["nvsa"]),
              "problems_per_s": rep.work_per_s("nvsa"),
              "problems_per_s_own_span": len(lat) / span,
              "service_ms_p50_p95": [s["p50"] * 1e3, s["p95"] * 1e3],
              "groups": len(rep.groups),
              "buckets": {str(b): c for b, c in rep.bucket_histogram("nvsa").items()},
              "per_replica": pool.per_replica() if r > 1 else None,
              "replica_breakdown": rep.replica_breakdown("nvsa"),
              "circ_conv_per_group": circ / len(rep.groups),
              "virtual_clock_bit_identical": True, "build_and_warm_s": build_s[r]})
        check(sorted(rep.results["nvsa"]) == list(range(REPLICA_REQUESTS)),
              f"replica {r}: real clock answered {len(rep.results['nvsa'])}")
        check(circ == 42 * len(rep.groups),
              f"replica {r}: {circ} circ_conv launches in {len(rep.groups)} groups")
    counts = dict(registry.LAUNCHES)
    emit({"phase": "replica_done", "seconds": time.perf_counter() - t_phase})
    return counts


# -- phase 8: golden traces -----------------------------------------------------

TRACE_REQUESTS = 16     # per model
TRACE_FIXTURE = ROOT / "tests" / "golden" / "nvsa_oracle_d128.jsonl"


def phase_trace(dep) -> dict[str, int]:
    """Record ``TRACE_REQUESTS`` requests a model through phase 6's
    deployment of the four reasoners on the card (to a file outside the
    repository), then replay it: (1) through the same deployment and (2)
    through a fresh card deployment rebuilt from its header, both
    bit-exact; (3) through a fresh CPU deployment, within the registry's
    tolerance of the changed kernels (circ_conv's 1e-3), answers exact;
    and (4) the trace the JAX package recorded (``TRACE_FIXTURE``) through
    a card deployment bound to its constants, within 1e-3.  Returns the
    path's launch counts."""
    import tempfile

    from repro_torch import interop
    from repro_torch.backend import registry
    from repro_torch.serve import trace as tr

    registry.reset_launches()
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "golden.jsonl")
        arrivals, _ = dep.synthetic_traffic(TRACE_REQUESTS, seed=400)
        t0 = time.perf_counter()
        report, trace = tr.record(dep, arrivals, path)
        emit({"phase": "trace_record", "seconds": time.perf_counter() - t0,
              "requests": {m: len(r) for m, r in report.results.items()},
              "groups": len(trace.groups), "tags": dep.backend.tag()})
        check(all(len(r) == TRACE_REQUESTS for r in report.results.values()),
              "trace: not every recorded request was answered")
        loaded = tr.GoldenTrace.load(path)

        def jax_fixture():
            """The JAX-recorded trace and a card deployment from its header,
            bound to the reference's constants of its ``.npz``."""
            fixture = tr.GoldenTrace.load(str(TRACE_FIXTURE))
            fdep = fixture.deploy(registry.negotiate("cuda"))
            consts = interop.from_reference(
                interop.load_npz(TRACE_FIXTURE.with_suffix(".npz")), "cuda")
            for eng in fdep.engines.values():
                eng.consts = {**eng.consts, **consts}
            return fixture, {"deployment": fdep}

        # (leg, the tolerance the registry must give, (trace, replay kwargs))
        legs = (
            ("same_deployment", 0.0, lambda: (trace, {"deployment": dep})),
            ("fresh_card", 0.0,
             lambda: (loaded, {"backend": registry.negotiate("cuda")})),
            ("fresh_cpu", 1e-3,
             lambda: (loaded, {"backend": registry.negotiate("cpu")})),
            ("jax_fixture", 1e-3, jax_fixture),
        )
        for name, tolerance, setup in legs:
            t0 = time.perf_counter()
            golden, kw = setup()
            replay = golden.replay(**kw)
            diff = golden.diff(replay)
            answers = [f for f in diff.failures if f.field == "answer"]
            emit({"phase": "trace", "leg": name, "tolerance": diff.tolerance,
                  "max_abs_err": diff.max_abs_err, "n_compared": diff.n_compared,
                  "ok": diff.ok, "answer_mismatches": len(answers),
                  "recorded_tags": sorted(set(diff.recorded_tags.values())),
                  "replayed": replay.plan.tag(), "kernels": sorted(replay.kernels),
                  "seconds": time.perf_counter() - t0,
                  "describe": diff.describe()})
            check(diff.tolerance == tolerance,
                  f"trace {name}: tolerance {diff.tolerance}, want {tolerance}")
            check(diff.ok and not answers, f"trace {name}: {diff.describe()}")
            check(diff.n_compared == len(golden.results) > 0,
                  f"trace {name}: compared {diff.n_compared}")
    counts = dict(registry.LAUNCHES)
    emit({"phase": "trace_done", "seconds": time.perf_counter() - t_phase})
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


# -- phase 10: the LM substrate --------------------------------------------------

LM_ARCH = "llama3.2-3b"
LM_FORWARD_SHAPES = ((1, 2048), (4, 512))   # (B, S) of the timed forwards
LM_CPU_LAYERS, LM_CPU_SHAPE = 2, (1, 512)    # the forward held against the CPU
LM_LOGIT_TOL = 3e-2     # of the logits' scale: 3e-2 x max(1, max |logit|)
# decode and the full-context forward are two bf16 computations of the same
# logits: at every generated position of every stream, the decode's logits
# lie within LM_LOGIT_TOL of the forward's scale there.  A greedy token may
# so leave the forward's argmax only where the forward's top-2 margin is
# at most twice that (a near tie, counted)
LM_SERVE = dict(max_slots=8, max_len=512, max_new_tokens=32, decode_block=8,
                prefill_bucket=16)
LM_REQUESTS, LM_PROMPTS = 16, (16, 128)
LM_SAMPLED = dict(temperature=0.8, top_k=50)
LM_RING_ARCH, LM_RING_LAYERS = "gemma3-12b", 6   # one 5:1 local:global unit
LM_RING_REQUESTS, LM_RING_PROMPTS = 4, (1040, 1120)
# the MoE / MLA archs: granite-moe at its published width (GQA at head dim
# 64 on flash_attn), deepseek-v3 at its width cut to its 3 dense layers and
# its first MoE layer (MLA on the plain attention, bf16 parameters, the MTP
# head drawn)
LM_MOE_ARCHS = ("granite-moe-1b-a400m", "deepseek-v3-671b")
LM_MLA_LAYERS = 4
LM_MOE_FORWARDS = {"granite-moe-1b-a400m": ((1, 2048), (4, 512)),
                   "deepseek-v3-671b": ((1, 2048),)}
LM_MOE_SERVE = {"granite-moe-1b-a400m": dict(LM_SERVE, max_new_tokens=16),
                "deepseek-v3-671b": dict(LM_SERVE, max_slots=4, max_len=256,
                                         max_new_tokens=24)}
LM_MOE_REQUESTS = {"granite-moe-1b-a400m": (8, (16, 64)),
                   "deepseek-v3-671b": (8, (16, 32))}
# the routing check at the published capacity: 2048 tokens, 32 distinct
# ones repeated, so that experts overflow (random distinct tokens spread
# evenly over the experts and drop nothing at a capacity factor of 1.25)
LM_MOE_TOKENS, LM_MOE_DISTINCT = 2048, 32
LM_PEAK_LIMIT = 70e9    # max_memory_allocated of deepseek-v3's run


def lm_config(arch_id: str):
    """The published width of ``arch_id``; gemma3-12b cut to one pattern unit
    of depth (6 of its 48 layers: 5 local with window 1024, 1 global),
    deepseek-v3-671b to ``LM_MLA_LAYERS`` (its 3 dense layers and 1 MoE
    layer of 61)."""
    import dataclasses

    from repro_torch.configs import get_arch

    cfg = get_arch(arch_id).make_full()
    if arch_id == LM_RING_ARCH:
        cfg = dataclasses.replace(cfg, n_layers=LM_RING_LAYERS)
    if arch_id == "deepseek-v3-671b":
        cfg = dataclasses.replace(cfg, n_layers=LM_MLA_LAYERS)
    return cfg


def dropless(cfg):
    """``cfg`` with a capacity factor of n_experts / top_k, where every expert
    takes every token routed to it (capacity >= the tokens of the call), as
    both MoE archs serve upstream.  The engine and the decode check run
    there: at the published 1.25 a token's output depends on the other
    tokens of its call (who fills an expert first), so neither a slot pool
    nor a forward against a decode would compute the same function."""
    import dataclasses

    moe = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        moe, capacity_factor=moe.n_experts / moe.top_k))


def lm_prompts(vocab: int, n: int, lens: tuple[int, int], seed: int):
    """``n`` prompts of ``SyntheticTokens`` streams, lengths drawn in
    ``lens`` (inclusive) from ``seed``."""
    import numpy as np

    from repro_torch.data.tokens import SyntheticTokens, TokenPipelineConfig

    toks, _ = SyntheticTokens(TokenPipelineConfig(
        vocab_size=vocab, seq_len=lens[1], global_batch=n, seed=seed)).batch(0)
    sizes = np.random.default_rng(seed).integers(lens[0], lens[1] + 1, n)
    return [toks[i, :sizes[i]].astype(np.int32) for i in range(n)]


class FlashHeld:
    """While open, the first ``flash_mha`` call at each shape is held against
    ``flash_attention_ref`` on its own inputs and output, within 1e-3 + one
    bf16 step (the path computes in bf16), as ``flash_kernel_rows`` holds
    the kernel; the check itself launches nothing.  ``rows`` keeps one row
    per shape held."""

    def __init__(self):
        self.rows: list[dict] = []
        self._seen: set = set()

    def __enter__(self):
        from repro_torch.kernels.flash_attn import ops as flash_ops

        self._ops, self._launch = flash_ops, flash_ops.flash_mha
        flash_ops.flash_mha = self._held
        return self

    def __exit__(self, *exc):
        self._ops.flash_mha = self._launch

    def _held(self, q, k, v, scale, causal=True):
        from repro_torch.kernels.flash_attn import ref as flash_ref

        out = self._launch(q, k, v, scale, causal)
        if tuple(q.shape) not in self._seen:
            self._seen.add(tuple(q.shape))
            b, s, h, hd = q.shape
            flat = lambda t: t.transpose(1, 2).reshape(b * h, t.shape[1], hd)  # noqa: E731
            want = flash_ref.flash_attention_ref(flat(q), flat(k), flat(v), scale=scale,
                                                 causal=causal)
            err = close(out, want.reshape(b, h, s, hd).transpose(1, 2), 1e-3, BF16_STEP)
            self.rows.append({"shape": [b, s, h, hd], "max_abs_err": err})
        return out

    def shapes(self) -> set:
        return {tuple(r["shape"]) for r in self.rows}


def flash_random_rows(shapes, gen, dev) -> list[dict]:
    """``flash_mha`` on random bf16 q and on k / v drawn as KVH heads and
    repeated, at each (B, S, H, hd, KVH) of ``shapes``, against
    ``flash_attention_ref`` within 1e-3 + one bf16 step.  Comparison
    launches: the caller reads the path's counts before."""
    import torch

    from repro_torch.kernels.flash_attn import ops as flash_ops
    from repro_torch.kernels.flash_attn import ref as flash_ref

    rows = []
    for b, s, h, hd, kvh in shapes:
        q = torch.randn(b, s, h, hd, device=dev, generator=gen).bfloat16()
        k, v = (torch.randn(b, s, kvh, hd, device=dev, generator=gen)
                .bfloat16().repeat_interleave(h // kvh, dim=2) for _ in "kv")
        out = flash_ops.flash_mha(q, k, v, hd ** -0.5, True)
        flat = lambda t: t.transpose(1, 2).reshape(b * h, s, hd)  # noqa: E731
        want = flash_ref.flash_attention_ref(flat(q), flat(k), flat(v), scale=hd ** -0.5,
                                             causal=True)
        err = close(out, want.reshape(b, h, s, hd).transpose(1, 2), 1e-3, BF16_STEP)
        rows.append({"shape": [b, s, h, hd], "kv_heads": kvh, "max_abs_err": err})
    return rows


def lm_forward_logits(params, cfg, prompt, tokens, dev):
    """The full-context forward over the prompt and the tokens before the
    last: its f32 logits at each generated position (row j predicts
    ``tokens[j]``)."""
    import numpy as np
    import torch

    from repro_torch.models import lm

    ctx = torch.as_tensor(np.concatenate([prompt, tokens[:-1]]), device=dev)[None].long()
    hidden, _ = lm.forward(params, cfg, ctx)
    return lm.lm_logits(params, cfg, hidden[0, len(prompt) - 1:]).float()


def lm_decode_logits(params, cfg, seqs, starts, dev, batch=None, cache_len=None):
    """``decode_step`` scanned over ``seqs``, one slot each, with per-slot
    positions (a slot past its end repeats its last token at its last
    position, as the engine's prefill clamps); returns each slot's f32
    logits at positions ``starts[i]`` and after.  ``batch`` / ``cache_len``
    (default: one slot per sequence, the longest sequence) give the scan an
    engine's slot count and KV length, so that it computes what that engine
    computes; sequences then go ``batch`` at a time."""
    import torch

    from repro_torch.models import lm

    if batch is not None and len(seqs) > batch:
        return [x for i in range(0, len(seqs), batch)
                for x in lm_decode_logits(params, cfg, seqs[i:i + batch],
                                          starts[i:i + batch], dev, batch, cache_len)]
    top = max(map(len, seqs))
    seqs = list(seqs) + [seqs[0]] * ((batch or len(seqs)) - len(seqs))
    caches = lm.init_caches(cfg, len(seqs), cache_len or top, device=dev)
    out = [[] for _ in seqs]
    for t in range(top):
        pos = [min(t, len(s) - 1) for s in seqs]
        tok = torch.tensor([int(s[p]) for s, p in zip(seqs, pos)], device=dev)
        caches, logits = lm.decode_step(params, cfg, caches, tok,
                                        torch.tensor(pos, device=dev))
        for i, s in enumerate(seqs[:len(starts)]):
            if starts[i] <= t < len(s):
                out[i].append(logits[i].float())
    return [torch.stack(o) for o in out[:len(starts)]]


class RoutesHeld:
    """While open, wraps ``moe.route``: each call's experts (T, k), as
    chosen, are recorded on the host in call order; and where ``forced``
    gives a call's experts (a (T, k) tensor, rows of -1 left alone), those
    replace the call's own choice, their weights taken from the call's own
    router probabilities as ``route`` takes them.  ``changed`` counts the
    (token, layer) choices so replaced by other experts."""

    def __init__(self, forced: list | None = None):
        self.calls: list = []
        self.forced = forced
        self.changed = 0

    def __enter__(self):
        from repro_torch.nn import moe

        self._moe, self._route = moe, moe.route
        moe.route = self._held
        return self

    def __exit__(self, *exc):
        self._moe.route = self._route

    def _held(self, params, cfg, x):
        import torch

        w, idx, probs = self._route(params, cfg, x)
        if self.forced is not None:
            want = self.forced[len(self.calls)].to(idx.device)
            keep = (want < 0).all(-1, keepdim=True)
            new = torch.where(keep, idx, want)
            self.changed += int((new.sort(-1).values != idx.sort(-1).values)
                                .any(-1).sum())
            idx = new
            w = probs.gather(-1, idx)
            if cfg.router_norm_topk:
                w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
        self.calls.append(idx.cpu())
        return w, idx, probs


def lm_check_decode(params, cfg, prompts, results, dev, label,
                    serve: dict | None = None) -> dict:
    """The greedy streams against the full-context forward (flash_attn on the
    unwindowed layers) over prompt + generated tokens.  At every generated
    position of every stream, the logits of ``decode_step`` scanned over
    the same tokens lie within ``LM_LOGIT_TOL`` of the forward's scale
    there, and the stream's token is the argmax wherever its top-2 margin
    exceeds twice that (near ties counted).  A control reads the decode one
    position late against the forward, which the tolerance must not admit
    everywhere.

    A MoE arch passes its engine's ``serve``.  Routing is discrete: a
    last-bit difference between two bf16 computations of a token's hidden
    state can send it to another expert, and then the two part by far more
    than a bf16 step, for that token and every later one.  So the scan runs
    at the engine's slot count and KV length, computing what the engine
    computes, and the tokens are held to that scan's argmax; the scan is
    then run again with each MoE layer's experts for each token forced to
    those the forward chose (``RoutesHeld``; the weights stay the scan's
    own), and that forced scan is what is held against the forward.  The
    (token, layer) choices the forcing changed are counted.  Returns the
    counts and each stream's margins, in units of the tie margin."""
    import numpy as np
    import torch

    uids = sorted(results)
    seqs = [np.concatenate([prompts[u], results[u].tokens[:-1]]) for u in uids]
    starts = [len(prompts[u]) - 1 for u in uids]
    scan = {} if serve is None else dict(batch=serve["max_slots"],
                                         cache_len=serve["max_len"])
    fwd, routes = [], []
    for u in uids:
        with RoutesHeld() as held:
            fwd.append(lm_forward_logits(params, cfg, prompts[u], results[u].tokens, dev))
        routes.append(held.calls)
    decoded = lm_decode_logits(params, cfg, seqs, starts, dev, **scan)
    # the greedy tokens' reference: the forward, or for a MoE arch the scan
    argref = fwd if serve is None else decoded
    forcing = None
    if serve is not None:
        # the scan runs chunks of ``batch`` streams, each for its longest
        # stream's steps, one route call per MoE layer and step
        batch, n_moe, k = serve["max_slots"], len(routes[0]), cfg.moe.top_k
        forced = []
        for c in range(0, len(seqs), batch):
            rows = range(c, min(c + batch, len(seqs)))
            for t in range(max(len(seqs[n]) for n in rows)):
                for layer in range(n_moe):
                    want = torch.full((batch, k), -1, dtype=torch.long)
                    for r, n in enumerate(rows):
                        if t < len(seqs[n]):
                            want[r] = routes[n][layer][t]
                    forced.append(want)
        with RoutesHeld(forced) as forcing:
            decoded = lm_decode_logits(params, cfg, seqs, starts, dev, **scan)
    positions = near = flips = 0
    worst = worst_share = 0.0
    late_beyond = late_n = 0
    margins = {}
    for u, dec, f, a in zip(uids, decoded, fwd, argref):
        tol = LM_LOGIT_TOL * f.abs().amax(-1).clamp(min=1.0)
        gap = (dec - f).abs().amax(-1)
        j = int((gap / tol).argmax())
        check(bool((gap <= tol).all()),
              f"{label}: request {u} position {j}: decode logits {float(gap[j])} "
              f"from the forward's, beyond {float(tol[j])}")
        worst, worst_share = max(worst, float(gap.max())), max(worst_share,
                                                                float((gap / tol).max()))
        late = (dec[:-1] - f[1:]).abs().amax(-1) > tol[1:]
        late_beyond, late_n = late_beyond + int(late.sum()), late_n + late.numel()
        top = a.topk(2, dim=-1).values
        margin = ((top[:, 0] - top[:, 1])
                  / (2 * LM_LOGIT_TOL * a.abs().amax(-1).clamp(min=1.0))).cpu().numpy()
        pred = a.argmax(-1).cpu().numpy()
        margins[u] = margin
        for j, tok in enumerate(results[u].tokens):
            positions += 1
            near += int(margin[j] <= 1)
            if tok != pred[j]:
                check(margin[j] <= 1,
                      f"{label}: request {u} token {j} is {tok}, the "
                      f"{'forward' if serve is None else 'decode scan'}'s argmax "
                      f"{pred[j]} by {margin[j]} tie margins")
                flips += 1
    check(late_beyond > 0, f"{label}: the decode one position late lies within the "
                           "tolerance everywhere, which so would not show it")
    row = {"positions": positions, "near_ties": near, "tie_flips": flips,
           "max_logit_gap": worst, "max_gap_of_tolerance": worst_share,
           "late_by_one_beyond_tolerance": [late_beyond, late_n], "margins": margins}
    if forcing is not None:
        row["routing_choices_forced"] = [forcing.changed, sum(map(len, seqs)) * n_moe]
    return row


def lm_step_profile(step, params, caches, slots: int, at: int, dev) -> dict:
    """Host and device time of one decode step over ``slots`` slots (at
    position ``at`` of ``caches``): the host clock around 5 synchronised
    steps, and the CUDA kernels' time in a ``torch.profiler`` trace of 5
    more (0.0 where the trace holds no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    tok = torch.zeros(slots, dtype=torch.long, device=dev)
    pos = torch.full((slots,), at, dtype=torch.long, device=dev)
    step(params, caches, tok, pos)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        step(params, caches, tok, pos)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            step(params, caches, tok, pos)
        torch.cuda.synchronize()
    device_us = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    return {"step_wall_ms": wall_ms, "step_device_ms": device_us / 5e3,
            "device_busy_share": device_us / 5e3 / wall_ms}


def lm_same_streams(a: dict, b: dict, margins: dict, label: str) -> int:
    """Streams ``b`` equal ``a`` (whose forward margins, in tie margins, are
    ``margins``), except that one may leave ``a`` at a near tie of the
    forward; returns how many did."""
    left = 0
    for uid, res in a.items():
        x, y = list(res.tokens), list(b[uid].tokens)
        if x == y:
            continue
        j = next(i for i, (p, q) in enumerate(zip(x, y)) if p != q)
        check(margins[uid][j] <= 1,
              f"{label}: request {uid} leaves the stream at token {j}, where the "
              f"forward's margin is {margins[uid][j]} tie margins")
        left += 1
    return left


def lm_engine_row(step, init, params, cfg, serve: dict, prompts, label, dev,
                  full: bool, held: FlashHeld) -> dict:
    """Serve ``prompts`` through ``Engine``: greedy twice (the second run
    measured) and online (``submit`` / ``drain_ready``), every request
    answered with its budget, the greedy streams against the forward
    (``lm_check_decode``, given ``serve`` for a MoE arch; its
    ``flash_mha`` calls held by ``held``); with ``full`` also
    sampled, offline and online, and, for a dense arch, at
    ``max_slots=3``.  Returns the row, with its seconds."""
    import torch

    from repro_torch.common.tree import tree_leaves
    from repro_torch.serve.engine import Engine, Request, ServeConfig

    t0 = time.perf_counter()
    reqs = [Request(uid=i, prompt=p) for i, p in enumerate(prompts)]

    def engine(**kw):
        return Engine(step, init, ServeConfig(**{**serve, **kw}), params=params)

    def answered(results, what):
        check(sorted(results) == list(range(len(prompts))),
              f"{label} {what}: {len(results)} of {len(prompts)} answered")
        for uid, r in results.items():
            check(len(r.tokens) == serve["max_new_tokens"] or r.finished_by_eos,
                  f"{label} {what}: request {uid} got {len(r.tokens)} tokens")

    def online(eng):
        out = {}
        for i in range(0, len(reqs), eng.admission_cap):
            eng.submit(reqs[i:i + eng.admission_cap])
            out.update(eng.drain_ready())
        out.update(eng.drain_all())
        return out

    def same(a, b):
        return all(list(a[u].tokens) == list(b[u].tokens) for u in a)

    torch.cuda.reset_peak_memory_stats()
    eng = engine()
    greedy = eng.run(reqs)
    again = eng.run(reqs)
    answered(greedy, "greedy")
    check(same(greedy, again), f"{label}: a second greedy run differs")
    stats = dict(eng.stats)
    kv_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(eng._caches))
    with held:
        decode = lm_check_decode(params, cfg, prompts, greedy, dev, label,
                                 None if cfg.moe is None else serve)
    check(same(greedy, online(engine())), f"{label}: online greedy streams differ "
                                          "from run()")
    row = {"phase": "lm", "engine": label, "requests": len(prompts),
           "serve": serve, "tokens_per_s": eng.tokens_per_s(),
           "warmup_run_tokens_per_s": eng.runs[0]["tokens_per_s"],
           "ms_per_decode_step": stats["decode_time_s"] * 1e3
           / (stats["decode_blocks"] * serve["decode_block"]),
           "ms_per_admission": (stats["wall_time_s"] - stats["decode_time_s"]) * 1e3
           / stats["prefills"],
           "utilization": eng.utilization(), "prefills": stats["prefills"],
           "kv_cache_bytes": kv_bytes,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "decode_vs_forward": {k: v for k, v in decode.items() if k != "margins"}}
    if full and cfg.moe is None:
        row["max_slots_3_left_at_near_ties"] = lm_same_streams(
            greedy, engine(max_slots=3).run(reqs), decode["margins"], label)
    if full:
        sampled = engine(**LM_SAMPLED).run(reqs)
        answered(sampled, "sampled")
        check(same(sampled, online(engine(**LM_SAMPLED))),
              f"{label}: online sampled streams differ from run()")
        check(not same(sampled, greedy), f"{label}: sampled streams equal greedy ones")
        row["sampled"] = dict(LM_SAMPLED, online_equals_offline=True)
        row["decode_step_profile"] = lm_step_profile(
            step, params, eng._caches, serve["max_slots"], serve["max_len"] // 2, dev)
    row["seconds"] = time.perf_counter() - t0
    return row


def lm_moe_routing(params, cfg, dev) -> dict:
    """The first MoE layer's routing at the published capacity, on
    ``LM_MOE_TOKENS`` random tokens (``LM_MOE_DISTINCT`` distinct ones,
    repeated, so that pairs overflow and drop): the experts the card
    chooses are the
    CPU's for every token whose k-th and (k+1)-th router probabilities lie
    more than 1e-6 apart (the router is f32 on both; closer pairs are
    counted), the queue positions and kept pairs the card computes for its
    choice equal the CPU's for the same choice, and the gather path's output
    (capacity drops, overflow slot) lies within 3e-2 of the scale of the
    reference's one-hot oracle ``moe_dense`` on the card."""
    import torch

    from repro_torch.models import lm
    from repro_torch.nn import moe

    layer = lm._layer(params["body"], 0)["u0"]["ffn"]
    k = cfg.moe.top_k
    gen = torch.Generator(dev).manual_seed(SEED + 4)
    x = torch.randn(LM_MOE_DISTINCT, cfg.d_model, device=dev, generator=gen).bfloat16()
    x = x.repeat(LM_MOE_TOKENS // LM_MOE_DISTINCT, 1)
    _, idx, _ = moe.route(layer, cfg.moe, x)
    _, idx_cpu, probs_cpu = moe.route({"router": layer["router"].cpu()}, cfg.moe, x.cpu())
    top = probs_cpu.topk(k + 1, dim=-1).values
    clear = (top[:, k - 1] - top[:, k]) > 1e-6
    same = (idx.cpu().sort(-1).values == idx_cpu.sort(-1).values).all(-1)
    check(bool(same[clear].all()), f"{cfg.name}: the card chose other experts than the "
                                   f"CPU for {int((~same & clear).sum())} tokens")
    cap = moe._capacity(cfg.moe, LM_MOE_TOKENS)
    pos, keep = moe.dispatch(idx, cfg.moe.n_experts, cap)
    pos_cpu, keep_cpu = moe.dispatch(idx.cpu(), cfg.moe.n_experts, cap)
    check(torch.equal(pos.cpu(), pos_cpu) and torch.equal(keep.cpu(), keep_cpu),
          f"{cfg.name}: queue positions on the card differ from the CPU's")
    check(not bool(keep.all()), f"{cfg.name}: no pair dropped at capacity {cap}")
    got, _ = moe.moe_gather(layer, cfg.moe, x, cfg.compute_dtype)
    want, _ = moe.moe_dense(layer, cfg.moe, x, cfg.compute_dtype)
    tol = LM_LOGIT_TOL * max(1.0, float(want.float().abs().max()))
    err = float((got.float() - want.float()).abs().max())
    check(err <= tol, f"{cfg.name}: moe_gather {err} from moe_dense, beyond {tol}")
    return {"tokens": LM_MOE_TOKENS, "capacity": cap,
            "pairs_dropped": int((~keep).sum()), "pairs": keep.numel(),
            "router_near_ties": int((~clear).sum()),
            "gather_vs_dense_max_abs_err": err, "tolerance": tol}


def lm_moe_arch(arch_id: str, dev: str, held: "FlashHeld") -> list[tuple]:
    """One MoE / MLA arch at published width (deepseek-v3 cut in depth):
    parameters drawn on the card, the full-context forward at
    ``LM_MOE_FORWARDS`` at the published capacity (flash_attn once per GQA
    layer, none for MLA), the routing check (``lm_moe_routing``), then the
    slot-pool engine and the decode check on the dropless config
    (``dropless``).  Returns the forwards' flash_attn shapes with KV heads."""
    import torch

    from repro_torch.backend import registry
    from repro_torch.configs import base as cb
    from repro_torch.configs import get_arch
    from repro_torch.nn import init as nninit

    arch, cfg = get_arch(arch_id), lm_config(arch_id)
    spec = cb.model_spec(arch, cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = nninit.materialize(spec, torch.Generator(dev).manual_seed(SEED))
    torch.cuda.synchronize()
    gqa_layers = 0 if cfg.attn_kind == "mla" else cfg.n_layers
    emit({"phase": "lm", "arch": arch_id, "n_layers": cfg.n_layers,
          "params": nninit.param_count(spec), "param_bytes": nninit.param_bytes(spec),
          "active_params": cb.active_param_count(arch, cfg),
          "mtp_params": nninit.param_count(spec["mtp"]) if cfg.mtp else 0,
          "param_dtype": str(cfg.param_dtype), "compute_dtype": str(cfg.compute_dtype),
          "draw_s": time.perf_counter() - t0})
    forward = cb.prefill_fn(arch, cfg)
    gen = torch.Generator("cpu").manual_seed(SEED)
    for b, s in LM_MOE_FORWARDS[arch_id]:
        toks = torch.randint(0, cfg.vocab, (b, s), generator=gen).to(dev)
        before = registry.LAUNCHES["flash_attn"]
        with held:
            logits = forward(params, toks)
        torch.cuda.synchronize()
        launches = registry.LAUNCHES["flash_attn"] - before
        check(launches == gqa_layers, f"{arch_id} forward {(b, s)}: {launches} "
                                      f"flash_attn launches, want {gqa_layers}")
        check(tuple(logits.shape) == (b, cfg.vocab) and bool(logits.isfinite().all()),
              f"{arch_id} forward {(b, s)}: logits")
        ms = cuda_ms(lambda: forward(params, toks), reps=1, samples=3)
        emit({"phase": "lm", "arch": arch_id, "forward": [b, s],
              "flash_attn_launches": launches, "ms_per_forward": ms,
              "tokens_per_s": b * s / ms * 1e3,
              "max_memory_allocated": torch.cuda.max_memory_allocated()})
    emit({"phase": "lm", "arch": arch_id, "moe_routing": lm_moe_routing(params, cfg, dev)})
    serve_cfg = dropless(cfg)
    serve = LM_MOE_SERVE[arch_id]
    n, lens = LM_MOE_REQUESTS[arch_id]
    step, init = cb.serve_fns(arch, serve_cfg, serve["max_len"])
    prompts = lm_prompts(cfg.vocab, n, lens, SEED + 5)
    peak = torch.cuda.max_memory_allocated()
    row = lm_engine_row(step, init, params, serve_cfg, serve, prompts, arch_id, dev,
                        full=arch_id == LM_MOE_ARCHS[0], held=held)
    row.update(params=nninit.param_count(spec), param_bytes=nninit.param_bytes(spec),
               capacity_factor=serve_cfg.moe.capacity_factor,
               max_memory_allocated=max(peak, row["max_memory_allocated"]))
    emit(row)
    check(row["max_memory_allocated"] <= LM_PEAK_LIMIT,
          f"{arch_id}: {row['max_memory_allocated']} bytes at the peak")
    del params
    torch.cuda.empty_cache()
    return [(b, s, cfg.n_heads, cfg.hd, cfg.n_kv_heads)
            for b, s in LM_MOE_FORWARDS[arch_id]] if gqa_layers else []


def phase_lm(dev: str = "cuda") -> dict[str, int]:
    """The LM substrate on the card at published width: llama3.2-3b's
    full-context forward (``configs.base.prefill_fn``, flash_attn on all 28
    layers) at (B, S) = (1, 2048) and (4, 512), held at two layers' depth
    against the CPU; its slot-pool ``Engine`` serving ``LM_REQUESTS``
    requests (``lm_engine_row``); then gemma3-12b at one pattern unit of
    depth (a reduced depth: 6 of 48 layers) serving prompts longer than its
    1024-token window, so the local layers' ring caches wrap; then the MoE /
    MLA archs (``lm_moe_arch``): granite-moe-1b-a400m at its width and
    deepseek-v3-671b at its width cut to 4 layers.  Returns the path's
    launch counts."""
    import dataclasses

    import torch

    from repro_torch import interop
    from repro_torch.backend import registry
    from repro_torch.common.tree import tree_map
    from repro_torch.configs import base as cb
    from repro_torch.configs import get_arch
    from repro_torch.nn import init as nninit

    registry.reset_launches()
    t_phase = time.perf_counter()
    held = FlashHeld()
    arch, cfg = get_arch(LM_ARCH), lm_config(LM_ARCH)
    spec = cb.model_spec(arch, cfg)
    t0 = time.perf_counter()
    params = nninit.materialize(spec, torch.Generator(dev).manual_seed(SEED))
    emit({"phase": "lm", "arch": LM_ARCH, "params": nninit.param_count(spec),
          "param_bytes": nninit.param_bytes(spec), "param_dtype": "float32",
          "compute_dtype": "bfloat16", "draw_s": time.perf_counter() - t0})
    forward = cb.prefill_fn(arch, cfg)
    gen = torch.Generator("cpu").manual_seed(SEED)
    for b, s in LM_FORWARD_SHAPES:
        toks = torch.randint(0, cfg.vocab, (b, s), generator=gen).to(dev)
        before = registry.LAUNCHES["flash_attn"]
        with held:
            logits = forward(params, toks)
        torch.cuda.synchronize()
        launches = registry.LAUNCHES["flash_attn"] - before
        check(launches == cfg.n_layers, f"lm forward {(b, s)}: {launches} flash_attn "
                                        f"launches, want {cfg.n_layers}")
        check(tuple(logits.shape) == (b, cfg.vocab) and bool(logits.isfinite().all()),
              f"lm forward {(b, s)}: logits")
        ms = cuda_ms(lambda: forward(params, toks), reps=1, samples=5)
        emit({"phase": "lm", "forward": [b, s], "flash_attn_launches": launches,
              "ms_per_forward": ms, "tokens_per_s": b * s / ms * 1e3})
    forward_heads = [(b, s, cfg.n_heads, cfg.hd, cfg.n_kv_heads)
                     for b, s in LM_FORWARD_SHAPES]
    # two layers' depth against the CPU on the same parameters
    cfg2 = dataclasses.replace(cfg, n_layers=LM_CPU_LAYERS)
    params2 = {**params, "body": tree_map(lambda t: t[:LM_CPU_LAYERS], params["body"])}
    toks = torch.randint(0, cfg.vocab, LM_CPU_SHAPE, generator=gen)
    card = cb.prefill_fn(arch, cfg2)(params2, toks.to(dev)).float().cpu()
    cpu = cb.prefill_fn(arch, cfg2)(interop.to_device(params2, "cpu"), toks).float()
    err = float((card - cpu).abs().max())
    tol = LM_LOGIT_TOL * max(1.0, float(cpu.abs().max()))
    emit({"phase": "lm", "forward_vs_cpu": [LM_CPU_LAYERS, *LM_CPU_SHAPE],
          "max_abs_err": err, "tolerance": tol, "max_abs_logit": float(cpu.abs().max()),
          "argmax_equal": bool(torch.equal(card.argmax(-1), cpu.argmax(-1)))})
    check(err <= tol, f"lm forward at {LM_CPU_LAYERS} layers: card {err} from the "
                      f"CPU, beyond {tol}")
    del params2, card, cpu

    step, init = cb.serve_fns(arch, cfg, LM_SERVE["max_len"])
    prompts = lm_prompts(cfg.vocab, LM_REQUESTS, LM_PROMPTS, SEED)
    emit(lm_engine_row(step, init, params, cfg, LM_SERVE, prompts, LM_ARCH, dev,
                       full=True, held=held))
    del params
    torch.cuda.empty_cache()

    # the ring-buffer path: gemma3-12b's width, one pattern unit of depth
    arch, cfg = get_arch(LM_RING_ARCH), lm_config(LM_RING_ARCH)
    spec = cb.model_spec(arch, cfg)
    params = nninit.materialize(spec, torch.Generator(dev).manual_seed(SEED))
    prompts = lm_prompts(cfg.vocab, LM_RING_REQUESTS, LM_RING_PROMPTS, SEED + 1)
    check(min(map(len, prompts)) > cfg.window, "ring prompts must pass the window")
    serve = dict(LM_SERVE, max_slots=LM_RING_REQUESTS,
                 max_len=-(-(LM_RING_PROMPTS[1] + LM_SERVE["max_new_tokens"]) // 64) * 64)
    step, init = cb.serve_fns(arch, cfg, serve["max_len"])
    before = registry.LAUNCHES["flash_attn"]
    row = lm_engine_row(step, init, params, cfg, serve, prompts,
                        f"{LM_RING_ARCH}[{LM_RING_LAYERS} layers]", dev, full=False,
                        held=held)
    row.update(params=nninit.param_count(spec), param_bytes=nninit.param_bytes(spec),
               window=cfg.window, prompt_lens=[len(p) for p in prompts],
               flash_attn_launches=registry.LAUNCHES["flash_attn"] - before)
    emit(row)
    del params
    torch.cuda.empty_cache()
    global_heads = sorted((*x, cfg.n_kv_heads) for x in held.shapes()
                          if x[2:] == (cfg.n_heads, cfg.hd))
    # the MoE / MLA archs; granite-moe's GQA layers run flash_attn at head
    # dim 64, deepseek-v3's MLA layers the plain attention
    for arch_id in LM_MOE_ARCHS:
        forward_heads += lm_moe_arch(arch_id, dev, held)
    counts = dict(registry.LAUNCHES)
    check(counts["flash_attn"] > 0, "flash_attn was not launched on the lm path")
    # the kernel at the shapes this path gave it: every forward shape and
    # the global layer's (head dim 256) were held above; the same shapes
    # again on random inputs (comparison launches, after the counts)
    for shape in forward_heads:
        check(shape[:4] in held.shapes(), f"lm: no flash_attn call at {shape[:4]} "
                                          "was held")
    check(len(global_heads) > 0, "lm: no flash_attn call of the global layer was held")
    gen = torch.Generator(dev).manual_seed(SEED + 2)
    emit({"phase": "lm", "flash_attn_held": [[*r["shape"], r["max_abs_err"]]
                                             for r in held.rows],
          "flash_attn_random": flash_random_rows(forward_heads + global_heads[-1:],
                                                 gen, dev)})
    emit({"phase": "lm_done", "seconds": time.perf_counter() - t_phase,
          "launches": counts})
    return counts


# -- phase 11: LM traffic behind the front door -----------------------------------

DOOR_LM_REQUESTS, DOOR_LM_PROMPTS = 16, (16, 64)
DOOR_LM_SERVE = dict(LM_SERVE, max_new_tokens=16)   # 8 slots of 512 tokens
DOOR_NVSA_REQUESTS = 64
DOOR_OFFERED = 0.5      # of each model's sequential rate, measured here
DOOR_DEADLINE_S = 0.02
DOOR_DEPLOY_MODELS = ("nvsa", LM_ARCH)
DOOR_DEPLOY_REQUESTS = 8   # per model, deploy() at the reference's smoke scale


def door_rows(report, label: str, offered: dict) -> None:
    """One ``door_lm`` row per model of a front door's report: its rate in
    its own unit, p50 / p95 queue and service ms, groups, buckets and close
    reasons."""
    import collections

    for m in report.results:
        groups = [g for g in report.groups if g.model == m]
        q = report.percentiles("queue_s", m, qs=(50, 95))
        sv = report.percentiles("service_s", m, qs=(50, 95))
        lat = [x for x in report.latencies if x.model == m]
        span = max(x.done_s for x in lat) - min(x.arrival_s for x in lat)
        unit = report.work_unit(m)
        emit({"phase": "door_lm", "door": label, "model": m,
              "offered_rps": offered.get(m), "served": len(report.results[m]),
              # over the serve's whole wall time (the report's own rate), and
              # over this model's first arrival to its last answer
              f"{unit}_per_s": report.work_per_s(m),
              f"{unit}_per_s_own_span": report.work_per_s(m) * report.wall_time_s / span,
              "queue_ms_p50_p95": [q["p50"] * 1e3, q["p95"] * 1e3],
              "service_ms_p50_p95": [sv["p50"] * 1e3, sv["p95"] * 1e3],
              "groups": len(groups),
              "buckets": {str(b): c for b, c in report.bucket_histogram(m).items()},
              "closed": dict(collections.Counter(g.close_reason for g in groups))})


def phase_door_lm(dev: str = "cuda") -> dict[str, int]:
    """LM traffic behind the port's front door on the card.  (1) A door
    built by hand over llama3.2-3b at its published width (the ``lm``
    phase's engine, ``DOOR_LM_SERVE``) and an nvsa cnn fp32 engine at
    d = 256: ``DOOR_LM_REQUESTS`` greedy ``SyntheticTokens`` prompts of
    16-64 tokens and ``DOOR_NVSA_REQUESTS`` nvsa requests in one Poisson
    feed from seed 0, each model offered ``DOOR_OFFERED`` of its
    sequential rate measured just before, on the real clock.  Every LM
    stream equals the same engine's offline run of its request, token for
    token (the engine is slot-invariant), and the decode check of the
    ``lm`` phase holds the streams against the full-context forward; every
    nvsa answer equals the same engine's replay of its door group, at the
    same bucket, bit for bit.  (2) ``deploy()`` of nvsa
    and llama3.2-3b at the reference's smoke scale on the card: warmed up,
    ``DOOR_DEPLOY_REQUESTS`` a model of its synthetic traffic recorded as a
    golden trace (lm and reason classes), replayed through the same and a
    fresh card deployment, tokens and answers exact.  Returns the launch
    counts of the served windows: the door's serve, the recorded serve and
    the replays, not the checks."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.backend import registry
    from repro_torch.configs import base as cb
    from repro_torch.configs import get_arch
    from repro_torch.nn import init as nninit
    from repro_torch.serve import trace as tr
    from repro_torch.serve.deploy import deploy
    from repro_torch.serve.engine import Engine, Request, ServeConfig
    from repro_torch.serve.frontdoor import (FrontDoor, FrontDoorConfig, merge_arrivals,
                                             poisson_arrivals)
    from repro_torch.serve.reason import ReasonConfig

    t_phase = time.perf_counter()
    held = FlashHeld()
    arch, cfg = get_arch(LM_ARCH), lm_config(LM_ARCH)
    params = nninit.materialize(cb.model_spec(arch, cfg),
                                torch.Generator(dev).manual_seed(SEED))
    step, init = cb.serve_fns(arch, cfg, DOOR_LM_SERVE["max_len"])
    lm_eng = Engine(step, init, ServeConfig(**DOOR_LM_SERVE), params=params)
    prompts = lm_prompts(cfg.vocab, DOOR_LM_REQUESTS, DOOR_LM_PROMPTS, SEED + 3)
    lm_reqs = [Request(uid=i, prompt=p) for i, p in enumerate(prompts)]
    lm_eng.run(lm_reqs)                       # the shapes' first runs
    offline = lm_eng.run(lm_reqs)
    lm_seq = len(lm_reqs) / lm_eng.last_run["wall_time_s"]

    entry = cb.REASON_WORKLOADS["nvsa"]
    ncfg = entry.make_config(d=256)
    nv_eng = cb.reason_engine(
        "nvsa", ncfg, ReasonConfig(batch_size=8, buckets=BUCKETS, max_inflight=2),
        consts=entry.make_consts(ncfg, torch.Generator().manual_seed(SEED)),
        variants=("cnn",))
    factory, _ = entry.make_requests(ncfg, DOOR_NVSA_REQUESTS, SEED)
    nv_reqs = list(factory())
    for b in BUCKETS:                         # every bucket's first run
        nv_eng.run(nv_reqs[:b])
    nv_eng.run(nv_reqs, schedule="sequential")
    nv_seq = nv_eng.last_run["problems_per_s"]
    offered = {"nvsa": DOOR_OFFERED * nv_seq, LM_ARCH: DOOR_OFFERED * lm_seq}
    emit({"phase": "door_lm", "sequential_rps": {"nvsa": nv_seq, LM_ARCH: lm_seq},
          "lm_offline_tokens_per_s": lm_eng.tokens_per_s()})

    door = FrontDoor({"nvsa": nv_eng, LM_ARCH: lm_eng},
                     FrontDoorConfig(deadline_s=DOOR_DEADLINE_S))
    # the path's launches: the door's serve here, deploy()'s recorded serve
    # and its replays below; the checks between them are not counted
    registry.reset_launches()
    report = door.serve(merge_arrivals(
        poisson_arrivals("nvsa", nv_reqs, offered["nvsa"], seed=SEED),
        poisson_arrivals(LM_ARCH, lm_reqs, offered[LM_ARCH], seed=SEED + 1)))
    counts = dict(registry.LAUNCHES)
    door_rows(report, "hand-built", offered)
    check(not report.shed, f"door_lm: {len(report.shed)} requests shed")
    check({g.model for g in report.groups} == {"nvsa", LM_ARCH},
          "door_lm: one model had no group")
    for m, n in (("nvsa", DOOR_NVSA_REQUESTS), (LM_ARCH, DOOR_LM_REQUESTS)):
        check(sorted(report.results[m]) == list(range(n)),
              f"door_lm {m}: {len(report.results[m])} of {n} answered")
    streams = report.results[LM_ARCH]
    for uid, res in offline.items():
        check(list(streams[uid].tokens) == list(res.tokens),
              f"door_lm: request {uid}'s stream differs from the offline run")
    with held:
        decode = lm_check_decode(params, cfg, prompts, streams, dev, "door_lm")
    replayed = 0
    for g in report.groups:
        if g.model != "nvsa":
            continue
        rec = nv_eng.submit([nv_reqs[u] for u in g.uids])
        again = nv_eng.drain_all()
        check(rec.bucket == g.bucket, f"door_lm nvsa group {g.uids}: bucket "
                                      f"{rec.bucket}, served at {g.bucket}")
        for u in g.uids:
            got, want = report.results["nvsa"][u], again[u]
            check(got.answer == want.answer and np.array_equal(
                got.answer_logprobs, want.answer_logprobs),
                f"door_lm nvsa request {u}: served answer differs from its group's "
                "replay at the same bucket")
            replayed += 1
    emit({"phase": "door_lm", "door": "hand-built", "lm_streams_equal_offline":
          len(offline), "nvsa_equal_group_replay": replayed,
          "decode_vs_forward": {k: v for k, v in decode.items() if k != "margins"},
          "flash_attn_held": [[*r["shape"], r["max_abs_err"]] for r in held.rows],
          "serve_wall_s": report.wall_time_s})
    del params, lm_eng, door
    torch.cuda.empty_cache()

    # deploy() of nvsa and the LM's smoke arch, recorded and replayed
    t0 = time.perf_counter()
    dep = deploy(list(DOOR_DEPLOY_MODELS), preflight="off")
    deploy_s = time.perf_counter() - t0
    dep.warmup()
    check(dep.classes == {"nvsa": "reason", LM_ARCH: "lm"}, f"deploy: {dep.classes}")
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "door_lm.jsonl")
        arrivals, _ = dep.synthetic_traffic(DOOR_DEPLOY_REQUESTS, seed=500)
        registry.reset_launches()
        report, trace = tr.record(dep, arrivals, path)
        door_rows(report, "deploy", {m: dep.traffic.rate_rps for m in dep.engines})
        check(all(len(r) == DOOR_DEPLOY_REQUESTS for r in report.results.values()),
              "door_lm deploy: not every recorded request was answered")
        check(trace.header["models"][LM_ARCH]["class"] == "lm", "door_lm: no lm class")
        legs = (("same_deployment", lambda: (trace, {"deployment": dep})),
                ("fresh_card", lambda: (tr.GoldenTrace.load(path),
                                        {"backend": registry.negotiate("cuda")})))
        for name, setup in legs:
            t0 = time.perf_counter()
            golden, kw = setup()
            replay = golden.replay(**kw)
            diff = golden.diff(replay)
            emit({"phase": "door_lm_trace", "leg": name, "tolerance": diff.tolerance,
                  "max_abs_err": diff.max_abs_err, "n_compared": diff.n_compared,
                  "lm_results": sum(m == LM_ARCH for m, _ in golden.results),
                  "kernels": sorted(replay.kernels), "seconds": time.perf_counter() - t0,
                  "describe": diff.describe()})
            check(diff.tolerance == 0.0 and diff.ok,
                  f"door_lm trace {name}: {diff.describe()}")
            check(diff.n_compared == 2 * DOOR_DEPLOY_REQUESTS,
                  f"door_lm trace {name}: compared {diff.n_compared}")
        counts = {k: n + registry.LAUNCHES[k] for k, n in counts.items()}
    emit({"phase": "door_lm", "door": "deploy", "deploy_s": deploy_s,
          "summary": dep.summary()})
    # the LM engine admits prompts through ``decode_step`` token by token, as
    # the reference's does, so LM traffic launches no flash_attn
    check(counts["circ_conv"] > 0, "kernel circ_conv was not launched on the "
                                   "door_lm path")
    emit({"phase": "door_lm_done", "seconds": time.perf_counter() - t_phase,
          "launches": counts})
    return counts


# the other rows a kernel's entry of the ``kernels`` line carries, under
# these keys: circ_conv at NVSA's served bucket, circ_dict corr and bf16,
# unbind_classify at d = 256, simd_fused bf16, at d = 128 and at M = 1024,
# flash_attn bf16 and bf16 at head dim 64
SUB_ROWS = {"circ_conv": (("served", "circ_conv_served"),),
            "circ_dict": (("corr", "circ_dict_corr"), ("bf16", "circ_dict_bf16")),
            "unbind_classify": (("d256", "unbind_classify_d256"),),
            "simd_fused": (("bf16", "simd_fused_bf16"), ("d128", "simd_fused_d128"),
                           ("m1024", "simd_fused_m1024")),
            "flash_attn": (("bf16", "flash_attn_bf16"), ("hd64", "flash_attn_hd64"))}


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
    paths = {"nvsa": phase_serve(), "mimonet": phase_mimonet(), **phase_reasoners()}
    paths["deploy"], dep = phase_deploy()
    paths["replica"] = phase_replica()
    paths["trace"] = phase_trace(dep)
    paths["ops"] = phase_ops()
    paths["lm"] = phase_lm()
    paths["door_lm"] = phase_door_lm()
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
