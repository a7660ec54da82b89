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
   one bf16 step at bf16, both on the tensor cores, at granite-moe's
   (1, 2048, 16, 64) and internvl2-26b's (1, 2048, 48, 128) at bf16; also
   Sq = 100 against Skv = 300 and S = 1000
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
   of the CPU; ``flash_mha``'s gradient (kernel forward, plain-chain
   backward) within 1e-4 of each input's max |grad| of the CPU's, and it
   taking a transposed view bit for bit as its contiguous copy.
9a. Analyze: ``repro_torch.analyze``'s full tier on the card (its
   launches under ``launches_by_path["analyze"]``).  Every
   ``REASON_WORKLOADS`` model x variant at d = 256 (so circ_conv lies on
   the nvsa, lvrf and mimonet schedules) over buckets 1, 2, 4 and 8, and
   nvsa cnn at int8 ``nn_precision`` (qmatmul on its frontend), compiled
   for the card and checked on ``meta``: precision flow, host syncs,
   bucket closure and batch-axis invariance, double-trace determinism,
   the registry's static checks, dispatch floors and the lint over
   ``src/repro_torch``.  Then the kernel probes of all six kernels on the
   card (``analyze.registry_check.run_probes``): each wrapper at d in (5,
   12, 33, 8, 32, 128, 256) (flash_attn: head dims 64 / 128 / 256 at 77
   tokens, causal and not, f32 and bf16) against its plain version and
   its gather lowering within the registry's epsilon, and at one size its
   wrapper refuses, which must raise naming it, with a direct launch of
   the C entry point there that must not conform.  One
   ``analyze_probe`` row per kernel (sizes probed and refused, max |err|
   against the plain version and the gather lowering, the epsilon), then
   the report's coverage, findings and seconds; ``report.ok`` must hold.
   Phases 6 and 11 deploy through the default ``preflight="error"`` gate.
9b. Train: NSAI training on the card at the published widths (after the
   ops phase; its launches under ``launches_by_path["train"]``).  First
   step, card against CPU from one seeded init and one batch:
   ``nvsa.frontend_loss`` (``NVSAConfig()``: d = 256, cnn_width 16,
   cnn_feat 128; 64 panels), ``mimonet.loss_fn`` (``MIMONetConfig()``: d =
   128, K = 2, trunk 2 x 1024; 32 problems, so circ_elem runs forward and
   backward at (64, 4, 128)) and ``lvrf.loss_fn`` (``LVRFConfig()``, d =
   128, 16 oracle problems): the loss within 1e-5, every grad leaf within
   1e-4 of its max |grad|, the BN batch stats within 1e-5 of their scale,
   one AdamW step within 2 lr everywhere and 1e-6 at all but one element
   in 10^3 (``TRAIN_FIRST_TOL``; TF32 off).  Then the
   ``examples/train_nvsa_raven_torch.py`` twin: 400 steps on the panels of
   400 problems (the loss every 50 steps, ms a step on the host clock; the
   last 50 steps' mean loss below a quarter of step 0's), and Tab. IV on 128
   problems per style (raven, iraven, pgm by fp32, bf16, int8, mp, int4:
   answer and rule accuracy, memory bytes; fp32 answer accuracy >= 0.9,
   the fp32 / mp memory ratio inside (3.5, 8.5)).  MIMONet: 200 AdamW
   steps on panel pairs labelled by shape type (the loss falling, ms a
   step, accuracy on 64 held-out pairs).  LVRF at d = 128: 60 full-batch
   SGD steps at lr 0.5 on the 16 oracle problems (accuracy >= 0.9).  The
   phase's seconds and ``max_memory_allocated``.
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
   within 1e-3 + one bf16 step.  Its slot-pool ``Engine`` on its first 7
   layers (``LM_ENGINE_LAYERS``: each engine row of an arch run at full
   depth serves a cut depth, for the script's time) (``serve_fns``, ``ServeConfig(max_slots=8, max_len=512,
   max_new_tokens=32, decode_block=8, prefill_bucket=16)``) serving 16
   ``SyntheticTokens`` prompts of 16-64 tokens: greedy twice (the second
   run measured), online ``submit`` / ``drain_ready`` equal to ``run()``,
   the same streams at ``max_slots=3`` but where they leave at a near tie,
   sampled (temperature 0.8, top-k 50) offline equal to online, every
   request answered with its budget.  Decode against the full-context
   forward over prompt + generated tokens: at every generated position of
   every stream and the 16 prompt positions before, the logits of
   ``decode_step`` scanned over the same tokens within 3e-2 of the
   forward's logits' scale there, and each greedy token the forward's
   argmax wherever the forward's top-2 margin exceeds twice that (near
   ties counted); the decode read one position late must lie beyond the
   tolerance somewhere on those same positions.  Rows: tokens/s, ms per
   decode step and per admission, parameter and KV-cache bytes,
   ``max_memory_allocated``.  Then gemma3-12b at its width and one pattern
   unit of depth (a reduced depth: 6 of its 48 layers, 5 local with window
   1024 and 1 global, 2.35B parameters) serving one greedy prompt of
   1040-1120 tokens (one, for time), so the local layers' ring caches
   wrap, with the same checks against its forward (plain windowed attention on the local
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
   the slot-pool engine (granite at 6 of its 24 layers, 8 slots of 512,
   greedy and sampled;
   deepseek 4 of 256) on a dropless capacity (``dropless``), its greedy
   tokens the argmax of ``decode_step`` scanned as the engine runs it
   outside near ties, and that scan, each MoE layer's experts forced to
   those the forward chose (``RoutesHeld``), within 3e-2 of the forward's
   scale at every generated position (``lm_check_decode`` given the
   engine's ``serve``).  Parameter, KV and peak bytes.  Then the recurrent
   kinds at their published widths (``lm_recurrent_arch``): rwkv6-7b (32
   layers, d 4096, 7.02B f32 parameters) and recurrentgemma-9b (38 layers,
   d 4096, RG-LRU and MQA with a 2048-token window, 9.40B), each the
   ``prefill_fn`` forward at (1, 2048) and (4, 512) (no kernel: the WKV
   recurrence, the RG-LRU scan and the causal conv are plain PyTorch, as
   they are plain ``jnp`` in the reference), rwkv's chunked WKV (chunk 64)
   against its token scan on 256 tokens within 3e-2 of the logits' scale
   at f32 compute at 32 layers and at bf16 at 1 and 2 layers, the bf16 gap
   reported at 4, 8, 16 and 32 (at this width the reference's own bf16
   paths part by more than the tolerance from 4 layers on), the forward
   at 2 (rwkv) or 3 (griffin: one unit) layers against the CPU, then the
   engine at bf16 with exact-length prefill, at 16 (rwkv) or 18 (griffin)
   layers: 8 slots of 512, 8 prompts of
   16, 32 and 48 tokens, 16 new, one prefill scan per distinct length,
   the decode step's profile, and the decode held against the forward
   at f32 compute and f32 decode state (the bf16 gap reported: rounding
   flips grow through the layers) from position 15 of each sequence (the
   positions before reported: while the state holds few tokens, rounding
   alone parts the decode at 8 slots from itself at 1 slot at full
   depth), the scale taken without the
   input token's column (griffin's tied embedding echoes the input token
   at ~81 against ~5 elsewhere), its tokens the argmax of the bf16 decode
   scan at the engine's slot count outside near ties; rwkv6-7b also
   served at 2 layers, held at bf16; recurrentgemma-9b also at one (rec,
   rec, attn) unit of depth serving one prompt of 2056-2100 tokens (one,
   for time), 4 new tokens, so its rings wrap past the window, held at
   f32 as above.  Then internvl2-26b
   at its width cut by memory to 38 of its 48 layers (``lm_vlm_arch``,
   15.96B f32 parameters): the forward over 1024 random patch embeddings
   and 1024 tokens, flash_attn once per layer at (1, 2048, 48, 128), held
   against its plain version, and at 2 layers against the CPU.
10b. Train LM: LM training on the card (its launches under
   ``launches_by_path["train_lm"]``).  llama3.2-3b's first step at its
   published width cut to 2 layers, f32 compute (the 3xTF32 flash kernel)
   and tokens (1, 128), card against CPU with phase 9b's checks (loss
   1e-5, grads 1e-4 of each leaf's max, one AdamW step within 2 lr and
   within 1e-6 at all but one element in 10^3); then all 28 layers (f32
   parameters, bf16 compute, AdamW with f32 moments donated in place,
   remat off as its config says) for 6 steps of ``trainer.train_step`` on
   one (1, 2048) ``SyntheticTokens`` batch: 28 flash_attn launches a step
   (the forward; the backward recomputes the plain chain), ms a step on
   the host clock and in CUDA events, ``max_memory_allocated``, the loss
   at each step (finite, the last below step 0's), the first flash_attn
   call held against its plain version, and one more step under
   ``torch.profiler`` (host and device time, the kernels).  Then the
   ``examples/train_lm_torch.py`` twin at ``full100m`` (~101M parameters)
   with the reference example's defaults (200 steps of 8 x 256, lr 1e-3,
   warmup 20, a checkpoint every 50, remat on: 24 flash_attn launches a
   step), its mean loss over the last 20 steps below the first 20's; then
   again with ``FailureInjector(fail_at_step=130)`` under
   ``run_with_restarts``, resumed from step 100's checkpoint: its losses of
   steps 100-199 and its final parameters and moments bit for bit the
   uninterrupted run's, and one profiled step of it.  Last, outside the
   path's counts, flash_attention's backward at (1, 2048, 24, 128) bf16
   (the plain chain, recomputed) beside the kernel forward, SDPA's forward
   plus backward and the backward's bound.
10c. Enc-dec: seamless-m4t-large-v2 on the card (its launches under
   ``launches_by_path["encdec"]``).  Its first step at its published width
   cut to 2 + 2 layers, f32 compute (the 3xTF32 flash kernel, non-causal)
   and (1, 128) frames and targets, card against CPU with phase 9b's
   checks; then all 24 + 24 layers (1.37B f32 parameters, bf16 compute,
   AdamW with f32 moments, remat on as its config says) for 6 steps of
   ``trainer.train_step`` on one batch of (1, 2048) frames and (1, 2048)
   targets: 144 flash_attn launches a step (24 encoder, 24 decoder self-
   and 24 cross-attention calls, each again in remat's recompute), ms a
   step on the host clock and in CUDA events, ``max_memory_allocated``,
   the loss at each step (finite, the last below step 0's).  Then the
   ``examples/serve_lm_torch.py`` twin's enc-dec serving at full width: 3
   batches of (2, 2048) frames, 32 greedy tokens each, encode(i+1) issued
   on a side stream before decode(i): ms an encode and a decode step, the
   cross-cache bytes, 24 flash_attn launches an encode and a decode step;
   the decode logits at every generated position within 3e-2 of the
   logits' scale of ``decode_train`` over the same tokens, and the same
   decode with its cross caches zeroed beyond it.  Then ``prefill_fn`` at
   (1, 32768) frames (the encoder output's mean), timed.  Each flash_attn
   shape on the path is held against its plain version (``FlashHeld``; at
   32768 queries a sample of 256 rows over all keys), and, outside the
   path's counts, the kernel at the four non-causal shapes
   (``ENCDEC_FLASH``) is timed beside SDPA and its bound.
11. Door LM: LM traffic behind the front door.  A door built by hand over
   llama3.2-3b at its published width and an nvsa cnn fp32 engine at
   d = 256, 16 LM requests (16-64-token prompts, 16 new tokens, greedy)
   and 64 nvsa requests in one Poisson feed, each model at half its
   sequential rate measured just before: every stream equal to the same
   engine's offline run, held against the forward as in phase 10, every
   nvsa answer equal to its group's replay at the same bucket; rows of
   tokens/s and problems/s, p50 / p95 queue and service ms, close
   reasons.  Then ``deploy(["nvsa", "llama3.2-3b"])`` and ``deploy(["nvsa",
   "rwkv6-7b", "recurrentgemma-9b"])`` at the reference's smoke scale
   (the recurrent LMs with exact-length prefill), each warmed up, 8
   requests a model recorded as a golden trace and replayed through the
   same and a fresh card deployment, tokens and answers exact.  The path's launches are those
   of the door's serve, the recorded serve and the replays: circ_conv
   only, since the LM engine admits prompts through ``decode_step`` token
   by token, as the reference's does (the decode check's forwards launch
   flash_attn, uncounted).
11b. TP: distribution on the serving path (``launches_by_path["tp"]``,
   summed over the ranks).  llama3.2-3b at its published width and depth
   served tensor-parallel by a world of two ranks on the one card
   (``devices=("cuda:0", "cuda:0")``, gloo, ``distributed.world``), each
   drawing the seeded parameters and keeping its cut: a (1, 2048) bf16
   forward, 28 flash_attn launches on each rank at (1, 2048, 12, 128), the
   same logits on both ranks and within 3e-2 of the single-device
   forward's scale (the single device run in rank 0's process, after the
   world, counted apart); the engine serving 4 prompts of 16-32 tokens,
   16 new tokens, 4 slots, twice, its tokens the single-device engine's
   outside near ties of the forward.  granite-moe-1b-a400m at its
   published width and depth, dropless, at tp 2: its vocab of 49155 does
   not divide, so its embedding is cut along the embed dim; a (1, 2048)
   forward with each MoE layer's experts forced to the single-device
   forward's, within the same bound, 24 flash_attn launches on each rank
   at (1, 2048, 8, 64).  Then the other kinds at tp 2 on one world of two
   ranks (``tp_kinds``), each against the single device run first in rank
   0's process (its parameters freed before the world's): rwkv6-7b and
   recurrentgemma-9b at their widths and 8 / 9 layers at f32 compute
   (within 1e-3 of the logits' scale), then their bf16 forward at tp 2
   held against the single device's f32 forward within 1.5 times the
   single device's own bf16 gap of it, deepseek-v3-671b at 4 layers,
   dropless, without its MTP head (experts forced to the single device's;
   3e-2): a (1, 512) forward and 2 prompts x 4 new tokens through the
   engine twice, no flash_attn launch; internvl2-26b at 8 layers: a
   prefill of 1024 patch embeddings + 1024 tokens (``world.model_prefill``), 8
   flash_attn launches a rank at (1, 2048, 24, 128); seamless-m4t-large-v2
   at 24 + 24 layers: an encode of (1, 2048) frames (24 launches a rank at
   (1, 2048, 8, 64), non-causal), ``decode_train``'s logits for 64 target
   tokens (48), an encode of (2, 2048), its caches and 4 decode steps at
   B = 2 fed the single device's greedy tokens (24 each); every output
   within 3e-2 of the single device's scale, the same bits on both ranks,
   each greedy token the single device's outside near ties, each rank's
   peak at most ``LM_PEAK_LIMIT``, each flash_attn shape held against its
   plain version on rank 0.  Then ``deploy(["nvsa", "llama3.2-3b"],
   Budget(devices=2, replicas="auto", tp=2))`` on the card: the mesh
   co-search gives nvsa 2 replicas and the LM (smoke scale) a world of
   two ranks, 8 requests a model served through the door, circ_conv
   launched.  Rows: ms a forward and a decode step, tensor-parallel and
   single-device (the other kinds: ms a prefill, an encode, a decode step);
   each collective's count, bytes and host ms (a timed call, the device
   synchronised around each collective); each rank's peak bytes; world
   build seconds; the mesh records.
11c. Dist: the training half of distribution (``launches_by_path["dist"]``,
   summed over the ranks), on one world of two ranks on the one card.
   llama3.2-3b at its published width (28 layers, f32 parameters, bf16
   compute) pipelined by ``distributed/gpipe.py`` over the two ranks, 14
   layers each (rank 0 holds layers 0-13 and the embedding, final norm
   and head; rank 1 draws 14-27 from the same seeded generator), 4
   microbatches of (1, 512): 5 ticks, 70 flash_attn launches on each rank;
   the logits within 3e-2 of the scale of the single device's forward of
   the same parameters, one backward through the schedule (the permutes'
   reverse, in lockstep) with each stage's gradients within 1e-4 of each
   leaf's max of the single device accumulating the same microbatches in
   order; the permutes' count, bytes and host ms (a second step, timed),
   the bubble fraction, ms a pipelined step, each rank's peak bytes.
   ``compressed_psum`` of each rank's largest gradient leaf (one layer's
   (3072, 8192) f32 MLP weight: a stage holds a leaf a layer) within the
   quantisation bound (the sum of the ranks' scale / 2) of the exact sum; ten
   error-feedback steps within the last residual of the true sum.  NVSA
   cnn at d = 128 folded by ``core/folding.py`` (n_l = 1): the frontend on
   64 panels on rank 0, the symbolic back end on 8 problems' PMFs on rank
   1 (circ_conv launched there), both bit for bit the single process's
   calls.  ``launch.train`` at llama3.2-3b's smoke width (20 steps of 4 x
   32, checkpoints at 10 and 20; the loss falling), then ``--resume`` from
   step 10's checkpoint, bit for bit the uninterrupted run; a tp-2 world
   whose ranks restore their cuts of its parameters
   (``world.CheckpointParams``, ``checkpoint.restore(shardings=)``), its
   logits within 3e-2 of the single device's.  Then tensor-parallel
   training (``world.TPTrainer``, ``dist_tp_train``): llama3.2-3b at its
   published width, 2 layers, f32 compute, one step on (1, 512) at tp 2,
   each rank against the single device in its own process (loss within
   1e-5 relative, each leaf's gradient within 1e-4 of its max |g|, leaves
   read whole included and none without a gradient where the single
   device has one, parameters after the AdamW step within 2 lr, a sanity
   bound; before it the world's optimizer alone, fed the single device's
   gradients of 3 steps cut to each rank's slice, within 1e-2 lr of the
   single device's fed the same, its global norms within 1e-5; flash_attn
   at these shapes, (1, 512, 12 or 24, 128) f32, is held in phase 2); then
   14 of its 28 layers at bf16 (a cut for memory: both ranks share the card),
   3 steps on (1, 2048) at tp 2 after the same 3 steps on the single device in
   rank 0's process, each step's loss within 3e-2 relative of the single
   device's and falling, flash_attn once per layer a rank a step; both
   rows hold the ranks' losses, norms and replicated leaves and kept
   wholes to the same bits and each cut to the slice of its kept whole.
   Rows: ms a step tp and single; the last step's collectives by phase
   (count, MB, host ms, the card synchronised around each), the logits'
   vocab gather apart; each rank's peak bytes.  Then the dry-run
   (``launch.dryrun.measure_cell``) of phase 10b's step, (1, 2048) on a (1,
   1) mesh, beside its measurement: the measured step at least the
   roofline bound, the argument bytes those of the tensors the step held.
12. The ``kernels`` JSON line: every ported kernel with its launches on the
   paths (each path's counts set to 0 just before it runs and read just
   after) and its times at its path's shape, its bound and the units the
   bound counts; entries carry other rows (``SUB_ROWS``): ``circ_conv``
   the (8, 4, 256) bucket under ``served`` (39 of NVSA's 42 calls) and
   MIMONet's training shape (64, 4, 128) under ``train`` and ``train_corr``,
   ``circ_dict`` corr and bf16 at (256, 16, 4, 256), ``unbind_classify``
   (8, 2, 4, 256, 5) under ``d256``, ``simd_fused`` bf16, (67, 5, 4, 128)
   under ``d128`` and (64, 1024, 4, 256) under ``m1024``, ``flash_attn``
   bf16 at the same shape, bf16 at (1, 2048, 16, 64) under ``hd64``,
   bf16 at (1, 2048, 48, 128) under ``internvl2`` and the four non-causal
   shapes of phase 10c under ``encoder``, ``cross``, ``decode_cross`` and
   ``encoder_32k``, and phase 11b's per-rank shapes (1, 2048, 12, 128)
   under ``tp`` and (1, 2048, 8, 64) under ``tp_moe``, and seamless's
   (``TP_ENCDEC_FLASH_ROWS``) under ``tp_encoder``, ``tp_encoder_b2``,
   ``tp_dec_self``, ``tp_cross`` and ``tp_decode_cross``
   (ms, device_ms, library_ms, bound_ms, bound_units, max_abs_err).
13. The last line: ``{"ok": true, "device": {...}}``.

It needs the repository's ``src/`` beside it and a CUDA device; without
either it exits with code 2.
"""

from __future__ import annotations

import dataclasses
import gc
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
CARD = ""   # the card's name and power limit, as nvidia-smi gives them


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

    global CARD
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    CARD = smi.splitlines()[0]
    print(CARD, flush=True)
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
                if (n, d) == (64, 128):  # MIMONet's training step (32 problems)
                    main[f"circ_conv_train_{mode}"] = row
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


FLASH_HELD_SCORES = 8192 * 8192   # past this many scores a head, hold a row sample


def flash_held_rows(sq: int, skv: int, causal: bool, device):
    """The query rows of a flash_attn call at (Sq, Skv) that are held
    against the plain version: all of them up to ``FLASH_HELD_SCORES``
    scores a head, past it (where the plain version's scores would not
    fit) 256 evenly spaced rows over all keys, which only a call without
    the mask may take."""
    import torch

    if sq * skv <= FLASH_HELD_SCORES:
        return slice(None)
    check(not causal, "a row sample of flash_attn is held without the mask only")
    return torch.linspace(0, sq - 1, 256, device=device).long()


def flash_row(gen, b: int, sq: int, skv: int, h: int, hd: int, causal: bool, dtype,
              reps: int = 10, samples: int = 21) -> dict:
    """``flash_mha`` on random q, k, v at (B, Sq, Skv, H, hd): held against
    ``flash_attention_ref`` (within 2e-5 at f32, 1e-3 + one bf16 step at
    bf16) on ``flash_held_rows`` and timed eager and on the device beside
    the plain version, SDPA and the bound.  Where a row sample is held, the
    plain version's time is left out."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend

    from repro_torch.kernels.flash_attn import ops as flash_ops
    from repro_torch.kernels.flash_attn import ref as flash_ref

    scale = hd ** -0.5
    q = torch.randn(b, sq, h, hd, device="cuda", generator=gen).to(dtype)
    k = torch.randn(b, skv, h, hd, device="cuda", generator=gen).to(dtype)
    v = torch.randn(b, skv, h, hd, device="cuda", generator=gen).to(dtype)
    flat = lambda t: t.transpose(1, 2).reshape(b * h, t.shape[1], hd)  # noqa: E731
    got = flash_ops.flash_mha(q, k, v, scale, causal)
    rows = flash_held_rows(sq, skv, causal, q.device)
    plain = isinstance(rows, slice)
    want = flash_ref.flash_attention_ref(flat(q[:, rows]), flat(k), flat(v), scale=scale,
                                         causal=causal)
    want = want.reshape(b, h, -1, hd).transpose(1, 2)
    torch.cuda.synchronize()
    f32 = dtype == torch.float32
    err = close(got[:, rows], want, FLASH_F32_ATOL if f32 else 1e-3, 0.0 if f32 else BF16_STEP)
    # SDPA's is_causal is aligned at position 0 too (tril of ones(Sq, Skv))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def sdpa(qt=qt, kt=kt, vt=vt, causal=causal, scale=scale):
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, scale=scale)

    lib_err = float((sdpa().transpose(1, 2)[:, rows].float() - want.float()).abs().max())
    check(lib_err <= (1e-3 if dtype == torch.float32 else 3e-2),
          f"flash library call err {lib_err}")
    backend = SDPBackend(torch._fused_sdp_choice(qt, kt, vt, is_causal=causal,
                                                 scale=scale)).name
    bound, by, units = flash_bound(b, sq, skv, h, hd, causal, q.element_size())
    call = lambda: flash_ops.flash_mha(q, k, v, scale, causal)  # noqa: E731
    return {"kernel": "flash_attn", "dtype": str(dtype).split(".")[1],
            "shape": [b, sq, skv, h, hd], "causal": causal, "max_abs_err": err,
            "held_rows": "all" if plain else 256,
            "kernel_ms": cuda_ms(call, reps, samples),
            "kernel_device_ms": graph_ms(call, reps, samples),
            "plain_ms": cuda_ms(lambda: flash_ref.flash_attention_ref(
                flat(q), flat(k), flat(v), scale=scale, causal=causal), reps, samples)
            if plain else None,
            "library_ms": cuda_ms(sdpa, reps, samples),
            "library": "scaled_dot_product_attention, is_causal aligned at 0 "
                       "like the kernel (1 call)",
            "library_backend": backend,
            "bound_ms": bound, "bound_by": by, "bound_units": units, "card": CARD}


def flash_kernel_rows(gen) -> dict:
    import torch

    from repro_torch.kernels.flash_attn import ref as flash_ref

    main = {}
    b = 1
    # llama3.2-3b's 24 heads of 128, granite-moe's 16 heads of 64,
    # internvl2-26b's 48 heads of 128, and half of llama's and granite's
    for sq, skv, causal, dtype, h, hd in ((2048, 2048, True, torch.float32, 24, 128),
                                          (2048, 2048, True, torch.bfloat16, 24, 128),
                                          (100, 300, True, torch.float32, 24, 128),
                                          (100, 300, True, torch.bfloat16, 24, 128),
                                          (1000, 1000, True, torch.float32, 24, 128),
                                          (1000, 1000, True, torch.bfloat16, 24, 128),
                                          (2048, 2048, True, torch.bfloat16, 16, 64),
                                          (2048, 2048, True, torch.bfloat16, 48, 128),
                                          # each rank's heads at tp 2 (phase 11b)
                                          (2048, 2048, True, torch.bfloat16, 12, 128),
                                          (2048, 2048, True, torch.bfloat16, 8, 64),
                                          # phase 11c's f32 training step: each
                                          # rank's heads and the single device's
                                          (512, 512, True, torch.float32, 12, 128),
                                          (512, 512, True, torch.float32, 24, 128)):
        row = flash_row(gen, b, sq, skv, h, hd, causal, dtype)
        f32 = dtype == torch.float32
        if f32 and sq == 2048:
            g = torch.Generator(device="cuda").manual_seed(SEED)
            q, k, v = (torch.randn(b * h, n, hd, device="cuda", generator=g)
                       for n in (sq, skv, skv))
            want = flash_ref.flash_attention_ref(q, k, v, scale=hd ** -0.5, causal=causal)
            single = single_tf32_attention(q, k, v, hd ** -0.5, causal)
            row["single_tf32_max_abs_err"] = float((single - want).abs().max())
            check(row["single_tf32_max_abs_err"] > FLASH_F32_ATOL,
                  f"one tf32 product per f32 product: err "
                  f"{row['single_tf32_max_abs_err']} is within the f32 limit "
                  f"{FLASH_F32_ATOL}, which so would not show a lost split")
        emit(row)
        if sq == 2048 and h in (12, 8) and causal:
            main["flash_attn_tp" if h == 12 else "flash_attn_tp_moe"] = row
        elif sq == 2048 and hd == 64:
            main["flash_attn_hd64"] = row
        elif sq == 2048 and h == 48:
            main["flash_attn_internvl2"] = row
        elif sq == 2048:
            main["flash_attn" if f32 else "flash_attn_bf16"] = row
    # seamless-m4t-large-v2's shapes on each rank at tp 2 (8 of its 16 heads)
    for name, (b, sq, skv, h, hd, causal) in TP_ENCDEC_FLASH_ROWS.items():
        row = flash_row(gen, b, sq, skv, h, hd, causal, torch.bfloat16)
        emit(row)
        main[f"flash_attn_{name}"] = row
    return main


# (B, Sq, Skv, H, hd, causal) of seamless-m4t-large-v2's attention on each rank
# at tp 2 (phase 11b): the encoder at (1, 2048) and at the serving batch of 2,
# decode_train's self- and cross-attention over 64 target tokens, the decode
# step's cross-attention
TP_ENCDEC_FLASH_ROWS = {"tp_encoder": (1, 2048, 2048, 8, 64, False),
                        "tp_encoder_b2": (2, 2048, 2048, 8, 64, False),
                        "tp_dec_self": (1, 64, 64, 8, 64, True),
                        "tp_cross": (1, 64, 2048, 8, 64, False),
                        "tp_decode_cross": (2, 1, 2048, 8, 64, False)}


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
                 Budget(max_pes=4096, max_batch=8), options={"nvsa": {"d": 256}})
    deploy_s = time.perf_counter() - t0
    analysis = dep.report()["analysis"]
    emit({"phase": "deploy_preflight", "ok": analysis["ok"],
          "coverage": analysis["coverage"], "findings": analysis["findings"]})
    check(analysis["ok"] and analysis["coverage"]["schedules"] == len(DEPLOY_MODELS),
          f"deploy preflight: {analysis}")
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
    within 1e-4 of the CPU; flash_mha's gradient (its kernel forward, the
    plain chain's backward, no launch) within 1e-4 of each input's max
    |grad| of the CPU's, and flash_mha taking the (B, S, H, hd) view of a
    (B, H, S, hd) tensor bit for bit as its copy."""
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
    w = torch.randn(b, sq, h, hd, device="cuda", generator=gen)
    grads = []
    for dev in ("cuda", "cpu"):
        leaves = [t.to(dev).clone().requires_grad_() for t in (q, kk, v)]
        out = launched(lambda: flash_ops.flash_mha(*leaves, hd ** -0.5), "flash_attn",
                       int(dev == "cuda"))
        check(out.grad_fn is not None, f"flash_mha under grad on {dev}: no grad_fn")
        loss = (w.to(dev) * out).sum()
        g = launched(lambda: torch.autograd.grad(loss, leaves), "flash_attn", 0)
        grads.append([t.cpu() for t in g])
    err = max(float((x - y).abs().max()) / float(y.abs().max()) for x, y in zip(*grads))
    check(err <= 1e-4, f"flash_mha gradient {err} of its scale from the CPU's")
    emit({"phase": "ops", "entry": "flash_mha backward", "shape": [b, sq, h, hd],
          "layout": "(B, H, S, hd) transposed", "launches": {"forward": 1, "backward": 0},
          "max_grad_diff_vs_cpu_of_scale": err})
    view = launched(lambda: flash_ops.flash_mha(q, kk, v, hd ** -0.5), "flash_attn", 1)
    copy = launched(lambda: flash_ops.flash_mha(q.contiguous(), kk.contiguous(),
                                                v.contiguous(), hd ** -0.5), "flash_attn", 1)
    check(not q.is_contiguous() and torch.equal(view, copy),
          "flash_mha: the transposed view differs from its contiguous copy")
    emit({"phase": "ops", "entry": "flash_mha, (B, H, S, hd) transposed",
          "shape": [b, sq, sq, h, hd], "dtype": "float32", "launches": 2,
          "bit_identical_to_contiguous": True})


# -- phase 9a: analyze ---------------------------------------------------------

# block dim and buckets of the schedules the analyze phase compiles
ANALYZE_D = 256
ANALYZE_BUCKETS = (1, 2, 4, 8)


def phase_analyze(dev: str = "cuda") -> dict[str, int]:
    """``repro_torch.analyze``'s full tier on the card: every reasoner x
    variant at ``ANALYZE_D`` over ``ANALYZE_BUCKETS`` and nvsa cnn at int8
    (qmatmul on the frontend), double trace on, then the probes of all six
    kernels on ``dev``.  Returns the path's launch counts (the probes')."""
    from repro_torch.analyze import registry_check
    from repro_torch.analyze.preflight import preflight, reason_subjects
    from repro_torch.backend import registry
    from repro_torch.configs import base as cb

    registry.reset_launches()
    t0 = time.perf_counter()
    subjects = reason_subjects(cb.REASON_WORKLOADS, ANALYZE_D, ANALYZE_BUCKETS, dev)
    entry = cb.REASON_WORKLOADS["nvsa"]
    cfg = entry.make_config(d=ANALYZE_D, nn_precision="int8")
    subjects.append((cb.compile_reason_schedule("nvsa", cfg, "cnn",
                                                batch_size=ANALYZE_BUCKETS, device=dev),
                     cfg, entry, "cnn"))
    t1 = time.perf_counter()
    report = preflight(subjects, lint_root=str(ROOT / "src" / "repro_torch"),
                       double_trace=True, device=dev)
    t2 = time.perf_counter()
    check(registry.LAUNCHES == dict.fromkeys(registry.KERNELS, 0),
          f"the checks on meta launched kernels: {registry.LAUNCHES}")
    probes, rows = registry_check.run_probes(dev)
    report.merge(probes)
    t3 = time.perf_counter()
    counts = dict(registry.LAUNCHES)
    for row in rows:
        emit({"phase": "analyze_probe", **row.record(), "card": CARD})
    emit({"phase": "analyze", "ok": report.ok, "errors": len(report.errors),
          "warnings": len(report.warnings), "coverage": report.coverage,
          "findings": [f.render() for f in report.findings],
          "seconds": {"compile": t1 - t0, "checks": t2 - t1, "probes": t3 - t2,
                      "total": t3 - t0},
          "launches": counts, "card": CARD})
    check(report.ok, "analyze: " + report.render())
    check(report.coverage["schedules"] == len(subjects),
          f"analyze: {report.coverage['schedules']} schedules of {len(subjects)}")
    for row in rows:
        check(row.probed > row.refused >= 1 and counts[row.kernel] > 0,
              f"analyze: {row.record()} with {counts[row.kernel]} launches")
        check(row.max_err_plain is not None and row.max_err_plain <= row.epsilon,
              f"analyze: {row.record()}")
    return counts


# -- phase 9b: NSAI training ----------------------------------------------------

TRAIN_FIRST_TOL = {"loss": 1e-5, "grad": 1e-4, "stats": 1e-5}   # card against CPU
TRAIN_STEPS, TRAIN_PROBLEMS, TRAIN_EVAL = 400, 400, 128   # the example's defaults
MIMO_STEPS, MIMO_BATCH, MIMO_PAIRS = 200, 32, 800
LVRF_STEPS, LVRF_LR = 60, 0.5


def example_module(name: str):
    """``examples/<name>.py`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tree_rel_err(got, want) -> float:
    """Largest |got - want| over a tree's leaves, each leaf's error taken
    relative to its own max |want|; None leaves must match."""
    from repro_torch.common.tree import tree_leaves

    worst = 0.0
    for g, w in zip(tree_leaves(got), tree_leaves(want), strict=True):
        check((g is None) == (w is None), "a gradient is None on one device only")
        if w is not None:
            scale = max(float(w.abs().max()), 1e-30)
            worst = max(worst, float((g.cpu().float() - w.float()).abs().max()) / scale)
    return worst


def train_first_step(label: str, fn, has_aux: bool, params, args, ocfg,
                     phase: str = "train", kernel: str = "circ_conv") -> None:
    """One seeded init and one batch through ``fn`` on the card and on the
    CPU: the loss, every grad leaf (relative to its max |grad|), the BN
    batch stats (relative to their scale) and one AdamW step.  An Adam
    first step moves each element by up to lr whatever its gradient's
    size, so the step is held within 2 lr everywhere, and within 1e-6 at
    all but one element in 10^3 (gradients f32 rounding away from 0).  The
    row counts ``kernel``'s launches on the card."""
    import torch

    from repro_torch import interop
    from repro_torch.backend import registry
    from repro_torch.common.tree import tree_leaves
    from repro_torch.train import optimizer as opt

    out = {}
    for dev in ("cuda", "cpu"):
        p = interop.to_device(params, dev)
        a = [interop.to_device(x, dev) for x in args]
        before = registry.LAUNCHES[kernel]
        value, grads = opt.value_and_grad(fn, has_aux)(p, *a)
        new, _, metrics = opt.apply_updates(p, grads, opt.init_state(p, ocfg), ocfg)
        if dev == "cuda":
            torch.cuda.synchronize()
        out[dev] = (value, grads, new, metrics, registry.LAUNCHES[kernel] - before)
    (vg, gg, ng, mg, launches), (vc, gc, nc, mc, _) = out["cuda"], out["cpu"]
    loss_g, loss_c = (float(v[0] if has_aux else v) for v in (vg, vc))
    loss_err = abs(loss_g - loss_c)
    grad_err = tree_rel_err(gg, gc)
    stats_err = 0.0
    if has_aux:
        check(list(vg[1]) == list(vc[1]), f"train {label}: BN stats paths differ")
        stats_err = tree_rel_err([list(t) for t in vg[1].values()],
                                 [list(t) for t in vc[1].values()])
    lr0 = float(mc["lr"])
    diffs = torch.cat([(g.cpu() - c).abs().reshape(-1)
                       for g, c in zip(tree_leaves(ng), tree_leaves(nc))])
    step_max, step_far = float(diffs.max()), int((diffs > 1e-6).sum())
    row = {"phase": phase, "row": "first_step", "model": label, "loss_cuda": loss_g,
           "loss_cpu": loss_c, "loss_abs_err": loss_err, "grad_rel_err": grad_err,
           "bn_stats_rel_err": stats_err, "grad_norm_cuda": float(mg["grad_norm"]),
           "grad_norm_cpu": float(mc["grad_norm"]), "adamw_step_max_abs_diff": step_max,
           "adamw_elements_beyond_1e-6": step_far, "adamw_elements": diffs.numel(),
           "lr0": lr0, f"{kernel}_launches": launches, "tolerances": TRAIN_FIRST_TOL}
    emit(row)
    check(loss_err <= TRAIN_FIRST_TOL["loss"], f"train {label}: loss {loss_err} from the CPU")
    check(grad_err <= TRAIN_FIRST_TOL["grad"], f"train {label}: grads {grad_err} from the CPU")
    check(stats_err <= TRAIN_FIRST_TOL["stats"], f"train {label}: BN stats {stats_err}")
    check(step_max <= 2 * lr0 and step_far <= diffs.numel() // 1000,
          f"train {label}: AdamW step {step_max} ({step_far} elements beyond 1e-6)")


def phase_train() -> dict[str, int]:
    """NSAI training on the card at the published widths; returns the
    path's launch counts.  a. first-step parity with the CPU for
    ``nvsa.frontend_loss`` (``NVSAConfig()``, 64 panels),
    ``mimonet.loss_fn`` (``MIMONetConfig()``, 32 problems of K = 2, so
    circ_elem runs at (64, 4, 128)) and ``lvrf.loss_fn`` (``LVRFConfig()``,
    16 oracle problems); b. the ``train_nvsa_raven`` twin: 400 steps on the
    panels of 400 problems, then Tab. IV on 128 problems per style;
    c. MIMONet: 200 AdamW steps on panel pairs labelled by shape type;
    d. LVRF: 60 full-batch SGD steps at lr 0.5 on the 16 oracle problems."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.backend import registry
    from repro_torch.data import raven
    from repro_torch.models import lvrf, mimonet, nvsa
    from repro_torch.nn import init as nninit
    from repro_torch.train import optimizer as opt

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    twin = example_module("train_nvsa_raven_torch")
    ocfg = opt.AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=TRAIN_STEPS,
                           weight_decay=1e-4)
    registry.reset_launches()

    # a. first-step parity, card against CPU
    ncfg = nvsa.NVSAConfig()
    imgs, attrs = raven.panel_dataset(ncfg.raven, seed=11, n_problems=4)
    gen = torch.Generator().manual_seed(SEED)
    train_first_step("nvsa", nvsa.frontend_loss, True,
                     nninit.materialize(nvsa.nvsa_spec(ncfg), gen),
                     (ncfg, torch.from_numpy(imgs), torch.from_numpy(attrs)), ocfg)
    mcfg = mimonet.MIMONetConfig()
    k = mcfg.n_channels
    pair_imgs, pair_attrs = raven.panel_dataset(mcfg.raven, seed=12,
                                                n_problems=MIMO_PAIRS * k // 16)
    pairs = torch.from_numpy(pair_imgs).reshape(-1, k, *pair_imgs.shape[1:])
    shapes = torch.from_numpy(pair_attrs[:, 0]).reshape(-1, k)
    mkeys = mimonet.mimonet_keys(mcfg, gen)
    train_first_step("mimonet", mimonet.loss_fn, True,
                     nninit.materialize(mimonet.mimonet_spec(mcfg), gen),
                     (mkeys, mcfg, pairs[:MIMO_BATCH], shapes[:MIMO_BATCH]), ocfg)
    lcfg = lvrf.LVRFConfig()
    batch = raven.generate_batch(lcfg.raven, seed=5, n=16)
    ctx = nvsa.oracle_pmfs(ncfg, torch.from_numpy(batch["context_attrs"]))
    cand = nvsa.oracle_pmfs(ncfg, torch.from_numpy(batch["candidate_attrs"]))
    answers = torch.from_numpy(batch["answer"]).long()
    books = lvrf.lvrf_codebooks(lcfg, gen)
    lparams = nninit.materialize(lvrf.lvrf_spec(lcfg), gen)
    train_first_step("lvrf", lvrf.loss_fn, False, lparams,
                     (books, lcfg, ctx, cand, answers), ocfg)

    # b. the example's run and Tab. IV
    t0 = time.perf_counter()
    params, losses, loop_s = twin.train_frontend(ncfg, TRAIN_STEPS, TRAIN_PROBLEMS,
                                                  device="cuda")
    loss0, late = float(losses[0]), losses[-50:]   # steps 350-399 of 400
    emit({"phase": "train", "row": "nvsa_frontend", "steps": TRAIN_STEPS,
          "panels": TRAIN_PROBLEMS * 16, "batch": 64,
          "loss_every_50": [float(losses[s]) for s in range(0, TRAIN_STEPS, 50)],
          "loss_last": float(losses[-1]), "loss_last_50_mean": float(late.mean()),
          "loss_last_50_range": [float(late.min()), float(late.max())],
          "ms_per_step": loop_s / TRAIN_STEPS * 1e3, "seconds": time.perf_counter() - t0})
    check(bool(torch.isfinite(losses).all()), "nvsa training: a loss is not finite")
    check(float(late.mean()) < loss0 / 4,
          f"nvsa training: mean loss {float(late.mean())} of the last 50 steps, "
          f"step 0 {loss0}")
    tab = twin.tab4(params, ncfg, TRAIN_EVAL)
    for style, row in tab.items():
        for label, r in row.items():
            emit({"phase": "train", "row": "tab4", "style": style, "precision": label, **r})
        check(row["fp32"]["answer_acc"] >= 0.9,
              f"Tab. IV {style} fp32 answer accuracy {row['fp32']['answer_acc']}")
    ratio = tab["raven"]["fp32"]["memory_bytes"] / tab["raven"]["mp"]["memory_bytes"]
    emit({"phase": "train", "row": "tab4_memory_ratio", "fp32_over_mp": ratio})
    check(3.5 < ratio < 8.5, f"Tab. IV memory ratio {ratio}")

    # c. MIMONet: AdamW at the example's lr on panel pairs labelled by shape
    mparams = nninit.materialize(mimonet.mimonet_spec(mcfg),
                                 torch.Generator(device="cuda").manual_seed(SEED))
    keys_d = mkeys.cuda()
    n_train = pairs.shape[0] - 64  # the last 64 pairs held out
    pairs_d, shapes_d = pairs.cuda(), shapes.cuda()
    mocfg = dataclasses.replace(ocfg, total_steps=MIMO_STEPS)
    mstate = opt.init_state(mparams, mocfg)
    grad_fn = opt.value_and_grad(mimonet.loss_fn, has_aux=True)
    rng = np.random.default_rng(0)
    mlosses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MIMO_STEPS):
        idx = torch.from_numpy(rng.integers(0, n_train, MIMO_BATCH)).cuda()
        (loss, stats), grads = grad_fn(mparams, keys_d, mcfg, pairs_d[idx], shapes_d[idx])
        mparams, mstate, _ = opt.apply_updates(mparams, grads, mstate, mocfg)
        mparams = mimonet.apply_bn_stats(mparams, stats, momentum=0.9)
        mlosses.append(loss)
    mlosses = torch.stack(mlosses).cpu()
    mimo_s = time.perf_counter() - t0
    first, last = float(mlosses[:20].mean()), float(mlosses[-20:].mean())
    acc_train = mimonet.accuracy(mparams, keys_d, mcfg, pairs_d[:64], shapes_d[:64])
    acc_held = mimonet.accuracy(mparams, keys_d, mcfg, pairs_d[n_train:], shapes_d[n_train:])
    emit({"phase": "train", "row": "mimonet", "steps": MIMO_STEPS, "batch": MIMO_BATCH,
          "loss_every_50": [float(mlosses[s]) for s in range(0, MIMO_STEPS, 50)],
          "loss_mean_first_20": first, "loss_mean_last_20": last,
          "ms_per_step": mimo_s / MIMO_STEPS * 1e3, "accuracy_train_64": acc_train,
          "accuracy_held_out_64": acc_held})
    check(bool(torch.isfinite(mlosses).all()) and last < first,
          f"mimonet training: loss {first} -> {last}")

    # d. LVRF at d = 128: full-batch SGD, as test_lvrf_learns_rules_quickly
    lp = {k: v.cuda() for k, v in lparams.items()}
    args = ([b.cuda() for b in books], lcfg, [c.cuda() for c in ctx],
            [c.cuda() for c in cand], answers.cuda())
    lvrf_grad = opt.value_and_grad(lvrf.loss_fn)
    llosses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LVRF_STEPS):
        loss, grads = lvrf_grad(lp, *args)
        lp = {k: lp[k] - LVRF_LR * grads[k] for k in lp}
        llosses.append(loss)
    llosses = torch.stack(llosses).cpu()
    lvrf_s = time.perf_counter() - t0
    lacc = lvrf.accuracy(lp, *args)
    emit({"phase": "train", "row": "lvrf", "d": lcfg.d, "steps": LVRF_STEPS,
          "loss_first": float(llosses[0]), "loss_last": float(llosses[-1]),
          "ms_per_step": lvrf_s / LVRF_STEPS * 1e3, "accuracy": lacc})
    check(lacc >= 0.9, f"lvrf training: accuracy {lacc}")

    counts = dict(registry.LAUNCHES)
    check(counts["circ_conv"] > 0, "kernel circ_conv was not launched on the train path")
    emit({"phase": "train", "row": "phase", "seconds": time.perf_counter() - t_phase,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "launches": {k: v for k, v in counts.items() if v}})
    return counts


# -- phase 10: the LM substrate --------------------------------------------------

LM_ARCH = "llama3.2-3b"
LM_FORWARD_SHAPES = ((1, 2048), (4, 512))   # (B, S) of the timed forwards
LM_CPU_LAYERS, LM_CPU_SHAPE = 2, (1, 512)    # the forward held against the CPU
LM_LOGIT_TOL = 3e-2     # of the logits' scale: 3e-2 x max(1, max |logit|)
LM_CONTROL_BACK = 16    # prompt positions before the generated ones the control reads
LM_REC_WARM = 15        # a held recurrent check leaves out each sequence's first 15 positions
# decode and the full-context forward are two bf16 computations of the same
# logits: at every generated position of every stream (and the
# LM_CONTROL_BACK before), the decode's logits lie within LM_LOGIT_TOL of
# the forward's scale there.  A greedy token may
# so leave the forward's argmax only where the forward's top-2 margin is
# at most twice that (a near tie, counted)
LM_SERVE = dict(max_slots=8, max_len=512, max_new_tokens=32, decode_block=8,
                prefill_bucket=16)
LM_REQUESTS, LM_PROMPTS = 16, (16, 64)
LM_SAMPLED = dict(temperature=0.8, top_k=50)
LM_RING_ARCH, LM_RING_LAYERS = "gemma3-12b", 6   # one 5:1 local:global unit
LM_RING_REQUESTS, LM_RING_PROMPTS = 1, (1040, 1120)   # past the 1024 window; one for time
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
LM_PEAK_LIMIT = 70e9    # max_memory_allocated of each arch's run
# the recurrent kinds at their published widths: rwkv6-7b (32 layers, d
# 4096, WKV heads of 64, chunk 64) and recurrentgemma-9b (38 layers, d 4096,
# RG-LRU and MQA with a 2048-token window, 2:1); their engines admit with
# one exact-length prefill scan per distinct prompt length
LM_RWKV_ARCH, LM_GRIFFIN_ARCH = "rwkv6-7b", "recurrentgemma-9b"
LM_REC_ARCHS = (LM_RWKV_ARCH, LM_GRIFFIN_ARCH)
LM_REC_FORWARDS = ((1, 2048), (4, 512))
LM_REC_CHUNK_TOKENS = 256   # rwkv's chunked WKV against its token scan
LM_RWKV_DEPTHS = (1, 2, 4, 8, 16, 32)   # ... at bf16 at these depths
LM_RWKV_BF16_LAYERS = 2     # the depth to which the bf16 paths are held
LM_REC_CPU_LAYERS = {LM_RWKV_ARCH: 2, LM_GRIFFIN_ARCH: 3}   # griffin: one unit
LM_REC_SERVE = dict(LM_SERVE, max_new_tokens=16)   # 8 slots of 512 tokens
LM_REC_REQUESTS, LM_REC_LENGTHS = 8, (16, 32, 48)   # three distinct lengths
LM_REC_RING_REQUESTS, LM_REC_RING_PROMPTS = 1, (2056, 2100)   # past the window; one for time
LM_REC_RING_NEW = 4   # new tokens a ring prompt (one decode block): the scans take the time
# internvl2-26b: 48 layers of 390M parameters and a 1.14B untied embed and
# head, 79.4 GB of f32; cut by memory to 38 layers (63.8 GB)
VLM_ARCH, VLM_LAYERS = "internvl2-26b", 38
# the engine rows of the archs at full depth serve the first layers only,
# cut for the script's time (each row is host-bound, its time about
# proportional to the depth); their forwards run at full depth
LM_ENGINE_LAYERS = {LM_ARCH: 7, "granite-moe-1b-a400m": 6, LM_RWKV_ARCH: 8,
                    LM_GRIFFIN_ARCH: 9}   # griffin: 3 (rec, rec, attn) units
VLM_IMAGE_TOKENS = VLM_TEXT_TOKENS = 1024
VLM_CPU_LAYERS, VLM_CPU_TOKENS = 2, 128


def lm_config(arch_id: str):
    """The published width of ``arch_id``; gemma3-12b cut to one pattern unit
    of depth (6 of its 48 layers: 5 local with window 1024, 1 global),
    deepseek-v3-671b to ``LM_MLA_LAYERS`` (its 3 dense layers and 1 MoE
    layer of 61), internvl2-26b to ``VLM_LAYERS`` of its 48."""
    import dataclasses

    from repro_torch.configs import get_arch

    cfg = get_arch(arch_id).make_full()
    if arch_id == LM_RING_ARCH:
        cfg = dataclasses.replace(cfg, n_layers=LM_RING_LAYERS)
    if arch_id == "deepseek-v3-671b":
        cfg = dataclasses.replace(cfg, n_layers=LM_MLA_LAYERS)
    if arch_id == VLM_ARCH:
        cfg = dataclasses.replace(cfg, lm=dataclasses.replace(cfg.lm, n_layers=VLM_LAYERS))
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
    """While open, the first ``flash_mha`` call at each (q shape, k shape,
    causal) is held against ``flash_attention_ref`` on its own inputs and
    output, within 1e-3 + one bf16 step (the path computes in bf16), as
    ``flash_kernel_rows`` holds the kernel; the check itself launches
    nothing, on the query rows ``flash_held_rows`` picks.  ``rows`` keeps
    one row per call held."""

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

        import torch

        out = self._launch(q, k, v, scale, causal)
        key = (tuple(q.shape), tuple(k.shape), bool(causal))
        if key not in self._seen:
            self._seen.add(key)
            b, s, h, hd = q.shape
            rows = flash_held_rows(s, k.shape[1], causal, q.device)
            sampled = not isinstance(rows, slice)
            flat = lambda t: t.transpose(1, 2).reshape(b * h, t.shape[1], hd)  # noqa: E731
            with torch.no_grad():   # under training, the check records no graph
                want = flash_ref.flash_attention_ref(flat(q[:, rows]), flat(k), flat(v),
                                                     scale=scale, causal=causal)
                err = close(out[:, rows], want.reshape(b, h, -1, hd).transpose(1, 2), 1e-3,
                            BF16_STEP)
            self.rows.append({"shape": [b, s, h, hd], "skv": k.shape[1], "causal": causal,
                              "held_rows": 256 if sampled else "all",
                              "max_abs_err": err})
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


def lm_forward_logits(params, arch, cfg, prompt, tokens, dev, back: int = 0):
    """The full-context forward (``configs.base.forward_fn``) over the
    prompt and the tokens before the last: its f32 logits at each generated
    position (row ``back + j`` predicts ``tokens[j]``), after those of the
    ``back`` prompt positions before."""
    import numpy as np
    import torch

    from repro_torch.configs import base as cb

    forward, readout = cb.forward_fn(arch, cfg)
    ctx = torch.as_tensor(np.concatenate([prompt, tokens[:-1]]), device=dev)[None].long()
    return readout(params, forward(params, ctx)[0, len(prompt) - 1 - back:]).float()


def lm_decode_logits(params, arch, cfg, seqs, starts, dev, batch=None, cache_len=None,
                     state_dtype=None):
    """``serve_fns``' decode step scanned over ``seqs``, one slot each, with
    per-slot positions (a slot past its end repeats its last token at its
    last position, as the engine's prefill clamps); returns each slot's f32
    logits at positions ``starts[i]`` and after.  ``batch`` / ``cache_len``
    (default: one slot per sequence, the longest sequence) give the scan an
    engine's slot count and KV length, so that it computes what that engine
    computes; sequences then go ``batch`` at a time.  ``state_dtype``
    casts the floating leaves of the decode state (the KV caches and
    carries, bf16 as allocated)."""
    import torch

    from repro_torch.common.tree import tree_map
    from repro_torch.configs import base as cb

    if batch is not None and len(seqs) > batch:
        return [x for i in range(0, len(seqs), batch)
                for x in lm_decode_logits(params, arch, cfg, seqs[i:i + batch],
                                          starts[i:i + batch], dev, batch, cache_len,
                                          state_dtype)]
    top = max(map(len, seqs))
    seqs = list(seqs) + [seqs[0]] * ((batch or len(seqs)) - len(seqs))
    step, init = cb.serve_fns(arch, cfg, cache_len or top)
    caches = init(len(seqs), device=dev)
    if state_dtype is not None:
        caches = tree_map(lambda t: t.to(state_dtype) if t.is_floating_point() else t,
                          caches)
    out = [[] for _ in seqs]
    for t in range(top):
        pos = [min(t, len(s) - 1) for s in seqs]
        tok = torch.tensor([int(s[p]) for s, p in zip(seqs, pos)], device=dev)
        caches, logits = step(params, caches, tok, torch.tensor(pos, device=dev))
        for i, s in enumerate(seqs[:len(starts)]):
            if starts[i] <= t < len(s):
                out[i].append(logits[i].float())
    return [torch.stack(o) for o in out[:len(starts)]]


def logit_scale(logits, inputs=None):
    """max(1, max |logit|) of each row; with ``inputs`` (each row's input
    token), over the other columns.  A tied embedding echoes the input
    token (recurrentgemma-9b's echo logit is ~81 against ~5 elsewhere), so
    a scale taken with that column would admit any error below the echo's
    3 %."""
    import torch

    a = logits.abs()
    if inputs is not None:
        a = a.scatter(-1, torch.as_tensor(inputs, device=a.device).long()[:, None], 0.0)
    return a.amax(-1).clamp(min=1.0)


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


def lm_check_decode(params, arch, cfg, prompts, results, dev, label,
                    serve: dict | None = None, held_cfg=None) -> dict:
    """The greedy streams against the full-context forward (flash_attn on the
    unwindowed layers) over prompt + generated tokens.  At every generated
    position of every stream, and at the ``LM_CONTROL_BACK`` prompt
    positions before them, the logits of ``decode_step`` scanned over the
    same tokens lie within ``LM_LOGIT_TOL`` of the forward's scale there,
    and the stream's token is the argmax wherever its top-2 margin exceeds
    twice that (near ties counted).  A control reads the decode one
    position late against the forward over those same positions, which the
    tolerance must not admit everywhere (a stream that repeats one token
    cannot show a late read by itself, hence the prompt positions).

    A MoE arch passes its engine's ``serve``.  Routing is discrete: a
    last-bit difference between two bf16 computations of a token's hidden
    state can send it to another expert, and then the two part by far more
    than a bf16 step, for that token and every later one.  So the scan runs
    at the engine's slot count and KV length, computing what the engine
    computes, and the tokens are held to that scan's argmax; the scan is
    then run again with each MoE layer's experts for each token forced to
    those the forward chose (``RoutesHeld``; the weights stay the scan's
    own), and that forced scan is what is held against the forward.  The
    (token, layer) choices the forcing changed are counted.

    The recurrent archs at full depth pass ``serve`` and ``held_cfg``,
    their config at f32 compute.  The tokens are then held to the argmax
    of the bf16 scan at the engine's slot count, which computes what the
    engine computes, and the decode scan, its state in f32 too, and the
    forward are held against each other at ``held_cfg`` over the same
    tokens, the scale taken without the input token's column
    (``logit_scale``), from position ``LM_REC_WARM`` of each sequence on
    (``lm_rec_early_rows`` reports the positions before: there the state
    holds few tokens and rounding alone parts two computations of the
    same function at full depth).  Rounding, not the function, parts the
    two at full depth otherwise: at bf16 compute the decode's WKV scan and the
    forward's chunked WKV part through bf16 rounding flips that grow
    with depth, in the reference as in the port
    (``tests/test_torch_rwkv_width.py``), and the bf16 carries of the
    decode state (the token shifts, the conv window, the KV ring) feed
    the same growth at f32 compute; the bf16 pair's largest gap is
    reported, in units of the scale.  Returns the counts and each stream's
    margins, in units of the tie margin."""
    import numpy as np
    import torch

    uids = sorted(results)
    seqs = [np.concatenate([prompts[u], results[u].tokens[:-1]]) for u in uids]
    warm = 0 if held_cfg is None else LM_REC_WARM
    back = [max(0, min(LM_CONTROL_BACK, len(prompts[u]) - 1 - warm)) for u in uids]
    starts = [len(prompts[u]) - 1 - k for u, k in zip(uids, back)]
    scan = {} if serve is None else dict(batch=serve["max_slots"],
                                         cache_len=serve["max_len"])
    fwd, routes = [], []
    for u, k in zip(uids, back):
        with RoutesHeld() as held:
            fwd.append(lm_forward_logits(params, arch, cfg, prompts[u], results[u].tokens,
                                         dev, k))
        routes.append(held.calls)
    decoded = lm_decode_logits(params, arch, cfg, seqs, starts, dev, **scan)
    # the greedy tokens' reference: the forward, or for a MoE or recurrent
    # arch the scan
    argref = fwd if serve is None else decoded
    forcing = own_gap = inputs = None
    if held_cfg is not None:
        own_gap = max(float(((d - f).abs().amax(-1) / logit_scale(f)).max())
                      for d, f in zip(decoded, fwd))
        fwd = [lm_forward_logits(params, arch, held_cfg, prompts[u], results[u].tokens,
                                 dev, k) for u, k in zip(uids, back)]
        decoded = lm_decode_logits(params, arch, held_cfg, seqs, starts, dev, **scan,
                                   state_dtype=torch.float32)
        inputs = [s[st:] for s, st in zip(seqs, starts)]
    elif serve is not None:
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
            decoded = lm_decode_logits(params, arch, cfg, seqs, starts, dev, **scan)
    positions = held_positions = near = flips = 0
    worst = worst_share = 0.0
    late_beyond = late_n = 0
    margins = {}
    for n, (u, dec, f, a, k) in enumerate(zip(uids, decoded, fwd, argref, back)):
        tol = LM_LOGIT_TOL * logit_scale(f, None if inputs is None else inputs[n])
        late = (dec[:-1] - f[1:]).abs().amax(-1) > tol[1:]
        late_beyond, late_n = late_beyond + int(late.sum()), late_n + late.numel()
        gap = (dec - f).abs().amax(-1)
        j = int((gap / tol).argmax())
        check(bool((gap <= tol).all()),
              f"{label}: request {u} position {j - k} after the prompt: decode logits "
              f"{float(gap[j])} from the forward's, beyond {float(tol[j])}")
        held_positions += len(gap)
        worst, worst_share = max(worst, float(gap.max())), max(worst_share,
                                                                float((gap / tol).max()))
        a = a[k:]
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
    row = {"positions": positions, "held_positions": held_positions, "near_ties": near,
           "tie_flips": flips, "max_logit_gap": worst, "max_gap_of_tolerance": worst_share,
           "late_by_one_beyond_tolerance": [late_beyond, late_n], "margins": margins}
    if forcing is not None:
        row["routing_choices_forced"] = [forcing.changed, sum(map(len, seqs)) * n_moe]
    if held_cfg is not None:
        row.update(held_at="float32 compute and state", scale_without_input_column=True,
                   held_from_position=warm, own_dtype_max_gap_of_scale=own_gap)
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


def lm_engine_row(arch, params, cfg, serve: dict, prompts, label, dev,
                  full: bool, held: FlashHeld, profile: bool = False,
                  held_cfg=None) -> dict:
    """Serve ``prompts`` through ``Engine`` on ``serve_fns(arch, cfg)``:
    greedy twice (the second run measured) and online (``submit`` /
    ``drain_ready``), every request answered with its budget, the greedy
    streams against the forward (``lm_check_decode``, given ``serve`` for
    a MoE arch or with ``held_cfg``; its ``flash_mha`` calls held by
    ``held``); with ``full`` also sampled, offline and online, and, for a
    dense arch, at ``max_slots=3``; with ``full`` or ``profile`` the decode
    step's profile.  Returns the row, with its seconds."""
    import torch

    from repro_torch.common.tree import tree_leaves
    from repro_torch.configs import base as cb
    from repro_torch.serve.engine import Engine, Request, ServeConfig

    t0 = time.perf_counter()
    step, init = cb.serve_fns(arch, cfg, serve["max_len"])
    reqs = [Request(uid=i, prompt=p) for i, p in enumerate(prompts)]
    moe = getattr(cfg, "moe", None)

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
        decode = lm_check_decode(params, arch, cfg, prompts, greedy, dev, label,
                                 None if moe is None and held_cfg is None else serve,
                                 held_cfg)
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
           "stateful_prefill": eng.cfg.stateful_prefill,
           "kv_cache_bytes": kv_bytes,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "decode_vs_forward": {k: v for k, v in decode.items() if k != "margins"}}
    if full and moe is None:
        row["max_slots_3_left_at_near_ties"] = lm_same_streams(
            greedy, engine(max_slots=3).run(reqs), decode["margins"], label)
    if full:
        sampled = engine(**LM_SAMPLED).run(reqs)
        answered(sampled, "sampled")
        check(same(sampled, online(engine(**LM_SAMPLED))),
              f"{label}: online sampled streams differ from run()")
        check(not same(sampled, greedy), f"{label}: sampled streams equal greedy ones")
        row["sampled"] = dict(LM_SAMPLED, online_equals_offline=True)
    if full or profile:
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

    layer = lm._unstack(params["body"], 1)[0]["u0"]["ffn"]
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
    serve_cfg, params_e, label = dropless(cfg), params, arch_id
    if arch_id in LM_ENGINE_LAYERS:
        params_e, serve_cfg, label = lm_engine_depth(params, arch_id, serve_cfg)
    serve = LM_MOE_SERVE[arch_id]
    n, lens = LM_MOE_REQUESTS[arch_id]
    prompts = lm_prompts(cfg.vocab, n, lens, SEED + 5)
    peak = torch.cuda.max_memory_allocated()
    row = lm_engine_row(arch, params_e, serve_cfg, serve, prompts, label, dev,
                        full=arch_id == LM_MOE_ARCHS[0], held=held)
    row.update(params=nninit.param_count(spec), param_bytes=nninit.param_bytes(spec),
               capacity_factor=serve_cfg.moe.capacity_factor,
               max_memory_allocated=max(peak, row["max_memory_allocated"]))
    emit(row)
    check(row["max_memory_allocated"] <= LM_PEAK_LIMIT,
          f"{arch_id}: {row['max_memory_allocated']} bytes at the peak")
    del params, params_e
    torch.cuda.empty_cache()
    return [(b, s, cfg.n_heads, cfg.hd, cfg.n_kv_heads)
            for b, s in LM_MOE_FORWARDS[arch_id]] if gqa_layers else []


def lm_sliced(params, arch_id: str, cfg, n_layers: int):
    """(params, cfg) of the first ``n_layers`` layers of ``arch_id``:
    views of the stacked body, nothing copied (griffin: whole (rec, rec,
    attn) units, its tail dropped)."""
    import dataclasses

    from repro_torch.common.tree import tree_map

    if arch_id == LM_GRIFFIN_ARCH:
        unit = len(cfg.pattern)
        return ({**params, "body": tree_map(lambda t: t[:n_layers // unit], params["body"]),
                 "tail": []}, dataclasses.replace(cfg, n_layers=n_layers))
    if arch_id == VLM_ARCH:
        return ({**params, "body": tree_map(lambda t: t[:n_layers], params["body"])},
                dataclasses.replace(cfg, lm=dataclasses.replace(cfg.lm, n_layers=n_layers)))
    return ({**params, "body": tree_map(lambda t: t[:n_layers], params["body"])},
            dataclasses.replace(cfg, n_layers=n_layers))


def lm_engine_depth(params, arch_id: str, cfg):
    """(params, cfg, label) of ``arch_id``'s engine rows: its first
    ``LM_ENGINE_LAYERS[arch_id]`` layers (``lm_sliced``)."""
    n = LM_ENGINE_LAYERS[arch_id]
    params, cfg = lm_sliced(params, arch_id, cfg, n)
    return params, cfg, f"{arch_id}[{n} layers]"


def lm_vs_cpu(forward_of, params, cfg, inputs, label: str) -> dict:
    """``forward_of(cfg)(params, inputs)`` on the card against the same
    function on the CPU with the same parameters, within ``LM_LOGIT_TOL``
    of the CPU logits' scale."""
    import torch

    from repro_torch import interop
    from repro_torch.common.tree import tree_map

    on_card = tree_map(lambda t: t.cuda() if isinstance(t, torch.Tensor) else t, inputs)
    card = forward_of(cfg)(params, on_card).float().cpu()
    cpu = forward_of(cfg)(interop.to_device(params, "cpu"), inputs).float()
    err = float((card - cpu).abs().max())
    tol = LM_LOGIT_TOL * max(1.0, float(cpu.abs().max()))
    check(err <= tol, f"{label}: card {err} from the CPU, beyond {tol}")
    return {"max_abs_err": err, "tolerance": tol, "max_abs_logit": float(cpu.abs().max()),
            "argmax_equal": bool(torch.equal(card.argmax(-1), cpu.argmax(-1)))}


def lm_fixed_prompts(vocab: int, lengths, seed: int):
    """``SyntheticTokens`` prompts of the given lengths."""
    import numpy as np

    from repro_torch.data.tokens import SyntheticTokens, TokenPipelineConfig

    toks, _ = SyntheticTokens(TokenPipelineConfig(
        vocab_size=vocab, seq_len=max(lengths), global_batch=len(lengths),
        seed=seed)).batch(0)
    return [toks[i, :n].astype(np.int32) for i, n in enumerate(lengths)]


def lm_rwkv_chunked_rows(params, cfg, toks) -> None:
    """rwkv's chunked WKV (the forward's path) against its token scan (the
    decode's) on ``toks``, their logits at every position: at
    f32 compute at full depth, held within ``LM_LOGIT_TOL`` of the scan
    logits' scale; at bf16 at each depth of ``LM_RWKV_DEPTHS``, held up to
    ``LM_RWKV_BF16_LAYERS`` layers and reported beyond.  At bf16 the two
    paths part through bf16 rounding flips of the WKV output where their
    f32 sums differ in the last bits, and the gap grows with depth: at this
    width the reference's own two paths part by more than the tolerance
    from 4 layers on (``tests/test_torch_rwkv_width.py``), so the port's
    are held where the reference's hold."""
    import dataclasses

    import torch

    from repro_torch.models import rwkv6

    f32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    for c, depth in [(f32, cfg.n_layers)] + [(cfg, d) for d in LM_RWKV_DEPTHS]:
        p, cd = lm_sliced(params, LM_RWKV_ARCH, c, depth)
        dtype = str(c.compute_dtype)[6:]
        row = {"phase": "lm", "arch": LM_RWKV_ARCH, "wkv_chunked_vs_scan": list(toks.shape),
               "chunk": cfg.chunk, "layers": depth, "compute": dtype}
        out = {}
        for impl in ("chunked", "scan"):
            ci = dataclasses.replace(cd, impl=impl)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[impl] = rwkv6.logits(p, ci, rwkv6.forward(p, ci, toks)).float()
            torch.cuda.synchronize()
            row[f"{impl}_s"] = time.perf_counter() - t0
        scale = max(1.0, float(out["scan"].abs().max()))
        err = float((out["chunked"] - out["scan"]).abs().max())
        held = dtype == "float32" or depth <= LM_RWKV_BF16_LAYERS
        row.update(max_abs_err=err, tolerance=LM_LOGIT_TOL * scale, gap_of_scale=err / scale,
                   held=held, argmax_equal_share=float(
                       (out["chunked"].argmax(-1) == out["scan"].argmax(-1)).float().mean()))
        emit(row)
        check(not held or err <= row["tolerance"],
              f"{LM_RWKV_ARCH}[{depth} layers]: chunked WKV {err} from the scan at "
              f"{dtype} compute, beyond {row['tolerance']}")


def lm_rec_early_rows(params, arch, cfg, prompts, serve: dict, dev) -> dict:
    """The positions a held recurrent check leaves out, and the next: the
    first ``LM_REC_WARM`` + 1 tokens of each prompt, at f32 compute and f32
    state, the decode at the engine's slot count against the forward and
    (the first two prompts) against the same decode at one slot (one
    function, rounded in another order), per position the largest gap
    over the prompts in units of the forward's scale.  Reported, not
    held."""
    import dataclasses

    import torch

    from repro_torch.configs import base as cb

    f32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    forward, readout = cb.forward_fn(arch, f32)
    seqs = [p[:LM_REC_WARM + 1] for p in prompts[:serve["max_slots"]]]
    slots = lm_decode_logits(params, arch, f32, seqs, [0] * len(seqs), dev,
                             batch=serve["max_slots"], cache_len=serve["max_len"],
                             state_dtype=torch.float32)
    vs_forward, vs_one_slot = [], []
    for i, s in enumerate(seqs):
        f = readout(params, forward(params, torch.as_tensor(s, device=dev)[None].long())[0])
        scale = logit_scale(f)
        vs_forward.append((slots[i] - f).abs().amax(-1) / scale)
        if i < 2:
            one = lm_decode_logits(params, arch, f32, [s], [0], dev,
                                   state_dtype=torch.float32)[0]
            vs_one_slot.append((slots[i] - one).abs().amax(-1) / scale)
    return {"positions": len(seqs[0]),
            "decode_vs_forward_of_scale": torch.stack(vs_forward).amax(0).tolist(),
            "slots_vs_one_slot_of_scale": torch.stack(vs_one_slot).amax(0).tolist()}


def lm_recurrent_arch(arch_id: str, dev: str) -> None:
    """One recurrent arch at its published width, parameters drawn on the
    card: the ``prefill_fn`` forward at ``LM_REC_FORWARDS`` (no kernel:
    rwkv's chunked WKV and griffin's RG-LRU scan and windowed attention are
    plain PyTorch, as they are plain ``jnp`` in the reference), rwkv's
    chunked WKV against its token scan (``lm_rwkv_chunked_rows``), the
    forward at ``LM_REC_CPU_LAYERS`` layers against the CPU, then the
    slot-pool engine at bf16 with exact-length prefill:
    ``LM_REC_REQUESTS`` prompts of three distinct lengths, one prefill scan
    per length, the decode held against the forward at f32 compute and
    f32 decode state, the tokens the argmax of the bf16 decode scan
    (``lm_check_decode`` with ``held_cfg``).  rwkv6-7b's engine also serves at
    ``LM_RWKV_BF16_LAYERS`` layers, its decode held against the forward at
    bf16; recurrentgemma-9b serves prompts past its 2048-token window at
    one (rec, rec, attn) unit of depth, so its rings wrap, held at f32."""
    import dataclasses

    import numpy as np
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
    emit({"phase": "lm", "arch": arch_id, "n_layers": cfg.n_layers,
          "params": nninit.param_count(spec), "param_bytes": nninit.param_bytes(spec),
          "param_dtype": str(cfg.param_dtype), "compute_dtype": str(cfg.compute_dtype),
          "draw_s": time.perf_counter() - t0})
    forward = cb.prefill_fn(arch, cfg)
    gen = torch.Generator("cpu").manual_seed(SEED)
    for b, s in LM_REC_FORWARDS:
        toks = torch.randint(0, cfg.vocab, (b, s), generator=gen).to(dev)
        before = dict(registry.LAUNCHES)
        logits = forward(params, toks)
        torch.cuda.synchronize()
        launched = {k: n - before[k] for k, n in registry.LAUNCHES.items() if n != before[k]}
        check(not launched, f"{arch_id} forward {(b, s)}: launched {launched}")
        check(tuple(logits.shape) == (b, cfg.vocab) and bool(logits.isfinite().all()),
              f"{arch_id} forward {(b, s)}: logits")
        ms = cuda_ms(lambda: forward(params, toks), reps=1, samples=3)
        emit({"phase": "lm", "arch": arch_id, "forward": [b, s], "kernel_launches": 0,
              "ms_per_forward": ms, "tokens_per_s": b * s / ms * 1e3,
              "max_memory_allocated": torch.cuda.max_memory_allocated()})
    if arch_id == LM_RWKV_ARCH:
        lm_rwkv_chunked_rows(params, cfg, torch.randint(
            0, cfg.vocab, (1, LM_REC_CHUNK_TOKENS), generator=gen).to(dev))
    n_cpu = LM_REC_CPU_LAYERS[arch_id]
    params_c, cfg_c = lm_sliced(params, arch_id, cfg, n_cpu)
    toks = torch.randint(0, cfg.vocab, LM_CPU_SHAPE, generator=gen)
    emit({"phase": "lm", "arch": arch_id, "forward_vs_cpu": [n_cpu, *LM_CPU_SHAPE],
          **lm_vs_cpu(lambda c: cb.prefill_fn(arch, c), params_c, cfg_c, toks, arch_id)})
    del params_c

    params_e, cfg_e, label = lm_engine_depth(params, arch_id, cfg)
    f32 = dataclasses.replace(cfg_e, compute_dtype=torch.float32)
    lengths = np.random.default_rng(SEED + 6).permutation(
        [LM_REC_LENGTHS[i % len(LM_REC_LENGTHS)] for i in range(LM_REC_REQUESTS)])
    prompts = lm_fixed_prompts(cfg.vocab, lengths, SEED + 6)
    peak = torch.cuda.max_memory_allocated()
    row = lm_engine_row(arch, params_e, cfg_e, LM_REC_SERVE, prompts, label, dev,
                        full=False, held=FlashHeld(), profile=True, held_cfg=f32)
    check(row["stateful_prefill"], f"{arch_id}: the engine did not take serve_fns' "
                                   "stateful_prefill tag")
    row["decode_vs_forward"]["early_positions"] = lm_rec_early_rows(
        params_e, arch, cfg_e, prompts, LM_REC_SERVE, dev)
    del params_e
    # two greedy runs, each one admission group of three distinct lengths
    check(row["prefills"] == 2 * len(LM_REC_LENGTHS),
          f"{arch_id}: {row['prefills']} prefill scans, want one per distinct length")
    row.update(params=nninit.param_count(spec), param_bytes=nninit.param_bytes(spec),
               prompt_lens=[int(n) for n in lengths],
               max_memory_allocated=max(peak, row["max_memory_allocated"]))
    emit(row)
    check(row["max_memory_allocated"] <= LM_PEAK_LIMIT,
          f"{arch_id}: {row['max_memory_allocated']} bytes at the peak")
    if arch_id == LM_RWKV_ARCH:
        # the engine at bf16 where the reference's bf16 paths hold
        params_b, cfg_b = lm_sliced(params, arch_id, cfg, LM_RWKV_BF16_LAYERS)
        row = lm_engine_row(arch, params_b, cfg_b, LM_REC_SERVE, prompts,
                            f"{arch_id}[{LM_RWKV_BF16_LAYERS} layers]", dev, full=False,
                            held=FlashHeld())
        row.update(prompt_lens=[int(n) for n in lengths])
        emit(row)
        del params_b
    if arch_id == LM_GRIFFIN_ARCH:
        # the ring past the window: one (rec, rec, attn) unit of depth
        params_r, cfg_r = lm_sliced(params, arch_id, cfg, len(cfg.pattern))
        prompts = lm_prompts(cfg.vocab, LM_REC_RING_REQUESTS, LM_REC_RING_PROMPTS, SEED + 7)
        check(min(map(len, prompts)) > cfg.window, "ring prompts must pass the window")
        serve = dict(LM_SERVE, max_slots=LM_REC_RING_REQUESTS,
                     max_new_tokens=LM_REC_RING_NEW, decode_block=LM_REC_RING_NEW,
                     max_len=-(-(LM_REC_RING_PROMPTS[1] + LM_REC_RING_NEW) // 64) * 64)
        row = lm_engine_row(arch, params_r, cfg_r, serve, prompts,
                            f"{arch_id}[{cfg_r.n_layers} layers]", dev, full=False,
                            held=FlashHeld(),
                            held_cfg=dataclasses.replace(cfg_r, compute_dtype=torch.float32))
        row.update(window=cfg.window, prompt_lens=[len(p) for p in prompts])
        emit(row)
        del params_r
    del params
    torch.cuda.empty_cache()


def lm_vlm_arch(dev: str, held: FlashHeld) -> list[tuple]:
    """internvl2-26b at its width, cut by memory to ``VLM_LAYERS`` of its 48
    layers (f32 parameters drawn on the card): the ``prefill_fn`` forward
    over ``VLM_IMAGE_TOKENS`` random patch embeddings and
    ``VLM_TEXT_TOKENS`` tokens, flash_attn once per layer at (1, 2048, 48,
    128), held against its plain version by ``held``; the forward at
    ``VLM_CPU_LAYERS`` layers against the CPU.  Returns the flash_attn shape
    with its KV heads."""
    import torch

    from repro_torch.backend import registry
    from repro_torch.configs import base as cb
    from repro_torch.configs import get_arch
    from repro_torch.nn import init as nninit

    arch, cfg = get_arch(VLM_ARCH), lm_config(VLM_ARCH)
    spec = cb.model_spec(arch, cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = nninit.materialize(spec, torch.Generator(dev).manual_seed(SEED))
    torch.cuda.synchronize()
    emit({"phase": "lm", "arch": VLM_ARCH, "n_layers": cfg.lm.n_layers,
          "params": nninit.param_count(spec), "param_bytes": nninit.param_bytes(spec),
          "draw_s": time.perf_counter() - t0})
    forward = cb.prefill_fn(arch, cfg)
    gen = torch.Generator("cpu").manual_seed(SEED + 8)

    def inputs(n_img, n_txt):
        return {"patch_embeds": torch.randn(1, n_img, cfg.lm.d_model, generator=gen),
                "tokens": torch.randint(0, cfg.lm.vocab, (1, n_txt), generator=gen)}

    batch = {k: v.to(dev) for k, v in inputs(VLM_IMAGE_TOKENS, VLM_TEXT_TOKENS).items()}
    before = registry.LAUNCHES["flash_attn"]
    with held:
        logits = forward(params, batch)
    torch.cuda.synchronize()
    launches = registry.LAUNCHES["flash_attn"] - before
    check(launches == cfg.lm.n_layers, f"{VLM_ARCH} forward: {launches} flash_attn "
                                       f"launches, want {cfg.lm.n_layers}")
    check(tuple(logits.shape) == (1, cfg.lm.vocab) and bool(logits.isfinite().all()),
          f"{VLM_ARCH} forward: logits")
    ms = cuda_ms(lambda: forward(params, batch), reps=1, samples=3)
    s = VLM_IMAGE_TOKENS + VLM_TEXT_TOKENS
    emit({"phase": "lm", "arch": VLM_ARCH, "forward": [1, VLM_IMAGE_TOKENS, VLM_TEXT_TOKENS],
          "flash_attn_launches": launches, "ms_per_forward": ms,
          "tokens_per_s": s / ms * 1e3,
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    check(torch.cuda.max_memory_allocated() <= LM_PEAK_LIMIT,
          f"{VLM_ARCH}: {torch.cuda.max_memory_allocated()} bytes at the peak")
    params_c, cfg_c = lm_sliced(params, VLM_ARCH, cfg, VLM_CPU_LAYERS)
    emit({"phase": "lm", "arch": VLM_ARCH,
          "forward_vs_cpu": [VLM_CPU_LAYERS, VLM_CPU_TOKENS, VLM_CPU_TOKENS],
          **lm_vs_cpu(lambda c: cb.prefill_fn(arch, c), params_c, cfg_c,
                      inputs(VLM_CPU_TOKENS, VLM_CPU_TOKENS), VLM_ARCH)})
    del params, params_c
    torch.cuda.empty_cache()
    return [(1, s, cfg.lm.n_heads, cfg.lm.hd, cfg.lm.n_kv_heads)]


def phase_lm(dev: str = "cuda") -> dict[str, int]:
    """The LM substrate on the card at published width: llama3.2-3b's
    full-context forward (``configs.base.prefill_fn``, flash_attn on all 28
    layers) at (B, S) = (1, 2048) and (4, 512), held at two layers' depth
    against the CPU; its slot-pool ``Engine`` serving ``LM_REQUESTS``
    requests (``lm_engine_row``); then gemma3-12b at one pattern unit of
    depth (a reduced depth: 6 of 48 layers) serving prompts longer than its
    1024-token window, so the local layers' ring caches wrap; then the MoE /
    MLA archs (``lm_moe_arch``): granite-moe-1b-a400m at its width and
    deepseek-v3-671b at its width cut to 4 layers; then the recurrent kinds
    at their widths (``lm_recurrent_arch``: rwkv6-7b, recurrentgemma-9b)
    and internvl2-26b cut to ``VLM_LAYERS`` (``lm_vlm_arch``).  Returns the
    path's launch counts."""
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

    prompts = lm_prompts(cfg.vocab, LM_REQUESTS, LM_PROMPTS, SEED)
    params_e, cfg_e, label = lm_engine_depth(params, LM_ARCH, cfg)
    emit(lm_engine_row(arch, params_e, cfg_e, LM_SERVE, prompts, label, dev,
                       full=True, held=held))
    del params, params_e
    torch.cuda.empty_cache()

    # the ring-buffer path: gemma3-12b's width, one pattern unit of depth
    arch, cfg = get_arch(LM_RING_ARCH), lm_config(LM_RING_ARCH)
    spec = cb.model_spec(arch, cfg)
    params = nninit.materialize(spec, torch.Generator(dev).manual_seed(SEED))
    prompts = lm_prompts(cfg.vocab, LM_RING_REQUESTS, LM_RING_PROMPTS, SEED + 1)
    check(min(map(len, prompts)) > cfg.window, "ring prompts must pass the window")
    serve = dict(LM_SERVE, max_slots=LM_RING_REQUESTS,
                 max_len=-(-(LM_RING_PROMPTS[1] + LM_SERVE["max_new_tokens"]) // 64) * 64)
    before = registry.LAUNCHES["flash_attn"]
    row = lm_engine_row(arch, params, cfg, serve, prompts,
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
    # the recurrent kinds (no kernel on their paths), then the VLM: every
    # layer of its forward on flash_attn at internvl2's 48 heads
    for arch_id in LM_REC_ARCHS:
        lm_recurrent_arch(arch_id, dev)
    forward_heads += lm_vlm_arch(dev, held)
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


# -- phase 10b: LM training -------------------------------------------------------

# llama3.2-3b's first step on the card against the CPU: its published width
# cut to 2 layers, f32 compute (so the 3xTF32 flash kernel runs), tokens
# (1, 128); the checks are TRAIN_FIRST_TOL's and the AdamW step's of phase 9b
TRAIN_LM_FIRST_LAYERS, TRAIN_LM_FIRST_SEQ = 2, 128
# then all 28 layers: f32 parameters, bf16 compute, f32 moments, remat off as
# its config says, TRAIN_LM_STEPS steps on one repeated batch of (1, 2048)
TRAIN_LM_STEPS, TRAIN_LM_SEQ = 6, 2048
TRAIN_LM_OPT = dict(lr=1e-4, warmup_steps=1, total_steps=TRAIN_LM_STEPS)
# the examples/train_lm_torch.py twin at full100m with the reference
# example's defaults (200 steps of 8 x 256, lr 1e-3, warmup 20, a checkpoint
# every 50 steps, remat on), then again failing at step 130 under
# run_with_restarts, resumed from step 100's checkpoint
TWIN_LM_WIDTH, TWIN_LM_STEPS, TWIN_LM_BATCH, TWIN_LM_SEQ, TWIN_LM_LR = \
    "full100m", 200, 8, 256, 1e-3
TWIN_LM_FAIL_AT = 130
TRAIN_LM_MEASURED: dict = {}   # the llama3.2-3b step's times and bytes, for phase 11c


def train_step_profile(step) -> dict:
    """One synchronised call of ``step`` under ``torch.profiler``: its host
    time, the CUDA kernels' busy time and share of it, their count, and the
    25 kernel names that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:25]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms, "kernels": sum(e.count for e in kernels),
            "top": [{"name": e.key[:90], "device_ms": e.self_device_time_total / 1e3,
                     "count": e.count} for e in top]}


def train_lm_config():
    """llama3.2-3b at its published width (28 layers, remat off)."""
    from repro_torch.configs import get_arch

    return get_arch(LM_ARCH).make_full()


def train_lm_batch(cfg, seq: int, dev):
    """One ``SyntheticTokens`` batch of (1, seq) with a leading microbatch
    axis of 1, as ``train_step`` takes it."""
    import torch

    from repro_torch.data.tokens import SyntheticTokens, TokenPipelineConfig

    toks, tgts = SyntheticTokens(TokenPipelineConfig(
        vocab_size=cfg.vocab, seq_len=seq, global_batch=1, seed=SEED)).batch(0)
    return {"tokens": torch.from_numpy(toks)[None].to(dev),
            "targets": torch.from_numpy(tgts)[None].to(dev)}


def attention_backward_row(dev) -> dict:
    """flash_attention's backward at llama3.2-3b's training shape (1, 2048,
    24, 128) bf16: ``_FlashMHA``'s backward (the plain chain, recomputed)
    beside the kernel forward, PyTorch's scaled_dot_product_attention
    forward plus backward, and the backward's bound (2.5 x the causal
    forward's operations over the bf16 peak; its bytes, q, k, v, o and the
    output grad read and dq, dk, dv written once, take less)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attn import ops as flash_ops

    b, s, h, hd = 1, TRAIN_LM_SEQ, 24, 128
    gen = torch.Generator(device=dev).manual_seed(SEED)
    q, k, v, g = (torch.randn(b, s, h, hd, device=dev, generator=gen).bfloat16()
                  for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_ops.flash_mha(*leaves, hd ** -0.5, True)
    backward_ms = cuda_ms(lambda: torch.autograd.grad(out, leaves, g, retain_graph=True),
                          reps=3, samples=7)
    forward_ms = cuda_ms(lambda: flash_ops.flash_mha(q, k, v, hd ** -0.5, True),
                         reps=3, samples=7)
    sdpa = [t.transpose(1, 2).detach().clone().requires_grad_() for t in (q, k, v)]
    gt = g.transpose(1, 2)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(*sdpa, is_causal=True, scale=hd ** -0.5)
        torch.autograd.grad(o, sdpa, gt)

    sdpa_ms = cuda_ms(sdpa_fwd_bwd, reps=3, samples=7)
    ops = 2.5 * flash_flops(b, s, s, h, hd, True)
    t_ops, t_bytes = ops / BF16_FLOPS, 8 * b * s * h * hd * 2 / HBM_BYTES_PER_S
    return {"phase": "train_lm", "row": "attention_backward", "shape": [b, s, h, hd],
            "dtype": "bfloat16", "backward_ms": backward_ms, "forward_kernel_ms": forward_ms,
            "sdpa_fwd_bwd_ms": sdpa_ms, "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "backward_scores_bytes": b * h * s * s * 4, "card": CARD}


def train_lm_twin(dev) -> dict:
    """The example twin at ``TWIN_LM_WIDTH``: the uninterrupted run, its
    flash_attn calls held against the plain version (``FlashHeld``), then a
    run failing at ``TWIN_LM_FAIL_AT`` under ``run_with_restarts``; the
    resumed run's losses of steps 100-199 and its final parameters and
    moments must equal the uninterrupted run's bit for bit.  On the card,
    one more step of the resumed run under the profiler."""
    import shutil
    import tempfile

    import torch

    from repro_torch.backend import registry
    from repro_torch.common.tree import tree_leaves
    from repro_torch.train import trainer
    from repro_torch.train.trainer import FailureInjector, run_with_restarts

    twin = example_module("train_lm_torch")
    args = (TWIN_LM_WIDTH, TWIN_LM_STEPS, TWIN_LM_BATCH, TWIN_LM_SEQ, TWIN_LM_LR)
    with tempfile.TemporaryDirectory() as tmp:
        before = registry.LAUNCHES["flash_attn"]
        ref, n_params = twin.make_trainer(*args, f"{tmp}/ref", dev)
        t0 = time.perf_counter()
        with FlashHeld() as held:
            hist = ref.run()
        run_s = time.perf_counter() - t0
        per_step = (registry.LAUNCHES["flash_attn"] - before) / TWIN_LM_STEPS
        shutil.rmtree(f"{tmp}/ref")
        calls = {"n": 0}

        def make():
            calls["n"] += 1
            inj = FailureInjector(fail_at_step=TWIN_LM_FAIL_AT) if calls["n"] == 1 else None
            return twin.make_trainer(*args, f"{tmp}/ft", dev, injector=inj)[0]

        t0 = time.perf_counter()
        ft = run_with_restarts(make, TWIN_LM_STEPS)
        restart_s = time.perf_counter() - t0
    resumed_from = TWIN_LM_STEPS - len(ft.metrics_history)
    losses = [h["loss"] for h in hist]
    same_losses = [h["loss"] for h in ft.metrics_history] == losses[resumed_from:]
    same_state = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(ref.state_tree()), tree_leaves(ft.state_tree()), strict=True))
    first, last = sum(losses[:20]) / 20, sum(losses[-20:]) / 20
    times = sorted(h["step_time_s"] for h in hist)
    profile = None
    if dev == "cuda":   # one more step of the resumed run, after the comparison
        batch = ft._batch(ft.step)
        profile = train_step_profile(lambda: trainer.train_step(
            ft.loss_fn, ft.params, ft.opt_state, batch, ft.ocfg))
    row = {"phase": "train_lm", "row": "twin", "width": TWIN_LM_WIDTH, "params": n_params,
           "steps": TWIN_LM_STEPS, "batch": [TWIN_LM_BATCH, TWIN_LM_SEQ], "lr": TWIN_LM_LR,
           "loss_every_20": losses[::20], "loss_mean_first_20": first,
           "loss_mean_last_20": last, "ms_per_step_median": times[len(times) // 2] * 1e3,
           "run_s": run_s, "flash_attn_launches_per_step": per_step,
           "restart_run_s": restart_s, "incarnations": calls["n"],
           "fail_at": TWIN_LM_FAIL_AT, "resumed_from": resumed_from,
           "resumed_losses_bit_exact": same_losses, "resumed_state_bit_exact": same_state,
           "flash_attn_held": held.rows, "profiled_step": profile, "card": CARD}
    emit(row)
    w = twin.WIDTHS[TWIN_LM_WIDTH]
    shape = (TWIN_LM_BATCH, TWIN_LM_SEQ, w["n_heads"], w["head_dim"])
    check(shape in held.shapes(), f"twin: flash_attn at {shape} was not held, only at "
          f"{sorted(held.shapes())}")
    check(all(math.isfinite(x) for x in losses) and last < first,
          f"twin: loss {first} -> {last}")
    check(per_step == 2 * twin.WIDTHS[TWIN_LM_WIDTH]["n_layers"],
          f"twin: {per_step} flash_attn launches a step, want a forward and a recompute "
          "a layer")
    every = ft.tcfg.ckpt_every
    check(calls["n"] == 2 and resumed_from == TWIN_LM_FAIL_AT // every * every,
          f"twin: {calls['n']} incarnations, resumed from step {resumed_from}")
    check(same_losses and same_state, "twin: the resumed run is not the uninterrupted one")
    return row


def phase_train_lm(dev: str = "cuda") -> dict[str, int]:
    """LM training on the card; returns the path's launch counts.
    a. llama3.2-3b's first step at 2 layers and f32 compute, card against
    CPU (``train_first_step``); b. all 28 layers at bf16 compute:
    ``TRAIN_LM_STEPS`` steps of ``trainer.train_step`` (AdamW with f32
    moments, donated) on one (1, 2048) batch, 28 flash_attn launches a
    step, ms a step on the host clock and in CUDA events, the peak bytes,
    the loss at each step (finite, the last below step 0's), then one
    more step under ``torch.profiler`` (``train_step_profile``); c. the
    ``train_lm_torch`` twin and its bit-exact resume (``train_lm_twin``),
    then one profiled step of it.
    Then, outside the path's counts, the attention backward's row."""
    import dataclasses

    import torch

    from repro_torch.backend import registry
    from repro_torch.common.tree import tree_leaves
    from repro_torch.models import lm
    from repro_torch.nn import init as nninit
    from repro_torch.train import optimizer as opt
    from repro_torch.train import trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    on_card = dev == "cuda"
    t_phase = time.perf_counter()
    registry.reset_launches()
    cfg = train_lm_config()
    ocfg = opt.AdamWConfig(**TRAIN_LM_OPT)

    # a. the first step at 2 layers and f32 compute, card against CPU
    small = dataclasses.replace(cfg, n_layers=TRAIN_LM_FIRST_LAYERS,
                                compute_dtype=torch.float32)
    params = nninit.materialize(lm.lm_spec(small), torch.Generator(dev).manual_seed(SEED))
    batch = {k: v[0] for k, v in train_lm_batch(small, TRAIN_LM_FIRST_SEQ, dev).items()}
    train_first_step("llama3.2-3b@2 layers f32", lm.loss_fn, False, params, (small, batch),
                     ocfg, phase="train_lm", kernel="flash_attn")
    del params

    # b. llama3.2-3b at its published width
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    params = nninit.materialize(lm.lm_spec(cfg), torch.Generator(dev).manual_seed(SEED))
    state = opt.init_state(params, ocfg)
    batches = train_lm_batch(cfg, TRAIN_LM_SEQ, dev)
    held_bytes = sum(t.numel() * t.element_size() for t in tree_leaves((params, state, batches)))
    loss_fn = lambda p, b: lm.loss_fn(p, cfg, b)   # noqa: E731
    losses, host_ms, event_ms, launches = [], [], [], []
    with FlashHeld() as held:
        for _ in range(TRAIN_LM_STEPS):
            before = registry.LAUNCHES["flash_attn"]
            if on_card:
                torch.cuda.synchronize()
                start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
                start.record()
            t0 = time.perf_counter()
            params, state, metrics = trainer.train_step(loss_fn, params, state, batches, ocfg)
            if on_card:
                end.record()
            losses.append(float(metrics["loss"]))
            host_ms.append((time.perf_counter() - t0) * 1e3)
            if on_card:
                end.synchronize()
                event_ms.append(start.elapsed_time(end))
            launches.append(registry.LAUNCHES["flash_attn"] - before)
    n_params = sum(t.numel() for t in tree_leaves(params))
    peak = torch.cuda.max_memory_allocated() if on_card else None
    # one more step, under the profiler (its launches are the path's too)
    profile = train_step_profile(lambda: trainer.train_step(
        loss_fn, params, state, batches, ocfg)) if on_card else None
    emit({"phase": "train_lm", "row": "llama3.2-3b", "n_layers": cfg.n_layers,
          "params": n_params, "param_dtype": "float32", "compute_dtype": "bfloat16",
          "moments": "float32", "remat": cfg.remat, "tokens": [1, TRAIN_LM_SEQ],
          "opt": TRAIN_LM_OPT, "losses": losses, "ms_per_step_host": host_ms,
          "ms_per_step_cuda_events": event_ms, "flash_attn_launches_per_step": launches,
          "max_memory_allocated": peak, "flash_attn_held": held.rows,
          "profiled_step": profile, "card": CARD})
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"llama3.2-3b training: losses {losses}")
    check(all(n == cfg.n_layers for n in launches),
          f"llama3.2-3b training: flash_attn launches a step {launches}, "
          f"want {cfg.n_layers}")
    if on_card:   # the dry-run row of phase 11c reads the warm steps
        TRAIN_LM_MEASURED.update(ms_host=statistics.median(host_ms[1:]),
                                 ms_events=statistics.median(event_ms[1:]),
                                 peak=peak, held_bytes=held_bytes)
    del params, state, metrics, batches
    if on_card:
        torch.cuda.empty_cache()

    # c. the example twin and its restart
    train_lm_twin(dev)
    counts = dict(registry.LAUNCHES)
    check(counts["flash_attn"] > 0, "kernel flash_attn was not launched on the train_lm path")
    if on_card:
        emit(attention_backward_row(dev))
    emit({"phase": "train_lm", "row": "phase", "seconds": time.perf_counter() - t_phase,
          "launches": {k: v for k, v in counts.items() if v}, "card": CARD})
    return counts


# -- phase 10c: the enc-dec kind ---------------------------------------------------

ENCDEC_ARCH = "seamless-m4t-large-v2"
# the first step on the card against the CPU: the published width cut to 2 + 2
# layers, f32 compute (the 3xTF32 flash kernel, non-causal), frames (1, 128,
# 1024) and targets (1, 128); the checks are TRAIN_FIRST_TOL's
ENCDEC_FIRST_LAYERS, ENCDEC_FIRST_SEQ = 2, 128
# then all 24 + 24 layers: f32 parameters, bf16 compute, f32 moments, remat on
# as its config says, ENCDEC_STEPS steps on one repeated batch of the
# reference's train_4k split per example (2048 source frames, 2048 target
# tokens), its batch cut from 256 to 1
ENCDEC_STEPS, ENCDEC_SRC, ENCDEC_TGT = 6, 2048, 2048
ENCDEC_OPT = dict(lr=1e-4, warmup_steps=1, total_steps=ENCDEC_STEPS)
# serving: examples/serve_lm_torch.py's schedule at full width and depth
ENCDEC_SERVE = dict(n_batches=3, batch=2, src_len=2048, new_tokens=32, max_len=64)
# prefill_fn at the reference's prefill_32k per-example shape, batch cut 32 -> 1
ENCDEC_LONG = 32768
# the flash_attn shapes new on this path, non-causal bf16: (B, Sq, Skv, H, hd)
ENCDEC_FLASH = {"encoder": (1, 2048, 2048, 16, 64), "cross": (2, 64, 2048, 16, 64),
                "decode_cross": (2, 1, 2048, 16, 64),
                "encoder_32k": (1, 32768, 32768, 16, 64)}


def encdec_config():
    """seamless-m4t-large-v2 at its published width and depth."""
    from repro_torch.configs import get_arch

    return get_arch(ENCDEC_ARCH).make_full()


def encdec_batch(cfg, src: int, tgt: int, gen, dev) -> dict:
    """bf16 standard-normal frames (1, src, D) from ``gen`` (the stub
    frontend's output) and one ``SyntheticTokens`` target row of ``tgt``."""
    import torch

    from repro_torch.data.tokens import SyntheticTokens, TokenPipelineConfig

    toks, tgts = SyntheticTokens(TokenPipelineConfig(
        vocab_size=cfg.vocab, seq_len=tgt, global_batch=1, seed=SEED)).batch(0)
    return {"frames": torch.randn(1, src, cfg.d_model, device=dev, generator=gen).bfloat16(),
            "tgt_tokens": torch.from_numpy(toks).to(dev),
            "tgt_targets": torch.from_numpy(tgts).to(dev)}


def encdec_decode_check(params, cfg, served: list, dev) -> dict:
    """Each served batch's decode logits against ``decode_train`` over the
    same teacher-forced tokens (the decode's inputs: 0, then the greedy
    tokens), at every generated position, relative to the forward's logits'
    scale without the input token's column (the tied embedding may echo
    it); then the same decode with the cross caches zeroed, which must lie
    beyond the tolerance somewhere."""
    import torch

    from repro_torch.models import encdec
    from repro_torch.nn import layers

    worst, control = 0.0, 0.0
    for r in served:
        inputs = torch.cat([torch.zeros_like(r["tokens"][:, :1]), r["tokens"][:, :-1]], 1)
        with torch.no_grad():
            hidden = encdec.decode_train(params, cfg, r["enc_out"], inputs)
            want = layers.logits(params["embed"], hidden, cfg.compute_dtype).float()
            caches = encdec.init_caches(params, cfg, r["enc_out"], ENCDEC_SERVE["max_len"],
                                        device=dev)
            for t in caches["cross"].values():
                t.zero_()
            zeroed = []
            for t in range(inputs.shape[1]):
                caches, logits = encdec.decode_step(params, cfg, caches, inputs[:, t], t)
                zeroed.append(logits.float())
        zeroed = torch.stack(zeroed, 1)
        scale = torch.stack([logit_scale(want[:, t], inputs[:, t])
                             for t in range(inputs.shape[1])], 1)
        worst = max(worst, float(((r["logits"] - want).abs().amax(-1) / scale).max()))
        control = max(control, float(((zeroed - want).abs().amax(-1) / scale).max()))
    return {"decode_vs_forward": worst, "zeroed_cross_vs_forward": control,
            "tolerance": LM_LOGIT_TOL}


def encdec_serial(twin, params, cfg, dev, srv) -> list:
    """The plain schedule of the twin's enc-dec serving on the same
    batches: each batch encoded, then decoded, on one stream; the greedy
    tokens per batch."""
    import torch

    from repro_torch.models import encdec

    out = []
    for f in twin.encdec_frames(cfg.d_model, srv["n_batches"], srv["batch"], srv["src_len"]):
        enc = encdec.encode(params, cfg, f.to(dev))
        out.append(twin.greedy_decode(params, cfg, enc, srv["new_tokens"], srv["max_len"],
                                      torch.device(dev))[0])
    return out


def phase_encdec(dev: str = "cuda") -> tuple[dict[str, int], dict]:
    """The enc-dec kind on the card; returns the path's launch counts and
    the ``kernels`` line's rows of its new flash_attn shapes.
    a. seamless-m4t-large-v2's first step at 2 + 2 layers and f32 compute,
    card against CPU (``train_first_step``); b. all 24 + 24 layers at bf16
    compute: ``ENCDEC_STEPS`` steps of ``trainer.train_step``, 144
    flash_attn launches a step (72 forward, 72 recomputed by remat), ms a
    step on the host clock and in CUDA events, the peak bytes, the loss at
    each step (finite, the last below step 0's); c. the example twin's
    enc-dec serving at full width (``ENCDEC_SERVE``, encode(i+1) issued
    before decode(i)), ms an encode and a decode step, the cross-cache
    bytes, the decode against ``decode_train`` within 3e-2 of the logits'
    scale and the zeroed-cross control beyond it; then, outside
    ``FlashHeld``, the twin's schedule timed against the plain
    encode-then-decode loop (``encdec_serial``) on the same batches, in the
    order serial, overlap, overlap, serial, with equal tokens; d. ``prefill_fn`` at
    (1, ``ENCDEC_LONG``), its first layer's flash_attn held on a 256-row
    sample.  Every new flash_attn shape on the path is held against its
    plain version (``FlashHeld``).  Then, outside the path's counts, the
    rows of ``ENCDEC_FLASH``."""
    import dataclasses

    import torch

    from repro_torch.backend import registry
    from repro_torch.common.tree import tree_leaves
    from repro_torch.configs import base as cb
    from repro_torch.configs import get_arch
    from repro_torch.models import encdec
    from repro_torch.nn import init as nninit
    from repro_torch.train import optimizer as opt
    from repro_torch.train import trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    on_card = dev == "cuda"
    t_phase = time.perf_counter()
    registry.reset_launches()
    arch, cfg = get_arch(ENCDEC_ARCH), encdec_config()
    ocfg = opt.AdamWConfig(**ENCDEC_OPT)
    gen = torch.Generator(dev).manual_seed(SEED)

    # a. the first step at 2 + 2 layers and f32 compute, card against CPU
    small = dataclasses.replace(cfg, n_enc_layers=ENCDEC_FIRST_LAYERS,
                                n_dec_layers=ENCDEC_FIRST_LAYERS, compute_dtype=torch.float32)
    params = nninit.materialize(encdec.encdec_spec(small), gen)
    batch = encdec_batch(small, ENCDEC_FIRST_SEQ, ENCDEC_FIRST_SEQ, gen, dev)
    if on_card:
        train_first_step("seamless-m4t-large-v2@2+2 layers f32", encdec.loss_fn, False,
                         params, (small, batch), ocfg, phase="encdec", kernel="flash_attn")
    del params

    # b. training at the published width and depth
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    params = nninit.materialize(encdec.encdec_spec(cfg), gen)
    n_params = sum(t.numel() for t in tree_leaves(params))
    state = opt.init_state(params, ocfg)
    batches = {k: v[None] for k, v in encdec_batch(cfg, ENCDEC_SRC, ENCDEC_TGT, gen,
                                                   dev).items()}
    loss_fn = cb.loss_fn(arch, cfg)
    losses, host_ms, event_ms, launches = [], [], [], []
    with FlashHeld() as held_train:
        for _ in range(ENCDEC_STEPS):
            before = registry.LAUNCHES["flash_attn"]
            if on_card:
                torch.cuda.synchronize()
                start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
                start.record()
            t0 = time.perf_counter()
            params, state, metrics = trainer.train_step(loss_fn, params, state, batches, ocfg)
            if on_card:
                end.record()
            losses.append(float(metrics["loss"]))
            host_ms.append((time.perf_counter() - t0) * 1e3)
            if on_card:
                end.synchronize()
                event_ms.append(start.elapsed_time(end))
            launches.append(registry.LAUNCHES["flash_attn"] - before)
    peak = torch.cuda.max_memory_allocated() if on_card else None
    per_step = (1 + cfg.remat) * (cfg.n_enc_layers + 2 * cfg.n_dec_layers)
    emit({"phase": "encdec", "row": "train", "model": ENCDEC_ARCH,
          "layers": [cfg.n_enc_layers, cfg.n_dec_layers], "params": n_params,
          "param_dtype": "float32", "compute_dtype": "bfloat16", "moments": "float32",
          "remat": cfg.remat, "frames": [1, ENCDEC_SRC, cfg.d_model],
          "targets": [1, ENCDEC_TGT], "opt": ENCDEC_OPT, "losses": losses,
          "ms_per_step_host": host_ms, "ms_per_step_cuda_events": event_ms,
          "flash_attn_launches_per_step": launches, "max_memory_allocated": peak,
          "flash_attn_held": held_train.rows, "card": CARD})
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"{ENCDEC_ARCH} training: losses {losses}")
    check(all(n == per_step for n in launches),
          f"{ENCDEC_ARCH} training: flash_attn launches a step {launches}, want {per_step}")
    del state, metrics, batches
    if on_card:
        torch.cuda.empty_cache()

    # c. serving at full width: the example twin's schedule
    twin = example_module("serve_lm_torch")
    srv = ENCDEC_SERVE
    before = registry.LAUNCHES["flash_attn"]
    t0 = time.perf_counter()
    with torch.no_grad(), FlashHeld() as held_serve:
        served = twin.serve_encdec_overlap(dev, cfg=cfg, params=params,
                                           keep_logits=True, **srv)
        serve_s = time.perf_counter() - t0
        serve_launches = registry.LAUNCHES["flash_attn"] - before
        check_row = encdec_decode_check(params, cfg, served, dev)
        frames0, enc0 = served[0]["frames"], served[0]["enc_out"]
        encode_ms = cuda_ms(lambda: encdec.encode(params, cfg, frames0), reps=1,
                            samples=5) if on_card else None
        if on_card:
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
            start.record()
        t0 = time.perf_counter()
        twin.greedy_decode(params, cfg, enc0, srv["new_tokens"], srv["max_len"],
                           torch.device(dev))
        if on_card:
            end.record()
            end.synchronize()
        decode_host_ms = (time.perf_counter() - t0) * 1e3 / srv["new_tokens"]
        decode_event_ms = start.elapsed_time(end) / srv["new_tokens"] if on_card else None
    cross_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(encdec.cache_shapes(
        cfg, srv["batch"], srv["max_len"], srv["src_len"])["cross"]))
    want_serve = srv["n_batches"] * (cfg.n_enc_layers + srv["new_tokens"] * cfg.n_dec_layers)
    emit({"phase": "encdec", "row": "serve", "model": ENCDEC_ARCH, **srv,
          "tokens": [r["tokens"].tolist() for r in served], "seconds": serve_s,
          "ms_per_encode": encode_ms, "ms_per_decode_step_host": decode_host_ms,
          "ms_per_decode_step_cuda_events": decode_event_ms,
          "cross_cache_bytes": cross_bytes, "flash_attn_launches": serve_launches,
          **check_row, "flash_attn_held": held_serve.rows, "card": CARD})
    check(serve_launches == want_serve,
          f"{ENCDEC_ARCH} serving: {serve_launches} flash_attn launches, want {want_serve}")
    check(check_row["decode_vs_forward"] <= LM_LOGIT_TOL,
          f"{ENCDEC_ARCH}: decode {check_row['decode_vs_forward']} of the logits' scale "
          "from decode_train")
    check(check_row["zeroed_cross_vs_forward"] > LM_LOGIT_TOL,
          f"{ENCDEC_ARCH}: the decode with zeroed cross caches lies within the tolerance "
          f"({check_row['zeroed_cross_vs_forward']}), so the check does not read the encoder")

    # the overlapped schedule against the plain loop, outside FlashHeld
    sched: dict[str, list] = {"serial": [], "overlap": []}
    issue_ms = []
    with torch.no_grad():
        for _ in range(3):   # the host's time to issue one encode
            if on_card:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            encdec.encode(params, cfg, frames0)
            issue_ms.append((time.perf_counter() - t0) * 1e3)
        for mode in ("serial", "overlap", "overlap", "serial"):
            if on_card:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            if mode == "overlap":
                toks = [r["tokens"] for r in twin.serve_encdec_overlap(
                    dev, cfg=cfg, params=params, **srv)]
            else:
                toks = encdec_serial(twin, params, cfg, dev, srv)
            if on_card:
                torch.cuda.synchronize()
            sched[mode].append(time.perf_counter() - t0)
            check(all(torch.equal(a, r["tokens"]) for a, r in zip(toks, served)),
                  f"{ENCDEC_ARCH}: the {mode} schedule's tokens differ from the served ones")
    emit({"phase": "encdec", "row": "overlap", "model": ENCDEC_ARCH, **srv,
          "seconds_serial": sched["serial"], "seconds_overlap": sched["overlap"],
          "ms_per_encode": encode_ms, "ms_encode_issue_host": issue_ms, "card": CARD})
    del served, frames0, enc0

    # d. the long-context encode through prefill_fn
    frames = torch.randn(1, ENCDEC_LONG, cfg.d_model, device=dev, generator=gen).bfloat16()
    prefill = cb.prefill_fn(arch, cfg)
    with torch.no_grad(), FlashHeld() as held_long:
        summary = prefill(params, frames)
        long_ms = cuda_ms(lambda: prefill(params, frames), reps=1, samples=3) \
            if on_card else None
    emit({"phase": "encdec", "row": "prefill_long", "model": ENCDEC_ARCH,
          "frames": [1, ENCDEC_LONG, cfg.d_model], "ms": long_ms,
          "flash_attn_held": held_long.rows, "card": CARD})
    check(tuple(summary.shape) == (1, cfg.d_model) and bool(torch.isfinite(summary).all()),
          f"{ENCDEC_ARCH}: prefill_fn gave {tuple(summary.shape)}")
    held = {(r["shape"][0], r["shape"][1], r["skv"], r["causal"])
            for h in (held_train, held_serve, held_long) for r in h.rows}
    b = srv["batch"]
    for want in ((1, ENCDEC_SRC, ENCDEC_SRC, False), (1, ENCDEC_TGT, ENCDEC_TGT, True),
                 (b, srv["src_len"], srv["src_len"], False), (b, 1, srv["src_len"], False),
                 (1, ENCDEC_LONG, ENCDEC_LONG, False)):
        check(want in held, f"{ENCDEC_ARCH}: flash_attn at (B, Sq, Skv, causal) = {want} "
              f"was not held, only at {sorted(held)}")
    del params, summary, frames
    counts = dict(registry.LAUNCHES)
    check(counts["flash_attn"] > 0, "kernel flash_attn was not launched on the encdec path")
    rows = {}
    if on_card:
        torch.cuda.empty_cache()
        for name, (b, sq, skv, h, hd) in ENCDEC_FLASH.items():
            reps, samples = (2, 5) if name == "encoder_32k" else (10, 21)
            rows[f"flash_attn_{name}"] = row = flash_row(
                gen, b, sq, skv, h, hd, False, torch.bfloat16, reps=reps, samples=samples)
            emit({**row, "phase": "encdec", "row": name})
    emit({"phase": "encdec", "row": "phase", "seconds": time.perf_counter() - t_phase,
          "launches": {k: v for k, v in counts.items() if v}, "card": CARD})
    return counts, rows


# -- phase 11: LM traffic behind the front door -----------------------------------

DOOR_LM_REQUESTS, DOOR_LM_PROMPTS = 16, (16, 64)
DOOR_LM_SERVE = dict(LM_SERVE, max_new_tokens=16)   # 8 slots of 512 tokens
DOOR_NVSA_REQUESTS = 64
DOOR_OFFERED = 0.5      # of each model's sequential rate, measured here
DOOR_DEADLINE_S = 0.02
# deploy() at the reference's smoke scale for the LMs: nvsa beside llama3.2-3b,
# then beside the recurrent kinds
DOOR_DEPLOY_MODELS = (("nvsa", LM_ARCH), ("nvsa", *LM_REC_ARCHS))
DOOR_DEPLOY_REQUESTS = 8   # per model


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


def door_deploy_trace(models) -> dict[str, int]:
    """``deploy(models)`` (nvsa and LM smoke archs) on the card, warmed up,
    ``DOOR_DEPLOY_REQUESTS`` a model of its synthetic traffic recorded as a
    golden trace (lm and reason classes), replayed through the same and a
    fresh card deployment, tokens and answers exact.  Returns the launches
    of the recorded serve and the replays."""
    import tempfile

    from repro_torch.backend import registry
    from repro_torch.serve import trace as tr
    from repro_torch.serve.deploy import deploy

    t0 = time.perf_counter()
    dep = deploy(list(models))
    deploy_s = time.perf_counter() - t0
    check(dep.report()["analysis"]["ok"], f"deploy preflight: {dep.summary()}")
    dep.warmup()
    lms = [m for m in models if m != "nvsa"]
    check(dep.classes == {"nvsa": "reason", **{m: "lm" for m in lms}},
          f"deploy: {dep.classes}")
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "door_lm.jsonl")
        arrivals, _ = dep.synthetic_traffic(DOOR_DEPLOY_REQUESTS, seed=500)
        registry.reset_launches()
        report, trace = tr.record(dep, arrivals, path)
        door_rows(report, "deploy", {m: dep.traffic.rate_rps for m in dep.engines})
        check(all(len(r) == DOOR_DEPLOY_REQUESTS for r in report.results.values()),
              "door_lm deploy: not every recorded request was answered")
        for m in lms:
            check(trace.header["models"][m]["class"] == "lm", f"door_lm: {m} not lm")
        legs = (("same_deployment", lambda: (trace, {"deployment": dep})),
                ("fresh_card", lambda: (tr.GoldenTrace.load(path),
                                        {"backend": registry.negotiate("cuda")})))
        for name, setup in legs:
            t0 = time.perf_counter()
            golden, kw = setup()
            replay = golden.replay(**kw)
            diff = golden.diff(replay)
            emit({"phase": "door_lm_trace", "models": list(models), "leg": name,
                  "tolerance": diff.tolerance, "max_abs_err": diff.max_abs_err,
                  "n_compared": diff.n_compared,
                  "lm_results": sum(m in lms for m, _ in golden.results),
                  "kernels": sorted(replay.kernels), "seconds": time.perf_counter() - t0,
                  "describe": diff.describe()})
            check(diff.tolerance == 0.0 and diff.ok,
                  f"door_lm trace {name}: {diff.describe()}")
            check(diff.n_compared == len(models) * DOOR_DEPLOY_REQUESTS,
                  f"door_lm trace {name}: compared {diff.n_compared}")
        served = dict(registry.LAUNCHES)
    emit({"phase": "door_lm", "door": "deploy", "models": list(models),
          "deploy_s": deploy_s, "stateful_prefill": {
              m: dep.engines[m].cfg.stateful_prefill for m in lms},
          "summary": dep.summary()})
    return served


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
    same bucket, bit for bit.  (2) ``deploy()`` of nvsa beside llama3.2-3b,
    then beside rwkv6-7b and recurrentgemma-9b, at the reference's smoke
    scale on the card (``door_deploy_trace``): recorded and replayed,
    tokens and answers exact.  Returns the launch counts of the served
    windows: the door's serve, the recorded serves and the replays, not
    the checks."""
    import numpy as np
    import torch

    from repro_torch.backend import registry
    from repro_torch.configs import base as cb
    from repro_torch.configs import get_arch
    from repro_torch.nn import init as nninit
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
        decode = lm_check_decode(params, arch, cfg, prompts, streams, dev, "door_lm")
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

    # deploy() of nvsa beside the LMs' smoke archs, recorded and replayed:
    # llama3.2-3b, then the recurrent kinds
    for models in DOOR_DEPLOY_MODELS:
        served = door_deploy_trace(models)
        counts = {k: n + served[k] for k, n in counts.items()}
    # the LM engine admits prompts through ``decode_step`` token by token, as
    # the reference's does, so LM traffic launches no flash_attn
    check(counts["circ_conv"] > 0, "kernel circ_conv was not launched on the "
                                   "door_lm path")
    emit({"phase": "door_lm_done", "seconds": time.perf_counter() - t_phase,
          "launches": counts})
    return counts


# -- phase 11b ----------------------------------------------------------------

TP_DEVICES = ("cuda:0", "cuda:0")   # two ranks over-subscribe the one card
TP_FORWARD = (1, 2048)
TP_SERVE = dict(max_slots=4, max_len=128, max_new_tokens=16, decode_block=8,
                prefill_bucket=16)
TP_REQUESTS, TP_PROMPTS = 4, (16, 32)
TP_MOE_ARCH = "granite-moe-1b-a400m"
TP_DEPLOY_REQUESTS = 8   # per model


def tp_forced_forward(rank, toks, forced):
    """On every rank of a world: the forward's logits of ``toks`` with each
    MoE layer's experts forced to ``forced`` (``RoutesHeld``); rank 0
    returns them, the others their ``world.digest``."""
    from repro_torch.distributed import world

    with RoutesHeld(forced):
        y = world.forward_logits(rank, toks)
    return y if rank.ctx.rank == 0 else world.digest(y)


def tp_forward_at(rank, toks, dtype: str):
    """On every rank of a world: the forward's logits of ``toks`` at compute
    dtype ``dtype`` over the rank's parameters; rank 0 returns them, the
    others their ``world.digest``."""
    import torch

    from repro_torch.configs import base as cb
    from repro_torch.configs import get_arch
    from repro_torch.distributed import world

    cfg = dataclasses.replace(rank.spec.cfg, compute_dtype=getattr(torch, dtype))
    forward, readout = cb.forward_fn(get_arch(rank.spec.arch_id), cfg)
    t = toks.to(rank.device)
    y = rank.run(lambda: readout(rank.params, forward(rank.params, t)))
    return y if rank.ctx.rank == 0 else world.digest(y)


def tp_logit_err(got, want, inputs=None) -> float:
    """max |got - want| over the logits' scale of each row (``logit_scale``;
    with ``inputs``, each row's input token, taken without that column, as
    a tied embedding echoes it)."""
    got, want = got.float().flatten(0, -2), want.float().flatten(0, -2)
    if inputs is not None:
        inputs = inputs.reshape(-1)
    return float(((got - want).abs().amax(-1) / logit_scale(want, inputs)).max())


def tp_ms(fn, reps: int = 3) -> float:
    """Median host ms of ``fn`` (which runs on every rank), the card
    synchronised around each call."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def tp_collectives(eng, fn) -> dict:
    """Each collective of one ``fn()`` on rank 0: its count, the bytes rank
    0 handed it and, in a second call with the card synchronised around
    each collective, its host ms."""
    before, bytes_before = dict(eng.collectives), dict(eng.rank0.ctx.nbytes)
    fn()
    mid, bytes_mid = dict(eng.collectives), dict(eng.rank0.ctx.nbytes)
    eng.rank0.ctx.timed = True
    try:
        fn()
    finally:
        eng.rank0.ctx.timed = False
    out = {}
    for op, (n, _) in mid.items():
        n0, s0 = before.get(op, (0, 0.0))
        n1, s1 = eng.collectives[op]
        out[op] = {"count": n - n0, "bytes": bytes_mid[op] - bytes_before.get(op, 0),
                   "ms_each": (s1 - mid[op][1]) * 1e3 / max(1, n1 - n)}
    return out


def tp_embed_cut(rank):
    """The dim the rank's embedding table was cut along (None: whole)."""
    return getattr(rank.params["embed"]["table"], "tp_dim", None)


# -- phase 11b: the other kinds at tp 2 ------------------------------------------
# each at its published width on one world of two ranks, against the single
# device in rank 0's process (before the model's world calls, its parameters
# freed after): rwkv6-7b and recurrentgemma-9b at LM_ENGINE_LAYERS' depths and
# f32 compute (two bf16 computations of either part by more than 3e-2 of the
# logits' scale: each lies that far from its own f32 forward, which the row
# reports), deepseek-v3-671b at lm's 4 layers, dropless, without its MTP head
# (a fifth MoE layer only the training loss reads: with it, two ranks drawing
# on one card would peak near its 80 GB), internvl2-26b at 8 of its 48
# layers, seamless-m4t-large-v2 at its full 24 + 24
TP_KIND_ARCHS = (LM_RWKV_ARCH, LM_GRIFFIN_ARCH, "deepseek-v3-671b")
TP_KIND_FORWARD = (1, 512)
TP_KIND_SERVE = dict(max_slots=2, max_len=64, max_new_tokens=4, decode_block=4,
                     prefill_bucket=16)
TP_KIND_REQUESTS, TP_KIND_PROMPTS = 2, (16, 32)
TP_REC_TOL = 1e-3       # of the logits' scale: the recurrent kinds at f32 compute
# the recurrent kinds' bf16 forward at tp 2 lies from the single device's f32
# forward at most this many times the single device's own bf16 forward does
TP_REC_BF16_RATIO = 1.5
TP_VLM_LAYERS = 8
TP_ENCDEC_SRC, TP_ENCDEC_TGT, TP_ENCDEC_SERVE_B, TP_ENCDEC_STEPS = 2048, 64, 2, 4
# the flash_attn launches a call makes on each rank
TP_ENCDEC_FLASH = {"encode": 24, "decode_train": 48, "decode_step": 24}


def tp_kind_config(arch_id: str):
    """The config of ``arch_id``'s tp-2 row (``TP_KIND_ARCHS``, the VLM,
    the enc-dec kind): its published width, cut in depth as the comment
    above ``TP_KIND_ARCHS`` says."""
    import dataclasses

    import torch

    cfg = lm_config(arch_id) if arch_id != ENCDEC_ARCH else encdec_config()
    if arch_id in LM_REC_ARCHS:
        return dataclasses.replace(cfg, n_layers=LM_ENGINE_LAYERS[arch_id],
                                   compute_dtype=torch.float32)
    if arch_id == "deepseek-v3-671b":
        return dropless(dataclasses.replace(cfg, mtp=False))
    if arch_id == VLM_ARCH:
        return dataclasses.replace(cfg, lm=dataclasses.replace(cfg.lm, n_layers=TP_VLM_LAYERS))
    return cfg


def tp_reset_peak() -> None:
    """Reset this process's peak allocated bytes on its card (run on every
    rank by ``tp_reset_peaks``)."""
    import torch

    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()


def tp_reset_peaks(w) -> None:
    """Reset every rank's peak allocated bytes, before a model is built."""
    w.spmd(tp_reset_peak, [()] * w.size)


def tp_margins(params, arch, cfg, prompts, streams, dev, tol: float) -> dict:
    """Each stream's top-2 margins of the single device's forward over
    prompt + generated tokens, at its generated positions, in tie margins
    (twice ``tol`` of the logits' scale), as ``lm_check_decode`` takes
    them."""
    out = {}
    for uid, res in streams.items():
        a = lm_forward_logits(params, arch, cfg, prompts[uid], res.tokens, dev)
        top = a.topk(2, dim=-1).values
        out[uid] = ((top[:, 0] - top[:, 1]) / (2 * tol * a.abs().amax(-1).clamp(min=1.0))
                    ).cpu().numpy()
    return out


def tp_peaks(model, label: str) -> list[int]:
    """Each rank's peak allocated bytes since ``tp_reset_peaks``, each at
    most ``LM_PEAK_LIMIT``."""
    from repro_torch.distributed import world

    peaks = [world.peak_bytes(model.rank0), *model.on_every_rank(world.peak_bytes)[1]]
    check(max(peaks) <= LM_PEAK_LIMIT, f"{label}: peak bytes per rank {peaks}")
    return peaks


def tp_token_kind(w, on_path, arch_id: str, held: "FlashHeld", dev: str) -> dict:
    """``arch_id`` (rwkv6-7b, recurrentgemma-9b, deepseek-v3-671b) at tp 2
    against the single device: a ``TP_KIND_FORWARD`` forward (deepseek's
    experts forced to the single device's, ``RoutesHeld``) within
    ``LM_LOGIT_TOL`` (the recurrent kinds: ``TP_REC_TOL`` at f32) of the
    logits' scale (griffin's without the input token's column),
    the same bits on both ranks; the recurrent kinds' bf16 forward at tp 2
    within ``TP_REC_BF16_RATIO`` times the single device's own bf16 gap of
    the f32 forward, the same bits on both ranks; the engine serving ``TP_KIND_REQUESTS``
    prompts twice, equal, and the single device's streams but at near
    ties of its forward; no flash_attn launch.  Returns the row."""
    import torch

    from repro_torch.configs import base as cb
    from repro_torch.configs import get_arch
    from repro_torch.distributed import world
    from repro_torch.nn import init as nninit
    from repro_torch.serve.engine import Engine, Request, ServeConfig

    arch, cfg = get_arch(arch_id), tp_kind_config(arch_id)
    moe = getattr(cfg, "moe", None) is not None
    tol = TP_REC_TOL if arch_id in LM_REC_ARCHS else LM_LOGIT_TOL
    gen = torch.Generator("cpu").manual_seed(SEED + 13)
    toks = torch.randint(0, cfg.vocab, TP_KIND_FORWARD, generator=gen).to(dev)
    prompts = lm_prompts(cfg.vocab, TP_KIND_REQUESTS, TP_KIND_PROMPTS, SEED + 5)
    reqs = [Request(uid=i, prompt=q) for i, q in enumerate(prompts)]
    echo = toks if arch_id == LM_GRIFFIN_ARCH else None

    # the single device first, its parameters freed before the world's
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = nninit.materialize(cb.model_spec(arch, cfg), torch.Generator(dev).manual_seed(SEED))
    torch.cuda.synchronize()
    row = {"phase": "tp", "arch": arch_id, "tp": 2, "n_layers": cfg.n_layers,
           "compute_dtype": str(cfg.compute_dtype).split(".")[1],
           "forward": list(TP_KIND_FORWARD), "single_draw_s": time.perf_counter() - t0}
    forward, readout = cb.forward_fn(arch, cfg)
    with RoutesHeld() as routes:
        single = readout(params, forward(params, toks))
    row["single_ms_per_forward"] = tp_ms(lambda: readout(params, forward(params, toks)))
    if arch_id in LM_REC_ARCHS:
        # the model's own bf16 rounding at this depth, which two bf16
        # computations of it (tp and single) may each show
        f16, r16 = cb.forward_fn(arch, dataclasses.replace(cfg, compute_dtype=torch.bfloat16))
        single16 = r16(params, f16(params, toks))
        row["single_bf16_vs_f32_of_scale"] = tp_logit_err(single16, single, echo)
    step, init = cb.serve_fns(arch, cfg, TP_KIND_SERVE["max_len"])
    one = Engine(step, init, ServeConfig(**TP_KIND_SERVE), params=params)
    one.run(reqs)
    single_streams = one.run(reqs)
    row["single_ms_per_decode_step"] = (
        one.stats["decode_time_s"] * 1e3
        / (one.stats["decode_blocks"] * TP_KIND_SERVE["decode_block"]))
    margins = tp_margins(params, arch, cfg, prompts, single_streams, dev, tol)
    row["single_peak_bytes"] = torch.cuda.max_memory_allocated()
    del params, one, step, init
    gc.collect()     # the engine's cycles hold the parameters
    torch.cuda.empty_cache()

    tp_reset_peaks(w)
    t0 = time.perf_counter()
    eng = world.TPEngine(w, world.EngineSpec(
        arch_id, cfg, world.SeededParams.of(torch.Generator(dev).manual_seed(SEED)),
        ServeConfig(**TP_KIND_SERVE)), owns_world=False)
    row["build_s"] = time.perf_counter() - t0
    if moe:
        def fwd():
            y, theirs = eng.on_every_rank(tp_forced_forward, toks, routes.calls)
            check(all(d == world.digest(y) for d in theirs),
                  f"{arch_id} tp forward: the ranks' logits differ")
            return y
    else:
        def fwd():
            return eng.forward(toks)          # raises unless both ranks' bits agree
    with held:
        y, per_rank = on_path(w, fwd)
    row["flash_attn_launches_per_rank"] = [c["flash_attn"] for c in per_rank]
    check(row["flash_attn_launches_per_rank"] == [0, 0],
          f"{arch_id} tp forward: flash_attn per rank {row['flash_attn_launches_per_rank']}")
    check(tuple(y.shape) == (*TP_KIND_FORWARD, cfg.vocab) and bool(y.isfinite().all()),
          f"{arch_id} tp forward: logits")
    row["logits_vs_single_device"] = tp_logit_err(y, single, echo)
    row["tolerance_of_scale"] = tol
    check(row["logits_vs_single_device"] <= tol,
          f"{arch_id} tp forward: {row['logits_vs_single_device']} of the logits' scale "
          "from the single device")
    del y
    if arch_id in LM_REC_ARCHS:
        # the bf16 path at tp 2, held against the f32 forward by the single
        # device's own bf16 gap: a fault of the cut at bf16 only shows here
        y16, theirs = eng.on_every_rank(tp_forward_at, toks, "bfloat16")
        check(all(d == world.digest(y16) for d in theirs),
              f"{arch_id} tp bf16 forward: the ranks' logits differ")
        row["tp_bf16_vs_single_bf16_of_scale"] = tp_logit_err(y16, single16, echo)
        row["tp_bf16_vs_single_f32_of_scale"] = tp_logit_err(y16, single, echo)
        bound = TP_REC_BF16_RATIO * row["single_bf16_vs_f32_of_scale"]
        check(row["tp_bf16_vs_single_f32_of_scale"] <= bound,
              f"{arch_id} tp bf16 forward: {row['tp_bf16_vs_single_f32_of_scale']} of the "
              f"scale from the single device's f32 forward, above {bound}")
        del y16, single16
    del single
    row["ms_per_forward"] = tp_ms(fwd)
    row["collectives_per_forward"] = tp_collectives(eng, fwd)
    (served, per_a), (again, per_b) = (on_path(w, lambda: eng.run(reqs)) for _ in "ab")
    check(all(list(served[u].tokens) == list(again[u].tokens) for u in served),
          f"{arch_id} tp engine: a second greedy run differs")
    check([c["flash_attn"] for c in per_a + per_b] == [0] * 4,
          f"{arch_id} tp engine: flash_attn launched")
    row["left_single_device_at_near_ties"] = lm_same_streams(single_streams, served,
                                                             margins, f"{arch_id} tp engine")
    stats = eng.stats
    row["ms_per_decode_step"] = (stats["decode_time_s"] * 1e3
                                 / (stats["decode_blocks"] * TP_KIND_SERVE["decode_block"]))
    row["peak_bytes_per_rank"] = tp_peaks(eng, f"{arch_id} tp")
    row["card"] = CARD
    eng.close()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return row


def tp_vlm(w, on_path, held: "FlashHeld", dev: str) -> dict:
    """internvl2-26b at its width and ``TP_VLM_LAYERS`` layers at tp 2: its
    partitioned ``prefill_fn`` (``TPModel.same`` of ``world.model_prefill``)
    over ``VLM_IMAGE_TOKENS`` patch embeddings and ``VLM_TEXT_TOKENS`` tokens,
    flash_attn once a layer on each rank at (1, 2048, 24, 128), the
    last-token logits within ``LM_LOGIT_TOL`` of the single device's scale,
    the same bits on both ranks."""
    import torch

    from repro_torch.configs import base as cb
    from repro_torch.configs import get_arch
    from repro_torch.distributed import world
    from repro_torch.nn import init as nninit

    arch, cfg = get_arch(VLM_ARCH), tp_kind_config(VLM_ARCH)
    gen = torch.Generator("cpu").manual_seed(SEED + 8)
    batch = {"patch_embeds": torch.randn(1, VLM_IMAGE_TOKENS, cfg.lm.d_model,
                                         generator=gen).to(dev),
             "tokens": torch.randint(0, cfg.lm.vocab, (1, VLM_TEXT_TOKENS),
                                     generator=gen).to(dev)}
    torch.cuda.reset_peak_memory_stats()
    params = nninit.materialize(cb.model_spec(arch, cfg), torch.Generator(dev).manual_seed(SEED))
    prefill = cb.prefill_fn(arch, cfg)
    single = prefill(params, batch)
    row = {"phase": "tp", "arch": VLM_ARCH, "tp": 2, "n_layers": cfg.lm.n_layers,
           "prefill": [1, VLM_IMAGE_TOKENS, VLM_TEXT_TOKENS],
           "single_ms_per_prefill": tp_ms(lambda: prefill(params, batch)),
           "single_peak_bytes": torch.cuda.max_memory_allocated()}
    del params
    gc.collect()
    torch.cuda.empty_cache()

    tp_reset_peaks(w)
    t0 = time.perf_counter()
    model = world.TPModel(w, world.EngineSpec(
        VLM_ARCH, cfg, world.SeededParams.of(torch.Generator(dev).manual_seed(SEED)), None),
        owns_world=False)
    row["build_s"] = time.perf_counter() - t0
    with held:
        y, per_rank = on_path(w, lambda: model.same(world.model_prefill, batch))
    row["flash_attn_launches_per_rank"] = [c["flash_attn"] for c in per_rank]
    check(row["flash_attn_launches_per_rank"] == [cfg.lm.n_layers] * 2,
          f"{VLM_ARCH} tp prefill: flash_attn per rank {row['flash_attn_launches_per_rank']}, "
          f"want {cfg.lm.n_layers}")
    check(tuple(y.shape) == (1, cfg.lm.vocab) and bool(y.isfinite().all()),
          f"{VLM_ARCH} tp prefill: logits")
    row["logits_vs_single_device"] = tp_logit_err(y, single)
    check(row["logits_vs_single_device"] <= LM_LOGIT_TOL,
          f"{VLM_ARCH} tp prefill: {row['logits_vs_single_device']} of the logits' scale")
    row["ms_per_prefill"] = tp_ms(lambda: model.same(world.model_prefill, batch))
    row["collectives_per_prefill"] = tp_collectives(
        model, lambda: model.same(world.model_prefill, batch))
    row["peak_bytes_per_rank"] = tp_peaks(model, f"{VLM_ARCH} tp")
    row["card"] = CARD
    model.close()
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return row


def tp_encdec(w, on_path, held: "FlashHeld", dev: str) -> dict:
    """seamless-m4t-large-v2 at its width and depth at tp 2 (``TPModel``):
    an encode of (1, ``TP_ENCDEC_SRC``) frames, ``decode_train``'s logits
    for ``TP_ENCDEC_TGT`` target tokens over it, then an encode of
    ``TP_ENCDEC_SERVE_B`` rows, its caches and ``TP_ENCDEC_STEPS`` decode
    steps fed the single device's greedy tokens: flash_attn on each rank
    ``TP_ENCDEC_FLASH`` times a call, every output within ``LM_LOGIT_TOL``
    of the single device's scale, the same bits on both ranks, each greedy
    token the single device's but at its near ties."""
    import torch

    from repro_torch.configs import base as cb
    from repro_torch.configs import get_arch
    from repro_torch.distributed import world
    from repro_torch.models import encdec
    from repro_torch.nn import init as nninit
    from repro_torch.nn import layers

    arch, cfg = get_arch(ENCDEC_ARCH), tp_kind_config(ENCDEC_ARCH)
    gen = torch.Generator("cpu").manual_seed(SEED + 21)
    frames = torch.randn(1, TP_ENCDEC_SRC, cfg.d_model, generator=gen).bfloat16().to(dev)
    frames2 = torch.randn(TP_ENCDEC_SERVE_B, TP_ENCDEC_SRC, cfg.d_model,
                          generator=gen).bfloat16().to(dev)
    tgt = torch.randint(0, cfg.vocab, (1, TP_ENCDEC_TGT), generator=gen).to(dev)
    max_len = TP_ENCDEC_STEPS + 1

    torch.cuda.reset_peak_memory_stats()
    params = nninit.materialize(cb.model_spec(arch, cfg), torch.Generator(dev).manual_seed(SEED))
    enc = encdec.encode(params, cfg, frames)
    dt = layers.logits(params["embed"], encdec.decode_train(params, cfg, enc, tgt),
                       cfg.compute_dtype)
    enc2 = encdec.encode(params, cfg, frames2)
    caches = encdec.init_caches(params, cfg, enc2, max_len, device=dev)
    tok = torch.zeros(TP_ENCDEC_SERVE_B, dtype=torch.long, device=dev)
    steps, toks = [], [tok]
    for t in range(TP_ENCDEC_STEPS):
        caches, logits = encdec.decode_step(params, cfg, caches, toks[-1], t)
        steps.append(logits)
        toks.append(logits.argmax(-1))
    row = {"phase": "tp", "arch": ENCDEC_ARCH, "tp": 2,
           "n_layers": [cfg.n_enc_layers, cfg.n_dec_layers],
           "encode": [1, TP_ENCDEC_SRC], "decode_train": [1, TP_ENCDEC_TGT],
           "decode_steps": [TP_ENCDEC_SERVE_B, TP_ENCDEC_STEPS],
           "single_ms_per_encode": tp_ms(lambda: encdec.encode(params, cfg, frames)),
           "single_ms_per_decode_step": tp_ms(lambda: encdec.decode_step(
               params, cfg, caches, toks[0], 0))}
    row["single_peak_bytes"] = torch.cuda.max_memory_allocated()
    del params, caches
    gc.collect()
    torch.cuda.empty_cache()

    tp_reset_peaks(w)
    t0 = time.perf_counter()
    model = world.TPModel(w, world.EngineSpec(
        ENCDEC_ARCH, cfg, world.SeededParams.of(torch.Generator(dev).manual_seed(SEED)), None),
        owns_world=False)
    row["build_s"] = time.perf_counter() - t0
    launches, errs = {}, {}

    def kept(fn, *args):      # an enc-dec serving step on every rank, the bits compared
        return model.same(world.model_call, fn, *args)

    def held_call(name, fn):
        with held:
            out, per_rank = on_path(w, fn)
        launches.setdefault(name, []).append([c["flash_attn"] for c in per_rank])
        check(launches[name][-1] == [TP_ENCDEC_FLASH.get(name, 0)] * 2,
              f"{ENCDEC_ARCH} tp {name}: flash_attn per rank {launches[name][-1]}")
        return out

    def held_err(name, got, want):
        errs[name] = max(errs.get(name, 0.0), tp_logit_err(got, want))
        check(errs[name] <= LM_LOGIT_TOL, f"{ENCDEC_ARCH} tp {name}: {errs[name]} of the "
                                          "single device's scale")

    held_err("encode", held_call("encode", lambda: kept(encdec.kept_encode, frames)), enc)
    held_err("decode_train",
             held_call("decode_train", lambda: kept(encdec.kept_decode_train, tgt)), dt)
    held_err("encode", held_call("encode", lambda: kept(encdec.kept_encode, frames2)), enc2)
    held_call("init_caches", lambda: kept(encdec.kept_init_caches, max_len))
    tie_left = 0
    for t in range(TP_ENCDEC_STEPS):
        got = held_call("decode_step", lambda t=t: kept(encdec.kept_decode_step, toks[t], t))
        held_err("decode_step", got, steps[t])
        want = steps[t].float()
        top = want.topk(2, dim=-1).values
        margin = (top[:, 0] - top[:, 1]) / (2 * LM_LOGIT_TOL * want.abs().amax(-1).clamp(min=1.0))
        differ = got.argmax(-1) != toks[t + 1]
        check(bool((margin[differ] <= 1).all()),
              f"{ENCDEC_ARCH} tp decode step {t}: a greedy token leaves the single "
              "device's outside a near tie")
        tie_left += int(differ.sum())
    row.update(flash_attn_launches_per_rank=launches, outputs_vs_single_device=errs,
               greedy_left_single_device_at_near_ties=tie_left)
    row["ms_per_encode"] = tp_ms(lambda: kept(encdec.kept_encode, frames))
    row["collectives_per_encode"] = tp_collectives(model,
                                                   lambda: kept(encdec.kept_encode, frames))
    kept(encdec.kept_encode, frames2)
    kept(encdec.kept_init_caches, max_len)
    row["ms_per_decode_step"] = tp_ms(lambda: kept(encdec.kept_decode_step, toks[0], 0))
    row["collectives_per_decode_step"] = tp_collectives(
        model, lambda: kept(encdec.kept_decode_step, toks[0], 0))
    row["peak_bytes_per_rank"] = tp_peaks(model, f"{ENCDEC_ARCH} tp")
    row["card"] = CARD
    model.close()
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return row


def tp_kinds(on_path, dev: str) -> None:
    """The other kinds at tp 2 on one world of two ranks (phase 11b's second
    part), a row each: ``tp_token_kind`` for ``TP_KIND_ARCHS``, ``tp_vlm``,
    ``tp_encdec``.  Rank 0's first flash_mha call at each shape is held
    against its plain version (``FlashHeld``)."""
    from repro_torch.distributed import world

    held = FlashHeld()
    t0 = time.perf_counter()
    w = world.World(TP_DEVICES)
    rows = [lambda a=a: tp_token_kind(w, on_path, a, held, dev) for a in TP_KIND_ARCHS]
    rows += [lambda: tp_vlm(w, on_path, held, dev), lambda: tp_encdec(w, on_path, held, dev)]
    try:
        for row in rows:
            t1 = time.perf_counter()
            emit(dict(row(), row_s=time.perf_counter() - t1))
    finally:
        w.close()
    emit({"phase": "tp", "kinds_s": time.perf_counter() - t0, "flash_held": held.rows,
          "card": CARD})

def phase_tp(dev: str = "cuda") -> dict[str, int]:
    """Distribution on the serving path (phase 11b of the module docstring).
    Returns the launch counts of the tensor-parallel forwards and serves,
    summed over the ranks, and of the deployment's serve."""
    import numpy as np
    import torch

    from repro_torch.backend import registry
    from repro_torch.configs import base as cb
    from repro_torch.configs import get_arch
    from repro_torch.distributed import world
    from repro_torch.nn import init as nninit
    from repro_torch.serve.deploy import Budget, Traffic, deploy
    from repro_torch.serve.engine import Engine, Request, ServeConfig

    t_phase = time.perf_counter()
    counts = {k: 0 for k in registry.KERNELS}

    def on_path(w, fn):
        """``fn()`` with every rank's counts set to 0 before and added to the
        path's after; returns its result and each rank's counts."""
        w.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        per_rank = w.launches()
        for c in per_rank:
            for k in counts:
                counts[k] += c[k]
        return out, per_rank

    # llama3.2-3b tensor-parallel, then the single device in this process
    arch, cfg = get_arch(LM_ARCH), lm_config(LM_ARCH)
    gen = torch.Generator("cpu").manual_seed(SEED + 11)
    toks = torch.randint(0, cfg.vocab, TP_FORWARD, generator=gen).to(dev)
    prompts = lm_prompts(cfg.vocab, TP_REQUESTS, TP_PROMPTS, SEED + 7)
    reqs = [Request(uid=i, prompt=p) for i, p in enumerate(prompts)]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = world.tp_engine(LM_ARCH, cfg,
                          world.SeededParams.of(torch.Generator(dev).manual_seed(SEED)),
                          2, TP_DEVICES, ServeConfig(**TP_SERVE))
    build_s = time.perf_counter() - t0
    tp_logits, per_rank = on_path(eng.world, lambda: eng.forward(toks))
    check([c["flash_attn"] for c in per_rank] == [cfg.n_layers] * 2,
          f"tp forward: flash_attn launches per rank {[c['flash_attn'] for c in per_rank]}, "
          f"want {cfg.n_layers} on each")
    check(tuple(tp_logits.shape) == (*TP_FORWARD, cfg.vocab)
          and bool(tp_logits.isfinite().all()), "tp forward: logits")
    (served, _), (again, _) = (on_path(eng.world, lambda: eng.run(reqs)) for _ in "ab")
    check(all(list(served[u].tokens) == list(again[u].tokens) for u in served),
          "tp engine: a second greedy run differs")
    stats = dict(eng.stats)
    fwd_collectives = tp_collectives(eng, lambda: eng.forward(toks))
    tp_forward_ms = tp_ms(lambda: eng.forward(toks))
    peaks = [torch.cuda.max_memory_allocated(),
             *eng.on_every_rank(world.peak_bytes)[1]]
    decode_steps = stats["decode_blocks"] * TP_SERVE["decode_block"]
    run_collectives = {op: n for op, (n, _) in eng.collectives.items()}
    tp_row = {"phase": "tp", "arch": LM_ARCH, "tp": 2, "devices": list(TP_DEVICES),
              "build_s": build_s, "forward": list(TP_FORWARD),
              "flash_attn_launches_per_rank": [c["flash_attn"] for c in per_rank],
              "ms_per_forward": tp_forward_ms,
              "ms_per_decode_step": stats["decode_time_s"] * 1e3 / decode_steps,
              "tokens_per_s": eng.tokens_per_s(),
              "collectives_per_forward": fwd_collectives,
              "collectives_all_calls": run_collectives,
              "peak_bytes_per_rank": peaks, "card": CARD}
    final = eng.close()
    del eng          # rank 0's cut of the parameters, in this process
    check(len(final) == 1, "tp: the world did not close with its worker's streams")
    tp_row["ranks_streams_equal"] = True

    torch.cuda.reset_peak_memory_stats()
    params = nninit.materialize(cb.model_spec(arch, cfg), torch.Generator(dev).manual_seed(SEED))
    forward, readout = cb.forward_fn(arch, cfg)
    single = readout(params, forward(params, toks))
    tp_row["logits_vs_single_device"] = tp_logit_err(tp_logits, single)
    check(tp_row["logits_vs_single_device"] <= LM_LOGIT_TOL,
          f"tp forward: {tp_row['logits_vs_single_device']} of the logits' scale from "
          "the single device")
    del tp_logits, single
    tp_row["single_ms_per_forward"] = tp_ms(lambda: readout(params, forward(params, toks)))
    step, init = cb.serve_fns(arch, cfg, TP_SERVE["max_len"])
    one = Engine(step, init, ServeConfig(**TP_SERVE), params=params)
    one.run(reqs)
    single_streams = one.run(reqs)
    tp_row["single_ms_per_decode_step"] = (one.stats["decode_time_s"] * 1e3
                                           / (one.stats["decode_blocks"] * TP_SERVE["decode_block"]))
    tp_row["single_peak_bytes"] = torch.cuda.max_memory_allocated()
    decode = lm_check_decode(params, arch, cfg, prompts, single_streams, dev, "tp single")
    tp_row["left_single_device_at_near_ties"] = lm_same_streams(
        single_streams, served, decode["margins"], "tp engine")
    emit(tp_row)
    del params, one
    gc.collect()     # the engine's cycles hold the parameters
    torch.cuda.empty_cache()

    # granite-moe-1b-a400m: its vocab does not divide, experts forced
    arch_m, cfg_m = get_arch(TP_MOE_ARCH), dropless(lm_config(TP_MOE_ARCH))
    toks_m = torch.randint(0, cfg_m.vocab, TP_FORWARD, generator=gen).to(dev)
    eng_m = world.tp_engine(TP_MOE_ARCH, cfg_m,
                            world.SeededParams.of(torch.Generator(dev).manual_seed(SEED)),
                            2, TP_DEVICES, ServeConfig(**TP_SERVE))
    embed_dims, _ = eng_m.on_every_rank(tp_embed_cut)
    check(embed_dims == 1, f"granite at tp 2: embedding cut along dim {embed_dims}, "
                           "want the embed dim (the fallback)")
    params_m = nninit.materialize(cb.model_spec(arch_m, cfg_m),
                                  torch.Generator(dev).manual_seed(SEED))
    fwd_m, read_m = cb.forward_fn(arch_m, cfg_m)
    with RoutesHeld() as routes:
        single_m = read_m(params_m, fwd_m(params_m, toks_m))
    ((y_m, theirs), per_rank_m) = on_path(
        eng_m.world, lambda: eng_m.on_every_rank(tp_forced_forward, toks_m, routes.calls))
    check(all(d == world.digest(y_m) for d in theirs),
          "granite tp forward: the ranks' logits differ")
    check([c["flash_attn"] for c in per_rank_m] == [cfg_m.n_layers] * 2,
          f"granite tp forward: flash_attn per rank {[c['flash_attn'] for c in per_rank_m]}")
    moe_row = {"phase": "tp", "arch": TP_MOE_ARCH, "tp": 2, "n_layers": cfg_m.n_layers,
               "capacity_factor": cfg_m.moe.capacity_factor, "embed_cut_dim": embed_dims,
               "flash_attn_launches_per_rank": [c["flash_attn"] for c in per_rank_m],
               "logits_vs_single_device": tp_logit_err(y_m, single_m),
               "ms_per_forward": tp_ms(lambda: eng_m.on_every_rank(
                   tp_forced_forward, toks_m, routes.calls)),
               "single_ms_per_forward": tp_ms(lambda: read_m(params_m, fwd_m(params_m, toks_m))),
               "card": CARD}
    check(moe_row["logits_vs_single_device"] <= LM_LOGIT_TOL,
          f"granite tp forward: {moe_row['logits_vs_single_device']} of the logits' scale")
    emit(moe_row)
    eng_m.close()
    del eng_m, params_m, single_m, y_m
    gc.collect()
    torch.cuda.empty_cache()

    tp_kinds(on_path, dev)

    # deploy()'s replicas / tp arm on the card
    t0 = time.perf_counter()
    dep = deploy(["nvsa", LM_ARCH], Traffic(rate_rps=20.0),
                 Budget(devices=2, replicas="auto", tp=2))
    rec = dep.report()
    check(rec["nvsa"]["replicas"] == 2 and rec["nvsa"]["mesh"]["model"] == 1,
          f"deploy: nvsa mesh {rec['nvsa']['mesh']}, replicas {rec['nvsa']['replicas']}")
    check(rec[LM_ARCH]["mesh"]["model"] == 2 and dep.engines[LM_ARCH].tp == 2,
          f"deploy: {LM_ARCH} mesh {rec[LM_ARCH]['mesh']}")
    emit({"phase": "tp", "deploy": {m: {"mesh": rec[m]["mesh"], "replicas": rec[m]["replicas"]}
                                    for m in ("nvsa", LM_ARCH)},
          "summary": dep.summary().splitlines(), "deploy_s": time.perf_counter() - t0})
    arrivals, _ = dep.synthetic_traffic(TP_DEPLOY_REQUESTS)
    report, per_rank_d = on_path(dep.engines[LM_ARCH].world, lambda: dep.serve(arrivals))
    for m in ("nvsa", LM_ARCH):
        check(sorted(report.results[m]) == list(range(TP_DEPLOY_REQUESTS)),
              f"deploy tp: {m}: {len(report.results[m])} of {TP_DEPLOY_REQUESTS} answered")
    check(per_rank_d[0]["circ_conv"] > 0, "deploy tp: circ_conv was not launched")
    emit({"phase": "tp", "deploy_served": {m: len(report.results[m]) for m in report.results},
          "nvsa_per_replica": dep.report()["nvsa"]["per_replica"],
          "launches_per_rank": per_rank_d, "serve_wall_s": report.wall_time_s})
    dep.close()
    check(counts["flash_attn"] > 0 and counts["circ_conv"] > 0,
          f"tp: the path's launches {counts}")
    emit({"phase": "tp_done", "seconds": time.perf_counter() - t_phase, "launches": counts})
    return counts


# -- phase 11c: the training half of distribution ----------------------------------

DIST_DEVICES = ("cuda:0", "cuda:0")   # two ranks over-subscribe the one card
DIST_STAGES, DIST_MICRO, DIST_MB = 2, 4, (1, 512)   # llama3.2-3b: 2 x 14 layers
DIST_NVSA_D, DIST_NVSA_PROBLEMS = 128, 8   # the served d; 64 panels a side
DIST_EF_STEPS, DIST_EF_SIZE = 10, 1 << 20
DIST_LAUNCH = ["--arch", LM_ARCH, "--steps", "20", "--batch", "4", "--seq", "32",
               "--lr", "3e-3"]   # smoke width, checkpoints at 10 and 20
DIST_DRY_SHAPE = (1, 2048)   # phase 10b's step: (B, S), on a (1, 1) mesh


def dist_peak(device: str) -> int:
    """The process's peak allocated bytes on its card (0 on the CPU)."""
    import torch

    if not device.startswith("cuda"):
        return 0
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated()


def dist_sync(dev: str) -> None:
    import torch

    if dev.startswith("cuda"):
        torch.cuda.synchronize()


def dist_stage_fn(cfg):
    """llama3.2-3b's layers over one stage's units (``dist_units``)."""
    import torch

    from repro_torch.models import lm

    plan = lm.stage_plan(cfg)

    def stage(units, h):
        positions = torch.arange(h.shape[1], device=h.device)
        for unit in units:
            h, _ = lm._unit_fwd(cfg, unit, h, positions, plan.unit)
        return h

    return stage


def dist_units(body, n: int) -> list:
    """The ``n`` units of a stacked body slice as leaves of their own: a
    layer's gradient then forms in place over the ticks, with no stacked
    copy (the schedule already holds every tick's activations and bf16
    weight copies, ~17 GB a rank at full width)."""
    from repro_torch.common.tree import tree_map
    from repro_torch.models import lm

    return [tree_map(lambda t: t.detach().clone().requires_grad_(), u)
            for u in lm._unstack(body, n)]


def dist_rank_init(cfg, source, n_stages: int):
    """On every rank of the pipeline: its stage's parameters (one leaf a
    layer, ``dist_units``), kept in its SPMD state.  Rank 0 is given its
    stage (copies of the caller's model); another rank draws the whole
    model from the generator state ``source`` leaf by leaf on its card, as
    ``nninit.materialize`` draws it, and keeps its slice of the body."""
    import torch

    from repro_torch.common.tree import tree_map
    from repro_torch.configs import base as cb
    from repro_torch.configs import get_arch
    from repro_torch.distributed import constraints as tpc
    from repro_torch.nn import init as nninit

    ctx = tpc.spmd_current("pod")
    if isinstance(source, list):
        body = source
    else:
        gen = torch.Generator(ctx.device)
        gen.set_state(source)
        per = cfg.n_layers // n_stages
        lo = ctx.rank * per
        body = None
        for key, sub in cb.model_spec(get_arch(LM_ARCH), cfg).items():
            drawn = tree_map(lambda p: nninit._materialize_one(p, gen)[lo:lo + per].clone()
                             if key == "body" else nninit._materialize_one(p, gen), sub)
            if key == "body":
                body = dist_units(drawn, per)
            del drawn
        if ctx.device.startswith("cuda"):
            torch.cuda.empty_cache()
    ctx.state.update(params=body, cfg=cfg)
    return dist_peak(ctx.device)


def dist_rank_forward(x_micro):
    """The pipelined body over ``x_micro`` (n_micro, mb, S, D); rank 0
    passes the caller's embeddings, the others zeros.  Keeps the outputs
    for the backward; rank 0 returns them."""
    from repro_torch.common.tree import tree_leaves
    from repro_torch.distributed import constraints as tpc
    from repro_torch.distributed import gpipe

    ctx = tpc.spmd_current("pod")
    units = ctx.state["params"]
    for p in tree_leaves(units):
        p.grad = None
    f = gpipe.make_pipelined_fn(dist_stage_fn(ctx.state["cfg"]), ctx.size, ctx.mesh, "pod")
    outs = f(units, x_micro.to(ctx.device))
    ctx.state["outs"] = outs
    return outs if ctx.rank == 0 else None


def dist_rank_backward(g):
    """One backward through the schedule from the cotangent ``g`` of the
    outputs, on every rank in lockstep; returns each rank's peak bytes."""
    import torch

    from repro_torch.common.tree import tree_map
    from repro_torch.distributed import constraints as tpc

    ctx = tpc.spmd_current("pod")
    torch.autograd.backward(ctx.state.pop("outs"), g.to(ctx.device))
    ctx.state["grads"] = tree_map(lambda p: p.grad, ctx.state["params"])
    return dist_peak(ctx.device)


def dist_rank_grads_err(src: int, want):
    """Rank ``src``'s stage gradients, summed to every rank leaf by leaf
    (zeros from the others: exact), against ``want`` on rank 0 (None on
    the others): the largest leaf error relative to the leaf's max."""
    import torch

    from repro_torch.common.tree import tree_leaves
    from repro_torch.distributed import constraints as tpc

    ctx = tpc.spmd_current("pod")
    want = None if want is None else tree_leaves(want)
    worst = 0.0
    with torch.no_grad():
        for i, g in enumerate(tree_leaves(ctx.state["grads"])):
            got = tpc.psum(g if ctx.rank == src else torch.zeros_like(g), "pod")
            if want is not None:
                scale = max(float(want[i].abs().max()), 1e-30)
                err = (got.to(want[i].device).float() - want[i].float()).abs().max()
                worst = max(worst, float(err) / scale)
            del got
    return worst


def dist_rank_compress():
    """``compressed_psum`` of the rank's largest gradient leaf over the
    ranks, against the exact f32 sum: (max |err|, the bound sum(scale) / 2,
    the leaf's shape, the int8 payload's bytes)."""
    import torch

    from repro_torch.common.tree import tree_leaves
    from repro_torch.distributed import compression, constraints as tpc

    ctx = tpc.spmd_current("pod")
    with torch.no_grad():
        g = max(tree_leaves(ctx.state["grads"]), key=lambda t: t.numel())
        before = dict(ctx.nbytes)
        got = compression.compressed_psum(g, "pod")
        wire = {k: v - before.get(k, 0) for k, v in ctx.nbytes.items()}
        bound = float(tpc.all_gather(compression.quantize(g)[1], "pod").sum()) / 2
        exact = tpc.psum(g.float(), "pod")
        err = float((got - exact).abs().max())
    return {"max_abs_err": err, "bound": bound, "shape": list(g.shape),
            "all_gather_bytes": wire.get("all_gather", 0), "f32_bytes": g.numel() * 4}


def dist_rank_clear():
    """Drop the rank's SPMD state and cached blocks."""
    import torch

    from repro_torch.distributed import constraints as tpc

    ctx = tpc.spmd_current("pod")
    ctx.state.clear()
    if ctx.device.startswith("cuda"):
        torch.cuda.empty_cache()


def dist_nvsa_streams(cfg, params, books):
    """NVSA's two streams as folding takes them: the frontend on panels (N,
    H, W, 1) -> every attribute's PMFs side by side (N, sum V); the
    symbolic back end on PMFs packed (N, 16, sum V) -> answer log-probs."""
    import torch

    from repro_torch.models import nvsa

    sizes = list(cfg.raven.attr_sizes)
    qbooks = nvsa.quantize_codebooks(cfg, books)

    def nn_fn(x):
        return torch.cat(nvsa.frontend_pmfs(params, cfg, x)[0], dim=-1)

    def vsa_fn(x):
        parts = torch.split(x, sizes, dim=-1)
        return nvsa.reason(cfg, qbooks, [p[:, :8] for p in parts], [p[:, 8:] for p in parts])[0]

    return nn_fn, vsa_fn


def dist_rank_fold(cfg, consts, panels, packed):
    """NVSA folded over two ranks (n_l = 1): the frontend on rank 0, the
    symbolic back end on rank 1."""
    from repro_torch.common.tree import tree_map
    from repro_torch.core import folding
    from repro_torch.distributed import constraints as tpc

    ctx = tpc.spmd_current("model")
    consts = tree_map(lambda t: t.to(ctx.device), consts)
    nn_fn, vsa_fn = dist_nvsa_streams(cfg, consts["params"], consts["books"])
    f = folding.make_folded_fn(ctx.mesh, "model", 1, nn_fn, vsa_fn,
                               (panels.shape[0], sum(cfg.raven.attr_sizes)),
                               (packed.shape[0], 8))
    return f(panels.to(ctx.device), packed.to(ctx.device))


def dist_gpipe(w, on_path, dev: str) -> dict:
    """llama3.2-3b at its published width pipelined over the world's two
    ranks (14 layers each; embedding, final norm and head on the caller),
    against the single device accumulating the same microbatches in order:
    the logits within ``LM_LOGIT_TOL`` of the scale, each stage's
    gradients within ``TRAIN_FIRST_TOL["grad"]``.  Then the compressed
    reduction of each rank's largest gradient leaf.  Returns the row."""
    import torch

    from repro_torch.common.tree import tree_leaves, tree_map
    from repro_torch.configs import base as cb
    from repro_torch.configs import get_arch
    from repro_torch.distributed import gpipe
    from repro_torch.models import lm
    from repro_torch.nn import init as nninit
    from repro_torch.nn import layers

    arch, cfg = get_arch(LM_ARCH), lm_config(LM_ARCH)
    per = cfg.n_layers // DIST_STAGES
    gen = torch.Generator(dev).manual_seed(SEED + 34)
    source = gen.get_state()
    params = nninit.materialize(cb.model_spec(arch, cfg), gen)
    g_cpu = torch.Generator("cpu").manual_seed(SEED + 35)
    toks = torch.randint(0, cfg.vocab, (DIST_MICRO, *DIST_MB), generator=g_cpu).to(dev)
    tgts = torch.randint(0, cfg.vocab, (DIST_MICRO, *DIST_MB), generator=g_cpu).to(dev)

    # the single device: the microbatches in order, their gradients summed
    t0 = time.perf_counter()
    flat = [t.detach().requires_grad_() for t in tree_leaves(params)]
    it = iter(flat)
    whole = tree_map(lambda _: next(it), params)
    ref, ref_logits = None, []
    for m in range(DIST_MICRO):
        hidden, _ = lm.forward(whole, cfg, toks[m])
        logits = lm.lm_logits(whole, cfg, hidden)
        got = torch.autograd.grad(lm._xent(logits, tgts[m]), flat)
        ref_logits.append(logits.detach())
        if ref is None:
            ref = list(got)
        else:
            for a, b in zip(ref, got):
                a.add_(b)
        del got
    dist_sync(dev)
    single_ms = (time.perf_counter() - t0) * 1e3
    # the reference's gradients wait on the host: the schedule holds each
    # tick's activations and bf16 weight copies at once, ~14 GB a rank
    ref = [g.cpu() for g in ref]
    it = iter(ref)
    ref = tree_map(lambda _: next(it), params)
    del flat, whole, it, hidden, logits
    ref_logits = torch.cat(ref_logits)

    # the pipeline: rank 0 holds layers 0-13 and the embedding, final norm
    # and head (copies of the caller's model, which is then freed); rank 1
    # draws layers 14-27
    caller = {k: tree_map(lambda t: t.detach().clone().requires_grad_(), params[k])
              for k in ("embed", "final_norm")}
    stage0 = dist_units(tree_map(lambda t: t[:per], params["body"]), per)
    del params
    if dev == "cuda":
        torch.cuda.empty_cache()
    peaks_init = w.spmd(dist_rank_init, [(cfg, stage0, DIST_STAGES),
                                         (cfg, source, DIST_STAGES)], axis="pod")

    def step():
        x = torch.stack([lm._embed(caller, cfg, toks[m]) for m in range(DIST_MICRO)])
        outs, _ = w.spmd(dist_rank_forward, [(x,), (torch.zeros(x.shape, dtype=x.dtype),)],
                         axis="pod")
        o = outs.detach().requires_grad_()
        logits = []
        for m in range(DIST_MICRO):   # the loss is the microbatches' sum
            h = layers.rmsnorm(caller["final_norm"], o[m], offset=cfg.norm_offset)
            y = lm.lm_logits(caller, cfg, h)
            lm._xent(y, tgts[m]).backward()
            logits.append(y.detach())
            del h, y
        peaks = w.spmd(dist_rank_backward, [(o.grad,), (o.grad.cpu(),)], axis="pod")
        return torch.cat(logits), peaks

    dist_sync(dev)
    t0 = time.perf_counter()
    (logits, peaks), per_rank = on_path(step)
    pipe_ms = (time.perf_counter() - t0) * 1e3
    ticks = DIST_MICRO + DIST_STAGES - 1
    row = {"phase": "dist", "row": "gpipe", "arch": LM_ARCH, "n_layers": cfg.n_layers,
           "stages": DIST_STAGES, "layers_per_stage": per, "microbatches": DIST_MICRO,
           "microbatch": list(DIST_MB), "ticks": ticks,
           "bubble_fraction": gpipe.bubble_fraction(DIST_STAGES, DIST_MICRO),
           "flash_attn_launches_per_rank": [c["flash_attn"] for c in per_rank],
           "logits_vs_single_device": tp_logit_err(logits, ref_logits),
           "ms_pipelined_step": pipe_ms, "ms_single_device_step": single_ms,
           "peak_bytes_per_rank": [max(a, b) for a, b in zip(peaks_init, peaks)],
           "card": CARD}
    check([c["flash_attn"] for c in per_rank] == [per * ticks] * DIST_STAGES,
          f"gpipe: flash_attn launches per rank {row['flash_attn_launches_per_rank']}, "
          f"want {per} a tick on each")
    check(row["logits_vs_single_device"] <= LM_LOGIT_TOL,
          f"gpipe: logits {row['logits_vs_single_device']} of the scale from the single device")
    del logits, ref_logits
    tol = TRAIN_FIRST_TOL["grad"]
    ref_units = lm._unstack(ref["body"], cfg.n_layers)
    errs = {"stage0": tree_rel_err(tree_map(lambda p: p.grad, stage0), ref_units[:per]),
            "caller": tree_rel_err(tree_map(lambda p: p.grad, caller),
                                   {k: ref[k] for k in caller})}
    errs["stage1"], _ = w.spmd(dist_rank_grads_err, [(1, ref_units[per:]), (1, None)],
                               axis="pod")
    row["grad_rel_err"] = errs
    check(max(errs.values()) <= tol, f"gpipe: gradients {errs} beyond {tol} of each leaf's max")
    del ref, ref_units

    # the permutes timed: a second step, the card synchronised around each
    ctx = w.spmd_ctx
    n0, b0 = ctx.stats.get("ppermute", (0, 0.0)), ctx.nbytes.get("ppermute", 0)
    ctx.timed = True
    try:
        for p in tree_leaves((caller, stage0)):
            p.grad = None
        dist_sync(dev)
        t0 = time.perf_counter()
        step()
        row["ms_pipelined_step_timed"] = (time.perf_counter() - t0) * 1e3
    finally:
        ctx.timed = False
    n1, b1 = ctx.stats["ppermute"], ctx.nbytes["ppermute"]
    row["ppermute"] = {"count": n1[0] - n0[0], "bytes": b1 - b0,
                       "ms_total": (n1[1] - n0[1]) * 1e3}

    # compression of each rank's largest gradient leaf
    comp_rows = w.spmd(dist_rank_compress, [()] * DIST_STAGES, axis="pod")
    row["compressed_psum"] = comp_rows[0]
    c = comp_rows[0]
    check(c["max_abs_err"] <= c["bound"] * (1 + 1e-4),
          f"compressed_psum: {c['max_abs_err']} beyond the quantisation bound {c['bound']}")
    check(c["all_gather_bytes"] * 2 <= c["f32_bytes"] * DIST_STAGES,
          f"compressed_psum moved {c['all_gather_bytes']} bytes")
    w.spmd(dist_rank_clear, [()] * DIST_STAGES, axis="pod")
    del caller, stage0
    if dev == "cuda":
        torch.cuda.empty_cache()
    return row


def dist_error_feedback(dev: str) -> dict:
    """Ten error-feedback steps on the card, as the reference's
    ``test_error_feedback_accumulates_to_truth`` runs them: the summed
    dequantised payloads stay within the last residual of the true sum."""
    import torch

    from repro_torch.distributed import compression

    gen = torch.Generator(dev).manual_seed(SEED + 36)
    res = {"g": torch.zeros(DIST_EF_SIZE, device=dev)}
    true_sum = torch.zeros(DIST_EF_SIZE, device=dev)
    ef_sum = torch.zeros(DIST_EF_SIZE, device=dev)
    for _ in range(DIST_EF_STEPS):
        g = {"g": torch.randn(DIST_EF_SIZE, generator=gen, device=dev) * 0.1}
        payload, res = compression.ef_compress_tree(g, res)
        true_sum += g["g"]
        ef_sum += compression.ef_decompress_tree(payload)["g"]
    err, resid = float((true_sum - ef_sum).abs().max()), float(res["g"].abs().max())
    check(err <= resid + 1e-5, f"error feedback: {err} beyond the residual {resid}")
    return {"steps": DIST_EF_STEPS, "size": DIST_EF_SIZE, "max_abs_err": err,
            "residual_max": resid}


def dist_fold(w, on_path, dev: str) -> dict:
    """NVSA cnn at the served d = 128 folded over the two ranks: the
    frontend on 64 panels on rank 0, the symbolic back end on 8 problems'
    PMFs on rank 1, both bit for bit the single process's calls."""
    import numpy as np
    import torch

    from repro_torch.common.tree import tree_map
    from repro_torch.configs import base as cb
    from repro_torch.data import raven

    entry = cb.REASON_WORKLOADS["nvsa"]
    cfg = entry.make_config(d=DIST_NVSA_D)
    consts = entry.make_consts(cfg, torch.Generator().manual_seed(SEED))
    batch = raven.generate_batch(cfg.raven, SEED + 37, DIST_NVSA_PROBLEMS)
    s = cfg.raven.image_size
    panels = torch.from_numpy(batch["context"].reshape(-1, s, s, 1).astype(np.float32))
    cands = torch.from_numpy(batch["candidates"].reshape(-1, s, s, 1).astype(np.float32))
    on_card = tree_map(lambda t: t.to(dev), consts)
    nn_fn, vsa_fn = dist_nvsa_streams(cfg, on_card["params"], on_card["books"])
    want_nn = nn_fn(panels.to(dev))
    n = DIST_NVSA_PROBLEMS
    packed = torch.cat([want_nn.reshape(n, 8, -1), nn_fn(cands.to(dev)).reshape(n, 8, -1)],
                       dim=1)
    want_vsa = vsa_fn(packed)
    dist_sync(dev)
    t0 = time.perf_counter()
    res, per_rank = on_path(lambda: w.spmd(
        dist_rank_fold, [(cfg, consts, panels, packed.cpu())] * 2, axis="model"))
    fold_ms = (time.perf_counter() - t0) * 1e3
    (nn0, vsa0), (nn1, vsa1) = res
    check(torch.equal(nn0, want_nn) and torch.equal(vsa0, want_vsa),
          "fold: rank 0's outputs differ from the single process's calls")
    check(torch.equal(nn1, want_nn.cpu()) and torch.equal(vsa1, want_vsa.cpu()),
          "fold: rank 1's outputs differ from the single process's calls")
    check(per_rank[1]["circ_conv"] > 0 and per_rank[0]["circ_conv"] == 0,
          f"fold: circ_conv launches per rank {[c['circ_conv'] for c in per_rank]}, "
          "want them on the VSA rank only")
    return {"phase": "dist", "row": "fold", "model": "nvsa", "d": cfg.d, "n_l": 1,
            "panels": list(panels.shape), "problems": n, "ms_folded_call": fold_ms,
            "circ_conv_launches_per_rank": [c["circ_conv"] for c in per_rank],
            "bit_equal": True, "card": CARD}


def dist_launcher(w, on_path, dev: str) -> dict:
    """``launch.train`` at llama3.2-3b's smoke width on the card: 20 steps
    with checkpoints at 10 and 20, then a run resumed from step 10's,
    bit for bit the uninterrupted one; then a tp-2 world whose ranks each
    restore their cut of the parameters from the checkpoint
    (``CheckpointParams``), its logits against the single device's."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs import base as cb
    from repro_torch.configs import get_arch
    from repro_torch.distributed import world
    from repro_torch.launch import train as launch_train
    from repro_torch.nn import init as nninit
    from repro_torch.serve.engine import ServeConfig
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as opt

    tmp = Path(tempfile.mkdtemp(prefix="dist_train_"))
    try:
        t0 = time.perf_counter()
        full, per_rank = on_path(lambda: launch_train.main(
            [*DIST_LAUNCH, "--device", dev, "--ckpt-dir", str(tmp / "a")]))
        losses = [m["loss"] for m in full]
        check(all(math.isfinite(x) for x in losses)
              and np.mean(losses[-5:]) < np.mean(losses[:5]),
              f"launch.train: losses {losses}")
        (tmp / "b").mkdir()
        shutil.copytree(tmp / "a" / "step_00000010", tmp / "b" / "step_00000010")
        (tmp / "b" / "LATEST").write_text("10")
        resumed, per_rank_b = on_path(lambda: launch_train.main(
            [*DIST_LAUNCH, "--device", dev, "--ckpt-dir", str(tmp / "b"), "--resume"]))
        train_s = time.perf_counter() - t0
        check([m["step"] for m in resumed] == list(range(11, 21))
              and [(m["loss"], m["grad_norm"]) for m in resumed]
              == [(m["loss"], m["grad_norm"]) for m in full[10:]],
              "launch.train --resume: steps 11-20 differ from the uninterrupted run")
        same = all(np.array_equal(np.load(f), np.load(tmp / "b" / "step_00000020" / f.name))
                   for f in sorted((tmp / "a" / "step_00000020").glob("a_*.npy")))
        check(same, "launch.train --resume: the final checkpoints differ")

        # the remesh: each rank restores its cut of the run's parameters
        arch = get_arch(LM_ARCH)
        cfg = arch.make_smoke()
        shapes = nninit.shapes(cb.model_spec(arch, cfg))
        template = {"opt": opt.state_shapes(shapes, opt.AdamWConfig(quantized_state=arch.opt_8bit)),
                    "params": shapes}
        restored, step = ckpt.restore(tmp / "a", template, device=dev)
        eng = world.TPEngine(w, world.EngineSpec(
            LM_ARCH, cfg, world.CheckpointParams(str(tmp / "a"), template, key="params"),
            ServeConfig(**TP_SERVE)), owns_world=False)
        cut_dims, _ = eng.on_every_rank(tp_embed_cut)
        toks = torch.randint(0, cfg.vocab, (1, 64),
                             generator=torch.Generator("cpu").manual_seed(SEED + 38)).to(dev)
        y, per_rank_tp = on_path(lambda: eng.forward(toks))
        forward, readout = cb.forward_fn(arch, cfg)
        single = readout(restored["params"], forward(restored["params"], toks))
        err = tp_logit_err(y, single)
        eng.close()
        check(err <= LM_LOGIT_TOL, f"remesh: tp-2 logits {err} of the scale from the single device")
        check(all(c["flash_attn"] == cfg.n_layers for c in per_rank_tp),
              f"remesh: flash_attn per rank {[c['flash_attn'] for c in per_rank_tp]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"phase": "dist", "row": "launch_train", "arch": LM_ARCH, "args": DIST_LAUNCH,
            "losses": losses, "resumed_bit_equal": True, "seconds": train_s,
            "flash_attn_launches": per_rank[0]["flash_attn"] + per_rank_b[0]["flash_attn"],
            "remesh": {"step": step, "tp": 2, "embed_cut_dim": cut_dims,
                       "logits_vs_single_device": err,
                       "flash_attn_launches_per_rank": [c["flash_attn"] for c in per_rank_tp]},
            "card": CARD}


def dist_dryrun_row() -> dict:
    """The dry-run of phase 10b's step (llama3.2-3b, (1, 2048), a (1, 1)
    mesh) through ``launch.dryrun.measure_cell``, beside its measurement:
    the measured time must be at least the roofline bound, and the
    argument bytes those of the tensors the step held."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh

    measured = TRAIN_LM_MEASURED
    check(bool(measured), "dist: the dry-run row reads phase 10b's step; run phase_train_lm first")
    b, s = DIST_DRY_SHAPE
    rec = dryrun.measure_cell(LM_ARCH, ShapeSpec("train_lm", "train", s, b), make_host_mesh())
    terms = rec["roofline"]
    row = {"phase": "dist", "row": "dryrun_vs_measured", "arch": LM_ARCH,
           "shape": list(DIST_DRY_SHAPE), "mesh": [1, 1], "roofline": terms,
           "flops_per_device": rec["flops_per_device"],
           "model_flops_per_device": rec["model_flops_per_device"],
           "bytes_per_device": rec["bytes_per_device"],
           "measured_ms_per_step_host": measured["ms_host"],
           "measured_ms_per_step_cuda_events": measured["ms_events"],
           "measured_peak_bytes": measured["peak"], "held_bytes": measured["held_bytes"],
           "bound_share": terms["bound_s"] * 1e3 / measured["ms_events"], "card": CARD}
    check(measured["ms_events"] / 1e3 >= terms["bound_s"],
          f"dry-run: the measured step {measured['ms_events']} ms beats its bound "
          f"{terms['bound_s'] * 1e3} ms")
    check(rec["bytes_per_device"]["arguments"] == measured["held_bytes"],
          f"dry-run: argument bytes {rec['bytes_per_device']['arguments']}, the step held "
          f"{measured['held_bytes']}")
    return row


# -- phase 11c: tensor-parallel training -------------------------------------
# llama3.2-3b at its published width on the phase's world of two ranks on the
# one card.  First one step at f32 compute and TP_TRAIN_FIRST_LAYERS layers,
# each rank against the single device in its own process (the whole
# parameters drawn from the trainer's generator state, outside the group).
# Then TP_TRAIN_STEPS steps at bf16 compute and TP_TRAIN_LAYERS of its 28
# layers, after the same steps on the single device in rank 0's process,
# freed before the world's trainer.  The depth is cut for memory: the two
# ranks share the card beside what rank 0's process keeps reserved from the
# phases before (~7.3 GB, with ~74 GB of the card free).  At all 28 layers
# each rank peaked at ~34 GB (~25.7 GB of f32 parameters, gradients and
# moments), which leaves the two allocators a few GB; at 14 layers ~19 GB a
# rank, and ~42 GB the single device's peak.  The
# ranks run train_step on their trainer's batches (Trainer.run's loop without
# its checkpoint, whose whole gathers and 21.6 GB of files would outlast the
# phase; TPTrainer.run with its saves runs in the card tests)
TP_TRAIN_FIRST_LAYERS, TP_TRAIN_FIRST_SHAPE = 2, (1, 512)
TP_TRAIN_LAYERS, TP_TRAIN_SHAPE, TP_TRAIN_STEPS = 14, (1, 2048), 3
# params_lr is a sanity bound (AdamW's first step moves each element by about
# lr whatever the gradient); fed_lr holds the world's optimizer, fed the single
# device's gradients of TP_TRAIN_FED_STEPS steps, against the single device's
# fed the same (the same f32 arithmetic but the global norm's order of sums)
TP_TRAIN_FIRST_TOL = {"loss": 1e-5, "grad": 1e-4, "params_lr": 2.0, "fed_lr": 1e-2,
                      "fed_norm": 1e-5}
TP_TRAIN_FED_STEPS = 3
TP_TRAIN_LOSS_TOL = 3e-2    # relative, each bf16 step's loss against the single device's
TP_TRAIN_OPT = dict(lr=3e-4, warmup_steps=1, total_steps=10)


def dist_part(t, p, rank: int):
    """The slice of a whole ``t`` that the cut leaf ``p`` holds on ``rank``."""
    d = getattr(p, "tp_dim", None)
    return t if d is None else t.narrow(d, rank * p.shape[d], p.shape[d])


def dist_tp_invariants(rank, params=None) -> dict:
    """The rank's parameters (its trainer's by default): each cut the slice
    of the whole it keeps, bit for bit, and the digests of its replicated
    leaves and kept wholes."""
    import torch

    from repro_torch.common.tree import tree_leaves
    from repro_torch.distributed import world

    leaves = tree_leaves(rank.engine.params if params is None else params)
    kept = [t for t in leaves if hasattr(t, "tp_whole")]
    return {"cuts_are_slices": all(torch.equal(t, dist_part(t.tp_whole, t, rank.ctx.rank))
                                   for t in kept),
            "kept_wholes": len(kept), "digests": world.trainer_digests(rank, params)}


def dist_tp_first_single(rank, batch: dict) -> None:
    """On each rank, outside its group: TP_TRAIN_FED_STEPS AdamW steps of
    the single device on the whole parameters (drawn from the trainer's
    generator state), each on its gradient at that step's parameters;
    the first loss, each step's gradients and global norm, the parameters
    after the first step and after the last, kept in ``rank.state`` for
    ``dist_tp_first_rank``."""
    from repro_torch.configs import base as cb
    from repro_torch.configs import get_arch
    from repro_torch.train import optimizer as opt

    tr = rank.engine
    batch = {k: v.to(rank.device) for k, v in batch.items()}
    whole = rank.spec.params_fn(cb.model_spec(get_arch(rank.spec.arch_id), rank.spec.cfg),
                                lambda p, t: t, rank.device)
    state, losses, grads_seq, norms, first = opt.init_state(whole, tr.ocfg), [], [], [], None
    for _ in range(TP_TRAIN_FED_STEPS):
        loss, grads = opt.value_and_grad(tr.loss_fn)(whole, batch)
        whole, state, m = opt.apply_updates(whole, grads, state, tr.ocfg)
        losses.append(float(loss))
        grads_seq.append(grads)
        norms.append(float(m["grad_norm"]))
        first = whole if first is None else first
    rank.state["single"] = {"loss": losses[0], "grads": grads_seq, "norms": norms,
                            "first": first, "last": whole}


def dist_tp_first_rank(rank, batch: dict) -> dict:
    """On each rank, under its group, against ``dist_tp_first_single``'s:
    first the world's optimizer on its own, from the trainer's parameters
    and fresh moments fed the single device's gradients cut to the rank's
    slice (each step's global norm's relative error, the parameters' error
    after the last step in lr, and their ``dist_tp_invariants``); then the
    loss and gradients of the rank's cut and one ``train_step``: the
    loss's relative error, each leaf's gradient error over that leaf's max
    |g| on the single device, the parameters' error after the step in lr,
    the leaves with a gradient on one side only, and
    ``dist_tp_invariants``."""
    from repro_torch.common.tree import tree_leaves, tree_map
    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainer import train_step

    tr, r = rank.engine, rank.ctx.rank
    batch = {k: v.to(rank.device) for k, v in batch.items()}
    single = rank.state.pop("single")
    params, state, fed_norms = tr.params, opt.init_state(tr.params, tr.ocfg), []
    for g_whole in single["grads"]:
        cut = tree_map(lambda p, g: None if g is None else dist_part(g, p, r).contiguous(),
                       params, g_whole)
        params, state, m = rank.run(lambda: opt.apply_updates(params, cut, state, tr.ocfg))
        fed_norms.append(float(m["grad_norm"]))
    fed_err = max(float((p - dist_part(w, p, r)).abs().max())
                  for p, w in zip(tree_leaves(params), tree_leaves(single["last"]))) / tr.ocfg.lr
    fed = {"fed_err_lr": fed_err, "fed_norms": fed_norms,
           "fed_norm_rel_err": max(abs(a - b) / b for a, b in zip(fed_norms, single["norms"])),
           "fed_invariants": dist_tp_invariants(rank, params)}
    del params, state, cut
    loss_1, grads_1, whole = single["loss"], single["grads"][0], single["first"]
    del single
    loss, grads = rank.run(lambda: opt.value_and_grad(tr.loss_fn)(tr.params, batch))
    tr.params, tr.opt_state, m = rank.run(lambda: train_step(
        tr.loss_fn, tr.params, tr.opt_state, {k: v[None] for k, v in batch.items()}, tr.ocfg))
    lr = float(m["lr"])
    grad_err = param_err = 0.0
    one_sided = 0
    for p, g1, g, p1 in zip(tree_leaves(tr.params), tree_leaves(grads_1), tree_leaves(grads),
                            tree_leaves(whole)):
        if (g1 is None) != (g is None):
            one_sided += 1
        elif g1 is not None:
            scale = max(float(g1.abs().max()), 1e-30)
            grad_err = max(grad_err, float((g.float() - dist_part(g1, p, r).float()).abs().max())
                           / scale)
        param_err = max(param_err, float((p.float() - dist_part(p1, p, r).float()).abs().max())
                        / lr)
    return {"loss": float(loss), "loss_single": loss_1,
            "loss_rel_err": abs(float(loss) - loss_1) / abs(loss_1),
            "grad_err": grad_err, "param_err_lr": param_err, "one_sided": one_sided,
            "grad_norm": float(m["grad_norm"]), **fed, **dist_tp_invariants(rank)}


def dist_tp_train_rank(rank, steps: int, timed: bool) -> dict:
    """On each rank: ``steps`` of ``train_step`` on its trainer's batches
    under its group (``timed``: the card synchronised around each
    collective, its host seconds counted); each step's loss, norm and host
    ms, the collectives by phase (count, bytes, host ms), ``dist_tp_invariants``."""
    import torch

    from repro_torch.train.trainer import train_step

    tr, ctx = rank.engine, rank.ctx
    ctx.phases.clear()
    ctx.timed = timed
    out = []
    try:
        for _ in range(steps):
            batch = tr._batch(tr.step)
            t0 = time.perf_counter()
            tr.params, tr.opt_state, m = rank.run(lambda: train_step(
                tr.loss_fn, tr.params, tr.opt_state, batch, tr.ocfg))
            loss = float(m["loss"])
            out.append({"loss": loss, "grad_norm": float(m["grad_norm"]),
                        "ms": (time.perf_counter() - t0) * 1e3})
            tr.step += 1
    finally:
        ctx.timed = False
    if rank.device.type == "cuda":
        torch.cuda.synchronize(rank.device)
    phases = {ph: {op: {"count": n, "MB": b / 1e6, "host_ms": sec * 1e3}
                   for op, (n, sec, b) in ops.items()} for ph, ops in ctx.phases.items()}
    return {"steps": out, "phases": phases, **dist_tp_invariants(rank)}


def dist_free_card() -> dict:
    """Empty this process's cached blocks on its card (run on every rank
    before the bf16 trainer is built); its reserved bytes after, the
    card's free bytes and the host's available bytes."""
    import torch

    avail = 0
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                avail = int(line.split()[1]) * 1024
    out = {"reserved": 0, "card_free": 0, "host_avail": avail}
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        out.update(reserved=torch.cuda.memory_reserved(), card_free=torch.cuda.mem_get_info()[0])
    return out


def dist_tp_same(mine: dict, theirs: list, label: str) -> None:
    """The ranks' losses, norms and digests are rank 0's, each cut the
    slice of its kept whole."""
    def bits(x):
        if "steps" in x:
            return [(st["loss"], st["grad_norm"]) for st in x["steps"]]
        return x["loss"], x["grad_norm"]

    for r, t in enumerate(theirs, 1):
        check(t["digests"] == mine["digests"], f"{label}: rank {r}'s replicated leaves or "
                                               "kept wholes differ from rank 0's")
        check(bits(t) == bits(mine), f"{label}: rank {r}'s losses or norms differ from rank 0's")
    check(all(x["cuts_are_slices"] for x in (mine, *theirs)) and mine["kept_wholes"] > 0,
          f"{label}: a cut is not the slice of its kept whole")


def dist_lm_batch(loader, step: int, dev):
    """``Trainer._batch``: the loader's batch of ``step`` with a leading
    microbatch axis of 1."""
    import numpy as np
    import torch

    toks, tgts = loader.batch(step)
    return {"tokens": torch.from_numpy(np.ascontiguousarray(toks[None])).to(dev),
            "targets": torch.from_numpy(np.ascontiguousarray(tgts[None])).to(dev)}


def dist_tp_train(w, on_path, dev: str) -> None:
    """Tensor-parallel training of llama3.2-3b on the world (the comment
    above ``TP_TRAIN_FIRST_LAYERS``): emits the f32 first-step row and the
    bf16 training row."""
    import dataclasses
    import shutil
    import tempfile

    import torch

    from repro_torch.configs import base as cb
    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import SyntheticTokens, TokenPipelineConfig
    from repro_torch.distributed import world
    from repro_torch.nn import init as nninit
    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainer import TrainerConfig, train_step

    arch = get_arch(LM_ARCH)
    ocfg = opt.AdamWConfig(**TP_TRAIN_OPT)
    tmp = Path(tempfile.mkdtemp(prefix="dist_tp_train_"))
    try:
        # f32, 2 layers: each rank against the single device
        t0 = time.perf_counter()
        cfg = dataclasses.replace(train_lm_config(), n_layers=TP_TRAIN_FIRST_LAYERS,
                                  compute_dtype=torch.float32)
        b, s = TP_TRAIN_FIRST_SHAPE
        data = TokenPipelineConfig(vocab_size=cfg.vocab, seq_len=s, global_batch=b,
                                   seed=SEED + 60)
        source = world.SeededParams.of(torch.Generator(dev).manual_seed(SEED + 61))
        trainer = world.TPTrainer(w, world.EngineSpec(LM_ARCH, cfg, source, None, world.TrainSpec(
            TrainerConfig(ckpt_dir=str(tmp / "first")), ocfg, data)), owns_world=False)
        toks, tgts = SyntheticTokens(data).batch(0)
        batch = {"tokens": torch.from_numpy(toks), "targets": torch.from_numpy(tgts)}
        trainer.on_every_rank(dist_tp_first_single, batch)
        (mine, theirs), per_rank = on_path(
            lambda: trainer.on_every_rank(dist_tp_first_rank, batch))
        trainer.close()
        dist_tp_same(mine, theirs, "tp train f32")
        dist_tp_same({**mine["fed_invariants"], "loss": 0.0, "grad_norm": mine["fed_norms"]},
                     [{**t["fed_invariants"], "loss": 0.0, "grad_norm": t["fed_norms"]}
                      for t in theirs], "tp train f32, the fed optimizer")
        every = [mine, *theirs]
        tol = TP_TRAIN_FIRST_TOL
        row = {"phase": "dist", "row": "tp_train_first_step", "arch": LM_ARCH, "tp": 2,
               "layers": cfg.n_layers, "shape": list(TP_TRAIN_FIRST_SHAPE), "compute": "f32",
               "loss": mine["loss"], "loss_single": mine["loss_single"],
               "loss_rel_err": max(x["loss_rel_err"] for x in every),
               "grad_err": max(x["grad_err"] for x in every),
               "param_err_lr": max(x["param_err_lr"] for x in every),
               "one_sided_grads": sum(x["one_sided"] for x in every),
               "fed_steps": TP_TRAIN_FED_STEPS,
               "fed_err_lr": max(x["fed_err_lr"] for x in every),
               "fed_norm_rel_err": max(x["fed_norm_rel_err"] for x in every),
               "kept_wholes": mine["kept_wholes"], "tol": tol,
               "flash_attn_per_rank": [c["flash_attn"] for c in per_rank],
               "seconds": time.perf_counter() - t0, "card": CARD}
        emit(row)
        check(row["loss_rel_err"] <= tol["loss"] and row["grad_err"] <= tol["grad"]
              and row["param_err_lr"] <= tol["params_lr"] and row["one_sided_grads"] == 0
              and row["fed_err_lr"] <= tol["fed_lr"] and row["fed_norm_rel_err"] <= tol["fed_norm"],
              f"tp train f32: {row}")
        check(all(c["flash_attn"] == 2 * cfg.n_layers for c in per_rank),
              f"tp train f32: flash_attn per rank {row['flash_attn_per_rank']} (two forwards)")

        # bf16, TP_TRAIN_LAYERS layers: the single device first, in this process
        t0 = time.perf_counter()
        cfg = dataclasses.replace(train_lm_config(), n_layers=TP_TRAIN_LAYERS)
        b, s = TP_TRAIN_SHAPE
        data = TokenPipelineConfig(vocab_size=cfg.vocab, seq_len=s, global_batch=b,
                                   seed=SEED + 62)
        gen = torch.Generator(dev).manual_seed(SEED + 63)
        source = world.SeededParams.of(gen)
        loss_fn = cb.loss_fn(arch, cfg)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = nninit.materialize(cb.model_spec(arch, cfg), gen)
        state = opt.init_state(params, ocfg)
        loader = SyntheticTokens(data)
        single = []
        for step in range(TP_TRAIN_STEPS):
            batch = dist_lm_batch(loader, step, dev)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            params, state, m = train_step(loss_fn, params, state, batch, ocfg)
            single.append({"loss": float(m["loss"]), "ms": (time.perf_counter() - t1) * 1e3})
        single_peak = torch.cuda.max_memory_allocated()
        del params, state, batch, m
        gc.collect()
        torch.cuda.empty_cache()
        single_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        free = w.spmd(dist_free_card, [()] * w.size)
        tp_reset_peaks(w)
        trainer = world.TPTrainer(w, world.EngineSpec(LM_ARCH, cfg, source, None, world.TrainSpec(
            TrainerConfig(ckpt_dir=str(tmp / "bf16")), ocfg, data)), owns_world=False)
        build_s = time.perf_counter() - t0
        (mine, theirs), per_rank = on_path(
            lambda: trainer.on_every_rank(dist_tp_train_rank, TP_TRAIN_STEPS - 1, False))
        dist_tp_same(mine, theirs, "tp train bf16")
        (last, theirs_last), per_rank_last = on_path(
            lambda: trainer.on_every_rank(dist_tp_train_rank, 1, True))
        dist_tp_same(last, theirs_last, "tp train bf16 (timed step)")
        peaks = tp_peaks(trainer, "tp train bf16")
        trainer.close()
        steps = mine["steps"] + last["steps"]
        errs = [abs(t["loss"] - o["loss"]) / abs(o["loss"]) for t, o in zip(steps, single)]
        launches = [(c["flash_attn"] + d["flash_attn"]) / TP_TRAIN_STEPS
                    for c, d in zip(per_rank, per_rank_last)]
        fwd = last["phases"].get("forward", {})
        row = {"phase": "dist", "row": "tp_train", "arch": LM_ARCH, "tp": 2,
               "layers": cfg.n_layers, "layers_published": train_lm_config().n_layers,
               "shape": list(TP_TRAIN_SHAPE), "compute": "bf16", "steps": TP_TRAIN_STEPS,
               "losses_tp": [x["loss"] for x in steps],
               "losses_single": [x["loss"] for x in single], "loss_rel_err": errs,
               "ms_per_step_tp": [x["ms"] for x in steps],
               "ms_per_step_single": [x["ms"] for x in single],
               "collectives_per_step": {
                   "forward": {op: v for op, v in fwd.items() if op != "gather_last"},
                   "logits_vocab_gather": fwd.get("gather_last"),
                   "backward": last["phases"].get("backward", {}),
                   "optimizer": last["phases"].get("optimizer", {})},
               "timed_step_note": "the last step, the card synchronised around each collective",
               "peak_gb_per_rank": [x / 1e9 for x in peaks],
               "single_peak_gb": single_peak / 1e9,
               "reserved_gb_per_rank_before": [x["reserved"] / 1e9 for x in free],
               "card_free_gb_before": min(x["card_free"] for x in free) / 1e9,
               "host_avail_gb_before": free[0]["host_avail"] / 1e9,
               "flash_attn_per_rank_per_step": launches,
               "single_seconds": single_s, "build_seconds": build_s,
               "seconds": time.perf_counter() - t0, "card": CARD}
        emit(row)
        check(max(errs) <= TP_TRAIN_LOSS_TOL, f"tp train bf16: losses {row['losses_tp']} "
                                             f"against {row['losses_single']}")
        check(all(math.isfinite(x) for x in row["losses_tp"])
              and row["losses_tp"][-1] < row["losses_tp"][0]
              and row["losses_single"][-1] < row["losses_single"][0],
              f"tp train bf16: losses not falling {row['losses_tp']} {row['losses_single']}")
        check(all(x == cfg.n_layers for x in launches),
              f"tp train bf16: flash_attn a rank a step {launches}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_dist(dev: str = "cuda") -> dict[str, int]:
    """The training half of distribution (phase 11c of the module
    docstring).  Returns the launch counts of the pipelined step, the
    fold, the launcher's runs and the restored world's forward, summed over
    the ranks."""
    import torch

    from repro_torch.backend import registry
    from repro_torch.distributed import world

    t_phase = time.perf_counter()
    counts = {k: 0 for k in registry.KERNELS}
    if dev == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    w = world.World(DIST_DEVICES)
    start_s = time.perf_counter() - t_phase

    def on_path(fn):
        """``fn()`` with every rank's counts set to 0 before and added to the
        path's after; returns its result and each rank's counts."""
        w.reset_launches()
        out = fn()
        dist_sync(dev)
        per_rank = w.launches()
        for c in per_rank:
            for k in counts:
                counts[k] += c[k]
        return out, per_rank

    try:
        t0 = time.perf_counter()
        row = dist_gpipe(w, on_path, dev)
        row.update(world_start_s=start_s, seconds=time.perf_counter() - t0,
                   error_feedback=dist_error_feedback(dev))
        emit(row)
        t0 = time.perf_counter()
        emit({**dist_fold(w, on_path, dev), "seconds": time.perf_counter() - t0})
        t0 = time.perf_counter()
        emit({**dist_launcher(w, on_path, dev), "seconds_with_remesh": time.perf_counter() - t0})
        t0 = time.perf_counter()
        dist_tp_train(w, on_path, dev)
        emit({"phase": "dist", "row": "tp_train_seconds", "seconds": time.perf_counter() - t0})
    finally:
        w.close()
    emit(dist_dryrun_row())
    check(counts["flash_attn"] > 0 and counts["circ_conv"] > 0,
          f"dist: the path's launches {counts}")
    emit({"phase": "dist_done", "seconds": time.perf_counter() - t_phase, "launches": counts})
    return counts



# the other rows a kernel's entry of the ``kernels`` line carries, under
# these keys: circ_conv at NVSA's served bucket and at MIMONet's training
# shape (conv and corr), circ_dict corr and bf16,
# unbind_classify at d = 256, simd_fused bf16, at d = 128 and at M = 1024,
# flash_attn bf16, bf16 at head dim 64, bf16 at internvl2-26b's 48 heads, the
# four non-causal bf16 shapes of the encdec phase (ENCDEC_FLASH) and each
# rank's heads in the tp phase (llama's, granite's, seamless's:
# TP_ENCDEC_FLASH_ROWS)
SUB_ROWS = {"circ_conv": (("served", "circ_conv_served"), ("train", "circ_conv_train_conv"),
                          ("train_corr", "circ_conv_train_corr")),
            "circ_dict": (("corr", "circ_dict_corr"), ("bf16", "circ_dict_bf16")),
            "unbind_classify": (("d256", "unbind_classify_d256"),),
            "simd_fused": (("bf16", "simd_fused_bf16"), ("d128", "simd_fused_d128"),
                           ("m1024", "simd_fused_m1024")),
            "flash_attn": (("bf16", "flash_attn_bf16"), ("hd64", "flash_attn_hd64"),
                           ("internvl2", "flash_attn_internvl2"),
                           ("encoder", "flash_attn_encoder"), ("cross", "flash_attn_cross"),
                           ("decode_cross", "flash_attn_decode_cross"),
                           ("encoder_32k", "flash_attn_encoder_32k"),
                           ("tp", "flash_attn_tp"), ("tp_moe", "flash_attn_tp_moe"),
                           *((k, f"flash_attn_{k}") for k in TP_ENCDEC_FLASH_ROWS))}


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
    paths["analyze"] = phase_analyze()
    paths["train"] = phase_train()
    paths["lm"] = phase_lm()
    paths["train_lm"] = phase_train_lm()
    paths["encdec"], encdec_rows = phase_encdec()
    main_rows.update(encdec_rows)
    paths["door_lm"] = phase_door_lm()
    paths["tp"] = phase_tp()
    paths["dist"] = phase_dist()
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
