"""The arch adapter, the reasoning-workload registry and the engine
constructors.

The port of ``repro.configs.base``.  ``ArchSpec`` is the uniform adapter of
the LM architectures (``configs/registry.py:ARCHS``): ``model_spec``,
``loss_fn`` (the training loss), ``prefill_fn`` (the full-context
forward, last-token logits),
``decode_fn``, ``serve_fns`` (the ``Engine``'s decode step and cache
allocator) and ``lm_engine``.  The port has every kind of the reference:
``lm`` (the dense GQA decoders and the MoE / MLA ones), ``rwkv`` and
``griffin`` (the recurrent decoders, served with exact-length prefill
scans: ``serve_fns`` tags their cache allocator ``stateful_prefill``),
``vlm`` (patch embeddings before the ``lm`` body) and ``encdec`` (an
encoder over frame embeddings and a decoder with cross-attention).  The
last two are not servable through the ``Engine``, as in the reference:
they take non-token inputs.

For NSAI reasoning, each
:class:`ReasonWorkload` entry declares how a workload serves: its stage
functions (with nn / vsa / simd stream tags), the staged-batch input specs,
its constants, and request ingest / collect adapters.
``compile_reason_schedule`` lowers an entry to a ``StagedSchedule`` and
``reason_engine`` wraps its variants in the generic ``ReasonEngine``:

    engine = reason_engine("nvsa", cfg, ReasonConfig(...), consts=consts)
    results = engine.run(requests)

``REASON_WORKLOADS`` holds the four reasoners of the reference: ``nvsa``,
``prae``, ``mimonet`` and ``lvrf``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import interop
from repro_torch.backend import registry
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.core import workloads
from repro_torch.data import raven
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import griffin as griffin_mod
from repro_torch.models import lm as lm_mod
from repro_torch.models import lvrf as lv
from repro_torch.models import mimonet as mm
from repro_torch.models import nvsa as nv
from repro_torch.models import prae as pr
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models import vlm as vlm_mod
from repro_torch.nn import init as nninit
from repro_torch.serve import schedule as sch
from repro_torch.serve.reason import ReasonConfig, ReasonEngine, ReasonRequest
from repro_torch.serve.schedule import StageSpec, TensorSpec


# ---------------------------------------------------------------------------
# LM architectures: the ArchSpec adapter
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    """The reference's ``ArchSpec``.  ``fsdp`` picks the sharding rules
    the dry-run's specs follow (``launch/dryrun.py``); ``opt_8bit`` is the
    optimizer switch the training launcher (``launch/train.py``) and the
    dry-run read (``AdamWConfig.quantized_state``)."""

    id: str
    family: str                   # moe | dense | ssm | hybrid | vlm | audio
    kind: str                     # lm | rwkv | griffin | vlm | encdec
    make_full: Callable[[], Any]
    make_smoke: Callable[[], Any]
    supports_long: bool = False
    fsdp: bool = False            # shard the non-TP weight dim over data
    opt_8bit: bool = False        # quantized AdamW moments
    note: str = ""
    source: str = ""


_MODS = {"lm": lm_mod, "rwkv": rwkv_mod, "griffin": griffin_mod, "vlm": vlm_mod,
         "encdec": encdec_mod}
_SPECS = {"lm": "lm_spec", "rwkv": "rwkv_spec", "griffin": "griffin_spec",
          "vlm": "vlm_spec", "encdec": "encdec_spec"}


def _mod(kind: str):
    if kind in _MODS:
        return _MODS[kind]
    raise ValueError(kind)


def model_spec(arch: ArchSpec, cfg):
    return getattr(_mod(arch.kind), _SPECS[arch.kind])(cfg)


def loss_fn(arch: ArchSpec, cfg):
    """``loss(params, batch)``, the kind's training loss: ``batch`` holds
    ``tokens`` and ``targets`` (B, S), and ``patch_embeds`` for ``vlm``;
    for ``encdec`` it holds ``frames`` (B, S_src, D), ``tgt_tokens`` and
    ``tgt_targets`` (B, S_tgt)."""
    m = _mod(arch.kind)
    return lambda params, batch: m.loss_fn(params, cfg, batch)


def forward_fn(arch: ArchSpec, cfg):
    """(forward, readout) of a token-input kind (``lm``, ``rwkv``,
    ``griffin``): ``forward(params, tokens)`` gives the full-context
    forward's hidden states (B, S, D), ``readout(params, hidden)`` their
    logits.  ``vlm`` takes patch embeddings too, and ``prefill_fn`` reads
    its hidden states itself."""
    m = _mod(arch.kind)
    if arch.kind == "lm":
        return (lambda params, tokens: m.forward(params, cfg, tokens)[0],
                lambda params, hidden: m.lm_logits(params, cfg, hidden))
    if arch.kind in ("rwkv", "griffin"):
        return (lambda params, tokens: m.forward(params, cfg, tokens),
                lambda params, hidden: m.logits(params, cfg, hidden))
    raise NotImplementedError(f"{arch.kind}: its forward takes non-token inputs")


def prefill_fn(arch: ArchSpec, cfg):
    """Full-context forward returning last-token logits (inference
    prefill).  Every unwindowed attention layer runs the ``flash_attn``
    kernel (``lm``, ``vlm``, ``encdec``); ``rwkv`` runs the chunked WKV,
    ``griffin`` the RG-LRU scan and windowed plain attention.  The ``vlm``
    function takes ``{"patch_embeds", "tokens"}`` in place of the tokens;
    the ``encdec`` function takes frames (B, S_src, D) and returns the
    encoder output's mean over positions, as the reference's does (the
    decoder starts empty)."""
    if arch.kind == "encdec":
        return lambda params, frames: encdec_mod.encode(params, cfg, frames).mean(dim=1)
    if arch.kind == "vlm":
        def f(params, batch):
            hidden, _ = vlm_mod.forward(params, cfg, batch["patch_embeds"],
                                        batch["tokens"])
            return lm_mod.lm_logits(params, cfg.lm, hidden[:, -1:])[:, 0]
        return f
    forward, readout = forward_fn(arch, cfg)

    def f(params, tokens):
        return readout(params, forward(params, tokens)[:, -1:])[:, 0]

    return f


def _dm(cfg, kind: str) -> int:
    return cfg.lm.d_model if kind == "vlm" else cfg.d_model


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_specs(arch: ArchSpec, cfg, shape: ShapeSpec):
    """One global training batch of ``shape`` as ``meta`` tensors (the
    reference's ``ShapeDtypeStruct``s): tokens and targets; the VLM's bf16
    patch embeds beside them; the enc-dec kind's frames and target tokens
    at half the sequence each, as the reference splits it."""
    b, s = shape.global_batch, shape.seq_len
    if arch.kind == "vlm":
        return {"patch_embeds": _meta((b, cfg.n_img_tokens, _dm(cfg, "vlm")), torch.bfloat16),
                "tokens": _meta((b, s), torch.int32), "targets": _meta((b, s), torch.int32)}
    if arch.kind == "encdec":
        half = s // 2
        return {"frames": _meta((b, half, cfg.d_model), torch.bfloat16),
                "tgt_tokens": _meta((b, half), torch.int32),
                "tgt_targets": _meta((b, half), torch.int32)}
    return {"tokens": _meta((b, s), torch.int32), "targets": _meta((b, s), torch.int32)}


def prefill_input_specs(arch: ArchSpec, cfg, shape: ShapeSpec) -> tuple:
    """``prefill_fn``'s inputs after the parameters, as ``meta`` tensors."""
    b, s = shape.global_batch, shape.seq_len
    if arch.kind == "vlm":
        return ({"patch_embeds": _meta((b, cfg.n_img_tokens, _dm(cfg, "vlm")),
                                       torch.bfloat16),
                 "tokens": _meta((b, s), torch.int32)},)
    if arch.kind == "encdec":
        return (_meta((b, s, cfg.d_model), torch.bfloat16),)
    return (_meta((b, s), torch.int32),)


def decode_state_specs(arch: ArchSpec, cfg, shape: ShapeSpec):
    """(caches, token, pos) of one decode step as ``meta`` tensors: the
    model's own ``cache_shapes`` / ``state_shapes`` (the enc-dec kind's
    self-attention cache capped at 4096 positions, its cross cache over
    the whole source, as the reference caps it)."""
    m = _mod(arch.kind)
    b, s = shape.global_batch, shape.seq_len
    if arch.kind == "rwkv":
        caches = m.state_shapes(cfg, b)
    elif arch.kind == "griffin":
        caches = m.state_shapes(cfg, b, s)
    elif arch.kind == "encdec":
        caches = m.cache_shapes(cfg, b, min(s, 4096), src_len=s)
    else:
        caches = m.cache_shapes(cfg, b, s)
    return caches, _meta((b,), torch.int32), _meta((), torch.int32)


def decode_fn(arch: ArchSpec, cfg):
    m = _mod(arch.kind)

    def f(params, caches, token, pos):
        return m.decode_step(params, cfg, caches, token, pos)

    return f


def serve_fns(arch: ArchSpec, cfg, max_len: int):
    """(decode_step, init_caches) pair for the continuous-batching
    ``Engine``: ``decode_step`` takes a per-slot (B,) position vector (or
    an int); ``init_caches(batch, device)`` allocates zeroed decode state
    with ``max_len`` KV capacity per slot on ``device``.  The recurrent
    kinds (rwkv, griffin) carry O(1) or windowed state, which bucketed
    prefill's pad steps would corrupt, so ``init_caches`` is tagged
    ``stateful_prefill = True`` and the Engine runs exact-length prefill
    scans.  ``vlm`` and ``encdec`` raise, as in the reference: serving
    needs their non-token inputs (their model modules' ``decode_step``
    runs them)."""
    m = _mod(arch.kind)
    step = decode_fn(arch, cfg)
    if arch.kind == "lm":
        def init(batch: int, device=None):
            return m.init_caches(cfg, batch, max_len, device=device)
    elif arch.kind == "rwkv":
        def init(batch: int, device=None):
            return m.init_state(cfg, batch, device=device)
    elif arch.kind == "griffin":
        def init(batch: int, device=None):
            return m.init_state(cfg, batch, max_len, device=device)
    else:
        raise NotImplementedError(
            f"{arch.kind}: serving needs non-token inputs (patch embeddings / "
            "encoder frames) — use the model module's forward / decode_step")
    init.stateful_prefill = arch.kind in ("rwkv", "griffin")
    return step, init


def device_pool(devices=None) -> tuple:
    """The devices a tensor-parallel world or a replica pool may take: the
    caller's ``devices``, else every visible CUDA device."""
    if devices is not None:
        return tuple(str(torch.device(d)) for d in devices)
    return tuple(f"cuda:{i}" for i in range(torch.cuda.device_count()))


def lm_engine(arch_id: str, serve_cfg=None, key=None, tp: int = 1, device=None,
              devices=None):
    """Draw a smoke-scale arch and wrap it in the slot-pool LM ``Engine``
    with params bound, the LM counterpart of ``reason_engine``.  Returns
    ``(engine, model_cfg)`` (callers need ``model_cfg.vocab`` for token
    traffic).

    ``key`` is a ``torch.Generator`` (None = seed 0 on the device); the
    parameters are drawn on its device and moved to ``device`` (None =
    ``"cuda"``; raises without CUDA unless ``"cpu"``).

    ``tp > 1`` serves the engine tensor-parallel: a world of ``tp``
    processes (``distributed.world.tp_engine``), rank r on the r-th device
    of the pool (``devices``, else every visible CUDA device), each holding
    its cut of the parameters by ``distributed.sharding_rules``
    (``TP_RULES``, the ``FALLBACK_TP_AXES`` escape, no size floor, as the
    reference binds them).  ``tp`` beyond the pool raises: on one card
    ``devices=("cuda:0",) * tp`` over-subscribes it, on the CPU
    ``devices=("cpu",) * tp``.  ``tp`` with ``device=`` raises, as in the
    reference.  The engine's ``close()`` ends the world."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.serve.engine import Engine, ServeConfig

    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if tp > 1 and device is not None:
        raise ValueError("pass tp= (tensor-parallel, over devices=) or device= "
                         "(one device), not both")
    arch = get_arch(arch_id)
    cfg = arch.make_smoke()
    serve_cfg = serve_cfg or ServeConfig()
    if tp > 1:
        from repro_torch.distributed import world

        world.refuse_uncovered(arch, cfg, tp)
        pool = device_pool(devices)
        if tp > len(pool):
            raise ValueError(
                f"tp={tp} exceeds the device pool of {len(pool)} {pool}: pass "
                f"devices= with {tp} entries (devices=('cuda:0',) * {tp} "
                f"over-subscribes one card, ('cpu',) * {tp} runs on the CPU)")
        devs = [registry.resolve_device(d) for d in pool[:tp]]
        gen = key if key is not None else torch.Generator(devs[0]).manual_seed(0)
        return world.tp_engine(arch.id, cfg, world.SeededParams.of(gen), tp, devs,
                               serve_cfg), cfg
    dev = registry.resolve_device(device)
    gen = key if key is not None else torch.Generator(dev).manual_seed(0)
    params = interop.to_device(nninit.materialize(model_spec(arch, cfg), gen), dev)
    step, init_caches = serve_fns(arch, cfg, max_len=serve_cfg.max_len)
    return Engine(step, init_caches, serve_cfg, params=params), cfg


def lm_engine_pool(arch_id: str, serve_cfg=None, key=None, replicas: int = 1,
                   tp: int = 1, device=None, devices=None):
    """``replicas`` data-parallel LM engines behind one ``ReplicaPool``
    (replica i's params on ``devices[i % len(devices)]``, by default the
    visible CUDA devices, or ``device`` alone; the same generator state,
    so token streams are replica-invariant), or a single (optionally
    tensor-parallel) engine when ``replicas == 1``.  Returns ``(engine,
    model_cfg)`` like :func:`lm_engine`."""
    from repro_torch.serve.replica import ReplicaPool

    if replicas < 1:
        raise ValueError(f"replicas must be >= 1, got {replicas}")
    if replicas > 1 and tp > 1:
        raise ValueError(
            f"replicas={replicas} with tp={tp}: combined data x tensor "
            "parallel LM serving is not wired up — pick one axis")
    if replicas == 1:
        return lm_engine(arch_id, serve_cfg, key=key, tp=tp,
                         device=device if tp == 1 else None, devices=devices)
    dev = registry.resolve_device(device)
    pool = device_pool(devices) if devices is not None or dev.type == "cuda" \
        else (str(dev),)
    engines, cfg = [], None
    for i in range(replicas):
        gen = None
        if key is not None:
            gen = torch.Generator(key.device)
            gen.set_state(key.get_state())
        eng, cfg = lm_engine(arch_id, serve_cfg, key=gen, device=pool[i % len(pool)])
        engines.append(eng)
    return ReplicaPool(engines), cfg


def param_count(arch: ArchSpec, cfg) -> int:
    return nninit.param_count(model_spec(arch, cfg))


def active_param_count(arch: ArchSpec, cfg) -> int:
    """MoE-aware active parameters per token (for MODEL_FLOPS =
    6·N_active·D): a routed-expert weight counts ``top_k`` of its
    ``n_experts`` experts."""
    moe_cfg = getattr(cfg, "moe", None)
    total = 0
    for p in nninit._specs(model_spec(arch, cfg)):
        n = math.prod(p.shape)
        if moe_cfg is not None and "experts" in p.axes:
            n = n * moe_cfg.top_k // moe_cfg.n_experts
        total += n
    return total


# ---------------------------------------------------------------------------
# NSAI reasoning traffic: the workload registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ReasonWorkload:
    """Registry entry: everything a workload contributes to serving.

    - ``variants``: named pipeline variants (first = default): ``cnn``
      (neural perception) and ``oracle`` (ground-truth PMFs).
    - ``make_config(**kw)``: config from generic knobs (``d``,
      ``nn_precision``, ``symb_precision``).
    - ``make_consts(cfg, generator)``: the constant tree every stage gets
      (CPU tensors; ``reason_engine`` moves them to its device).
    - ``stage_specs(cfg, variant)``: ordered ``StageSpec`` tuple.
    - ``input_specs(cfg, batch_size, variant)``: TensorSpec tree of one
      staged batch (stage 0's input).
    - ``ingest(cfg, variant)``: per-request host adapter -> numpy tree.
    - ``collect(cfg)``: ``(host_out, i) -> ReasonResult fields`` adapter.
    - ``make_requests(cfg, n, seed)``: ``(stream_factory, truth)``.
    - ``score(results, truth_values)``: serving accuracy.
    - ``paper_graph()``: the paper-scale OpGraph of ``core.workloads``
      (None where the paper publishes none, as for PrAE).
    - ``fused_stage_specs(cfg, variant)``: an alternate stage list for the
      fused schedule (None = the staged list composed), negotiated against
      the staged one by ``compile_schedule``.
    """

    name: str
    describe: str
    variants: tuple[str, ...]
    make_config: Callable[..., Any]
    make_consts: Callable[[Any, torch.Generator], Any]
    stage_specs: Callable[[Any, str], tuple]
    input_specs: Callable[[Any, int, str], Any]
    ingest: Callable[[Any, str], Callable]
    collect: Callable[[Any], Callable]
    make_requests: Callable[[Any, int, int], tuple]
    score: Callable[[dict, Any], float]
    paper_graph: Callable[[], Any] | None = None
    fused_stage_specs: Callable[[Any, str], tuple] | None = None


def _require(req, field: str):
    val = getattr(req, field)
    if val is None:
        raise ValueError(f"needs ReasonRequest.{field}")
    return val


def _raven_ingest(cfg, variant: str) -> Callable:
    if variant == "oracle":
        return lambda r: (
            np.asarray(_require(r, "context_attrs"), np.int32),
            np.asarray(_require(r, "candidate_attrs"), np.int32))
    return lambda r: (
        np.asarray(_require(r, "context"), np.float32),
        np.asarray(_require(r, "candidates"), np.float32))


def _raven_collect(cfg) -> Callable:
    def collect(host_out, i):
        logp, posts = host_out  # (B, 8), (A, B, R)
        return {"answer": int(np.argmax(logp[i])), "answer_logprobs": logp[i],
                "rule_posteriors": posts[:, i]}

    return collect


def _raven_input_specs(cfg, batch_size: int, variant: str):
    hw = cfg.raven.image_size
    if variant == "oracle":
        spec = TensorSpec((batch_size, 8, cfg.raven.n_attrs), torch.int32)
    else:
        spec = TensorSpec((batch_size, 8, hw, hw, 1), torch.float32)
    return (spec, spec)


def _raven_requests(cfg, n: int, seed: int):
    """Lazy RAVEN request stream + lazily materialised answers (captured as
    the stream is pulled, so scoring costs no second render pass)."""
    answers: dict[int, int] = {}

    def factory():
        for i in range(n):
            p = raven.generate_problem(cfg.raven, seed=seed + i)
            answers[i] = int(p["answer"])
            yield ReasonRequest(
                uid=i, context=p["context"], candidates=p["candidates"],
                context_attrs=p["context_attrs"],
                candidate_attrs=p["candidate_attrs"])

    def truth():
        for i in range(n):  # only re-render what was never pulled
            if i not in answers:
                answers[i] = int(raven.generate_problem(
                    cfg.raven, seed=seed + i)["answer"])
        return np.array([answers[i] for i in range(n)])

    return factory, truth


def _mean_match_score(results: dict, truth_values) -> float:
    """Mean answer == truth (elementwise for per-channel answer arrays)."""
    return float(np.mean([results[i].answer == truth_values[i]
                          for i in range(len(truth_values))]))


def _nvsa_frontend_stage(cfg, consts_key: str = "params"):
    """CNN perception stage (eval-mode BN: a request's PMFs do not depend
    on its admission group).  ``consts_key`` selects the frontend params in
    the workload's constants (LVRF keeps them under ``"frontend"``)."""

    def frontend(consts, bufs):
        ctx, cand = bufs
        n, _, h, w, c = ctx.shape
        p = consts[consts_key]
        ctx_p, _ = nv.frontend_pmfs(p, cfg, ctx.reshape(n * 8, h, w, c))
        cand_p, _ = nv.frontend_pmfs(p, cfg, cand.reshape(n * 8, h, w, c))
        return (tuple(x.reshape(n, 8, -1) for x in ctx_p),
                tuple(x.reshape(n, 8, -1) for x in cand_p))

    return StageSpec("frontend", "nn", frontend)


def _oracle_stage(cfg):
    """Ground-truth one-hot PMFs (perception bypass: symbolic-only serving)."""

    def oracle(consts, bufs):
        ctx_attrs, cand_attrs = bufs
        return (tuple(nv.oracle_pmfs(cfg, ctx_attrs)),
                tuple(nv.oracle_pmfs(cfg, cand_attrs)))

    return StageSpec("oracle", "simd", oracle)


# -- nvsa -------------------------------------------------------------------


def _nvsa_config(d: int = 128, nn_precision: str = "fp32",
                 symb_precision: str = "fp32", **_):
    return nv.NVSAConfig(d=d, nn_precision=nn_precision,
                         symb_precision=symb_precision,
                         use_qmatmul=nn_precision in ("int8", "int4"))


def _nvsa_consts(cfg, generator: torch.Generator):
    return {"params": nninit.materialize(nv.nvsa_spec(cfg), generator),
            "books": nv.nvsa_codebooks(cfg, generator)}


def _nvsa_stages(cfg, variant: str):
    def symbolic(consts, bufs):
        ctx_pmfs, cand_pmfs = bufs
        books = nv.quantize_codebooks(cfg, consts["books"])
        return nv.reason(cfg, books, list(ctx_pmfs), list(cand_pmfs))

    first = _oracle_stage(cfg) if variant == "oracle" \
        else _nvsa_frontend_stage(cfg)
    return (first, StageSpec("symbolic", "vsa", symbolic))


# -- prae -------------------------------------------------------------------


def _prae_stages(cfg, variant: str):
    """PrAE shares NVSA's config, constants and perception frontend; its
    symbolic engine works on PMF tables and launches no kernel."""
    pcfg = pr.PrAEConfig(raven=cfg.raven)

    def symbolic(consts, bufs):
        ctx_pmfs, cand_pmfs = bufs
        return pr.solve_from_pmfs(pcfg, list(ctx_pmfs), list(cand_pmfs))

    first = _oracle_stage(cfg) if variant == "oracle" \
        else _nvsa_frontend_stage(cfg)
    return (first, StageSpec("symbolic", "simd", symbolic))


# -- mimonet ----------------------------------------------------------------


def _mimonet_config(d: int = 128, **_):
    return mm.MIMONetConfig(d=d)


def _mimonet_consts(cfg, generator: torch.Generator):
    return {"params": nninit.materialize(mm.mimonet_spec(cfg), generator),
            "keys": mm.mimonet_keys(cfg, generator)}


def _mimonet_stages(cfg, variant: str):
    return (
        StageSpec("encode", "nn",
                  lambda c, images: mm.encode(c["params"], cfg, images)),
        StageSpec("superpose", "vsa",
                  lambda c, codes: mm.superpose(c["keys"], codes)),
        StageSpec("trunk", "nn", lambda c, x: mm.trunk(c["params"], x)),
        StageSpec("unbind", "vsa", lambda c, x: mm.unbind(c["keys"], cfg, x)),
        StageSpec("classify", "simd",
                  lambda c, u: mm.classify(c["params"], u)),
    )


def _mimonet_fused_stages(cfg, variant: str):
    """The fused stage list: unbind + classify collapse into the
    ``unbind_classify`` kernel, one launch instead of two.  Only the fused
    callable runs it, and only where the schedule's negotiation allows."""
    return _mimonet_stages(cfg, variant)[:3] + (
        StageSpec("unbind_classify", "simd",
                  lambda c, x: mm.unbind_classify(c["params"], c["keys"],
                                                  cfg, x)),
    )


def _mimonet_input_specs(cfg, batch_size: int, variant: str):
    hw = cfg.raven.image_size
    return TensorSpec((batch_size, cfg.n_channels, hw, hw, 1), torch.float32)


def _mimonet_ingest(cfg, variant: str):
    return lambda r: np.asarray(_require(r, "images"), np.float32)


def _mimonet_collect(cfg):
    def collect(host_out, i):
        logits = host_out[i]  # (K, n_classes)
        shifted = logits - logits.max(-1, keepdims=True)
        logp = shifted - np.log(np.exp(shifted).sum(-1, keepdims=True))
        return {"answer": np.argmax(logits, -1), "answer_logprobs": logp,
                "rule_posteriors": None}

    return collect


def _mimonet_requests(cfg, n: int, seed: int):
    """K-channel superposed-classification traffic from rendered RAVEN
    panels; truth is each channel's shape type, kept with the panels."""
    k = cfg.n_channels
    cache: dict = {}

    def _panels():
        if not cache:
            # 16 rendered panels per problem (8 context + 8 candidates)
            probs = (n * k + 15) // 16
            cache["imgs"], cache["attrs"] = raven.panel_dataset(
                cfg.raven, seed=seed, n_problems=probs)
        return cache["imgs"], cache["attrs"]

    def factory():
        imgs, _ = _panels()
        for i in range(n):
            yield ReasonRequest(uid=i, images=imgs[i * k:(i + 1) * k])

    def truth():
        _, attrs = _panels()
        return attrs[: n * k, 0].reshape(n, k)  # attr 0 = shape type

    return factory, truth


# -- lvrf -------------------------------------------------------------------


def _lvrf_config(d: int = 128, **_):
    return lv.LVRFConfig(d=d)


def _lvrf_frontend_cfg(cfg):
    """NVSA-frontend config for LVRF's CNN perception."""
    return nv.NVSAConfig(raven=cfg.raven)


def _lvrf_consts(cfg, generator: torch.Generator):
    return {"params": nninit.materialize(lv.lvrf_spec(cfg), generator),
            "books": lv.lvrf_codebooks(cfg, generator),
            "frontend": nninit.materialize(
                nv.nvsa_spec(_lvrf_frontend_cfg(cfg)), generator)}


def _lvrf_stages(cfg, variant: str):
    def abduce(consts, bufs):
        ctx_pmfs, cand_pmfs = bufs
        codes = lv.encode_codes(consts["books"], cfg, list(ctx_pmfs))
        posts = lv.abduce(consts["params"], cfg, codes)
        return (codes, posts, cand_pmfs)

    def execute(consts, bufs):
        codes, posts, cand_pmfs = bufs
        logp = lv.execute(consts["params"], consts["books"], cfg, codes,
                          posts, list(cand_pmfs))
        return (logp, posts)

    first = _oracle_stage(cfg) if variant == "oracle" \
        else _nvsa_frontend_stage(_lvrf_frontend_cfg(cfg),
                                  consts_key="frontend")
    return (first, StageSpec("abduce", "vsa", abduce),
            StageSpec("execute", "vsa", execute))


def _paper_graph(name: str):
    def build():
        return workloads.WORKLOADS[name]()

    return build


REASON_WORKLOADS: dict[str, ReasonWorkload] = {
    "nvsa": ReasonWorkload(
        name="nvsa",
        describe="NVSA: ResNet perception -> FPE/VSA rule abduction -> "
                 "circ-conv rule execution (RAVEN)",
        variants=("cnn", "oracle"),
        make_config=_nvsa_config, make_consts=_nvsa_consts,
        stage_specs=_nvsa_stages, input_specs=_raven_input_specs,
        ingest=_raven_ingest, collect=_raven_collect,
        make_requests=_raven_requests, score=_mean_match_score,
        paper_graph=_paper_graph("nvsa")),
    "prae": ReasonWorkload(
        name="prae",
        describe="PrAE: shared CNN perception -> PMF-table abduction/"
                 "execution (SIMD-shaped symbolic stream)",
        variants=("cnn", "oracle"),
        make_config=_nvsa_config, make_consts=_nvsa_consts,
        stage_specs=_prae_stages, input_specs=_raven_input_specs,
        ingest=_raven_ingest, collect=_raven_collect,
        make_requests=_raven_requests, score=_mean_match_score),
    "mimonet": ReasonWorkload(
        name="mimonet",
        describe="MIMONet: K-channel superposed classification — bind -> "
                 "shared NN trunk -> unbind/classify",
        variants=("default",),
        make_config=_mimonet_config, make_consts=_mimonet_consts,
        stage_specs=_mimonet_stages, input_specs=_mimonet_input_specs,
        ingest=_mimonet_ingest, collect=_mimonet_collect,
        make_requests=_mimonet_requests, score=_mean_match_score,
        paper_graph=_paper_graph("mimonet"),
        fused_stage_specs=_mimonet_fused_stages),
    "lvrf": ReasonWorkload(
        name="lvrf",
        describe="LVRF: frontend -> learned-rule posterior -> posterior-"
                 "weighted circ-conv execution (RAVEN)",
        variants=("cnn", "oracle"),
        make_config=_lvrf_config, make_consts=_lvrf_consts,
        stage_specs=_lvrf_stages, input_specs=_raven_input_specs,
        ingest=_raven_ingest, collect=_raven_collect,
        make_requests=_raven_requests, score=_mean_match_score,
        paper_graph=_paper_graph("lvrf")),
}


def _entry(model: str) -> ReasonWorkload:
    if model not in REASON_WORKLOADS:
        raise KeyError(f"unknown reasoning workload {model!r}; "
                       f"available: {tuple(REASON_WORKLOADS)}")
    return REASON_WORKLOADS[model]


def compile_reason_schedule(model: str, cfg, variant: str | None = None,
                            consts=None,
                            batch_size: int | tuple[int, ...] = 4,
                            device=None,
                            fused: bool | str = "auto") -> sch.StagedSchedule:
    """Lower one registry entry to a ``StagedSchedule`` on ``device``
    (None = ``"cuda"``; raises when CUDA is missing unless ``"cpu"``).

    ``batch_size`` may be a tuple of batch-size buckets: the input specs
    describe the largest, and the engine pads a partial group to the
    smallest covering bucket.  Without ``consts`` the entry's
    ``make_consts`` is drawn on the CPU for its shapes only.  The schedule
    carries the inter-stage buffer specs; its DataflowGraph is traced from
    the composed stages on first use (``serve.schedule.ensure_graph``).

    ``fused``: forwarded to ``compile_schedule`` (``"auto"`` negotiates the
    fused schedule, ``True`` forces it); the entry's ``fused_stage_specs``,
    where declared, supplies the fused stage list."""
    dev = registry.resolve_device(device)
    entry = _entry(model)
    variant = variant or entry.variants[0]
    if variant not in entry.variants:
        raise KeyError(f"{model}: unknown variant {variant!r}; "
                       f"available: {entry.variants}")
    buckets = tuple(sorted(set(batch_size))) \
        if isinstance(batch_size, (tuple, list)) else ()
    max_batch = buckets[-1] if buckets else batch_size
    if consts is None:  # shapes only: the meta run computes nothing
        consts = entry.make_consts(cfg, torch.Generator().manual_seed(0))
    fused_stages = entry.fused_stage_specs(cfg, variant) \
        if entry.fused_stage_specs is not None else None
    return sch.compile_schedule(
        model, entry.stage_specs(cfg, variant),
        entry.ingest(cfg, variant), entry.collect(cfg), device=dev,
        variant=variant, consts=consts,
        input_specs=entry.input_specs(cfg, max_batch, variant),
        batch_buckets=buckets, fused=fused,
        fused_stages=fused_stages)


def reason_engine(model: str, cfg, reason_cfg: ReasonConfig | None = None,
                  consts=None, variants: tuple[str, ...] | None = None,
                  device=None) -> ReasonEngine:
    """Compile all (or the given) variants of a workload and wrap them in
    the generic ``ReasonEngine`` on ``device`` (None = ``"cuda"``; raises
    when CUDA is missing unless ``"cpu"``).  ``consts`` (the workload's
    constant tree, e.g. from ``make_consts`` or
    ``interop.from_reference``) is moved to the device and bound onto the
    engine; without it the engine can be inspected but not served."""
    dev = registry.resolve_device(device)
    entry = _entry(model)
    reason_cfg = reason_cfg or ReasonConfig()
    if consts is not None:
        consts = interop.to_device(consts, dev)
    schedules = {
        v: compile_reason_schedule(
            model, cfg, variant=v, consts=consts,
            batch_size=reason_cfg.buckets or reason_cfg.batch_size,
            device=dev)
        for v in (variants or entry.variants)}
    return ReasonEngine(schedules, reason_cfg, consts=consts)


def reason_engine_pool(model: str, cfg, reason_cfg: ReasonConfig | None = None,
                       consts=None, variants: tuple[str, ...] | None = None,
                       replicas: int = 1, device=None):
    """``replicas`` data-parallel :func:`reason_engine` copies behind one
    :class:`~repro_torch.serve.replica.ReplicaPool`.

    Each replica gets the same constants (bit-identical answers whichever
    replica serves a request), moved to ``cuda:(i % device_count)``, or
    kept on the CPU when ``device="cpu"`` (None = ``"cuda"``).  Replicas
    on one device share one compiled schedule dict; a replica on another
    device gets the same schedules pointed at its device.  ``replicas=1``
    returns the bare engine (no pool on the single-replica path)."""
    import dataclasses as _dc

    from repro_torch.serve.replica import ReplicaPool

    if replicas < 1:
        raise ValueError(f"replicas must be >= 1, got {replicas}")
    reason_cfg = reason_cfg or ReasonConfig()
    if replicas == 1:
        return reason_engine(model, cfg, reason_cfg, consts=consts,
                             variants=variants, device=device)
    if consts is None:
        raise ValueError("a replica pool needs real consts (answers must "
                         "be replica-invariant, so every replica binds the "
                         "same constants)")
    dev = registry.resolve_device(device)
    ndev = torch.cuda.device_count() if dev.type == "cuda" else 1
    engines: list[ReasonEngine] = []
    schedules: dict[torch.device, dict] = {}
    for i in range(replicas):
        d = torch.device("cuda", i % ndev) if dev.type == "cuda" else dev
        rcfg = _dc.replace(reason_cfg)
        c = interop.to_device(consts, d)
        if not engines:
            eng = reason_engine(model, cfg, rcfg, consts=c,
                                variants=variants, device=d)
            schedules[d] = eng.schedules
        else:
            if d not in schedules:
                schedules[d] = {v: _dc.replace(s, device=d)
                                for v, s in engines[0].schedules.items()}
            eng = ReasonEngine(schedules[d], rcfg, consts=c)
        engines.append(eng)
    return ReplicaPool(engines)
