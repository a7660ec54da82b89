"""The arch adapter, the reasoning-workload registry and the engine
constructors.

The port of ``repro.configs.base``.  ``ArchSpec`` is the uniform adapter of
the LM architectures (``configs/registry.py:ARCHS``): ``model_spec``,
``prefill_fn`` (the full-context forward, last-token logits),
``decode_fn``, ``serve_fns`` (the ``Engine``'s decode step and cache
allocator) and ``lm_engine``.  The port has the ``lm`` kind only (the dense
GQA decoders and the MoE / MLA ones); the other kinds raise, naming
ROADMAP Queue 1 #4 item 3.

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
from repro_torch.core import workloads
from repro_torch.data import raven
from repro_torch.models import lm as lm_mod
from repro_torch.models import lvrf as lv
from repro_torch.models import mimonet as mm
from repro_torch.models import nvsa as nv
from repro_torch.models import prae as pr
from repro_torch.nn import init as nninit
from repro_torch.serve import schedule as sch
from repro_torch.serve.reason import ReasonConfig, ReasonEngine, ReasonRequest
from repro_torch.serve.schedule import StageSpec, TensorSpec


# ---------------------------------------------------------------------------
# LM architectures: the ArchSpec adapter
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    """The reference's ``ArchSpec`` without ``fsdp`` and ``opt_8bit``, the
    sharding and optimizer switches that wait for Queue 1 #5 and #6."""

    id: str
    family: str                   # moe | dense | ssm | hybrid | vlm | audio
    kind: str                     # lm | rwkv | griffin | vlm | encdec
    make_full: Callable[[], Any]
    make_smoke: Callable[[], Any]
    supports_long: bool = False
    note: str = ""
    source: str = ""


def _mod(kind: str):
    if kind == "lm":
        return lm_mod
    if kind in ("rwkv", "griffin", "vlm", "encdec"):
        raise NotImplementedError(
            f"arch kind {kind!r} is not ported yet (ROADMAP Queue 1 #4 item 3: "
            "nn/ssm.py, rwkv6, griffin, encdec and vlm)")
    raise ValueError(kind)


def model_spec(arch: ArchSpec, cfg):
    return _mod(arch.kind).lm_spec(cfg)


def prefill_fn(arch: ArchSpec, cfg):
    """Full-context forward returning last-token logits (inference
    prefill); every unwindowed layer runs the ``flash_attn`` kernel."""
    m = _mod(arch.kind)

    def f(params, tokens):
        hidden, _ = m.forward(params, cfg, tokens)
        return m.lm_logits(params, cfg, hidden[:, -1:])[:, 0]

    return f


def decode_fn(arch: ArchSpec, cfg):
    m = _mod(arch.kind)

    def f(params, caches, token, pos):
        return m.decode_step(params, cfg, caches, token, pos)

    return f


def serve_fns(arch: ArchSpec, cfg, max_len: int):
    """(decode_step, init_caches) pair for the continuous-batching
    ``Engine``: ``decode_step`` takes a per-slot (B,) position vector (or
    an int); ``init_caches(batch, device)`` allocates zeroed KV caches of
    ``max_len`` per slot on ``device``."""
    m = _mod(arch.kind)
    step = decode_fn(arch, cfg)

    def init(batch: int, device=None):
        return m.init_caches(cfg, batch, max_len, device=device)

    return step, init


def lm_engine(arch_id: str, serve_cfg=None, key=None, device=None):
    """Draw a smoke-scale arch and wrap it in the slot-pool LM ``Engine``
    with params bound, the LM counterpart of ``reason_engine``.  Returns
    ``(engine, model_cfg)`` (callers need ``model_cfg.vocab`` for token
    traffic).

    ``key`` is a ``torch.Generator`` (None = seed 0 on ``device``); the
    parameters are drawn on its device and moved to ``device`` (None =
    ``"cuda"``; raises without CUDA unless ``"cpu"``).  The reference's
    ``tp`` (tensor-parallel decode) waits for ROADMAP Queue 1 #6."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.serve.engine import Engine, ServeConfig

    dev = registry.resolve_device(device)
    arch = get_arch(arch_id)
    cfg = arch.make_smoke()
    serve_cfg = serve_cfg or ServeConfig()
    gen = key if key is not None else torch.Generator(dev).manual_seed(0)
    params = interop.to_device(nninit.materialize(model_spec(arch, cfg), gen), dev)
    step, init_caches = serve_fns(arch, cfg, max_len=serve_cfg.max_len)
    return Engine(step, init_caches, serve_cfg, params=params), cfg


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
