"""The reasoning-workload registry and the engine constructors.

The port of the NSAI part of ``repro.configs.base``.  Each
:class:`ReasonWorkload` entry declares how a workload serves: its stage
functions (with nn / vsa / simd stream tags), the staged-batch input specs,
its constants, and request ingest / collect adapters.
``compile_reason_schedule`` lowers an entry to a ``StagedSchedule`` and
``reason_engine`` wraps its variants in the generic ``ReasonEngine``:

    engine = reason_engine("nvsa", cfg, ReasonConfig(...), consts=consts)
    results = engine.run(requests)

``REASON_WORKLOADS`` holds ``nvsa`` alone in this slice of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import interop
from repro_torch.backend import registry
from repro_torch.data import raven
from repro_torch.models import nvsa as nv
from repro_torch.nn import init as nninit
from repro_torch.serve import schedule as sch
from repro_torch.serve.reason import ReasonConfig, ReasonEngine, ReasonRequest
from repro_torch.serve.schedule import StageSpec, TensorSpec


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
    """Mean answer == truth."""
    return float(np.mean([results[i].answer == truth_values[i]
                          for i in range(len(truth_values))]))


def _nvsa_frontend_stage(cfg):
    """CNN perception stage (eval-mode BN: a request's PMFs do not depend
    on its admission group)."""

    def frontend(consts, bufs):
        ctx, cand = bufs
        n, _, h, w, c = ctx.shape
        p = consts["params"]
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


REASON_WORKLOADS: dict[str, ReasonWorkload] = {
    "nvsa": ReasonWorkload(
        name="nvsa",
        describe="NVSA: ResNet perception -> FPE/VSA rule abduction -> "
                 "circ-conv rule execution (RAVEN)",
        variants=("cnn", "oracle"),
        make_config=_nvsa_config, make_consts=_nvsa_consts,
        stage_specs=_nvsa_stages, input_specs=_raven_input_specs,
        ingest=_raven_ingest, collect=_raven_collect,
        make_requests=_raven_requests, score=_mean_match_score),
}


def _entry(model: str) -> ReasonWorkload:
    if model not in REASON_WORKLOADS:
        raise KeyError(f"unknown reasoning workload {model!r}; "
                       f"available: {tuple(REASON_WORKLOADS)}")
    return REASON_WORKLOADS[model]


def compile_reason_schedule(model: str, cfg, variant: str | None = None,
                            consts=None,
                            batch_size: int | tuple[int, ...] = 4,
                            device=None) -> sch.StagedSchedule:
    """Lower one registry entry to a ``StagedSchedule`` on ``device``
    (None = ``"cuda"``; raises when CUDA is missing unless ``"cpu"``).

    ``batch_size`` may be a tuple of batch-size buckets: the input specs
    describe the largest, and the engine pads a partial group to the
    smallest covering bucket.  With ``consts`` the schedule carries the
    inter-stage buffer specs."""
    dev = registry.resolve_device(device)
    entry = _entry(model)
    variant = variant or entry.variants[0]
    if variant not in entry.variants:
        raise KeyError(f"{model}: unknown variant {variant!r}; "
                       f"available: {entry.variants}")
    buckets = tuple(sorted(set(batch_size))) \
        if isinstance(batch_size, (tuple, list)) else ()
    max_batch = buckets[-1] if buckets else batch_size
    return sch.compile_schedule(
        model, entry.stage_specs(cfg, variant),
        entry.ingest(cfg, variant), entry.collect(cfg), device=dev,
        variant=variant, consts=consts,
        input_specs=entry.input_specs(cfg, max_batch, variant),
        batch_buckets=buckets)


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
