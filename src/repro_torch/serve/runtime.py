"""The serving runtime's engine protocol and its accounting helpers.

The port's own copy of ``repro.serve.runtime`` (which it may not import):
the :class:`GroupRecord` envelope, the structural :class:`RequestLike` /
:class:`ResultLike` envelopes, the :class:`EngineProtocol` surface that
``serve.frontdoor.FrontDoor`` drives, the warmup/measured stats split, the
helpers the front-door and the overload controller read
(:func:`request_priority`, :func:`engine_observation`) and the runtime
registry of traffic classes
(:data:`TRAFFIC_CLASSES`, :func:`resolve_models`) that ``serve.deploy``
validates its model list against.

The registry serves the four reasoners of ``configs.base.REASON_WORKLOADS``.
The port's LM ``Engine`` (``serve.engine``, built by
``configs.base.lm_engine``) runs on its own; it is not a traffic class of
the registry yet, so an LM arch id of the reference, or the ``lm`` class,
raises ``KeyError`` naming ROADMAP Queue 1 #4.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable, Mapping, Protocol, Sequence, \
    runtime_checkable

from repro_torch.serve.slo import DEFAULT_PRIORITY


@dataclasses.dataclass
class GroupRecord:
    """Provenance + timing of one dispatched admission group.

    ``dispatch_t`` is stamped (engine clock) right before the group's
    pipeline is enqueued on the device; ``done_t`` stays None until every
    request of the group has its answer on the host, so arrival -> dispatch
    is queueing and dispatch -> done is service.  ``bucket`` is the
    compiled batch shape the group ran at.
    """

    uids: tuple[int, ...]
    index: int                    # engine-lifetime group counter
    variant: str
    bucket: int                   # batch size the group ran at
    size: int                     # real requests in the group (<= bucket)
    dispatch_t: float | None = None
    done_t: float | None = None
    # which replica of a replica pool served the group (None = not pooled)
    replica: int | None = None


@runtime_checkable
class RequestLike(Protocol):
    """Anything submittable: the envelope only pins the uid."""

    uid: int


@runtime_checkable
class ResultLike(Protocol):
    """Anything drainable: results are keyed and reported by uid."""

    uid: int


class EngineProtocol(Protocol):
    """The serving-runtime API a front-door drives: ``submit`` one group,
    ``drain_ready`` (non-blocking) or ``drain_all`` its results, with
    ``inflight``, ``admission_cap``, ``stats``, ``runs`` and ``clock``."""

    stats: dict
    runs: list
    clock: Callable[[], float]

    @property
    def admission_cap(self) -> int: ...          # pragma: no cover

    @property
    def inflight(self) -> int: ...               # pragma: no cover

    def submit(self, group: Sequence[RequestLike]) -> GroupRecord:
        ...                                      # pragma: no cover

    def drain_ready(self) -> dict[int, Any]: ...  # pragma: no cover

    def drain_all(self) -> dict[int, Any]: ...    # pragma: no cover


def fresh_split_stats() -> dict:
    """The warmup/measured wall-time split: a run that first touches a
    (variant, bucket) shape lands under ``warmup`` (kernel builds, cuDNN
    and allocator set-up), steady-state runs under ``measured``.  ``work``
    counts problems for reasoning engines."""
    return {
        "measured": {"requests": 0, "work": 0, "wall_time_s": 0.0},
        "warmup": {"requests": 0, "work": 0, "wall_time_s": 0.0},
    }


def measured_rate(stats: Mapping, field: str = "work") -> float:
    """Steady-state ``field``-per-second from a warmup-split stats dict;
    falls back to the warmup totals when only warmup runs exist."""
    m, w = stats["measured"], stats["warmup"]
    if m["wall_time_s"]:
        return m[field] / m["wall_time_s"]
    if w["wall_time_s"]:
        return w[field] / w["wall_time_s"]
    return 0.0


def work_units(result: Any) -> int:
    """Throughput units one result carries: generated tokens for LM
    results, 1 problem for reasoning results."""
    tokens = getattr(result, "tokens", None)
    return len(tokens) if tokens is not None else 1


def request_priority(request: Any) -> str:
    """Priority class of a request envelope: its ``priority`` attribute,
    or ``standard`` when it names none (the front-door validates it)."""
    return getattr(request, "priority", None) or DEFAULT_PRIORITY


def engine_observation(engine: Any) -> dict[str, Any]:
    """What the overload controller sees of one engine each tick: the
    engine's own ``observation()`` where it has one, else ``inflight`` and
    the steady-state ``work_rate`` (see :func:`measured_rate`)."""
    obs = getattr(engine, "observation", None)
    if callable(obs):
        return obs()
    return {"inflight": engine.inflight,
            "work_rate": measured_rate(engine.stats)}


# ---------------------------------------------------------------------------
# the runtime registry
# ---------------------------------------------------------------------------

#: The reference's servable LM arch ids (kinds lm / rwkv / griffin).  The
#: registry takes no LM traffic yet (ROADMAP Queue 1 #4).
LM_MODELS_NOT_PORTED: tuple[str, ...] = (
    "deepseek-v3-671b", "gemma3-12b", "granite-moe-1b-a400m", "llama3.2-3b",
    "recurrentgemma-9b", "rwkv6-7b", "stablelm-3b", "starcoder2-3b")


def _lm_not_ported(what: str) -> KeyError:
    return KeyError(f"{what}: the port's runtime registry has no LM traffic "
                    "class yet (ROADMAP Queue 1 #4, the LM substrate)")


def _reason_model_ids() -> tuple[str, ...]:
    from repro_torch.configs.base import REASON_WORKLOADS

    return tuple(REASON_WORKLOADS)


@dataclasses.dataclass(frozen=True)
class TrafficClass:
    """One entry of the runtime registry: a serving traffic class."""

    name: str
    describe: str
    models: Callable[[], tuple[str, ...]]   # servable model ids (lazy)


TRAFFIC_CLASSES: dict[str, TrafficClass] = {
    "reason": TrafficClass(
        "reason", "batched NSAI reasoning through the staged-pipeline "
                  "ReasonEngine", _reason_model_ids),
    "frontdoor": TrafficClass(
        "frontdoor", "online NSAI traffic: DSE-deployed engines behind one "
                     "deadline-batched front-door", _reason_model_ids),
}


def resolve_models(workload: str, models: Iterable[str]) -> tuple[str, ...]:
    """Validate a model list against a traffic class's registry entry.
    An LM arch id, or the ``lm`` class, raises ``KeyError`` (not ported)."""
    if workload == "lm":
        raise _lm_not_ported("traffic class 'lm'")
    tc = TRAFFIC_CLASSES.get(workload)
    if tc is None:
        raise KeyError(f"unknown workload {workload!r}; "
                       f"available: {tuple(TRAFFIC_CLASSES)}")
    known = tc.models()
    out = tuple(models)
    lm = [m for m in out if m in LM_MODELS_NOT_PORTED]
    if lm:
        raise _lm_not_ported(f"LM models {lm}")
    bad = [m for m in out if m not in known]
    if bad:
        raise ValueError(f"{workload}: unknown models {bad}; "
                         f"servable: {known}")
    return out
