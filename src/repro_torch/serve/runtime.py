"""The serving runtime's engine protocol and its accounting helpers.

The port's own copy of what ``ReasonEngine`` needs from
``repro.serve.runtime`` (which it may not import): the
:class:`GroupRecord` envelope, the :class:`EngineProtocol` surface the
reference's front-door drives, and the warmup/measured stats split.  Any
engine with this surface can be served by ``repro.serve.frontdoor``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Protocol, Sequence

# priority class of a request that names none (``repro.serve.slo``)
DEFAULT_PRIORITY = "standard"


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

    def submit(self, group: Sequence[Any]) -> GroupRecord:
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
