"""Golden-trace record/replay for the serving stack.

The port's copy of ``repro.serve.trace``, in the same file format.  NSFlow
validates generated accelerators against golden vectors: the same stimulus
is driven through the reference model and the lowered design, and the
outputs are diffed bit for bit.  This module is the serving-side analogue:
record what a deployment served (the admission groups the front door
formed, every request payload and every answer), then replay the same
groups offline and diff.

The tolerance of the diff comes from the registry
(:func:`repro_torch.backend.registry.replay_tolerance`): a replay under the
same per-kernel tags must be **bit-exact** (same grouping, same routes,
same floats); a replay under other tags (a trace recorded on the card and
replayed through the plain versions on the CPU, or a trace the JAX package
recorded) is held to the largest epsilon of the changed kernels that the
replay called.

Format, version 1, the reference's line for line: one JSONL file whose
``header`` line carries the recorded plan's per-kernel tags and the
``deploy()`` spec (workloads / seed / options / budget / traffic);
``group`` lines the admission groups in dispatch order; ``request`` and
``result`` lines base64 numpy arrays (numpy's dtype strings) with sha256
digests.  Each package loads the other's files.

    dep = deploy(["nvsa"], ...)
    arrivals, _ = dep.synthetic_traffic(32)
    report, trace = record(dep, arrivals, "golden.jsonl")
    ...
    trace = GoldenTrace.load("golden.jsonl")
    diff = trace.replay_and_diff(backend=registry.negotiate("cpu"))
    assert diff.ok, diff.describe()

The port takes no lowering override (ROADMAP Queue 1 #3e): ``backend`` is
None or a :class:`~repro_torch.backend.registry.LoweringPlan`, whose
platform says where a fresh deployment runs; a string raises.  Traces of
the ``lm`` class record and replay like NSAI ones, with token ids compared
exactly; a header naming a recurrent arch (rwkv6-7b, recurrentgemma-9b)
raises ``KeyError`` (#4 item 3).
"""

from __future__ import annotations

import base64
import dataclasses
import hashlib
import json
from typing import Any, Iterable, Iterator

import numpy as np
import torch

from repro_torch.backend import registry
from repro_torch.serve import runtime as rt
from repro_torch.serve.frontdoor import ArrivalRequest, FrontDoorReport

TRACE_VERSION = 1

# result fields diffed per traffic class; anything not listed here
# (timing, slot / batch indices) is process-dependent and recorded for
# provenance only
_DIFF_FIELDS = {
    "reason": ("answer", "answer_logprobs", "rule_posteriors"),
    "lm": ("tokens",),
}
# of those, the float-valued ones (epsilon applies); the rest are exact
# regardless of plan (argmax answers, token ids)
_FLOAT_FIELDS = ("answer_logprobs", "rule_posteriors")

# ---------------------------------------------------------------------------
# array / payload (de)serialization
# ---------------------------------------------------------------------------


def _enc_array(a: np.ndarray) -> dict:
    a = np.ascontiguousarray(a)
    return {"dtype": str(a.dtype), "shape": list(a.shape),
            "data": base64.b64encode(a.tobytes()).decode("ascii")}


def _dec_array(d: dict) -> np.ndarray:
    buf = base64.b64decode(d["data"])
    return np.frombuffer(buf, dtype=np.dtype(d["dtype"])).reshape(d["shape"])


def _enc_fields(obj) -> tuple[dict, dict]:
    """Split a request/result dataclass into (arrays, scalar meta)."""
    arrays, meta = {}, {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if v is None:
            continue
        if isinstance(v, np.ndarray):
            arrays[f.name] = v
        elif isinstance(v, torch.Tensor):
            arrays[f.name] = v.detach().cpu().numpy()
        elif isinstance(v, (bool, int, float, str, np.integer, np.floating)):
            meta[f.name] = v.item() if isinstance(v, np.generic) else v
        elif isinstance(v, (list, tuple)) and all(
                isinstance(x, (int, np.integer)) for x in v):
            meta[f.name] = [int(x) for x in v]
    return arrays, meta


def _digest(arrays: dict[str, np.ndarray]) -> str:
    h = hashlib.sha256()
    for name in sorted(arrays):
        h.update(name.encode())
        h.update(np.ascontiguousarray(arrays[name]).tobytes())
    return h.hexdigest()


def _payload_line(kind: str, model: str, obj) -> dict:
    arrays, meta = _enc_fields(obj)
    return {"kind": kind, "model": model, "uid": int(obj.uid),
            "meta": {k: v for k, v in meta.items() if k != "uid"},
            "arrays": {k: _enc_array(v) for k, v in arrays.items()},
            "digest": _digest(arrays)}


def _decode_payload(line: dict) -> dict:
    fields = dict(line["meta"])
    for k, v in line["arrays"].items():
        fields[k] = _dec_array(v)
    return fields


def _build_request(cls_name: str, uid: int, fields: dict):
    if cls_name == "reason":
        from repro_torch.serve.reason import ReasonRequest

        return ReasonRequest(uid=uid, **fields)
    from repro_torch.serve.engine import Request

    return Request(uid=uid, **fields)


def _port_budget(fields: dict):
    """The port's ``Budget`` from a header's budget record (the two
    packages' ``Budget`` have the same fields)."""
    from repro_torch.serve.deploy import Budget

    return Budget(**fields)


# ---------------------------------------------------------------------------
# recording
# ---------------------------------------------------------------------------


def _tap(arrivals: Iterable[ArrivalRequest], store: dict
         ) -> Iterator[ArrivalRequest]:
    """Tee an arrival stream, stashing payloads by (model, uid).  The
    front-door report only carries uids; the recorder needs the arrays."""
    for a in arrivals:
        store[(a.model, a.request.uid)] = a.request
        yield a


def record(deployment, arrivals: Iterable[ArrivalRequest], path: str
           ) -> tuple[FrontDoorReport, "GoldenTrace"]:
    """Serve ``arrivals`` through the deployment's front-door and write a
    golden trace of everything served to ``path`` (JSONL).

    Returns ``(report, trace)``: the normal :class:`FrontDoorReport` plus
    the in-memory :class:`GoldenTrace` (identical to ``GoldenTrace.load
    (path)``).
    """
    payloads: dict[tuple[str, int], Any] = {}
    report = deployment.serve(_tap(arrivals, payloads))

    header = {
        "kind": "header", "version": TRACE_VERSION,
        "backend": deployment.backend_record(),
        "models": {m: {"class": deployment.classes[m],
                       "variant": deployment.variants[m]}
                   for m in deployment.engines},
        "deploy": {
            "workloads": list(deployment.engines),
            "seed": deployment.seed,
            "options": deployment.options,
            "budget": dataclasses.asdict(deployment.budget),
            "traffic": dataclasses.asdict(deployment.traffic),
        },
    }
    lines: list[dict] = [header]
    served: set[tuple[str, int]] = set()
    for g in report.groups:
        served.update((g.model, u) for u in g.uids)
        lines.append({"kind": "group", "model": g.model,
                      "uids": list(g.uids), "bucket": g.bucket,
                      "size": g.size, "close_reason": g.close_reason})
    for (m, uid) in sorted(served):
        lines.append(_payload_line("request", m, payloads[(m, uid)]))
        lines.append(_payload_line("result", m, report.results[m][uid]))
    with open(path, "w") as f:
        for line in lines:
            f.write(json.dumps(line) + "\n")
    return report, GoldenTrace.from_lines(lines, path=path)


# ---------------------------------------------------------------------------
# replay + diff
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ReplayReport:
    """One offline replay: results per (model, uid), the plan used and the
    kernels the replay called (any route), which narrow the tolerance."""

    results: dict[tuple[str, int], Any]
    plan: registry.LoweringPlan
    kernels: frozenset = frozenset()


@dataclasses.dataclass
class FieldDiff:
    model: str
    uid: int
    field: str
    max_abs_err: float
    exact_mismatch: bool


@dataclasses.dataclass
class TraceDiff:
    """Outcome of diffing a replay against the recorded golden answers.

    ``tolerance`` is :func:`registry.replay_tolerance` of the recorded vs
    replayed per-kernel tags: 0.0 (bit-exact required) when they match,
    else the largest epsilon over the changed kernels the replay called.
    """

    tolerance: float
    recorded_tags: dict[str, str]
    replayed_tags: dict[str, str]
    n_compared: int
    max_abs_err: float
    failures: list[FieldDiff]

    @property
    def ok(self) -> bool:
        return not self.failures

    def describe(self) -> str:
        mode = "bit-exact" if self.tolerance == 0.0 \
            else f"epsilon={self.tolerance:g}"
        head = (f"replay diff [{mode}]: {self.n_compared} results, "
                f"max |err|={self.max_abs_err:.3g}, "
                f"{len(self.failures)} failures")
        tail = "".join(
            f"\n  {f.model}/{f.uid}.{f.field}: "
            + ("exact mismatch" if f.exact_mismatch
               else f"|err|={f.max_abs_err:.3g}")
            for f in self.failures[:8])
        return head + tail


@dataclasses.dataclass
class GoldenTrace:
    """A loaded golden trace: header + requests + groups + answers."""

    header: dict
    requests: dict[tuple[str, int], dict]
    results: dict[tuple[str, int], dict]
    groups: list[dict]
    path: str | None = None

    @classmethod
    def from_lines(cls, lines: Iterable[dict], path: str | None = None
                   ) -> "GoldenTrace":
        header, requests, results, groups = None, {}, {}, []
        for line in lines:
            kind = line["kind"]
            if kind == "header":
                if line["version"] != TRACE_VERSION:
                    raise ValueError(
                        f"golden trace version {line['version']} != "
                        f"{TRACE_VERSION}")
                header = line
            elif kind == "group":
                groups.append(line)
            elif kind == "request":
                requests[(line["model"], line["uid"])] = line
            elif kind == "result":
                results[(line["model"], line["uid"])] = line
        if header is None:
            raise ValueError("golden trace has no header line")
        return cls(header=header, requests=requests, results=results,
                   groups=groups, path=path)

    @classmethod
    def load(cls, path: str) -> "GoldenTrace":
        with open(path) as f:
            lines = [json.loads(l) for l in f if l.strip()]
        return cls.from_lines(lines, path=path)

    @property
    def recorded_tags(self) -> dict[str, str]:
        return dict(self.header["backend"]["lowerings"])

    # -- replay -------------------------------------------------------------

    def deploy(self, plan: registry.LoweringPlan | None = None):
        """A fresh deployment from the recorded spec, on the plan's
        platform (None = ``"cuda"``).  Its constants are drawn from the
        recorded seed; a trace the JAX package recorded replays through
        it once the reference's constants are bound to its engines."""
        from repro_torch.serve.deploy import Traffic, deploy

        device = None
        if plan is not None:
            device = {"gpu": "cuda", "cpu": "cpu"}.get(plan.platform)
            if device is None:
                raise ValueError(f"no port device for platform "
                                 f"{plan.platform!r}")
        spec = self.header["deploy"]
        return deploy(spec["workloads"], Traffic(**spec["traffic"]),
                      _port_budget(spec["budget"]), seed=spec["seed"],
                      options=spec["options"], preflight="off",
                      device=device)

    def replay(self, backend: registry.LoweringPlan | None = None,
               deployment=None) -> ReplayReport:
        """Re-serve the recorded admission groups.

        ``backend``: None (a fresh deployment runs on CUDA) or a
        :class:`~repro_torch.backend.registry.LoweringPlan` whose platform
        says where it runs (``registry.negotiate("cpu")``).  A string
        raises: the port takes no lowering override (ROADMAP Queue 1 #3e).
        ``deployment``: reuse an existing deployment's engines (its own
        plan wins); None re-deploys from the recorded spec: same
        workloads / seed / options, so constants are drawn again from the
        same seeds (a trace the JAX package recorded needs ``deployment=``
        with engines bound to the reference's constants).

        Grouping is preserved exactly: each recorded group is submitted
        as one admission group (same covering bucket, same padding), then
        drained before the next.
        """
        if isinstance(backend, str):
            raise NotImplementedError(
                f"backend={backend!r}: the port takes no lowering override "
                "(ROADMAP Queue 1 #3e, by design); pass a LoweringPlan, "
                "e.g. registry.negotiate('cpu')")
        if backend is not None and \
                not isinstance(backend, registry.LoweringPlan):
            raise TypeError(f"backend must be None or a LoweringPlan, got "
                            f"{type(backend).__name__}")
        unported = [m for m in self.header["models"]
                    if m in rt.LM_MODELS_NOT_PORTED]
        if unported:
            raise rt.recurrent_not_ported(f"models {unported} of the trace")
        if deployment is None:
            deployment = self.deploy(backend)
        plan = deployment.backend or backend or registry.negotiate()

        out: dict[tuple[str, int], Any] = {}
        with registry.record_kernels() as calls:
            for g in self.groups:
                m = g["model"]
                eng = deployment.engines[m]
                group = [
                    _build_request(
                        self.header["models"][m]["class"], uid,
                        _decode_payload(self.requests[(m, uid)]))
                    for uid in g["uids"]]
                eng.submit(group)
                out.update({(m, uid): r for uid, r in eng.drain_all().items()})
        return ReplayReport(results=out, plan=plan,
                            kernels=frozenset(k for k, _ in calls))

    # -- diff ---------------------------------------------------------------

    def diff(self, replay: ReplayReport,
             tolerance: float | None = None) -> TraceDiff:
        """Diff a replay against the recorded answers.

        ``tolerance`` defaults to ``registry.replay_tolerance(recorded,
        replayed, replay.kernels)``: bit-exact for identical per-kernel
        tags, else the largest epsilon over the changed kernels the replay
        called.  Integer-valued fields (answers) must match exactly under
        any pair of plans.
        """
        replayed_tags = replay.plan.tags()
        if tolerance is None:
            tolerance = registry.replay_tolerance(
                self.recorded_tags, replayed_tags, replay.kernels)
        failures: list[FieldDiff] = []
        max_err, n = 0.0, 0
        for key, line in sorted(self.results.items()):
            model, uid = key
            got = replay.results.get(key)
            if got is None:
                failures.append(FieldDiff(model, uid, "<missing>", np.inf,
                                          True))
                continue
            n += 1
            cls_name = self.header["models"][model]["class"]
            recorded = _decode_payload(line)
            got_arrays, got_meta = _enc_fields(got)
            got_fields = {**got_meta, **got_arrays}
            for field in _DIFF_FIELDS[cls_name]:
                want, have = recorded.get(field), got_fields.get(field)
                if want is None and have is None:
                    continue
                if want is None or have is None:
                    failures.append(FieldDiff(model, uid, field, np.inf,
                                              True))
                    continue
                want, have = np.asarray(want), np.asarray(have)
                if want.shape != have.shape:
                    failures.append(FieldDiff(model, uid, field, np.inf,
                                              True))
                    continue
                if field in _FLOAT_FIELDS and tolerance > 0.0:
                    err = float(np.max(np.abs(
                        want.astype(np.float64) - have.astype(np.float64)))
                        if want.size else 0.0)
                    max_err = max(max_err, err)
                    if err > tolerance:
                        failures.append(FieldDiff(model, uid, field, err,
                                                  False))
                elif not np.array_equal(want, have):
                    err = float(np.max(np.abs(
                        want.astype(np.float64) - have.astype(np.float64)))
                        if np.issubdtype(want.dtype, np.number)
                        and want.size else np.inf)
                    max_err = max(max_err, err if np.isfinite(err) else 0.0)
                    failures.append(FieldDiff(model, uid, field, err, True))
        return TraceDiff(tolerance=tolerance, recorded_tags=self.recorded_tags,
                         replayed_tags=replayed_tags, n_compared=n,
                         max_abs_err=max_err, failures=failures)

    def replay_and_diff(self, backend=None, deployment=None) -> TraceDiff:
        """``diff(replay(...))`` in one call."""
        return self.diff(self.replay(backend=backend, deployment=deployment))
