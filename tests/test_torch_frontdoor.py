"""The port's front door and control plane against the reference's.

``repro_torch.serve.frontdoor`` / ``control`` / ``slo`` are the port's own
copies (numpy and plain Python).  On the same inputs they must decide the
same: arrival streams, bucket ladders, SLO windows and attainment, bounded
priority queues and their sheds, the overload controller's decisions, and,
driving port engines on the CPU under a virtual clock, the groups the
door serves (uids, bucket, close reason and every timestamp), the
latencies it reports and the answers.
"""

import dataclasses

import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.serve import control as r_ctl
from repro.serve import frontdoor as r_fd
from repro.serve import slo as r_slo
from repro_torch.configs import base as cb
from repro_torch.serve import control as p_ctl
from repro_torch.serve import frontdoor as p_fd
from repro_torch.serve import runtime as p_rt
from repro_torch.serve import slo as p_slo
from repro_torch.serve.reason import ReasonConfig

torch.set_num_threads(2)

MODELS = ("nvsa", "prae")     # oracle variants: symbolic stages only
N_REQ = 24


class VirtualClock:
    """Deterministic clock + sleep pair for driving the serve loop."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def sleep(self, dt: float):
        assert dt >= 0
        self.t += dt


def _astuples(items):
    return [dataclasses.astuple(x) for x in items]


# -- arrivals and buckets --------------------------------------------------------


@pytest.mark.parametrize("max_batch", [1, 2, 3, 6, 8, 13, 64])
@pytest.mark.parametrize("min_bucket", [1, 2, 4])
def test_pow2_buckets_equal(max_batch, min_bucket):
    assert p_fd.pow2_buckets(max_batch, min_bucket) == \
        r_fd.pow2_buckets(max_batch, min_bucket)


@settings(max_examples=10, deadline=None)
@given(rate=st.floats(0.5, 2000.0), seed=st.integers(0, 10_000),
       n=st.integers(1, 40))
def test_arrival_streams_equal(rate, seed, n):
    """Poisson arrivals, their merge and a priority mix: same times, same
    order, same classes."""
    def streams(fd):
        a = fd.poisson_arrivals("a", range(n), rate, seed=seed)
        b = fd.poisson_arrivals("b", range(n), rate / 2, seed=seed + 1)
        merged = fd.merge_arrivals(a, b)
        return [(x.t, x.model, x.request, x.priority) for x in
                fd.with_priorities(merged, {"interactive": 1, "batch": 2},
                                   seed=seed)]

    assert streams(p_fd) == streams(r_fd)


def test_trace_arrivals_refuse_the_same_streams():
    for fd in (p_fd, r_fd):
        with pytest.raises(ValueError, match="nondecreasing"):
            list(fd.trace_arrivals("a", [0.2, 0.1], [1, 2]))
        with pytest.raises(ValueError, match="more times"):
            list(fd.trace_arrivals("a", [0.1, 0.2], [1]))
        with pytest.raises(ValueError, match="more requests"):
            list(fd.trace_arrivals("a", [0.1], [1, 2]))
        with pytest.raises(ValueError, match="rate_rps"):
            list(fd.poisson_arrivals("a", [1], 0.0))


# -- slo and control -------------------------------------------------------------


def test_slo_targets_estimator_and_attainment_equal():
    assert p_slo.PRIORITIES == r_slo.PRIORITIES
    assert p_slo.DEFAULT_PRIORITY == r_slo.DEFAULT_PRIORITY \
        == p_rt.DEFAULT_PRIORITY
    for spec in (None, 20.0, {"interactive": 5, "batch": 100}):
        assert _astuples(p_slo.slo_targets(spec).values()) == \
            _astuples(r_slo.slo_targets(spec).values())
    rng = np.random.default_rng(7)
    obs = [(str(rng.choice(["m1", "m2"])), str(rng.choice(p_slo.PRIORITIES)),
            float(rng.exponential(0.01)), i * 1e-3) for i in range(300)]
    ests = [mod.SLOEstimator(mod.slo_targets(8.0), window=64)
            for mod in (p_slo, r_slo)]
    for o in obs:
        for e in ests:
            e.observe(*o)
    for m in ("m1", "m2"):
        assert ests[0].snapshot(m) == ests[1].snapshot(m)

    @dataclasses.dataclass
    class Lat:
        model: str
        priority: str
        total_s: float

    lats = [Lat(m, p, s) for m, p, s, _ in obs]
    for model in (None, "m1"):
        assert p_slo.attainment(lats, p_slo.slo_targets(8.0), model) == \
            r_slo.attainment(lats, r_slo.slo_targets(8.0), model)
    with pytest.raises(ValueError, match="unknown priority"):
        p_slo.validate_priority("urgent")


@dataclasses.dataclass
class _Item:
    t: float
    model: str
    request: object


@dataclasses.dataclass
class _Req:
    uid: int


@pytest.mark.parametrize("policy", ["lowest-priority", "tail-drop"])
def test_class_queues_shed_the_same(policy):
    rng = np.random.default_rng(3)
    queues = [mod.ClassQueues(depth=5, policy=policy) for mod in (p_ctl, r_ctl)]
    logs = ([], [])
    for i in range(80):
        prio = str(rng.choice(p_slo.PRIORITIES))
        item = _Item(t=i * 0.01, model="m", request=_Req(i))
        pop = rng.random() < 0.3
        for q, log in zip(queues, logs):
            shed = q.offer(item, prio, now=i * 0.01)
            log.append(None if shed is None else dataclasses.astuple(shed))
            if pop:
                log.append([x.request.uid for x in q.pop(2)])
    assert logs[0] == logs[1]
    assert queues[0].depth_max == queues[1].depth_max
    assert queues[0].counts() == queues[1].counts()


def test_overload_controller_decides_the_same():
    rng = np.random.default_rng(11)
    ctls = [ctl.OverloadController(slo.slo_targets(6.0),
                                   ctl.ControlConfig(queue_depth=16, min_obs=4))
            for ctl, slo in ((p_ctl, p_slo), (r_ctl, r_slo))]
    for c in ctls:
        c.bind("m", deadline_s=0.02, cap=8, buckets=(2, 4, 8))
    for i in range(400):
        now = i * 0.005
        lat = float(rng.exponential(0.004 if i < 200 else 0.02))
        obs = {"m": {"queue_depth": int(rng.integers(0, 12)), "inflight": 1}}
        for c in ctls:
            c.observe("m", "interactive", lat, now)
            c.maybe_tick(now, obs)
    assert _astuples(ctls[0].decisions) == _astuples(ctls[1].decisions)
    assert ctls[0].decisions and ctls[0].ticks == ctls[1].ticks
    assert (ctls[0].deadline_s("m"), ctls[0].cap("m")) == \
        (ctls[1].deadline_s("m"), ctls[1].cap("m"))


# -- the door over port engines ----------------------------------------------------


def _engines():
    out = {}
    for i, m in enumerate(MODELS):
        entry = cb.REASON_WORKLOADS[m]
        cfg = entry.make_config(d=128)
        consts = entry.make_consts(cfg, torch.Generator().manual_seed(i))
        out[m] = cb.reason_engine(
            m, cfg, ReasonConfig(batch_size=4, buckets=(2, 4), max_inflight=2),
            consts=consts, variants=("oracle",), device="cpu")
    return out


@pytest.fixture(scope="module")
def traffic():
    """Bursts and trickles for two models: the same request objects and
    times go to both doors."""
    rng = np.random.default_rng(5)
    streams = []
    for j, m in enumerate(MODELS):
        entry = cb.REASON_WORKLOADS[m]
        factory, _ = entry.make_requests(entry.make_config(d=128), N_REQ, seed=j)
        gaps = np.where(rng.random(N_REQ) < 0.5, 1e-4, rng.exponential(0.012, N_REQ))
        streams.append((m, np.cumsum(gaps).tolist(), list(factory())))
    return streams


def _serve(fd, engines, streams, controller=None):
    clock = VirtualClock()
    door = fd.FrontDoor(engines, fd.FrontDoorConfig(deadline_s=0.01,
                                                    poll_s=0.002),
                        clock=clock, sleep=clock.sleep, controller=controller)
    arrivals = fd.merge_arrivals(*(fd.trace_arrivals(m, t, reqs)
                                   for m, t, reqs in streams))
    return door.serve(arrivals)


@pytest.mark.parametrize("control", [None, "slo_and_bound"])
def test_port_door_serves_the_reference_doors_groups(traffic, control):
    """The same arrivals through the reference's door and the port's, each
    over its own port engines on a virtual clock: equal groups, latencies,
    sheds, controller decisions and answers."""
    reports = []
    for fd, ctl_mod, slo_mod in ((r_fd, r_ctl, r_slo), (p_fd, p_ctl, p_slo)):
        ctl = None if control is None else ctl_mod.OverloadController(
            slo_mod.slo_targets(4.0),
            ctl_mod.ControlConfig(queue_depth=3, tick_s=0.01, min_obs=2))
        reports.append(_serve(fd, _engines(), traffic, ctl))
    want, got = reports
    # bare engines, no pool: the replica field is None on both sides
    assert all(g.replica is None for g in want.groups)
    assert all(g.replica is None for g in got.groups)
    fields = [f.name for f in dataclasses.fields(p_fd.ServedGroup)]
    assert _astuples(got.groups) == [tuple(getattr(g, f) for f in fields)
                                     for g in want.groups]
    assert _astuples(got.latencies) == _astuples(want.latencies)
    assert _astuples(got.shed) == _astuples(want.shed)
    assert _astuples(got.decisions) == _assert_nonempty(want.decisions, control)
    assert got.queue_depth_max == want.queue_depth_max
    assert got.wall_time_s == want.wall_time_s
    reasons = {g.close_reason for g in got.groups}
    if control is None:
        assert {"full", "deadline", "flush"} >= reasons >= {"full", "deadline"}
        assert not got.shed
    else:
        assert got.shed, "the bounded queues shed nothing"
    served = {m: len(r) for m, r in got.results.items()}
    assert sum(served.values()) + len(got.shed) == len(MODELS) * N_REQ
    for m in MODELS:
        assert sorted(got.results[m]) == sorted(want.results[m])
        for uid, res in want.results[m].items():
            np.testing.assert_array_equal(got.results[m][uid].answer_logprobs,
                                          res.answer_logprobs)
    for model in (None, *MODELS):
        assert got.percentiles("total_s", model) == \
            want.percentiles("total_s", model)
        assert got.bucket_histogram(model) == want.bucket_histogram(model)
    assert got.summary() == want.summary()


def _assert_nonempty(decisions, control):
    if control is not None:
        assert decisions, "the controller made no decision"
    return _astuples(decisions)


def test_runtime_registry_and_envelopes():
    assert p_rt.resolve_models("frontdoor", ["nvsa", "lvrf"]) == ("nvsa", "lvrf")
    assert set(p_rt.TRAFFIC_CLASSES["reason"].models()) == set(cb.REASON_WORKLOADS)
    # LM archs resolve in the lm and frontdoor classes; the recurrent kinds
    # still raise, naming their item
    assert p_rt.resolve_models("frontdoor", ["nvsa", "llama3.2-3b"]) == \
        ("nvsa", "llama3.2-3b")
    assert "llama3.2-3b" in p_rt.TRAFFIC_CLASSES["lm"].models()
    for workload in ("frontdoor", "lm"):
        with pytest.raises(KeyError, match="Queue 1 #4 item 3"):
            p_rt.resolve_models(workload, ["rwkv6-7b"])
    with pytest.raises(ValueError, match="unknown models"):
        p_rt.resolve_models("lm", ["nvsa"])
    with pytest.raises(ValueError, match="unknown models"):
        p_rt.resolve_models("reason", ["resnet"])
    with pytest.raises(KeyError, match="unknown workload"):
        p_rt.resolve_models("vision", ["nvsa"])
    req = _Req(3)
    assert isinstance(req, p_rt.RequestLike) and isinstance(req, p_rt.ResultLike)
    assert p_rt.request_priority(req) == "standard"
    eng = _engines()["nvsa"]
    assert p_rt.engine_observation(eng) == {"inflight": 0, "work_rate": 0.0}
