"""Golden-trace record -> replay on the port, and across the two packages.

``repro_torch.serve.trace`` writes and reads the reference's JSONL format
(version 1).  On the port alone, the cases of the reference's
``tests/test_trace_replay.py``: one nvsa deployment at d = 128 (the
kernels' dispatch floor, so binds take circ_conv's route) records what it
served; the trace replays bit-exact through the same deployment and
through a fresh one rebuilt from its header, a corrupted answer is
flagged, and the header holds the deploy spec.  Across packages: a trace
the JAX package records replays on the port through engines bound to the
reference's constants within ``registry.replay_tolerance`` (circ_conv's
1e-3) with answers exact, and a trace the port records loads in the
reference's ``GoldenTrace`` with its digests holding.

``tests/golden/nvsa_oracle_d128.jsonl`` (with its constants in the
``.npz`` beside it) is a trace the reference recorded, for ``chip_smoke.py``
to replay on the card, where there is no JAX.  Its door runs on a virtual
clock, so its groups follow from the arrivals alone.  A test re-records it
and holds the committed files to the reference; to write them anew:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_golden_trace.py
"""

import importlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.backend import registry
from repro_torch.serve import trace as p_trace

torch.set_num_threads(2)

r_deploy = importlib.import_module("repro.serve.deploy")
p_deploy = importlib.import_module("repro_torch.serve.deploy")

N_REQUESTS = 6
# the reference test's call: one nvsa deployment at d = 128, seed 3
TRAFFIC = {"rate_rps": 500.0, "deadline_s": 0.004}
BUDGET = {"max_batch": 2, "inflight_cap": 2}

FIXTURE = Path(__file__).resolve().parent / "golden" / "nvsa_oracle_d128.jsonl"
FIXTURE_NPZ = FIXTURE.with_suffix(".npz")
FIXTURE_REQUESTS = 8
FIXTURE_OPTIONS = {"nvsa": {"d": 128, "variant": "oracle"}}


class VirtualClock:
    """A clock that moves only when the door sleeps, so the groups a door
    forms depend on the arrivals alone, not on how fast the host serves."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def sleep(self, dt: float):
        self.t += dt


def _reference_deploy(options):
    from repro.backend import registry as r_registry

    clock = VirtualClock()
    return r_deploy.deploy(["nvsa"], r_deploy.Traffic(**TRAFFIC),
                           r_deploy.Budget(**BUDGET), seed=3, options=options,
                           backend=r_registry.negotiate(override=""),
                           preflight="off", clock=clock, sleep=clock.sleep)


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy_tree(v) for v in tree]
    return None if tree is None else np.asarray(tree)


def record_reference_fixture(path):
    """Record the fixture's trace with the reference (JAX on the CPU):
    nvsa, oracle, d = 128, ``FIXTURE_REQUESTS`` requests that carry only
    the attributes the oracle variant reads.  Returns the trace and the
    constants the oracle variant reads (the codebooks), as numpy."""
    from repro.configs import base as r_cb
    from repro.serve import frontdoor as r_fd
    from repro.serve import trace as r_trace
    from repro.serve.reason import ReasonRequest

    dep = _reference_deploy(FIXTURE_OPTIONS)
    factory, _ = r_cb.REASON_WORKLOADS["nvsa"].make_requests(
        dep.configs["nvsa"], FIXTURE_REQUESTS, seed=11)
    reqs = [ReasonRequest(uid=r.uid, context_attrs=r.context_attrs,
                          candidate_attrs=r.candidate_attrs)
            for r in factory()]
    arrivals = r_fd.poisson_arrivals("nvsa", reqs, dep.traffic.rate_rps,
                                     seed=11)
    _, trace = r_trace.record(dep, arrivals, str(path))
    return trace, {"books": _numpy_tree(dep.engines["nvsa"].consts["books"])}


def bind_constants(dep, consts, device="cpu"):
    """Bind a tree of the reference's constants (numpy) onto every engine
    of ``dep``, in place of the keys it holds."""
    for eng in dep.engines.values():
        eng.consts = {**eng.consts,
                      **interop.from_reference(consts, device)}
    return dep


# -- the port alone -------------------------------------------------------------


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("trace") / "golden.jsonl")
    clock = VirtualClock()
    dep = p_deploy.deploy(["nvsa"], p_deploy.Traffic(**TRAFFIC),
                          p_deploy.Budget(**BUDGET), seed=3,
                          options={"nvsa": {"d": 128}}, device="cpu",
                          clock=clock, sleep=clock.sleep)
    arrivals, _ = dep.synthetic_traffic(N_REQUESTS, seed=11)
    report, trace = p_trace.record(dep, arrivals, path)
    return dep, report, trace, path


def test_record_covers_everything_served(golden):
    dep, report, trace, path = golden
    served = {(m, uid) for m, res in report.results.items() for uid in res}
    assert len(served) == N_REQUESTS
    assert set(trace.requests) == served == set(trace.results)
    assert [tuple(g["uids"]) for g in trace.groups] == \
        [tuple(g.uids) for g in report.groups]
    assert trace.recorded_tags == dep.backend.tags() == \
        dict.fromkeys(registry.KERNELS, "torch")
    # d = 128 takes circ_conv's route, not the gather below its floor,
    # otherwise a cross-device replay would not exercise the kernel
    assert registry.dispatch_path("circ_conv", 128) == "kernel"


def test_trace_file_is_loadable_and_digests_hold(golden):
    _, _, trace, path = golden
    loaded = p_trace.GoldenTrace.load(path)
    assert loaded.header["deploy"]["workloads"] == ["nvsa"]
    assert loaded.recorded_tags == trace.recorded_tags
    for key, line in loaded.requests.items():
        arrays = {k: p_trace._dec_array(v) for k, v in line["arrays"].items()}
        assert p_trace._digest(arrays) == line["digest"], key


def test_replay_same_plan_is_bit_exact(golden):
    dep, _, trace, _ = golden
    rep = trace.replay(deployment=dep)
    assert rep.kernels >= {"circ_conv"}
    diff = trace.diff(rep)
    assert diff.tolerance == 0.0
    assert diff.n_compared == N_REQUESTS
    assert diff.ok, diff.describe()
    assert diff.max_abs_err == 0.0


def test_replay_fresh_deployment_same_plan_is_bit_exact(golden):
    _, _, trace, path = golden
    # re-deploy from the recorded spec: constants drawn again from the
    # seed, schedules compiled again; answers must still be bit-identical
    diff = p_trace.GoldenTrace.load(path).replay_and_diff(
        backend=registry.negotiate("cpu"))
    assert diff.tolerance == 0.0
    assert diff.n_compared == N_REQUESTS
    assert diff.ok, diff.describe()


def test_diff_flags_corrupted_answer(golden):
    dep, _, trace, _ = golden
    rep = trace.replay(deployment=dep)
    key = next(iter(rep.results))
    rep.results[key].answer = int(rep.results[key].answer) + 1
    diff = trace.diff(rep)
    assert not diff.ok
    assert any(f.field == "answer" and f.exact_mismatch
               for f in diff.failures)


def test_header_records_deploy_spec(golden):
    _, _, _, path = golden
    with open(path) as f:
        header = json.loads(f.readline())
    assert header["kind"] == "header" and header["version"] == 1
    assert header["backend"] == {"platform": "cpu", "source": "negotiated",
                                 "lowerings": registry.negotiate("cpu").tags()}
    assert header["deploy"]["seed"] == 3
    assert header["deploy"]["options"] == {"nvsa": {"d": 128}}
    assert header["deploy"]["budget"]["max_batch"] == 2
    assert header["models"]["nvsa"] == {"class": "reason", "variant": "cnn"}


def test_replay_refuses_what_the_port_does_not_take(golden):
    """A string backend (#3e) raises, and a model neither package serves (the
    vlm arch) is refused; a recurrent LM model in the header is taken (its
    kind is ported); the reference's LM fields of Budget are taken at any
    value."""
    _, _, trace, path = golden
    with pytest.raises(NotImplementedError, match="#3e"):
        trace.replay(backend="xla")
    with pytest.raises(NotImplementedError, match="#3e"):
        p_deploy.deploy(["nvsa"], backend=registry.negotiate("cpu"),
                        device="cpu")
    lines = [json.loads(l) for l in open(path)]

    def naming(arch_id):
        header = dict(lines[0], models={**lines[0]["models"],
                                        arch_id: {"class": "lm", "variant": None}})
        header["deploy"] = dict(header["deploy"], workloads=[
            *header["deploy"]["workloads"], arch_id])
        return p_trace.GoldenTrace.from_lines([header, *lines[1:]])

    with pytest.raises(ValueError, match="unknown models"):
        naming("internvl2-26b").replay(backend=registry.negotiate("cpu"))
    dep = naming("rwkv6-7b").deploy(registry.negotiate("cpu"))
    assert dep.classes["rwkv6-7b"] == "lm"
    budget = dict(trace.header["deploy"]["budget"])
    assert p_trace._port_budget(budget) == p_deploy.Budget(**BUDGET)
    assert p_trace._port_budget(dict(budget, max_slots=8)) == \
        p_deploy.Budget(**BUDGET, max_slots=8)


@pytest.mark.parametrize("recorded, replayed, served, want", [
    ({"circ_conv": "cuda"}, {"circ_conv": "cuda"}, None, 0.0),
    ({"circ_conv": "cuda", "flash_attn": "cuda"},
     {"circ_conv": "torch", "flash_attn": "cuda"}, None, 1e-3),
    ({"circ_conv": "interpret", "flash_attn": "interpret"},
     {"circ_conv": "torch", "flash_attn": "torch"}, None, 3e-2),
    ({"circ_conv": "interpret", "flash_attn": "interpret"},
     {"circ_conv": "torch", "flash_attn": "torch"}, {"circ_conv"}, 1e-3),
    ({"circ_conv": "interpret", "flash_attn": "interpret"},
     {"circ_conv": "torch", "flash_attn": "torch"}, {"circ_dict"}, 3e-2),
    ({}, {"circ_dict": "torch"}, {"circ_dict"}, 0.0),
])
def test_replay_tolerance(recorded, replayed, served, want):
    assert registry.replay_tolerance(recorded, replayed, served) == want


# -- across the two packages ---------------------------------------------------


@pytest.fixture(scope="module")
def jax_golden(tmp_path_factory):
    """The reference test's trace: the JAX package's deploy and record of
    nvsa (cnn) at d = 128, 6 requests."""
    from repro.serve import trace as r_trace

    path = str(tmp_path_factory.mktemp("jax_trace") / "golden.jsonl")
    dep = _reference_deploy({"nvsa": {"d": 128}})
    arrivals, _ = dep.synthetic_traffic(N_REQUESTS, seed=11)
    _, trace = r_trace.record(dep, arrivals, path)
    return path, _numpy_tree(dep.engines["nvsa"].consts)


def test_jax_recorded_trace_replays_on_the_port(jax_golden):
    path, consts = jax_golden
    trace = p_trace.GoldenTrace.load(path)
    assert set(trace.recorded_tags.values()) == {"interpret"}
    dep = bind_constants(trace.deploy(registry.negotiate("cpu")), consts)
    assert trace.header["deploy"]["budget"]["max_slots"] == \
        p_deploy.Budget().max_slots
    rep = trace.replay(deployment=dep)
    diff = trace.diff(rep)
    assert diff.tolerance == registry.KERNELS["circ_conv"].epsilon == 1e-3
    assert diff.n_compared == N_REQUESTS
    assert diff.ok, diff.describe()
    assert not any(f.field == "answer" for f in diff.failures)
    # the port's answers are the recorded ones
    for key, line in trace.results.items():
        assert int(rep.results[key].answer) == line["meta"]["answer"]


def test_port_recorded_trace_loads_in_the_reference(golden):
    from repro.serve import GoldenTrace as RefTrace
    from repro.serve import trace as r_trace

    _, _, trace, path = golden
    loaded = RefTrace.load(path)
    assert loaded.recorded_tags == trace.recorded_tags
    assert loaded.groups == trace.groups
    for lines in (loaded.requests, loaded.results):
        for key, line in lines.items():
            arrays = {k: r_trace._dec_array(v)
                      for k, v in line["arrays"].items()}
            assert r_trace._digest(arrays) == line["digest"], key
    spec = loaded.header["deploy"]
    assert r_deploy.Budget(**spec["budget"]).max_batch == 2
    assert r_deploy.Traffic(**spec["traffic"]) == r_deploy.Traffic(**TRAFFIC)
    # the reference's diff of the port's own results against the port's
    # recording: zero differences under the same tags
    rep = r_trace.ReplayReport(
        results={k: trace_result(v) for k, v in trace.results.items()},
        plan=_FixedPlan(trace.recorded_tags))
    diff = loaded.diff(rep)
    assert diff.tolerance == 0.0 and diff.ok, diff.describe()


class _FixedPlan:
    """A stand-in for the reference's LoweringPlan: only ``tags()``."""

    def __init__(self, tags):
        self._tags = tags

    def tags(self):
        return dict(self._tags)


def trace_result(line):
    from repro.serve.reason import ReasonResult

    return ReasonResult(uid=line["uid"], **p_trace._decode_payload(line))


# -- the committed fixture -----------------------------------------------------


def test_committed_fixture_is_the_reference_recording(tmp_path):
    """Re-record the fixture with the reference: the same groups, request
    digests and answers, log-probs within 1e-6, the same constants, and
    both files under 256 KB together."""
    trace, consts = record_reference_fixture(tmp_path / "fresh.jsonl")
    committed = p_trace.GoldenTrace.load(str(FIXTURE))
    assert FIXTURE.stat().st_size + FIXTURE_NPZ.stat().st_size < 256 * 1024
    assert committed.header == json.loads(json.dumps(trace.header))
    assert committed.groups == trace.groups
    assert {k: v["digest"] for k, v in committed.requests.items()} == \
        {k: v["digest"] for k, v in trace.requests.items()}
    assert len(committed.results) == FIXTURE_REQUESTS
    for key, line in trace.results.items():
        want = p_trace._decode_payload(line)
        got = p_trace._decode_payload(committed.results[key])
        assert got["answer"] == want["answer"], key
        for field in ("answer_logprobs", "rule_posteriors"):
            np.testing.assert_allclose(got[field], want[field], atol=1e-6,
                                       rtol=0)
    saved = interop.load_npz(FIXTURE_NPZ)
    flat = lambda t: interop._flatten(t, "", {})  # noqa: E731
    assert flat(saved).keys() == flat(consts).keys()
    for k, v in flat(consts).items():
        np.testing.assert_array_equal(flat(saved)[k], v)


def test_committed_fixture_replays_on_the_port():
    """The fixture through the port on the CPU, engines bound to its
    constants: within circ_conv's 1e-3, answers exact (``chip_smoke.py``
    replays it on the card the same way)."""
    trace = p_trace.GoldenTrace.load(str(FIXTURE))
    dep = bind_constants(trace.deploy(registry.negotiate("cpu")),
                         interop.load_npz(FIXTURE_NPZ))
    diff = trace.replay_and_diff(deployment=dep)
    assert diff.tolerance == 1e-3 and diff.n_compared == FIXTURE_REQUESTS
    assert diff.ok, diff.describe()
    assert diff.max_abs_err <= 1e-3


def test_npz_round_trip(tmp_path):
    tree = {"books": {"books": [np.arange(6.0).reshape(2, 3),
                                np.ones((1, 2), np.float32)],
                      "roles": np.zeros(4, np.int32)},
            "params": None, "w": torch.arange(3)}
    interop.save_npz(tmp_path / "t.npz", tree)
    got = interop.load_npz(tmp_path / "t.npz")
    assert set(got) == {"books", "w"}
    assert isinstance(got["books"]["books"], list)
    np.testing.assert_array_equal(got["books"]["books"][0], tree["books"]["books"][0])
    assert got["books"]["books"][1].dtype == np.float32
    np.testing.assert_array_equal(got["w"], np.arange(3))


if __name__ == "__main__":
    _, consts = record_reference_fixture(FIXTURE)
    interop.save_npz(FIXTURE_NPZ, consts)
    print(f"wrote {FIXTURE} ({FIXTURE.stat().st_size} B) and {FIXTURE_NPZ} "
          f"({FIXTURE_NPZ.stat().st_size} B)")
