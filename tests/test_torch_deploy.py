"""The port's ``deploy()`` against the reference's, on the CPU.

Four reasoners behind one front door, deployed by both packages: the
generator traces each pipeline, explores it with Algorithm 1 and derives
the serving plan.  ``DesignConfig.summary()`` and the ``ServingPlan`` must
be equal, at the reference's documented call (nvsa at d = 256, 4096 PEs)
and again at 16384 PEs with every model at d = 128.  ``synthetic_traffic``
must give the reference's arrival times and payloads, a served deployment
answers every request, and what the port does not have yet raises.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from repro_torch.backend import registry as p_registry
from repro_torch.configs import base as cb

# the modules (each package's ``serve`` exports the ``deploy`` function
# under the module's name)
r_deploy_mod = importlib.import_module("repro.serve.deploy")
p_deploy_mod = importlib.import_module("repro_torch.serve.deploy")

torch.set_num_threads(2)

MODELS = ["nvsa", "mimonet", "lvrf", "prae"]
# (name, traffic kwargs, budget kwargs, options): the call of the reference's
# documentation, then a second budget and width
CALLS = {
    "documented": ({"rate_rps": 20, "deadline_s": 0.02},
                   {"max_pes": 4096, "max_batch": 8}, {"nvsa": {"d": 256}}),
    "wide": ({}, {"max_pes": 16384, "max_batch": 8},
             {m: {"d": 128} for m in MODELS}),
}
# the reference's answer to the documented call (its deploy on the CPU)
DOCUMENTED = {
    "nvsa": ((2, 4, 8), 1, "overlap", "fused", (8, 32, 16), "13:3",
             "parallel", 409616, 437522, 32),
    "mimonet": ((2, 4, 8), 1, "sequential", "sequential", (8, 32, 16),
                "16:16", "sequential", 65408, 65408, 16),
    "lvrf": ((2, 4, 8), 1, "overlap", "fused", (8, 32, 16), "13:3",
             "parallel", 405506, 408260, 32),
    "prae": ((2, 4, 8), 1, "sequential", "sequential", (8, 32, 16), "16:16",
             "sequential", 373820, 373820, 32),
}
NVSA_MEMORY = {"MemA1": 589824, "MemA2": 589824, "MemB": 262144,
               "MemC": 1048576, "cache": 4980736}


class VirtualClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def sleep(self, dt: float):
        self.t += dt


def _deploy(mod, call, **kw):
    traffic, budget, options = CALLS[call]
    return mod.deploy(MODELS, mod.Traffic(**traffic), mod.Budget(**budget),
                      options=options, preflight="off", **kw)


_PAIRS: dict = {}


def _pair(call):
    """(call, reference deployment, port deployment on the CPU with a
    virtual clock), deployed once per module."""
    if call not in _PAIRS:
        clock = VirtualClock()
        _PAIRS[call] = (call, _deploy(r_deploy_mod, call),
                        _deploy(p_deploy_mod, call, device="cpu", clock=clock,
                                sleep=clock.sleep))
    return _PAIRS[call]


@pytest.fixture(scope="module", params=sorted(CALLS))
def pair(request):
    return _pair(request.param)


def test_designs_and_plans_equal(pair):
    call, ref, port = pair
    assert list(port.engines) == list(ref.engines) == MODELS
    for m in MODELS:
        assert port.designs[m].summary() == ref.designs[m].summary(), m
        assert dataclasses.asdict(port.designs[m]) == \
            dataclasses.asdict(ref.designs[m]), m
        assert dataclasses.asdict(port.plans[m]) == \
            dataclasses.asdict(ref.plans[m]), m
        # the fused upgrade of an overlap plan, and the engine's knobs
        for field in ("schedule", "batch_size", "max_inflight", "buckets",
                      "variant"):
            assert getattr(port.engines[m].cfg, field) == \
                getattr(ref.engines[m].cfg, field), (m, field)
        assert port.variants[m] == ref.variants[m]


def test_documented_call_gives_the_documented_table():
    call, ref, port = _pair("documented")
    for m, row in DOCUMENTED.items():
        plan, s = port.plans[m], port.designs[m].summary()
        got = (plan.buckets, plan.max_inflight, plan.schedule,
               port.engines[m].cfg.schedule, s["AdArray (H, W, N)"],
               s["partition"], s["mode"], s["t_para_cycles"],
               s["t_seq_cycles"], s["SIMD"])
        assert got == row, m
    s = port.designs["nvsa"].summary()
    assert {k: s[k] for k in NVSA_MEMORY} == NVSA_MEMORY


def test_report_keeps_the_reference_keys(pair):
    call, ref, port = pair
    want, got = ref.report(), port.report()
    assert set(got) == set(want)
    for m in MODELS:
        assert set(got[m]) == set(want[m]), m
        assert set(got[m]["serving"]) == set(want[m]["serving"]), m
        assert got[m]["design"] == want[m]["design"]
        assert got[m]["serving"]["fused"]["ok"] == \
            want[m]["serving"]["fused"]["ok"]
        # the device's lowering record, under the reference record's keys
        assert set(got[m]["backend"]) == set(want[m]["backend"])
        assert got[m]["backend"]["platform"] == "cpu"
        assert set(got[m]["backend"]["lowerings"]) == set(p_registry.KERNELS)
        assert got[m]["mesh"] is None
        assert got[m]["replicas"] == 1 and got[m]["per_replica"] is None
    assert got["analysis"] is None and got["control"] is None
    assert "dse=8x32x" in port.summary()
    assert "backend=cpu/torch" in port.summary()


def test_synthetic_traffic_equals_the_reference(pair):
    """32 requests per model: the reference's arrival times, order and
    payloads."""
    call, ref, port = pair
    want, want_truth = ref.synthetic_traffic(32)
    got, got_truth = port.synthetic_traffic(32)
    want, got = list(want), list(got)
    assert [(a.t, a.model, a.request.uid) for a in got] == \
        [(a.t, a.model, a.request.uid) for a in want]
    for a, b in zip(got, want):
        for field in ("context", "candidates", "context_attrs",
                      "candidate_attrs", "images"):
            x, y = getattr(a.request, field), getattr(b.request, field)
            assert (x is None) == (y is None), field
            if x is not None:
                np.testing.assert_array_equal(x, y)
    for m in MODELS:
        np.testing.assert_array_equal(got_truth[m](), want_truth[m]())


def test_served_deployment_answers_everything():
    """Warmed up, then 8 requests per model through the one front door on
    the virtual clock (at the narrower width, to keep it short): every
    request answered, every bucket a compiled one, and nvsa's answers
    equal to an offline run of its engine."""
    call, ref, port = _pair("wide")
    port.warmup()
    arrivals, truths = port.synthetic_traffic(8)
    report = port.serve(arrivals)
    for m in MODELS:
        assert sorted(report.results[m]) == list(range(8)), m
        for g in report.groups:
            assert g.bucket in port.plans[g.model].buckets
    assert not report.shed
    factory, _ = cb.REASON_WORKLOADS["nvsa"].make_requests(
        port.configs["nvsa"], 8, seed=100 + MODELS.index("nvsa"))
    offline = port.engines["nvsa"].run(factory())
    for uid, res in offline.items():
        np.testing.assert_allclose(report.results["nvsa"][uid].answer_logprobs,
                                   res.answer_logprobs, atol=1e-3, rtol=0)


def test_controller_attaches_as_in_the_reference():
    """``slo_ms`` / ``queue_depth`` attach the overload controller with the
    serving plan as its operating point."""
    budget = {"max_pes": 4096, "max_batch": 8, "slo_ms": 50.0,
              "queue_depth": 16}
    reps = [mod.deploy(["mimonet"], budget=mod.Budget(**budget),
                       preflight="off", **kw).report()["control"]
            for mod, kw in ((r_deploy_mod, {}), (p_deploy_mod, {"device": "cpu"}))]
    assert reps[0] == reps[1] and reps[1]["queue_depth"] == 16


@pytest.mark.parametrize("budget, match", [
    ({"devices": 2}, "#3d and #6"), ({"replicas": 2}, "#3d and #6"),
    ({"replicas": "auto"}, "#3d and #6"), ({"tp": 2}, "#3d and #6")])
def test_unported_budgets_raise(budget, match):
    with pytest.raises(NotImplementedError, match=match):
        p_deploy_mod.deploy(["nvsa"], budget=p_deploy_mod.Budget(**budget),
                            device="cpu")


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="#3e"):
        p_deploy_mod.deploy(["nvsa"], backend="xla", device="cpu")
    for preflight in ("error", "warn"):
        with pytest.raises(NotImplementedError, match="#7"):
            p_deploy_mod.deploy(["nvsa"], preflight=preflight, device="cpu")
    with pytest.raises(KeyError, match="#4 item 3"):
        p_deploy_mod.deploy(["nvsa", "rwkv6-7b"], device="cpu")
    with pytest.raises(ValueError, match="preflight must be"):
        p_deploy_mod.deploy(["nvsa"], preflight="strict", device="cpu")
    with pytest.raises(ValueError, match="at least one workload"):
        p_deploy_mod.deploy([], device="cpu")
