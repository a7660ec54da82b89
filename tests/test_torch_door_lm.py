"""LM traffic behind the port's front door, in ``deploy()`` and in golden
traces, against the JAX reference on the CPU.

Both packages deploy nvsa (oracle, d = 128, so binds take circ_conv's
route) beside llama3.2-3b's smoke arch behind one front door, on a virtual
clock.  The LM computes at f32 here (each package's registry entry is
patched to its f32 smoke config), and the port's engines are bound to the
reference's parameters and constants.  The reports agree apart from the
mesh point; the synthetic traffic is the reference's; served through the
door, the groups, the latencies and the token streams are the
reference's, the NSAI answers equal with log-probs within circ_conv's
1e-3.  An lm-class trace the JAX package records replays on the port
with equal tokens, and one the port records loads in the reference's
``GoldenTrace`` with its digests holding.

The reference's own mixed test
(``test_runtime.py::test_mixed_lm_nsai_frontdoor_bit_identical``) fails
in the reference, so these tests compare with what the reference computes.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro_torch import interop
from repro_torch.backend import registry
from repro_torch.configs import ARCHS as PARCHS
from repro_torch.serve import trace as p_trace

torch.set_num_threads(2)

r_deploy = importlib.import_module("repro.serve.deploy")
p_deploy = importlib.import_module("repro_torch.serve.deploy")

LM = "llama3.2-3b"
MODELS = ["nvsa", LM]
TRAFFIC = {"rate_rps": 50.0, "deadline_s": 0.01}
BUDGET = {"max_pes": 1024, "max_batch": 4, "max_slots": 2, "max_len": 64,
          "max_new_tokens": 6}
OPTIONS = {"nvsa": {"variant": "oracle", "d": 128}}
N_REQUESTS = 6          # per model


class VirtualClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def sleep(self, dt: float):
        self.t += dt


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy_tree(v) for v in tree]
    return None if tree is None else np.asarray(tree)


@pytest.fixture(scope="module")
def f32_lm():
    """Each package's registry entry of the LM, patched to compute at f32."""
    mp = pytest.MonkeyPatch()
    for archs, dtype in ((JARCHS, jnp.float32), (PARCHS, torch.float32)):
        arch = archs[LM]
        mp.setitem(archs, LM, dataclasses.replace(
            arch, make_smoke=lambda make=arch.make_smoke, dtype=dtype:
            dataclasses.replace(make(), compute_dtype=dtype)))
    yield
    mp.undo()


def _deploy(mod, **kw):
    clock = VirtualClock()
    return mod.deploy(MODELS, mod.Traffic(**TRAFFIC), mod.Budget(**BUDGET),
                      seed=3, options=OPTIONS, clock=clock,
                      sleep=clock.sleep, **kw)


def bind_reference(port, ref):
    """Bind the reference deployment's LM parameters and NSAI constants onto
    the port deployment's engines."""
    port.engines[LM].params = interop.from_reference(
        jax.tree.map(np.asarray, ref.engines[LM].params), "cpu")
    nvsa = port.engines["nvsa"]
    nvsa.consts = {**nvsa.consts, **interop.from_reference(
        _numpy_tree(ref.engines["nvsa"].consts), "cpu")}
    return port


@pytest.fixture(scope="module")
def pair(f32_lm):
    ref = _deploy(r_deploy)
    return ref, bind_reference(_deploy(p_deploy, device="cpu"), ref)


@pytest.fixture(scope="module")
def served(pair, tmp_path_factory):
    """The same traffic through each deployment's door, the reference's
    recorded: its report, the port's, and the path of its trace."""
    from repro.serve import trace as r_trace

    ref, port = pair
    path = str(tmp_path_factory.mktemp("lm_trace") / "jax_lm.jsonl")
    want, _ = r_trace.record(ref, ref.synthetic_traffic(N_REQUESTS)[0], path)
    got = port.serve(port.synthetic_traffic(N_REQUESTS)[0])
    return want, got, path


def test_deploy_reports_equal_apart_from_mesh(pair):
    ref, port = pair
    want, got = ref.report(), port.report()
    assert set(got) == set(want)
    assert port.classes == ref.classes == {"nvsa": "reason", LM: "lm"}
    for m in MODELS:
        w, g = dict(want[m]), dict(got[m])
        # the mesh co-search's point: the reference's factorisation and
        # keys, its times under the port's H100 table
        gm, wm = g.pop("mesh"), w.pop("mesh")
        assert set(gm) == set(wm) and (gm["data"], gm["model"]) == (wm["data"], wm["model"])
        wb, gb = w.pop("backend"), g.pop("backend")
        assert set(gb) == set(wb) and gb["platform"] == "cpu"
        if m == LM:
            assert g == w
        else:
            ws, gs = w.pop("serving"), g.pop("serving")
            assert g == w
            assert {k: v for k, v in gs.items() if k != "fused"} == \
                {k: v for k, v in ws.items() if k != "fused"}
            assert gs["fused"]["ok"] == ws["fused"]["ok"]
    assert f"{LM} [lm]: max_slots=2 max_len=64 decode_block=8 | " \
        "dse=n/a (single nn stream) | mesh=1x1 bound=" in port.summary()
    assert port.configs[LM] == dataclasses.replace(
        PARCHS[LM].make_smoke(), compute_dtype=torch.float32)


def test_synthetic_traffic_equals_the_reference(pair):
    ref, port = pair
    want, got = list(ref.synthetic_traffic(8)[0]), list(port.synthetic_traffic(8)[0])
    assert [(a.t, a.model, a.request.uid) for a in got] == \
        [(a.t, a.model, a.request.uid) for a in want]
    lm = [(a, b) for a, b in zip(got, want) if a.model == LM]
    assert len(lm) == 8
    for a, b in lm:
        np.testing.assert_array_equal(a.request.prompt, b.request.prompt)
        assert len(a.request.prompt) == min(16, BUDGET["max_len"]
                                            - BUDGET["max_new_tokens"])


def test_mixed_door_serves_the_reference_groups_and_tokens(served):
    """One door over nvsa and the LM: the reference's groups and latencies,
    its token streams, and its NSAI answers (log-probs within 1e-3)."""
    want, got, _ = served
    fields = ("model", "uids", "bucket", "size", "close_reason")
    assert [tuple(getattr(g, f) for f in fields) for g in got.groups] == \
        [tuple(getattr(g, f) for f in fields) for g in want.groups]
    assert {g.model for g in got.groups} == set(MODELS)
    assert [dataclasses.astuple(l) for l in got.latencies] == \
        [dataclasses.astuple(l) for l in want.latencies]
    assert sorted(got.results[LM]) == list(range(N_REQUESTS))
    for uid, res in want.results[LM].items():
        np.testing.assert_array_equal(got.results[LM][uid].tokens, res.tokens)
        assert len(res.tokens) == BUDGET["max_new_tokens"]
    for uid, res in want.results["nvsa"].items():
        assert int(got.results["nvsa"][uid].answer) == int(res.answer)
        np.testing.assert_allclose(got.results["nvsa"][uid].answer_logprobs,
                                   np.asarray(res.answer_logprobs), atol=1e-3,
                                   rtol=0)
    assert got.work_unit(LM) == "tok" and got.work_unit("nvsa") == "prob"
    assert f"({got.work_per_s(LM):.1f} tok/s)" in got.summary()


def test_door_streams_equal_offline_runs(pair, served):
    """The LM's streams through the door equal its engine's offline run of
    the same requests (the engine is slot-invariant), and a warmed-up
    deployment serves the same."""
    _, port = pair
    _, got, _ = served
    streams, _ = port._streams(N_REQUESTS, seed=100)
    offline = port.engines[LM].run(list(streams[LM]))
    for uid, res in got.results[LM].items():
        np.testing.assert_array_equal(res.tokens, offline[uid].tokens)
    port.warmup()
    assert port.engines[LM].stats["measured"]["requests"] + \
        port.engines[LM].stats["warmup"]["requests"] >= BUDGET["max_slots"]


def test_jax_recorded_lm_trace_replays_on_the_port(pair, served):
    """The mixed trace the JAX package recorded replays through the port's
    engines (bound to the reference's parameters): tokens exact, NSAI
    answers exact and log-probs within circ_conv's 1e-3."""
    _, port = pair
    trace = p_trace.GoldenTrace.load(served[2])
    assert trace.header["models"][LM] == {"class": "lm", "variant": None}
    assert trace.header["deploy"]["budget"]["max_slots"] == BUDGET["max_slots"]
    rep = trace.replay(deployment=port)
    # the engine decodes token by token, so only nvsa's binds call a kernel
    assert rep.kernels == {"circ_conv"}
    diff = trace.diff(rep)
    assert diff.n_compared == 2 * N_REQUESTS
    assert diff.ok, diff.describe()
    assert diff.max_abs_err <= 1e-3
    for (m, uid), line in trace.results.items():
        if m == LM:
            np.testing.assert_array_equal(
                rep.results[(m, uid)].tokens,
                p_trace._decode_payload(line)["tokens"])


def test_port_recorded_lm_trace(f32_lm, tmp_path):
    """A trace the port records of the mixed deployment: it replays
    bit-exact through the same and a fresh deployment, and it loads in the
    reference's ``GoldenTrace`` with its digests holding and no difference
    under its own tags."""
    from repro.serve import GoldenTrace as RefTrace
    from repro.serve import trace as r_trace
    from repro.serve.engine import Result as RefResult
    from repro.serve.reason import ReasonResult

    port = _deploy(p_deploy, device="cpu")
    path = str(tmp_path / "port_lm.jsonl")
    report, trace = p_trace.record(port, port.synthetic_traffic(N_REQUESTS)[0], path)
    assert len(trace.results) == 2 * N_REQUESTS
    for kw in ({"deployment": port}, {"backend": registry.negotiate("cpu")}):
        diff = p_trace.GoldenTrace.load(path).replay_and_diff(**kw)
        assert diff.tolerance == 0.0 and diff.n_compared == 2 * N_REQUESTS
        assert diff.ok, diff.describe()
    loaded = RefTrace.load(path)
    assert loaded.groups == trace.groups
    for lines in (loaded.requests, loaded.results):
        for key, line in lines.items():
            arrays = {k: r_trace._dec_array(v) for k, v in line["arrays"].items()}
            assert r_trace._digest(arrays) == line["digest"], key
    classes = {LM: RefResult, "nvsa": ReasonResult}
    rep = r_trace.ReplayReport(
        results={k: classes[k[0]](uid=v["uid"], **p_trace._decode_payload(v))
                 for k, v in trace.results.items()},
        plan=_FixedPlan(trace.recorded_tags))
    diff = loaded.diff(rep)
    assert diff.tolerance == 0.0 and diff.ok, diff.describe()


class _FixedPlan:
    """A stand-in for the reference's LoweringPlan: only ``tags()``."""

    def __init__(self, tags):
        self._tags = tags

    def tags(self):
        return dict(self._tags)
