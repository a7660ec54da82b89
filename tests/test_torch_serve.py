"""The port's serving path against the reference's, on the CPU.

The whole NVSA engine (``configs.base.reason_engine``) of both packages on
the same requests and constants, the port's three schedules against each
other, its protocol surface driven by the reference's ``FrontDoor``, and
the device rule of its entry points.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from test_torch_nvsa import ref_books, ref_params

from repro.configs import base as jcb
from repro.serve import frontdoor as fd
from repro.serve import reason as jreason
from repro.serve.control import OverloadController
from repro.serve.slo import slo_targets
from repro_torch import interop
from repro_torch.backend import registry
from repro_torch.configs import base as cb
from repro_torch.data import raven
from repro_torch.serve.reason import ReasonConfig, requests_from_batch

torch.set_num_threads(2)

N_REQ = 6


class VirtualClock:
    """Deterministic clock + sleep pair for driving the serve loop."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def sleep(self, dt: float):
        assert dt >= 0
        self.t += dt


@pytest.fixture(scope="module")
def case():
    """d=128 (the kernel route), a narrow CNN, buckets (2, 4): 6 requests
    make one group of 4 and one of 2."""
    kw = dict(cnn_width=8, cnn_feat=32)
    cfg = dataclasses.replace(cb.REASON_WORKLOADS["nvsa"].make_config(d=128), **kw)
    jcfg = dataclasses.replace(jcb.REASON_WORKLOADS["nvsa"].make_config(d=128), **kw)
    consts = {"params": ref_params(jcfg, seed=5), "books": ref_books(128, blocks=4)}
    batch = raven.generate_batch(cfg.raven, seed=3, n=N_REQ)
    eng = cb.reason_engine("nvsa", cfg, ReasonConfig(batch_size=4, buckets=(2, 4)),
                           consts=interop.from_reference(consts, "cpu"),
                           device="cpu")
    return cfg, jcfg, consts, batch, eng


def _requests(batch):
    return requests_from_batch(batch)


@pytest.mark.parametrize("variant", ["oracle", "cnn"])
def test_engine_matches_reference_engine(case, variant):
    """Log-probs and rule posteriors within 1e-3 (circ_conv's registry
    epsilon), the same answers; oracle answers are all right."""
    cfg, jcfg, consts, batch, eng = case
    jeng = jcb.reason_engine(
        "nvsa", jcfg, jreason.ReasonConfig(batch_size=4, buckets=(2, 4)),
        consts=jax.tree.map(np.asarray, consts), variants=(variant,),
        trace_graph=False)
    want = jeng.run(jreason.requests_from_batch(batch))
    got = eng.run(_requests(batch), variant=variant)
    assert sorted(got) == sorted(want) == list(range(N_REQ))
    for uid in want:
        np.testing.assert_allclose(got[uid].answer_logprobs,
                                   want[uid].answer_logprobs, atol=1e-3, rtol=0)
        np.testing.assert_allclose(got[uid].rule_posteriors,
                                   want[uid].rule_posteriors, atol=1e-3, rtol=0)
        assert got[uid].answer == want[uid].answer
    if variant == "oracle":
        assert [got[u].answer for u in range(N_REQ)] == list(batch["answer"])


def test_schedules_give_identical_answers(case):
    """overlap, fused and sequential run the same functions: bitwise equal
    answers; dispatch counts are 2 per staged group and 1 per fused group."""
    cfg, _, _, batch, eng = case
    eng.reset_stats()
    runs = {s: eng.run(_requests(batch), schedule=s, variant="cnn")
            for s in ("overlap", "fused", "sequential")}
    for s in ("fused", "sequential"):
        for uid, res in runs["overlap"].items():
            np.testing.assert_array_equal(runs[s][uid].answer_logprobs,
                                          res.answer_logprobs)
    assert eng.stats["batches"] == 6 and eng.stats["fused_groups"] == 2
    assert eng.stats["dispatches"] == 2 * 2 + 2 + 2 * 2
    assert set(eng.stats["stage_time_s"]["cnn"]) == {"frontend", "symbolic"}
    sched = eng.schedules["cnn"]
    assert sched.fused_ok and sched.batch_buckets == (2, 4)
    assert sched.describe().startswith("frontend[nn] --")
    pmf = sched.buffers[1].shapes[0]  # the frontend's context PMFs
    assert [s.shape for s in pmf] == [(4, 8, n) for n in cfg.raven.attr_sizes]
    assert sched.buffers[-1].shapes[0].shape == (4, 8)
    assert registry.LAUNCHES == dict.fromkeys(registry.KERNELS, 0)


def test_frontdoor_drives_port_engine(case):
    """The reference's FrontDoor, with its overload controller, serves the
    port's engine on a virtual clock: nothing shed, every uid answered,
    answers equal to the port's offline run."""
    cfg, _, consts, batch, _ = case
    eng = cb.reason_engine("nvsa", cfg,
                           ReasonConfig(batch_size=4, buckets=(2, 4),
                                        max_inflight=2),
                           consts=interop.from_reference(consts, "cpu"),
                           variants=("oracle",), device="cpu")
    clock = VirtualClock()
    door = fd.FrontDoor({"nvsa": eng}, fd.FrontDoorConfig(deadline_s=0.02),
                        clock=clock, sleep=clock.sleep,
                        controller=OverloadController(slo_targets(1000.0)))
    times = [0.0, 0.001, 0.002, 0.003, 0.05, 0.2]
    rep = door.serve(fd.trace_arrivals("nvsa", times, _requests(batch)))
    assert rep.shed == []
    assert sorted(rep.results["nvsa"]) == list(range(N_REQ))
    assert sum(g.size for g in rep.groups) == N_REQ
    assert all(l.service_s >= 0 for l in rep.latencies)
    assert eng.inflight == 0 and eng.accepting
    offline = eng.run(_requests(batch))
    for uid, res in rep.results["nvsa"].items():
        np.testing.assert_array_equal(res.answer_logprobs,
                                      offline[uid].answer_logprobs)


def test_inflight_window_and_drain(case):
    cfg, _, consts, batch, _ = case
    eng = cb.reason_engine("nvsa", cfg,
                           ReasonConfig(batch_size=2, buckets=(2,), max_inflight=2),
                           consts=interop.from_reference(consts, "cpu"),
                           variants=("oracle",), device="cpu")
    reqs = _requests(batch)
    recs = [eng.submit(reqs[i:i + 2]) for i in range(0, N_REQ, 2)]
    assert eng.inflight == 2 and not eng.accepting
    assert recs[0].done_t is not None and recs[2].done_t is None
    with pytest.raises(ValueError, match="duplicate request uid"):
        eng.submit(reqs[4:5])
    out = eng.drain_ready()  # CPU groups are done once dispatched
    out.update(eng.drain_all())
    assert sorted(out) == list(range(N_REQ)) and eng.inflight == 0
    assert eng.stats["warmup"]["requests"] == 2
    assert eng.stats["measured"]["requests"] == 4 and eng.problems_per_s() > 0


def test_entry_points_raise_without_cuda(case, monkeypatch):
    """device=None means CUDA; without it every entry point raises rather
    than carry on on the CPU."""
    cfg, _, consts, _, _ = case
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cb.reason_engine("nvsa", cfg, consts=None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cb.compile_reason_schedule("nvsa", cfg, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        interop.from_reference(consts)
    assert cb.compile_reason_schedule("nvsa", cfg, device="cpu").device.type == "cpu"
