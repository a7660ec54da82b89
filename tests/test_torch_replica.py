"""The port's replica pool against the reference's, on the CPU.

``repro_torch.serve.replica`` is the port's copy of
``repro.serve.replica``.  The reference's ``ReplicaPool`` and the port's,
each over the same port engines, must route, merge stats, split per
replica, drain and break down a front door's report alike on a virtual
clock; answers must not depend on the replica count;
``configs.base.reason_engine_pool`` places constants, shares the compiled
schedules and returns the bare engine at one replica; and ``Deployment``
reads a pool as the reference's does.
"""

import dataclasses
import importlib

import pytest
import torch

from repro.serve import frontdoor as r_fd
from repro.serve import replica as r_rep
from repro_torch.configs import base as cb
from repro_torch.serve import frontdoor as p_fd
from repro_torch.serve import replica as p_rep
from repro_torch.serve import runtime as p_rt
from repro_torch.serve.reason import ReasonConfig

torch.set_num_threads(2)

p_deploy_mod = importlib.import_module("repro_torch.serve.deploy")

D = 128      # the kernels' dispatch floor: binds take circ_conv's route
N_REQ = 12


class VirtualClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def sleep(self, dt: float):
        assert dt >= 0
        self.t += dt


def _cfg():
    return cb.REASON_WORKLOADS["nvsa"].make_config(d=D)


def _consts(cfg):
    return cb.REASON_WORKLOADS["nvsa"].make_consts(
        cfg, torch.Generator().manual_seed(1))


def _port_pool(replicas, batch_size=4, buckets=(2, 4), max_inflight=2):
    """An oracle nvsa pool of the port on the CPU (a pool even at 1), its
    engines on a frozen wall clock, so stats hold no host time."""
    cfg = _cfg()
    eng = cb.reason_engine_pool(
        "nvsa", cfg, ReasonConfig(batch_size=batch_size, buckets=buckets,
                                  max_inflight=max_inflight),
        consts=_consts(cfg), variants=("oracle",), replicas=replicas,
        device="cpu")
    pool = eng if isinstance(eng, p_rep.ReplicaPool) else \
        p_rep.ReplicaPool([eng])
    for r in pool.replicas:
        r.wall = lambda: 0.0
    return cfg, pool


def _requests(cfg, n=N_REQ, seed=3):
    factory, _ = cb.REASON_WORKLOADS["nvsa"].make_requests(cfg, n, seed=seed)
    return list(factory())


def _pools(replicas, **kw):
    """The same port engines behind the reference's pool and the port's:
    two engine sets built alike, one per pool."""
    cfg, a = _port_pool(replicas, **kw)
    _, b = _port_pool(replicas, **kw)
    return cfg, r_rep.ReplicaPool(a.replicas), b


def _answers(results):
    return {u: (int(r.answer), r.answer_logprobs.tobytes())
            for u, r in results.items()}


# -- construction + validation ------------------------------------------------


def test_pool_rejects_empty_and_mismatched_caps():
    with pytest.raises(ValueError, match="at least one"):
        p_rep.ReplicaPool([])
    _, two = _port_pool(1, batch_size=2, buckets=(2,))
    _, four = _port_pool(1)
    with pytest.raises(ValueError, match="admission_cap"):
        p_rep.ReplicaPool(two.replicas + four.replicas)


def test_reason_engine_pool_unwraps_single_replica():
    cfg = _cfg()
    consts = _consts(cfg)
    rcfg = ReasonConfig(batch_size=4)
    one = cb.reason_engine_pool("nvsa", cfg, rcfg, consts=consts,
                                variants=("oracle",), replicas=1,
                                device="cpu")
    assert not isinstance(one, p_rep.ReplicaPool)
    three = cb.reason_engine_pool("nvsa", cfg, rcfg, consts=consts,
                                  variants=("oracle",), replicas=3,
                                  device="cpu")
    assert isinstance(three, p_rep.ReplicaPool) and len(three) == 3
    # one device: the replicas share the compiled StagedSchedules, and each
    # has its own ReasonConfig copy and in-flight window
    assert all(r.schedules["oracle"] is three.replicas[0].schedules["oracle"]
               for r in three.replicas)
    assert len({id(r.cfg) for r in three.replicas}) == 3
    assert all(r.device == torch.device("cpu") for r in three.replicas)
    books = three.replicas[0].consts["books"]["roles"]
    assert all(torch.equal(r.consts["books"]["roles"], books)
               for r in three.replicas)
    with pytest.raises(ValueError, match="replicas"):
        cb.reason_engine_pool("nvsa", cfg, rcfg, consts=consts, replicas=0,
                              device="cpu")
    with pytest.raises(ValueError, match="real consts"):
        cb.reason_engine_pool("nvsa", cfg, rcfg, replicas=2, device="cpu")


@pytest.mark.parametrize("trees", [
    [{"n": 1, "nested": {"x": 2.0}, "lst": [1, 2], "flag": True, "name": "a"},
     {"n": 3, "nested": {"x": 0.5, "y": 7}, "lst": [10, 20], "flag": True,
      "name": "b"}],
    [{"measured": {"requests": 2, "work": 2, "wall_time_s": 0.5}},
     None, {"measured": {"requests": 1, "work": 1, "wall_time_s": 0.25},
            "stage_time_s": {"oracle": {"s": 1.0}}}],
    [{"lst": [1, 2]}, {"lst": [1, 2, 3]}], [None], []])
def test_merge_stats_equals_the_reference(trees):
    assert p_rep._merge_stats(trees) == r_rep._merge_stats(trees)


# -- routing + protocol surface ----------------------------------------------


def test_routing_stats_and_drains_equal_the_reference():
    """Back-to-back groups, a partial drain, more groups, then a full drain:
    the same replica per group, dispatch counters, per-replica split,
    merged stats and answers from both pools."""
    cfg, ref, port = _pools(3, max_inflight=2)
    reqs = _requests(cfg, 24)
    out = []
    for pool in (ref, port):
        recs = [pool.submit(reqs[i:i + 4]) for i in (0, 4, 8, 12)]
        first = pool.drain_ready()
        recs += [pool.submit(reqs[i:i + 4]) for i in (16, 20)]
        results = {**first, **pool.drain_all()}
        out.append(([r.replica for r in recs], pool.dispatched_groups,
                    pool.dispatched_requests, pool.per_replica(), pool.stats,
                    pool.observation(), _answers(results)))
    assert out[0] == out[1]
    routed, groups, requests, split, stats, obs, answers = out[1]
    assert routed[:4] == [0, 1, 2, 0]
    assert sum(groups) == 6 and sum(requests) == 24 and len(answers) == 24
    assert [r["replica"] for r in split] == [0, 1, 2]
    assert stats["batches"] == 6 and obs["inflight"] == 0


def test_run_merges_results_and_conserves_work():
    cfg, p1 = _port_pool(1)
    _, p4 = _port_pool(4)
    reqs = _requests(cfg)
    r1, r4 = p1.run(list(reqs)), p4.run(list(reqs))
    assert _answers(r1) == _answers(r4)
    for p in (p1, p4):
        s = p.stats
        assert s["measured"]["work"] + s["warmup"]["work"] == N_REQ
        assert p.runs[-1]["requests"] == N_REQ
    assert sum(p_rt.work_units(r) for r in r4.values()) == N_REQ
    assert sum(p4.dispatched_requests) == N_REQ
    p4.reset_stats()
    assert p4.stats["measured"]["work"] == 0 and p4.runs == []
    assert p4.dispatched_groups == [0] * 4


def test_pool_clock_fans_out_to_replicas():
    _, pool = _port_pool(2)
    clock = VirtualClock()
    pool.clock = clock
    assert all(r.clock is clock for r in pool.replicas)
    assert pool.clock is clock


# -- front door: the reference's door and the port's ---------------------------


def _serve(fd, pool, cfg, n=N_REQ, deadline_s=0.05):
    clock = VirtualClock()
    door = fd.FrontDoor({"nvsa": pool}, fd.FrontDoorConfig(deadline_s=deadline_s),
                        clock=clock, sleep=clock.sleep)
    arrivals = fd.poisson_arrivals("nvsa", _requests(cfg, n), rate_rps=200.0,
                                   seed=11)
    return door.serve(arrivals)


def test_door_breakdown_equals_the_reference():
    """The same arrivals through the reference's door over the reference's
    pool and the port's door over the port's: equal groups (with their
    replica), breakdown, summary lines and answers."""
    cfg, ref, port = _pools(4)
    want, got = _serve(r_fd, ref, cfg), _serve(p_fd, port, cfg)
    fields = [f.name for f in dataclasses.fields(p_fd.ServedGroup)]
    assert [tuple(getattr(g, f) for f in fields) for g in got.groups] == \
        [tuple(getattr(g, f) for f in fields) for g in want.groups]
    assert all(g.replica is not None for g in got.groups)
    bd = got.replica_breakdown("nvsa")
    assert bd == want.replica_breakdown("nvsa")
    assert sum(r["requests"] for r in bd.values()) == N_REQ
    assert abs(sum(r["share"] for r in bd.values()) - 1.0) < 1e-9
    line = [l for l in got.summary().splitlines() if "replicas r" in l]
    assert line == [l for l in want.summary().splitlines() if "replicas r" in l]
    assert line
    assert _answers(got.results["nvsa"]) == _answers(want.results["nvsa"])


def test_door_answers_invariant_under_replica_count():
    cfg, p1 = _port_pool(1)
    _, p4 = _port_pool(4)
    rep1, rep4 = _serve(p_fd, p1, cfg), _serve(p_fd, p4, cfg)
    assert [g.uids for g in rep1.groups] == [g.uids for g in rep4.groups]
    assert _answers(rep1.results["nvsa"]) == _answers(rep4.results["nvsa"])


def test_bare_engine_reports_no_breakdown():
    cfg = _cfg()
    bare = cb.reason_engine("nvsa", cfg, ReasonConfig(batch_size=4,
                                                      max_inflight=2),
                            consts=_consts(cfg), variants=("oracle",),
                            device="cpu")
    rep = _serve(p_fd, bare, cfg, n=4)
    assert rep.replica_breakdown("nvsa") is None
    assert all(g.replica is None for g in rep.groups)
    assert "replicas r" not in rep.summary()


# -- deploy reads a pool --------------------------------------------------------


def test_deployment_reports_and_warms_a_pool():
    dep = p_deploy_mod.deploy(
        ["nvsa"], budget=p_deploy_mod.Budget(max_batch=4),
        options={"nvsa": {"d": D, "variant": "oracle"}}, device="cpu")
    eng = dep.engines["nvsa"]
    pool = cb.reason_engine_pool("nvsa", dep.configs["nvsa"],
                                 dataclasses.replace(eng.cfg),
                                 consts=eng.consts, variants=("oracle",),
                                 replicas=2, device="cpu")
    dep.engines["nvsa"] = pool
    dep.warmup()
    rec = dep.report()["nvsa"]
    assert rec["replicas"] == 2
    assert [r["replica"] for r in rec["per_replica"]] == [0, 1]
    assert all(r["work"] > 0 for r in rec["per_replica"])
    assert rec["serving"]["batch_size"] == eng.cfg.batch_size
    assert rec["serving"]["dispatches"] == pool.stats["dispatches"]
    assert "nvsa replicas: r0:" in dep.summary()
