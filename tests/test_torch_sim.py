"""The port's two simulators against the reference's, on the CPU.

``repro_torch.serve.sim`` (the deterministic ``SimEngine`` and the bursty
arrival streams of the control-plane soak) and ``repro_torch.core.
simulator`` (the device-level model of the paper's Fig. 5 / 6) are the
port's copies.  On a virtual clock, through the reference's front door and
the port's, with and without the overload controller, the simulated
engine must serve the same groups, latencies, sheds and decisions; the
arrival streams must be equal float for float; and the three simulators
must give the reference's numbers to float equality on the paper graphs,
the matmul-heavy graph and a torch-traced NVSA pipeline.
"""

import dataclasses

import pytest
from _hypothesis_compat import given, settings, st

from repro.core import opgraph as r_og
from repro.core import simulator as r_sim
from repro.core import workloads as r_wl
from repro.serve import control as r_ctl
from repro.serve import frontdoor as r_fd
from repro.serve import sim as r_se
from repro.serve import slo as r_slo
from repro_torch.configs import base as cb
from repro_torch.core import opgraph as p_og
from repro_torch.core import simulator as p_sim
from repro_torch.core import workloads as p_wl
from repro_torch.serve import control as p_ctl
from repro_torch.serve import frontdoor as p_fd
from repro_torch.serve import schedule as p_sch
from repro_torch.serve import sim as p_se
from repro_torch.serve import slo as p_slo

GRAPHS = sorted(r_wl.WORKLOADS) + ["matmul_heavy"]
BURSTS = ((30.0, 20.0, 4.0), (120.0, 10.0, 8.0))
MIX = {"interactive": 0.3, "standard": 0.5, "batch": 0.2}


class VirtualClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def sleep(self, dt: float):
        assert dt >= 0
        self.t += dt


def _astuples(items):
    return [dataclasses.astuple(x) for x in items]


# -- arrival streams ---------------------------------------------------------------


@settings(max_examples=10, deadline=None)
@given(n=st.integers(1, 300), rate=st.floats(1.0, 2000.0),
       amp=st.floats(0.0, 0.9), seed=st.integers(0, 10_000))
def test_bursty_times_equal(n, rate, amp, seed):
    def times(se):
        bursts = [se.Burst(*b) for b in BURSTS]
        return se.bursty_times(n, rate, amp=amp, period_s=600.0,
                               bursts=bursts, seed=seed, start_s=1.5)

    assert times(p_se) == times(r_se)


@pytest.mark.parametrize("t", [0.0, 29.9, 30.0, 45.0, 125.0, 400.0, 3599.0])
def test_diurnal_rate_equal(t):
    for amp in (0.0, 0.4, 1.0):
        assert p_se.diurnal_rate(t, 50.0, amp, 600.0,
                                 [p_se.Burst(*b) for b in BURSTS]) == \
            r_se.diurnal_rate(t, 50.0, amp, 600.0,
                              [r_se.Burst(*b) for b in BURSTS])


@pytest.mark.parametrize("mix", [None, MIX, {"batch": 1.0}])
def test_sim_requests_equal(mix):
    got = p_se.sim_requests(200, mix=mix, seed=7, uid0=5)
    want = r_se.sim_requests(200, mix=mix, seed=7, uid0=5)
    assert _astuples(got) == _astuples(want)


def test_validation_equals_the_reference():
    for se in (p_se, r_se):
        vc = VirtualClock()
        with pytest.raises(ValueError, match="cap must be"):
            se.SimEngine(vc, vc.sleep, cap=0)
        with pytest.raises(ValueError, match="max_inflight"):
            se.SimEngine(vc, vc.sleep, max_inflight=0)
        with pytest.raises(ValueError, match="largest bucket"):
            se.SimEngine(vc, vc.sleep, cap=8, buckets=(2, 4))
        with pytest.raises(ValueError, match="base_rps"):
            se.bursty_times(3, 0.0)
        with pytest.raises(ValueError, match="weights"):
            se.sim_requests(3, mix={"batch": 0.0})
        eng = se.SimEngine(vc, vc.sleep, cap=4)
        with pytest.raises(ValueError, match="exceeds"):
            eng.submit([se.SimRequest(uid=i) for i in range(5)])
    for cap in (1, 3, 8, 12):
        assert p_se._pow2_chain(cap) == r_se._pow2_chain(cap)
        svc = (0.003, 0.0007)
        assert p_se.ServiceModel(*svc).capacity_rps(cap) == \
            r_se.ServiceModel(*svc).capacity_rps(cap)


# -- the simulated engine behind both doors -------------------------------------


def _soak(fd, se, ctl_mod, slo_mod, control: bool, n: int = 1500):
    """A bursty, mixed-priority stream (about twice the engine's capacity
    in the bursts) through one door on the virtual clock."""
    vc = VirtualClock()
    eng = se.SimEngine(vc, vc.sleep, cap=8, max_inflight=2,
                       service=se.ServiceModel(0.004, 0.001))
    ctl = None
    if control:
        ctl = ctl_mod.OverloadController(
            slo_mod.slo_targets(60.0),
            ctl_mod.ControlConfig(tick_s=0.5, queue_depth=32))
    door = fd.FrontDoor({"sim": eng}, fd.FrontDoorConfig(deadline_s=0.01),
                        clock=vc, sleep=vc.sleep, controller=ctl)
    times = se.bursty_times(n, 400.0, amp=0.5, period_s=4.0,
                            bursts=[se.Burst(1.0, 0.5, 4.0)], seed=3)
    reqs = se.sim_requests(n, mix=MIX, seed=4)
    return door.serve(fd.trace_arrivals("sim", times, reqs)), eng


@pytest.mark.parametrize("control", [False, True])
@pytest.mark.parametrize("door", ["reference", "port"])
def test_sim_engine_serves_the_reference_groups(control, door):
    """The port's SimEngine behind either door against the reference's
    SimEngine behind the reference's door: equal groups, latencies, sheds,
    decisions, stats and runs."""
    want, want_eng = _soak(r_fd, r_se, r_ctl, r_slo, control)
    fd = r_fd if door == "reference" else p_fd
    ctl = r_ctl if door == "reference" else p_ctl
    slo = r_slo if door == "reference" else p_slo
    got, got_eng = _soak(fd, p_se, ctl, slo, control)
    assert _astuples(got.groups) == _astuples(want.groups)
    assert _astuples(got.latencies) == _astuples(want.latencies)
    assert _astuples(got.shed) == _astuples(want.shed)
    assert _astuples(got.decisions) == _astuples(want.decisions)
    assert got.wall_time_s == want.wall_time_s
    assert got.queue_depth_max == want.queue_depth_max
    assert got_eng.stats == want_eng.stats and got_eng.runs == want_eng.runs
    assert {m: sorted(r) for m, r in got.results.items()} == \
        {m: sorted(r) for m, r in want.results.items()}
    assert bool(got.shed) == control
    if control:
        assert got.decisions


# -- the device-level simulator ----------------------------------------------------


def _build(mod, name):
    return mod.matmul_heavy_graph() if name == "matmul_heavy" \
        else mod.WORKLOADS[name]()


def _ref_graph(graph):
    """A port OpGraph as the reference's (the same nodes, as fields)."""
    out = r_og.OpGraph()
    for n in graph:
        out.add(r_og.OpNode(n.name, n.kind, dict(n.dims), list(n.deps),
                            n.out_bytes, n.in_bytes, n.param_bytes, n.flops,
                            n.label))
    return out


def _port_graph(graph):
    out = p_og.OpGraph()
    for n in graph:
        out.add(p_og.OpNode(n.name, n.kind, dict(n.dims), list(n.deps),
                            n.out_bytes, n.in_bytes, n.param_bytes, n.flops,
                            n.label))
    return out


def _traced_nvsa():
    """NVSA's served pipeline (cnn, d = 128, batch 2) traced by the port's
    torch trace, as one OpGraph."""
    cfg = cb.REASON_WORKLOADS["nvsa"].make_config(d=128)
    sched = cb.compile_reason_schedule("nvsa", cfg, variant="cnn",
                                       batch_size=2, device="cpu", fused=False)
    return _port_graph(p_sch.ensure_graph(sched).graph)


def _sims(sim, graph_fn):
    rows = [sim.simulate_generic(graph_fn(), dev)
            for dev in sim.DEVICES.values()]
    rows.append(sim.simulate_tpu_like(graph_fn()))
    rows.append(sim.simulate_tpu_like(graph_fn(), array=64,
                                      staging_factor=4.0))
    for kw in ({}, {"max_pes": 4096}, {"force_mode": "sequential"},
               {"phase2_enabled": False}, {"n_loops": 1, "iter_max": 2}):
        rows.append(sim.simulate_nsflow(graph_fn(), **kw))
    return [dataclasses.asdict(r) for r in rows]


def test_device_table_equals_the_reference():
    assert {k: dataclasses.astuple(v) for k, v in p_sim.DEVICES.items()} == \
        {k: dataclasses.astuple(v) for k, v in r_sim.DEVICES.items()}
    assert (p_sim.NSFLOW_FREQ, p_sim.NSFLOW_DRAM_BW, p_sim.TPU_LIKE_FREQ) == \
        (r_sim.NSFLOW_FREQ, r_sim.NSFLOW_DRAM_BW, r_sim.TPU_LIKE_FREQ)


@pytest.mark.parametrize("name", GRAPHS)
def test_simulators_equal_on_the_paper_graphs(name):
    assert _sims(p_sim, lambda: _build(p_wl, name)) == \
        _sims(r_sim, lambda: _build(r_wl, name))


def test_simulators_equal_on_a_traced_nvsa_graph():
    graph = _traced_nvsa()
    assert any(n.kind == "vsa" for n in graph)
    assert _sims(p_sim, lambda: _port_graph(graph)) == \
        _sims(r_sim, lambda: _ref_graph(graph))
