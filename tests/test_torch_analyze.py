"""The port's preflight analyzer (``repro_torch.analyze``) against the
reference's ``repro.analyze``, on the CPU.

Where a behaviour is the same in both packages one parametrised test holds
the port against the reference: the rule catalog, the AST lint's NSF101 /
NSF104 / NSF105 fixtures, and the preflight of every ``REASON_WORKLOADS``
model x variant at d = 32 over buckets (1, 2, 4).  The rules whose
meaning is torch's (NSF001-NSF003, NSF005 on the aten ops a stage runs on
``meta``, NSF102 / NSF103 in the lint, the registry's NSF006 / NSF007)
are pinned by torch fixtures and their clean twins.  Then the clean passes
over the real port (lint, registry, CPU kernel probes), the CLI and the
``deploy(preflight=)`` gate.  About 30 s in one process, most of it the
reference's preflight of the eight schedules.
"""

import dataclasses
import json
import textwrap
import types

import pytest
import torch

from repro.analyze import RULES as R_RULES
from repro.analyze import lint_file as r_lint_file
from repro.analyze import preflight as r_preflight
from repro.backend import registry as r_registry
from repro.configs import base as r_cbase
from repro_torch.analyze import (AnalysisReport, PreflightError, RULES,
                                 finding, lint_file, lint_tree, preflight)
from repro_torch.analyze import artifacts, registry_check, retrace
from repro_torch.backend import registry
from repro_torch.configs import base as cbase
from repro_torch.serve.schedule import StageSpec, TensorSpec

_SPECS = {"x": TensorSpec((4, 8), torch.float32)}


class _FakeSched:
    """Just enough StagedSchedule surface for the artifact/retrace checks
    (a real schedule's compile would already fail on a stage that syncs)."""

    def __init__(self, stages, input_specs=None, buckets=()):
        self.stages = list(stages)
        self.input_specs = _SPECS if input_specs is None else input_specs
        self.consts_spec = {}
        self.batch_buckets = tuple(buckets)
        self.workload = "fixture"
        self.variant = "bad"

    def covering_bucket(self, n):
        for b in self.batch_buckets:
            if b >= n:
                return b
        raise ValueError(f"no bucket covers {n}")


def _rules_of(report):
    return sorted({f.rule for f in report.findings})


def _stage(fn, stream="nn", name="stage"):
    return StageSpec(name, stream, fn)


# -- the catalog and the lint, held against the reference -----------------


def test_rule_catalog_matches_the_reference():
    assert {k: v[0] for k, v in RULES.items()} == \
        {k: v[0] for k, v in R_RULES.items()}


LINT_FIXTURES = {
    "raw_clock": ("fixture.py", """
        import time

        def measure():
            t0 = time.perf_counter()
            return time.perf_counter() - t0
        """),
    "injectable_clock": ("fixture.py", """
        import time

        def measure(clock=time.perf_counter, wall=time.perf_counter):
            return wall() - clock()
        """),
    "blocks_before_stamp": ("fixture.py", """
        import jax

        class BadEngine:
            def submit(self, group):
                out = jax.block_until_ready(self.fn(group))
                rec = self.record(group)
                rec.dispatch_t = self.clock()
                return rec
        """),
    "never_stamps": ("fixture.py", """
        class WorseEngine:
            def submit(self, group):
                return list(group)
        """),
    "stamp_then_block": ("fixture.py", """
        import jax

        class GoodEngine:
            def submit(self, group):
                rec = self.record(group)
                rec.dispatch_t = self.clock()
                jax.block_until_ready(self.fn(group))
                return rec
        """),
    "unbounded_queue": ("fixture.py", """
        class Router:
            def __init__(self):
                self.pending = []

            def enqueue(self, item):
                self.pending.append(item)
        """),
    "bounded_queue": ("fixture.py", """
        class Router:
            def __init__(self, depth):
                self.pending = []
                self.depth = depth

            def enqueue(self, item):
                if len(self.pending) >= self.depth:
                    return False
                self.pending.append(item)
                return True
        """),
    "closure_bound": ("fixture.py", """
        class Router:
            def enqueue(self, item):
                def bounded():
                    return len(self.pending) < self.depth
                self.pending.append(item)
                return bounded
        """),
    "non_queue_append": ("fixture.py", """
        def collect(rows):
            out = []
            for r in rows:
                out.append(r)
            return out
        """),
    "control_plane_time": ("control.py", """
        import dataclasses
        import time


        @dataclasses.dataclass
        class ControlConfig:
            clock: object = time.monotonic
        """),
    "time_outside_control_plane": ("helpers.py", """
        import dataclasses
        import time


        @dataclasses.dataclass
        class Cfg:
            clock: object = time.monotonic
        """),
}


def _write(tmp_path, src, name="fixture.py"):
    """A fixture under a serve/ dir, so the serving rule set applies."""
    p = tmp_path / "serve" / name
    p.parent.mkdir(exist_ok=True)
    p.write_text(textwrap.dedent(src))
    return str(p)


@pytest.mark.parametrize("fixture", sorted(LINT_FIXTURES))
def test_lint_fixture_matches_the_reference(tmp_path, fixture):
    """NSF101, NSF104 and NSF105 read only the AST: both packages give the
    same (rule, line) set on each fixture (and a clean twin gives none)."""
    name, src = LINT_FIXTURES[fixture]
    path = _write(tmp_path, src, name)
    got = {(f.rule, f.where) for f in lint_file(path)}
    want = {(f.rule, f.where) for f in r_lint_file(path)}
    assert got == want
    assert {r for r, _ in got} <= {"NSF101", "NSF104", "NSF105"}


@pytest.mark.parametrize("src, rules", [
    ("""
     from repro_torch.serve.schedule import StageSpec

     def build():
         def symbolic(consts, bufs):
             return bufs["x"].sum().item()
         return StageSpec("symbolic", "vsa", symbolic)
     """, ["NSF102"]),
    ("""
     from repro_torch.serve.schedule import StageSpec

     def build():
         return StageSpec("frontend", "nn", lambda c, b: b.cpu())
     """, ["NSF102"]),
    ("""
     import torch

     class Engine:
         def _make_step(self):
             def step(x):
                 torch.cuda.synchronize()
                 return x
             return step
     """, ["NSF102"]),
    ("""
     import numpy as np
     from repro_torch.serve.schedule import StageSpec

     def build():
         def symbolic(consts, bufs):
             return bufs["x"] * 2
         def collect(out, i):
             return np.asarray(out[i].cpu())
         return StageSpec("symbolic", "vsa", fn=symbolic), collect
     """, []),
    ("""
     import torch

     def sample(seed):
         return torch.Generator().manual_seed(seed)
     """, ["NSF103"]),
    ("""
     import torch
     from repro_torch.serve.engine import stream_seed

     def sample(seed, uid, index):
         return torch.Generator().manual_seed(stream_seed(seed, uid, index))
     """, []),
    ("""
     import numpy as np
     import torch

     def constants(seed, i):
         return torch.Generator().manual_seed(
             int(np.random.SeedSequence([seed, i]).generate_state(1)[0]))
     """, []),
], ids=["item_in_stage", "cpu_in_lambda_stage", "sync_in_make_builder",
        "host_copy_outside_stage", "seed_not_derived", "stream_seed",
        "seed_sequence"])
def test_torch_lint_rules(tmp_path, src, rules):
    """NSF102 (host copies in stage bodies and _make_* builders) and NSF103
    (seeds not derived from the request) in their torch meanings."""
    got = AnalysisReport(list(lint_file(_write(tmp_path, src))))
    assert _rules_of(got) == rules, got.render()


def test_port_sources_lint_clean():
    import repro_torch
    import repro_torch.serve as serve_pkg

    rep = lint_tree(serve_pkg.__path__[0])
    assert rep.findings == [], rep.render()
    assert rep.coverage["lint_files"] >= 8
    rep = lint_tree(repro_torch.__path__[0])
    assert rep.findings == [], rep.render()
    assert rep.coverage["lint_files"] >= 80


# -- torch fixture stages: NSF001-NSF005 --------------------------------------


def _downcast(consts, bufs):
    return {"x": bufs["x"].to(torch.bfloat16).float()}


@pytest.mark.parametrize("symb, rules", [("int8", ["NSF001"]),
                                         ("fp32", [])])
def test_nsf001_downcast_below_declared_int_precision(symb, rules):
    """f32 -> bf16 inside a vsa stage is an error where the config declares
    int8, and legal under fp32."""
    cfg = types.SimpleNamespace(nn_precision="fp32", symb_precision=symb)
    rep = artifacts.check_schedule(
        _FakeSched([_stage(_downcast, "vsa", "symbolic")]), cfg=cfg)
    assert _rules_of(rep) == rules
    assert rep.ok == (not rules)


@pytest.mark.parametrize("wide, rules", [(True, ["NSF001"]), (False, [])])
def test_nsf001_f64_upcast(wide, rules):
    """A float64 op in a stage is an error (torch shows it on ``meta``,
    where the reference's test needs x64 mode); its f32 twin is clean."""
    def fn(consts, bufs):
        x = bufs["x"].double() if wide else bufs["x"] * 1.0
        return {"x": x.float()}

    rep = artifacts.check_schedule(_FakeSched([_stage(fn, "nn", "drift")]))
    assert _rules_of(rep) == rules
    assert all("float64" in f.message for f in rep.findings)


def test_nsf001_kernel_argument_precision():
    """A kernel wrapper handed bf16 operands in a vsa stage declared int8
    is an error (its plain version's ops are recorded too)."""
    from repro_torch.kernels.circ_conv import ops as circ_ops

    def fn(consts, bufs):
        x = bufs["x"].reshape(4, 1, 8).to(torch.bfloat16)
        return {"x": circ_ops.circ_elem(x, x).float().reshape(4, 8)}

    cfg = types.SimpleNamespace(nn_precision="fp32", symb_precision="int8")
    rep = artifacts.check_schedule(_FakeSched([_stage(fn, "vsa")]), cfg=cfg)
    assert _rules_of(rep) == ["NSF001"]
    assert any("kernel 'circ_conv'" in f.message for f in rep.findings)


@pytest.mark.parametrize("mixed, rules", [(True, ["NSF002"]), (False, [])])
def test_nsf002_mixed_amax_dims(mixed, rules):
    """Global + per-problem amax scales in one stage: a warning (reported,
    never failing the preflight); per-problem alone is clean."""
    def fn(consts, bufs):
        x = bufs["x"]
        per_problem = x.abs().amax(dim=1, keepdim=True)
        scale = torch.max(x.abs()) if mixed else per_problem
        return {"x": x / scale + x / per_problem}

    rep = artifacts.check_schedule(_FakeSched([_stage(fn, "vsa", "quant")]))
    assert _rules_of(rep) == rules
    assert rep.ok


SYNCS = {
    "item": lambda x: x * x.sum().item(),
    "bool": lambda x: x if bool(x.sum() > 0) else -x,
    "cpu": lambda x: x.cpu() * 2,
    "nonzero": lambda x: x[torch.nonzero(x > 0)[:, 0]],
    "masked_select": lambda x: x.masked_select(x > 0).reshape(4, -1),
}


@pytest.mark.parametrize("kind", sorted(SYNCS))
def test_nsf003_host_sync_in_stage(kind):
    """A host sync in a stage body is recorded as NSF003 before ``meta``
    would raise; the trace then goes on (a placeholder) or ends at it."""
    body = SYNCS[kind]
    rep = artifacts.check_schedule(_FakeSched([
        _stage(lambda c, b: {"x": body(b["x"])}, "nn", "leak"),
        _stage(lambda c, b: {"x": b["x"] + 1}, "vsa", "after")]))
    assert _rules_of(rep) == ["NSF003"]
    assert not rep.ok
    assert rep.findings[0].where == "fixture/bad/leak"
    ends = kind in ("nonzero", "masked_select")
    assert rep.coverage["stage_ops"] == (1 if ends else 2)
    assert ("trace ends here" in rep.findings[-1].message) == ends


def test_nsf003_clean_twin_and_no_donation_rule():
    """The same stages without the sync give nothing; NSF004 has no torch
    counterpart (nothing is donated), so it never fires and its coverage
    is 0."""
    rep = artifacts.check_schedule(_FakeSched([
        _stage(lambda c, b: {"x": b["x"] * b["x"].sum()}, "nn", "leak"),
        _stage(lambda c, b: {"x": b["x"] + 1}, "vsa", "after")]))
    assert rep.findings == []
    assert rep.coverage == {"stage_ops": 2, "fused_donation": 0}
    assert "NSF004" in RULES


def test_nsf005_bucket_closure_hole():
    class _Leaky(_FakeSched):
        def covering_bucket(self, n):
            return n  # 1 and 3 are not declared buckets

    rep = retrace.check_retrace(_Leaky([], buckets=(2, 4)))
    assert _rules_of(rep) == ["NSF005"]
    assert len(rep.findings) == 2


@pytest.mark.parametrize("leak, rules", [(True, ["NSF005"]), (False, [])])
def test_nsf005_group_size_in_a_nonbatch_axis(leak, rules):
    entry = types.SimpleNamespace(input_specs=lambda cfg, b, v: (
        {"x": TensorSpec((b, b + 7 if leak else 9), torch.float32)},))
    out = retrace.check_bucket_specs(entry, None, None, (2, 4), "fixture")
    assert sorted({f.rule for f in out}) == rules
    if leak:   # leaves named as jax.tree_util.keystr names them
        assert out[0].where == "fixture[0]['x']"
        assert "non-batch" in out[0].message


@pytest.mark.parametrize("drift, rules", [(True, ["NSF005"]), (False, [])])
def test_nsf005_double_trace(drift, rules):
    """A stage whose op sequence changes between two calls (Python state
    leaking in) fails the double trace; a deterministic one passes."""
    counter = iter(range(100))

    def fn(consts, bufs):
        return {"x": bufs["x"] + (float(next(counter)) if drift else 2.0)}

    rep = retrace.check_retrace(_FakeSched([_stage(fn, "nn", "drift")],
                                           buckets=(2, 4)), double_trace=True)
    assert _rules_of(rep) == rules
    assert rep.coverage == {"bucket_closure": 1, "double_trace": 1}
    assert all("runs differently" in f.message for f in rep.findings)


# -- the registry: NSF006 / NSF007 --------------------------------------------


def test_registry_static_and_cpu_probes_clean():
    rep = registry_check.check_registry(probe=True, device="cpu")
    assert rep.findings == [], rep.render()
    assert rep.coverage["registry_static"] == len(registry.KERNELS)
    assert rep.coverage["dispatch_floors"] == len(registry.KERNELS)
    assert rep.coverage["smem_twins"] >= 100
    # the four kernels with a gather lowering, at the seven probe sizes
    assert rep.coverage["kernel_probes"] == 7 * 5


def test_probes_on_cuda_never_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the card's probes are in "
                    "test_torch_cuda.py")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        registry_check.check_probes("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        preflight(probe=True)


def test_refused_sizes_raise_naming_the_size(monkeypatch):
    """Each probe's refused size is refused by its wrapper's guards with an
    error that names it.  The guards run before any launch, so sending the
    CPU tensors down the card's path shows them here."""
    monkeypatch.setattr(registry, "on_card", lambda t: True)
    cases = registry_check._refused(torch.device("cpu"))
    assert {c.kernel for c in cases} == set(registry.KERNELS)
    for case in cases:
        with pytest.raises((ValueError, TypeError)) as ei:
            case.run()
        assert case.names in str(ei.value), (case.kernel, str(ei.value))


@pytest.mark.parametrize("breakage", [
    "ghost_entry", "missing_source", "orphan_source", "smem_twin_drift",
    "gather_drift"])
def test_nsf006_fires_under_a_broken_registry(monkeypatch, tmp_path,
                                              breakage):
    spec = registry.KERNELS["qmatmul"]
    if breakage == "ghost_entry":
        monkeypatch.setitem(registry.KERNELS, "ghost_kernel",
                            dataclasses.replace(spec, name="ghost_kernel"))
        want = ("registry/ghost_kernel",)
    elif breakage == "missing_source":
        monkeypatch.setitem(registry.KERNELS, "qmatmul",
                            dataclasses.replace(spec, source="gone.cu"))
        want = "registry/qmatmul", "csrc/qmatmul.cu"   # now an orphan too
    elif breakage == "orphan_source":
        csrc = tmp_path / "csrc"
        csrc.mkdir()
        for s in registry.KERNELS.values():
            (csrc / s.source).write_text(
                open(f"{registry_check._CSRC_DIR}/{s.source}").read())
        (csrc / "orphan.cu").write_text("// no entry\n")
        monkeypatch.setattr(registry_check, "_CSRC_DIR", str(csrc))
        want = ("csrc/orphan.cu",)
    elif breakage == "smem_twin_drift":
        from repro_torch.kernels.simd_fused import ops as simd_ops

        real = simd_ops.smem_bytes
        monkeypatch.setattr(simd_ops, "smem_bytes",
                            lambda *a, **k: real(*a, **k) + 16)
        want = ("registry/simd_fused",)
    else:
        from repro_torch.vsa import ops as vsa

        real = vsa.similarity_matrix
        monkeypatch.setattr(vsa, "similarity_matrix",
                            lambda q, d: real(q, d) * 1.5)
        rep = registry_check.check_probes("cpu")
        assert _rules_of(rep) == ["NSF006"]
        assert all(f.where.startswith("simd_fused/cpu@") for f in rep.findings)
        return
    rep = registry_check.check_static()
    assert _rules_of(rep) == ["NSF006"]
    assert {f.where for f in rep.findings} == set(want)


@pytest.mark.parametrize("kernel, floor, message", [
    ("qmatmul", 64, "dead policy"), ("circ_conv", 0, "no-op")])
def test_nsf007_dispatch_floors(monkeypatch, kernel, floor, message):
    spec = registry.KERNELS[kernel]
    assert bool(spec.dispatch_min_size) != bool(floor)  # the floor flips
    monkeypatch.setitem(registry.KERNELS, kernel,
                        dataclasses.replace(spec, dispatch_min_size=floor))
    rep = registry_check.check_dispatch_floors()
    assert [f.rule for f in rep.findings] == ["NSF007"]
    assert message in rep.findings[0].message


# -- the real workloads, held against the reference ---------------------------


REAL = [(m, v, p) for m, e in sorted(cbase.REASON_WORKLOADS.items())
        for v in e.variants for p in ("fp32",)] + [("nvsa", "oracle", "int8")]


@pytest.mark.parametrize("model, variant, precision", REAL)
def test_real_workload_preflight_matches_the_reference(model, variant,
                                                       precision):
    """Each model x variant at d = 32 over buckets (1, 2, 4): the port's
    full preflight (double trace on) fires the rule IDs the reference's
    does, here none, and at int8 NSAI precision the same NSF002 warnings
    over the same stages."""
    kw = {} if precision == "fp32" else {"nn_precision": precision,
                                         "symb_precision": precision}
    entry = cbase.REASON_WORKLOADS[model]
    cfg = entry.make_config(d=32, **kw)
    sched = cbase.compile_reason_schedule(model, cfg, variant,
                                          batch_size=(1, 2, 4), device="cpu")
    got = preflight([(sched, cfg, entry, variant)], double_trace=True)
    r_entry = r_cbase.REASON_WORKLOADS[model]
    r_cfg = r_entry.make_config(d=32, **kw)
    r_sched = r_cbase.compile_reason_schedule(
        model, r_cfg, variant, batch_size=(1, 2, 4), trace_graph=False,
        plan=r_registry.negotiate(platform="cpu", override=""))
    want = r_preflight([(r_sched, r_cfg, r_entry, variant)],
                       double_trace=True)
    assert {(f.rule, f.where) for f in got.findings} == \
        {(f.rule, f.where) for f in want.findings}, got.render()
    assert got.ok and want.ok
    assert _rules_of(got) == (["NSF002"] if precision == "int8" else [])
    cov = got.coverage
    assert cov["schedules"] == cov["bucket_specs"] == cov["double_trace"] == 1
    assert cov["stage_ops"] == want.coverage["stage_jaxprs"] == \
        len(sched.stages)
    assert cov["fused_donation"] == 0


# -- the CLI ------------------------------------------------------------------


def test_cli_lint_and_registry_only(tmp_path, capsys):
    from repro_torch.analyze.__main__ import main

    out = tmp_path / "results" / "ANALYZE.json"
    rc = main(["--workload", "none", "--device", "cpu", "--format", "json",
               "--out", str(out), "--no-probe", "--no-double-trace"])
    assert rc == 0
    data = json.loads(out.read_text())
    assert data["ok"] is True
    assert data["coverage"]["lint_files"] >= 40
    assert data["coverage"]["registry_static"] == len(registry.KERNELS)
    assert json.loads(capsys.readouterr().out) == data


def test_cli_full_tier_on_one_workload(capsys):
    """``--device cpu`` over mimonet's schedule: every check family ran."""
    from repro_torch.analyze.__main__ import main

    assert main(["--workload", "mimonet", "--device", "cpu",
                 "--format", "json"]) == 0
    data = json.loads(capsys.readouterr().out)
    assert data["ok"] is True and data["findings"] == []
    for key in ("stage_ops", "bucket_closure", "bucket_specs",
                "double_trace", "registry_static", "smem_twins",
                "dispatch_floors", "kernel_probes", "lint_files"):
        assert data["coverage"][key] > 0, key
    assert data["coverage"]["fused_donation"] == 0


def test_cli_rejects_unknown_workload_and_a_missing_card():
    from repro_torch.analyze.__main__ import main

    with pytest.raises(SystemExit):
        main(["--workload", "not_a_workload", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["--workload", "none", "--no-probe"])


# -- the report datatypes -----------------------------------------------------


def test_finding_and_report_surface():
    with pytest.raises(ValueError):
        finding("NSF999", "x", "no such rule")
    with pytest.raises(ValueError):
        finding("NSF001", "x", "bad severity", severity="fatal")
    a = AnalysisReport([finding("NSF003", "a", "err")], {"c": 1})
    a.merge(AnalysisReport([finding("NSF002", "b", "warn")], {"c": 2}))
    assert not a.ok and len(a.errors) == 1 and len(a.warnings) == 1
    assert a.coverage == {"c": 3}
    assert "preflight FAIL: 1 error(s), 1 warning(s)" in a.render()
    assert json.loads(a.to_json())["ok"] is False


# -- deploy() preflight gate --------------------------------------------------


def _seeded_failure(subjects, **kw):
    rep = AnalysisReport()
    rep.findings.append(finding("NSF003", "fixture/stage", "seeded error"))
    return rep


def _boom(*a, **kw):  # preflight="off" must never reach the analyzer
    raise AssertionError("preflight ran despite preflight='off'")


def test_deploy_preflight_gate(monkeypatch):
    import importlib

    # the package re-exports the preflight *function*, which shadows the
    # submodule on attribute access: resolve the module explicitly
    pf = importlib.import_module("repro_torch.analyze.preflight")
    from repro_torch.serve.deploy import Budget, deploy

    opts = {"nvsa": {"d": 32}}
    monkeypatch.setattr(pf, "preflight", _seeded_failure)
    # warn: the failing report is recorded, deploy still succeeds
    dep = deploy(["nvsa"], options=opts, budget=Budget(max_batch=2),
                 preflight="warn", device="cpu")
    rec = dep.report()["analysis"]
    assert rec["ok"] is False and rec["errors"] == 1
    assert "preflight FAIL: 1 error(s)" in dep.summary()
    # error (the default): the same findings abort the deploy
    with pytest.raises(PreflightError) as ei:
        deploy(["nvsa"], options=opts, budget=Budget(max_batch=2),
               device="cpu")
    assert [f.rule for f in ei.value.report.findings] == ["NSF003"]
    # off: nothing runs, nothing recorded
    monkeypatch.setattr(pf, "preflight", _boom)
    dep = deploy(["nvsa"], options=opts, budget=Budget(max_batch=2),
                 preflight="off", device="cpu")
    assert dep.report()["analysis"] is None
    assert "preflight" not in dep.summary()
    with pytest.raises(ValueError, match="preflight"):
        deploy(["nvsa"], options=opts, preflight="bogus", device="cpu")
