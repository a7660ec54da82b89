"""Parity of the port's MIMONet slice with the JAX reference, on the CPU.

The fused ``unbind_classify`` kernel's plain versions against the Pallas
kernel in interpret mode, ``unitary_codebook``, every MIMONet stage and the
composed forward on the reference's constants, the fused negotiation of
the schedule compiler, and the engine's fallback when the negotiation
refuses the fused schedule.  The reference runs under the negotiated CPU
plan, so its Pallas kernels run in interpret mode.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.backend import registry as jregistry
from repro.configs import base as jcb
from repro.kernels.unbind_classify import kernel as juc
from repro.kernels.unbind_classify import ref as juc_ref
from repro.models import mimonet as jmm
from repro.nn import init as jinit
from repro.serve import reason as jreason
from repro_torch import interop
from repro_torch.backend import registry
from repro_torch.configs import base as cb
from repro_torch.kernels.unbind_classify import ops as uc_ops
from repro_torch.kernels.unbind_classify import ref as uc_ref
from repro_torch.models import mimonet as mm
from repro_torch.serve.reason import ReasonConfig, ReasonEngine
from repro_torch.vsa import ops as vsa

torch.set_num_threads(2)

CPU_PLAN = jregistry.negotiate(platform="cpu", override="")
SMALL = dict(blocks=2, d=128, trunk_hidden=64, cnn_width=4)


def draw_spec(spec, seed: int):
    """Numpy draw of a reference spec tree: normal leaves at the spec's
    std, batchnorm scale / var in [0.5, 1.5] and every other leaf (biases,
    BN mean) small and non-zero, so each parameter is exercised."""
    rng = np.random.default_rng(seed)

    def draw(p):
        if p.init == "normal":
            std = p.scale or 1.0 / np.sqrt(np.prod(p.shape[:-1]))
            return (rng.standard_normal(p.shape) * std).astype(np.float32)
        if p.init == "ones":
            return rng.uniform(0.5, 1.5, p.shape).astype(np.float32)
        return (rng.standard_normal(p.shape) * 0.1).astype(np.float32)

    return jax.tree.map(draw, spec, is_leaf=lambda x: isinstance(x, jinit.P))


@functools.lru_cache(maxsize=None)
def ref_keys(d: int, blocks: int, channels: int = 2):
    """The reference's unitary keys (``jax.random`` key 2) as numpy."""
    jcfg = jmm.MIMONetConfig(d=d, blocks=blocks, n_channels=channels)
    return np.asarray(jmm.mimonet_keys(jcfg, jax.random.PRNGKey(2)))


def mimonet_case(seed: int = 0, **kw):
    """(port cfg, reference cfg, reference consts as numpy, port consts)."""
    cfg, jcfg = mm.MIMONetConfig(**kw), jmm.MIMONetConfig(**kw)
    consts = {"params": draw_spec(jmm.mimonet_spec(jcfg), seed),
              "keys": ref_keys(jcfg.d, jcfg.blocks, jcfg.n_channels)}
    return cfg, jcfg, consts, interop.from_reference(consts, "cpu")


def _images(n: int, k: int = 2, seed: int = 0):
    return np.random.default_rng(seed).uniform(0, 1, (n, k, 32, 32, 1)).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


# -- the fused unbind -> classify kernel ---------------------------------------


def _uc_inputs(n, d, k=2, blocks=4, c=5, seed=0):
    rng = np.random.default_rng(seed + n * 1000 + d)
    # unit-norm keys per block, as the unitary binding keys are
    keys = (rng.standard_normal((k, blocks, d)) / np.sqrt(d)).astype(np.float32)
    x = rng.standard_normal((n, blocks, d)).astype(np.float32)
    w = (rng.standard_normal((blocks, d, c)) / np.sqrt(blocks * d)).astype(np.float32)
    b = rng.standard_normal((1, c)).astype(np.float32)
    return keys, x, w, b


# (n, d, blocks): MIMONet's 4 blocks at d = 8, 128 and 256, and one block
_UC_PALLAS_CASES = [(n, d, blocks) for blocks in (4, 1) for d in (8, 128, 256)
                    for n in (1, 5, 9)]


@pytest.mark.parametrize(
    "n,d,blocks", _UC_PALLAS_CASES,
    ids=[f"{n}-{d}" + ("" if blocks == 4 else f"-B{blocks}")
         for n, d, blocks in _UC_PALLAS_CASES])
def test_fused_unbind_classify_matches_pallas_interpret(n, d, blocks):
    """The kernel's plain version (the CPU path of the wrapper) against the
    Pallas kernel in interpret mode, within the registry epsilon 1e-3."""
    keys, x, w, b = _uc_inputs(n, d, blocks=blocks)
    want = np.asarray(juc.fused_unbind_classify(
        jnp.asarray(keys), jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        interpret=True))
    before = dict(registry.LAUNCHES)
    got = uc_ops.fused_unbind_classify(_t(keys), _t(x), _t(w), _t(b))
    assert registry.LAUNCHES == before  # CPU tensors launch nothing
    assert got.dtype == torch.float32 and got.shape == (n, 2, 5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)


def test_unbind_classify_kernel_geometry():
    """The wrapper's copy of unbind_classify.cu's geometry: d padded to a
    multiple of 64 and S slices of the i-sum, the largest power of two up
    to 16 (4 above dp = 1024) with slices a multiple of 16 and at least 32
    long; one staged VSA block takes x twice over, the key and S partial
    sums, (3 + S)·dp floats; the wrapper raises exactly where that exceeds
    Hopper's 227 KB less the 2 KB reduction array."""
    cases = {1: (64, 2), 7: (64, 2), 128: (128, 4), 130: (192, 4), 256: (256, 8),
             512: (512, 16), 640: (640, 8), 1024: (1024, 16), 1088: (1088, 4)}
    for d, want in cases.items():
        dp, s = uc_ops.geometry(d)
        assert (dp, s) == want
        assert dp % s == 0 and (dp // s) % 16 == 0 and dp // s >= 32
        assert uc_ops.smem_bytes(d, rows=3) == 3 * 4 * (3 + s) * dp
    limit = 227 * 1024 - 16 * 32 * 4
    assert uc_ops.smem_bytes(uc_ops.MAX_D) <= limit < uc_ops.smem_bytes(uc_ops.MAX_D + 1)
    assert uc_ops.MAX_D == 8192
    d = uc_ops.MAX_D + 1
    args = (torch.zeros(1, 1, d), torch.zeros(1, 1, d), torch.zeros(1, d, 2),
            torch.zeros(1, 2))
    with pytest.raises(ValueError, match="shared memory"):
        uc_ops._launch(*args)


@pytest.mark.parametrize("d", [8, 128])
@pytest.mark.parametrize("n", [1, 5, 9])
def test_unbind_classify_ref_matches_reference_ref(n, d):
    """Both plain forms against the reference's staged chain
    (``unbind_classify/ref.py``), within 1e-5."""
    keys, x, w, b = _uc_inputs(n, d, seed=1)
    head = {"w": w.reshape(-1, 5), "b": b.reshape(5)}
    want = np.asarray(juc_ref.unbind_classify_ref(
        jax.tree.map(jnp.asarray, head), jnp.asarray(keys),
        jnp.asarray(x.reshape(n, -1))))
    got = uc_ref.unbind_classify_ref({k: _t(v) for k, v in head.items()},
                                     _t(keys), _t(x.reshape(n, -1)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    fused = uc_ref.fused_unbind_classify_ref(_t(keys), _t(x), _t(w), _t(b))
    np.testing.assert_allclose(fused.numpy(), want, atol=1e-5, rtol=0)
    wrapped = uc_ops.unbind_classify({k: _t(v) for k, v in head.items()},
                                     _t(keys), _t(x.reshape(n, -1)))
    np.testing.assert_allclose(wrapped.numpy(), want, atol=1e-5, rtol=0)


def test_unbind_classify_on_meta_computes_shapes_and_is_recorded():
    """On ``meta`` the wrapper takes the plain path (no launch) and notes
    its call to ``record_kernels``, which the negotiation reads."""
    keys, x, w, b = (torch.empty(s, device="meta")
                     for s in ((2, 4, 128), (3, 4, 128), (4, 128, 5), (1, 5)))
    with registry.record_kernels() as rec:
        out = uc_ops.fused_unbind_classify(keys, x, w, b)
    assert out.shape == (3, 2, 5) and out.device.type == "meta"
    assert rec == [("unbind_classify", "kernel")]
    assert registry.KERNELS["unbind_classify"].epsilon == 1e-3
    assert registry.KERNELS["unbind_classify"].dispatch_min_size == \
        jregistry.KERNELS["unbind_classify"].dispatch_min_size == 128


# -- unitary codes ---------------------------------------------------------------


@pytest.mark.parametrize("d", [64, 127, 128])
def test_unitary_codebook_has_unit_spectrum(d):
    """|rfft| = 1 in every bin (real DC and Nyquist), as the reference's;
    binding with a key and unbinding with it returns the code."""
    u = vsa.unitary_codebook(torch.Generator().manual_seed(d), 3, 2, d)
    assert u.shape == (3, 2, d) and u.dtype == torch.float32
    mag = torch.fft.rfft(u.double(), dim=-1).abs()
    torch.testing.assert_close(mag, torch.ones_like(mag), atol=1e-5, rtol=0)
    ref_u = np.array(jax.random.normal(jax.random.PRNGKey(0), (3, 2, d)))
    code = torch.from_numpy(ref_u).float()
    back = vsa.circ_corr_ref(u, vsa.circ_conv_ref(code, u))
    torch.testing.assert_close(back, code, atol=1e-4, rtol=0)


def test_keys_recover_each_channel():
    """The reference's MIMONet property (``test_nsai_models.py``): with
    unitary keys, unbinding a two-channel superposition picks the right
    channel with similarity > 0.6.  The port's own keys, at d = 128."""
    cfg = mm.MIMONetConfig()
    keys = mm.mimonet_keys(cfg, torch.Generator().manual_seed(3))
    codes = vsa.random_codebook(torch.Generator().manual_seed(4),
                                cfg.n_channels, cfg.blocks, cfg.d)
    sup = vsa.bind(codes, keys).sum(dim=0, keepdim=True)
    for c in range(cfg.n_channels):
        rec = vsa.unbind(keys[c][None], sup)
        sims = vsa.similarity(rec, codes)
        assert int(sims.argmax()) == c and float(sims[c]) > 0.6


# -- the model -------------------------------------------------------------------


@pytest.fixture(scope="module")
def small():
    return mimonet_case(**SMALL)


def test_stages_match_reference(small):
    """Each stage on the same inputs (the reference's previous output),
    within 1e-4."""
    cfg, jcfg, consts, tc = small
    jp, jk = jax.tree.map(jnp.asarray, consts["params"]), jnp.asarray(consts["keys"])
    imgs = _images(3)
    with jregistry.use_plan(CPU_PLAN):
        codes = np.asarray(jmm.encode(jp, jcfg, jnp.asarray(imgs)))
        sup = np.asarray(jmm.superpose(jk, jnp.asarray(codes)))
        x = np.asarray(jmm.trunk(jp, jnp.asarray(sup)))
        unb = np.asarray(jmm.unbind(jk, jcfg, jnp.asarray(x)))
        logits = np.asarray(jmm.classify(jp, jnp.asarray(unb)))
    p, k = tc["params"], tc["keys"]
    pairs = [(mm.encode(p, cfg, _t(imgs)), codes),
             (mm.superpose(k, _t(codes)), sup),
             (mm.trunk(p, _t(sup)), x),
             (mm.unbind(k, cfg, _t(x)), unb),
             (mm.classify(p, _t(unb)), logits)]
    for i, (got, want) in enumerate(pairs):
        assert got.shape == want.shape, i
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5,
                                   err_msg=f"stage {i}")


def test_trunk_gelu_is_the_tanh_approximation(small):
    """jax.nn.gelu defaults to the tanh form; the exact erf GELU would move
    the trunk's output far beyond 1e-4."""
    cfg, jcfg, consts, tc = small
    x = np.random.default_rng(4).standard_normal((2, 256)).astype(np.float32) * 3
    want = np.asarray(jmm.trunk(jax.tree.map(jnp.asarray, consts["params"]),
                                jnp.asarray(x)))
    np.testing.assert_allclose(mm.trunk(tc["params"], _t(x)).numpy(), want,
                               atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("route", ["staged", "fused"])
def test_forward_and_fused_tail_match_reference(small, route):
    """Logits within 1e-4: the staged route (``forward``: classify after
    unbind) against the reference's jitted ``forward``, and the fused route
    (``unbind_classify``, the kernel's plain version at d = 128) against
    the reference's fused route (its Pallas kernel in interpret mode)."""
    cfg, jcfg, consts, tc = small
    jp, jk = jax.tree.map(jnp.asarray, consts["params"]), jnp.asarray(consts["keys"])
    imgs = _images(4, seed=1)
    p, k = tc["params"], tc["keys"]
    with jregistry.use_plan(CPU_PLAN):
        if route == "staged":
            want = np.asarray(jmm.forward(jp, jk, jcfg, jnp.asarray(imgs)))
            got = mm.forward(p, k, cfg, _t(imgs))
        else:
            x = jmm.trunk(jp, jmm.superpose(jk, jmm.encode(jp, jcfg, jnp.asarray(imgs))))
            want = np.asarray(jmm.unbind_classify(jp, jk, jcfg, x))
            with registry.record_kernels() as rec:
                got = mm.unbind_classify(p, k, cfg, _t(np.asarray(x)))
            assert rec == [("unbind_classify", "kernel")]
    assert got.shape == (4, 2, 5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_unbind_classify_below_floor_is_the_staged_chain():
    """Below the dispatch floor (d = 64) the fused tail is literally
    ``classify(unbind(...))`` on the gather route: bit-identical."""
    cfg, _, _, tc = mimonet_case(seed=2, blocks=2, d=64, trunk_hidden=32,
                                 cnn_width=4)
    x = torch.randn(3, 2 * 64, generator=torch.Generator().manual_seed(0))
    p, k = tc["params"], tc["keys"]
    with registry.record_kernels() as rec:
        got = mm.unbind_classify(p, k, cfg, x)
    assert set(rec) == {("unbind_classify", "gather"), ("circ_conv", "gather")}
    assert torch.equal(got, mm.classify(p, mm.unbind(k, cfg, x)))


# -- the fused negotiation ---------------------------------------------------------


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("model,variant", [("nvsa", "cnn"), ("nvsa", "oracle"),
                                           ("mimonet", "default")])
def test_fused_negotiation_matches_reference(model, variant, d):
    """``fused_equivalence``, epsilon, lowering diff and ``fused_ok`` equal
    the reference's under its CPU plan, auto-negotiated and forced."""
    cfg = cb.REASON_WORKLOADS[model].make_config(d=d)
    jcfg = jcb.REASON_WORKLOADS[model].make_config(d=d)
    for fused in ("auto", True):
        with jregistry.use_plan(CPU_PLAN):
            want = jcb.compile_reason_schedule(model, jcfg, variant=variant,
                                               batch_size=2, trace_graph=False,
                                               fused=fused)
        got = cb.compile_reason_schedule(model, cfg, variant=variant,
                                         batch_size=2, device="cpu", fused=fused)
        assert got.fused_equivalence == want.fused_equivalence, fused
        assert got.fused_epsilon == want.fused_epsilon, fused
        assert got.fused_lowering_diff == want.fused_lowering_diff, fused
        assert got.fused_ok == want.fused_ok, fused
        assert got.fused_forced == (fused is True)
        assert [s.name for s in got.fused_stages] == \
            [s.name for s in want.fused_stages]


def test_fused_negotiation_rejects_a_mismatched_fused_list():
    """An alternate fused list whose output spec differs is refused, and
    one that needs specs cannot compile without them."""
    from repro_torch.serve.schedule import StageSpec, TensorSpec, compile_schedule

    staged = [StageSpec("a", "nn", lambda c, x: x * 2)]
    fused = [StageSpec("a", "nn", lambda c, x: x[:1])]
    spec = TensorSpec((4, 3), torch.float32)
    with pytest.raises(ValueError, match="output spec"):
        compile_schedule("w", staged, lambda r: r, lambda o, i: {},
                         device=torch.device("cpu"), consts={}, input_specs=spec,
                         fused_stages=fused)
    with pytest.raises(ValueError, match="needs input_specs"):
        compile_schedule("w", staged, lambda r: r, lambda o, i: {},
                         device=torch.device("cpu"), fused_stages=fused)
    with pytest.raises(ValueError, match="fused must be"):
        compile_schedule("w", staged, lambda r: r, lambda o, i: {},
                         device=torch.device("cpu"), fused="yes")
    plain = compile_schedule("w", staged, lambda r: r, lambda o, i: {},
                             device=torch.device("cpu"), fused=False)
    assert plain.fused_fn is None and not plain.fused_ok


def test_fused_epsilon_negotiation_falls_back_stagewise():
    """The port's twin of the reference's test of the same name: mimonet at
    d = 128, served with ``schedule="fused"`` through ``reason_engine``,
    refuses the epsilon-class fused list and serves stage by stage,
    counting the fallback, with the staged answers; ``fused=True``
    accepts it.  Answers equal the reference engine's (1e-4)."""
    cfg, jcfg, consts, tc = mimonet_case(seed=3, d=128)
    eng = cb.reason_engine("mimonet", cfg, ReasonConfig(batch_size=2),
                           consts=tc, device="cpu")
    sched = eng.schedules["default"]
    assert sched.fused_fn is not None and not sched.fused_ok
    assert sched.fused_equivalence == "epsilon" and sched.fused_epsilon > 0
    assert "unbind_classify" in sched.fused_lowering_diff
    factory, _ = cb.REASON_WORKLOADS["mimonet"].make_requests(cfg, 2, seed=0)
    reqs = list(factory())
    staged = eng.run(iter(reqs), schedule="overlap")
    fused = eng.run(iter(reqs), schedule="fused")
    assert eng.stats["fused_groups"] == 0
    assert eng.stats["fused_fallback_groups"] == 1
    assert eng.stats["dispatches"] == 2 * 5
    for uid in staged:
        np.testing.assert_array_equal(staged[uid].answer_logprobs,
                                      fused[uid].answer_logprobs)

    forced = cb.compile_reason_schedule("mimonet", cfg, consts=tc, batch_size=2,
                                        device="cpu", fused=True)
    assert forced.fused_forced and forced.fused_ok
    assert forced.fused_equivalence == "epsilon"
    feng = ReasonEngine(forced, ReasonConfig(batch_size=2), consts=tc)
    with registry.record_kernels() as rec:
        forced_res = feng.run(iter(reqs), schedule="fused")
    assert ("unbind_classify", "kernel") in rec
    assert feng.stats["fused_groups"] == 1
    assert feng.stats["fused_fallback_groups"] == 0

    with jregistry.use_plan(CPU_PLAN):
        jeng = jcb.reason_engine("mimonet", jcfg, jreason.ReasonConfig(batch_size=2),
                                 consts=consts, trace_graph=False)
        want = jeng.run(iter([jreason.ReasonRequest(uid=r.uid, images=r.images)
                              for r in reqs]), schedule="fused")
    for uid in want:
        for got in (fused[uid], forced_res[uid]):
            np.testing.assert_array_equal(got.answer, want[uid].answer)
            np.testing.assert_allclose(got.answer_logprobs,
                                       want[uid].answer_logprobs, atol=1e-4, rtol=0)
