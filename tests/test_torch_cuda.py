"""The port's CUDA kernels against their plain versions, on the card.

Imports neither JAX nor the reference, so it runs on a GPU host that has
only PyTorch:  ``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
Without a card every test skips: a CUDA kernel has no CPU mode.
"""

import pytest
import torch

from repro_torch.backend import registry
from repro_torch.kernels.circ_conv import ops as circ_ops
from repro_torch.kernels.circ_conv import ref as circ_ref
from repro_torch.kernels.flash_attn import ops as flash_ops
from repro_torch.kernels.flash_attn import ref as flash_ref
from repro_torch.kernels.qmatmul import ops as qops
from repro_torch.kernels.qmatmul import ref as qref
from repro_torch.kernels.simd_fused import ops as simd_ops
from repro_torch.kernels.simd_fused import ref as simd_ref
from repro_torch.kernels.unbind_classify import ops as uc_ops
from repro_torch.kernels.unbind_classify import ref as uc_ref
from repro_torch.vsa import ops as vsa

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["conv", "corr"])
@pytest.mark.parametrize("d", [1, 7, 128, 130, 256, 512])
def test_circ_elem_kernel(gen, d, mode, dtype):
    """Within circ_conv's registry epsilon (1e-3) of the plain version in
    f32; in bf16 both round an f32 sum, so they may sit one bf16 step
    (2^-8 relative) apart."""
    x = torch.randn(67, 4, d, device="cuda", generator=gen).to(dtype)
    y = torch.randn(67, 4, d, device="cuda", generator=gen).to(dtype)
    before = registry.LAUNCHES["circ_conv"]
    got = circ_ops.circ_elem(x, y, mode)
    torch.cuda.synchronize()
    assert registry.LAUNCHES["circ_conv"] == before + 1
    want = circ_ref.circ_elem_ref(x, y, mode)
    assert got.dtype == dtype and got.shape == x.shape
    rtol = 0 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(got.float(), want.float(), atol=1e-3, rtol=rtol)


@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("mkn", [(16, 128, 5), (64, 128, 6), (64, 128, 8),
                                 (67, 130, 7), (300, 257, 40)])
def test_qmatmul_kernel(gen, mkn, int4):
    """Exact int32 accumulators (unit scales) and f32 outputs within 1e-6
    relative of the plain version."""
    m, k, n = mkn
    lim = 8 if int4 else 128
    xq = torch.randint(-128, 128, (m, k), device="cuda", generator=gen,
                       dtype=torch.int8)
    wq = torch.randint(-lim, lim, (k, n), device="cuda", generator=gen,
                       dtype=torch.int8)
    if int4:
        wq = qops.pack_int4(wq)
    n_out = wq.shape[1] * (2 if int4 else 1)
    ones_m = torch.ones(m, device="cuda")
    ones_n = torch.ones(n_out, device="cuda")
    acc = qops.qmatmul(xq, wq, ones_m, ones_n, int4)
    torch.testing.assert_close(acc, qref.qmatmul_acc_ref(xq, wq, int4).float(),
                               atol=0, rtol=0)
    xs = torch.rand(m, device="cuda", generator=gen)
    ws = torch.rand(n_out, device="cuda", generator=gen)
    torch.testing.assert_close(qops.qmatmul(xq, wq, xs, ws, int4),
                               qref.qmatmul_ref(xq, wq, xs, ws, int4),
                               atol=0, rtol=1e-6)


def _same_as_contiguous(call, kernel, *views):
    """``call`` on non-contiguous views makes one launch of ``kernel`` and
    gives bit for bit what it gives on their contiguous copies."""
    assert not all(v.is_contiguous() for v in views)
    before = registry.LAUNCHES[kernel]
    got = call(*views)
    torch.cuda.synchronize()
    assert registry.LAUNCHES[kernel] == before + 1
    assert torch.equal(got, call(*[v.contiguous() for v in views]))


def test_wrappers_reject_what_the_kernels_do_not_take(gen):
    """The public call takes any layout, as the reference does: circ_elem
    reads (N, B) strides in place and copies only an operand whose last
    dimension is not contiguous; the launch itself refuses one."""
    x = torch.randn(4, 2, 64, device="cuda", generator=gen)
    _same_as_contiguous(circ_ops.circ_elem, "circ_conv", x.transpose(0, 1),
                        x.transpose(0, 1))
    _same_as_contiguous(circ_ops.circ_elem, "circ_conv", x.transpose(1, 2),
                        x.transpose(1, 2))
    assert torch.equal(circ_ops._launch(x.transpose(0, 1), x.transpose(0, 1), "conv"),
                       circ_ops.circ_elem(x.transpose(0, 1).contiguous(),
                                          x.transpose(0, 1).contiguous()))
    with pytest.raises(ValueError, match="contiguous last dimension"):
        circ_ops._launch(x.transpose(1, 2), x.transpose(1, 2), "conv")
    with pytest.raises(TypeError):
        circ_ops.circ_elem(x.half(), x.half())
    with pytest.raises(ValueError, match="shared memory"):
        big = torch.zeros(1, 1, 40000, device="cuda")
        circ_ops.circ_elem(big, big)
    xq = torch.zeros(4, 8, dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError, match="do not agree"):
        qops.qmatmul(xq, torch.zeros(8, 3, dtype=torch.int8, device="cuda"),
                     torch.ones(4, device="cuda"), torch.ones(4, device="cuda"))


@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("mkn", [(16, 128, 5), (16, 128, 6), (16, 128, 8), (64, 128, 5),
                                 (64, 128, 6), (64, 128, 8), (67, 130, 7), (64, 640, 8),
                                 (33, 1000, 13), (512, 1024, 256)])
def test_qmatmul_equals_plain_version(gen, mkn, int4):
    """The served shapes (M = 8·bucket in {16, 64}, K = 128, N in {5, 6,
    8}), ragged edges (K = 130 by element loads, K = 1000 through the ring
    by element loads, K = 640 through the ring by cp.async) and one large
    shape: exact int32 accumulators, and outputs equal to qmatmul_ref bit
    for bit (the same epilogue on the same exact sums)."""
    m, k, n = mkn
    lim = 8 if int4 else 128
    xq = torch.randint(-128, 128, (m, k), device="cuda", generator=gen, dtype=torch.int8)
    wq = torch.randint(-lim, lim, (k, n), device="cuda", generator=gen, dtype=torch.int8)
    if int4:  # an odd N is padded for packing, as qdense does
        wq = qops.pack_int4(wq)
    n_out = wq.shape[1] * (2 if int4 else 1)
    xs = torch.rand(m, device="cuda", generator=gen) + 0.01
    ws = torch.rand(n_out, device="cuda", generator=gen) + 0.01
    before = registry.LAUNCHES["qmatmul"]
    acc = qops.qmatmul(xq, wq, torch.ones_like(xs), torch.ones_like(ws), int4)
    got = qops.qmatmul(xq, wq, xs, ws, int4)
    torch.cuda.synchronize()
    assert registry.LAUNCHES["qmatmul"] == before + 2
    assert torch.equal(acc, qref.qmatmul_acc_ref(xq, wq, int4).float())
    assert torch.equal(got, qref.qmatmul_ref(xq, wq, xs, ws, int4))


def _allocations() -> int:
    return torch.cuda.memory_stats()["allocation.all.allocated"]


def _strided_operands(gen, case, dtype, d=256):
    """(x, y) views as NVSA's served binds make them, with the wrapper that
    takes them: a row slice ``codes[:, r0]`` of an (n, 8, B, d) tensor
    against another (stride 8·B·d over N), a key broadcast over the batch
    (``shifts[i][None]``, stride 0), a role broadcast over two lead dims
    (``roles[a][None, None]`` against (n, 8, B, d), merged to stride 0 by
    ``reshape``), and a bf16 or f32 row slice that starts one element past
    a 16-byte boundary (element loads)."""
    codes = torch.randn(8, 8, 4, d, device="cuda", generator=gen).to(dtype)
    key = torch.randn(4, d, device="cuda", generator=gen).to(dtype)
    if case == "row slices":
        return circ_ops.circ_elem, codes[:, 1], codes[:, 0]
    if case == "key over one lead dim":
        return circ_ops.circ_bind, codes[:, 1], key[None]
    if case == "key over two lead dims":
        return circ_ops.circ_bind, codes, key[None, None]
    odd = torch.randn(8, 8, 4, d + 1, device="cuda", generator=gen).to(dtype)
    return circ_ops.circ_elem, odd[:, 1, :, 1:], odd[:, 2, :, 1:]


@pytest.mark.parametrize("mode", ["conv", "corr"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["row slices", "key over one lead dim",
                                  "key over two lead dims", "unaligned row slices"])
def test_circ_elem_reads_strided_operands(gen, case, dtype, mode):
    """Strided and broadcast operands go to the kernel as they are: one
    launch and one allocation (the output; a copy would add one each), bit
    for bit the result on their contiguous copies, the same from launch to
    launch, and within 1e-3 of the plain version (bf16: also one bf16 step,
    2^-7 relative)."""
    call, x, y = _strided_operands(gen, case, dtype)
    xx, yy = torch.broadcast_tensors(x, y)
    assert not (xx.is_contiguous() and yy.is_contiguous())
    torch.cuda.synchronize()
    launches, allocs = registry.LAUNCHES["circ_conv"], _allocations()
    got = call(x, y, mode)
    torch.cuda.synchronize()
    assert registry.LAUNCHES["circ_conv"] == launches + 1
    assert _allocations() == allocs + 1
    assert torch.equal(got, call(xx.contiguous(), yy.contiguous(), mode))
    assert torch.equal(got, call(x, y, mode))
    want = circ_ref.circ_elem_ref(xx, yy, mode)
    rtol = 0 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(got.float(), want.float(), atol=1e-3, rtol=rtol)


def test_quantisers_round_like_the_cpu(gen):
    """Fake-quantised int4 weights quantised again per column land on exact
    .5 ties; the card must round them as the CPU does."""
    from repro_torch.models import nvsa

    w = nvsa.fake_quant(torch.randn(128, 7, device="cuda", generator=gen), "int4")
    for bits in (4, 8):
        q_gpu, s_gpu = qops.quantize_cols(w, bits)
        q_cpu, s_cpu = qops.quantize_cols(w.cpu(), bits)
        assert torch.equal(q_gpu.cpu(), q_cpu) and torch.equal(s_gpu.cpu(), s_cpu)
    x = torch.randn(64, 128, device="cuda", generator=gen)
    for prec in ("int8", "int4"):
        assert torch.equal(nvsa.fake_quant(x, prec).cpu(),
                           nvsa.fake_quant(x.cpu(), prec))
    q_gpu, s_gpu = qops.quantize_rows(x)
    q_cpu, s_cpu = qops.quantize_rows(x.cpu())
    assert torch.equal(q_gpu.cpu(), q_cpu) and torch.equal(s_gpu.cpu(), s_cpu)


def _uc_inputs(gen, n, d, k=2, blocks=4, c=5):
    keys = torch.randn(k, blocks, d, device="cuda", generator=gen) / d ** 0.5
    x = torch.randn(n, blocks, d, device="cuda", generator=gen)
    w = torch.randn(blocks, d, c, device="cuda", generator=gen) / (blocks * d) ** 0.5
    b = torch.randn(1, c, device="cuda", generator=gen)
    return keys, x, w, b


@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("n", [1, 8, 13])
def test_unbind_classify_kernel(gen, n, d):
    """Within the registry epsilon (1e-3) of the plain version, at the
    shapes chip_smoke.py's phase 2 checks; one launch per call."""
    keys, x, w, b = _uc_inputs(gen, n, d)
    before = registry.LAUNCHES["unbind_classify"]
    got = uc_ops.fused_unbind_classify(keys, x, w, b)
    torch.cuda.synchronize()
    assert registry.LAUNCHES["unbind_classify"] == before + 1
    assert got.dtype == torch.float32 and got.shape == (n, 2, 5)
    want = uc_ref.fused_unbind_classify_ref(keys, x, w, b)
    torch.testing.assert_close(got, want, atol=1e-3, rtol=0)


@pytest.mark.parametrize("d,c", [(1, 1), (7, 3), (130, 32), (512, 17)])
def test_unbind_classify_kernel_odd_shapes(gen, d, c):
    """Any d (the index wraps by a compare) and any C up to the cap."""
    keys, x, w, b = _uc_inputs(gen, 5, d, k=3, blocks=2, c=c)
    torch.testing.assert_close(uc_ops.fused_unbind_classify(keys, x, w, b),
                               uc_ref.fused_unbind_classify_ref(keys, x, w, b),
                               atol=1e-3, rtol=0)


@pytest.mark.parametrize("c", [1, 32])
@pytest.mark.parametrize("d", [1, 7, 130, 512])
@pytest.mark.parametrize("blocks", [1, 9])
def test_unbind_classify_kernel_blocks_dims_classes(gen, blocks, d, c):
    """The split d-sum at B = 1 and 9, d around its 64-output tiles and C at
    both ends: within the registry epsilon (1e-3) of the plain version, and
    bit-identical on a second launch."""
    keys, x, w, b = _uc_inputs(gen, 7, d, k=3, blocks=blocks, c=c)
    got = uc_ops.fused_unbind_classify(keys, x, w, b)
    assert got.shape == (7, 3, c)
    torch.testing.assert_close(got, uc_ref.fused_unbind_classify_ref(keys, x, w, b),
                               atol=1e-3, rtol=0)
    assert torch.equal(uc_ops.fused_unbind_classify(keys, x, w, b), got)


def test_unbind_classify_at_its_shared_memory_limit(gen):
    """At MAX_D one staged VSA block fills the shared memory: the kernel
    runs there and is right; one more and the wrapper raises."""
    keys, x, w, b = _uc_inputs(gen, 2, uc_ops.MAX_D, k=1, blocks=1, c=3)
    torch.testing.assert_close(uc_ops.fused_unbind_classify(keys, x, w, b),
                               uc_ref.fused_unbind_classify_ref(keys, x, w, b),
                               atol=1e-3, rtol=0)
    keys, x, w, b = _uc_inputs(gen, 2, uc_ops.MAX_D + 1, k=1, blocks=1, c=3)
    with pytest.raises(ValueError, match="shared memory"):
        uc_ops.fused_unbind_classify(keys, x, w, b)


def test_unbind_classify_is_deterministic(gen):
    """A fixed-order reduction without atomics: repeated launches give
    bit-identical logits."""
    keys, x, w, b = _uc_inputs(gen, 13, 256)
    first = uc_ops.fused_unbind_classify(keys, x, w, b)
    for _ in range(5):
        assert torch.equal(uc_ops.fused_unbind_classify(keys, x, w, b), first)


def test_unbind_classify_rejects_what_the_kernel_does_not_take(gen):
    keys, x, w, b = _uc_inputs(gen, 4, 128)
    with pytest.raises(TypeError, match="float32"):
        uc_ops.fused_unbind_classify(keys, x.double(), w, b)
    view = x.transpose(0, 1).contiguous().transpose(0, 1)
    _same_as_contiguous(lambda xx: uc_ops.fused_unbind_classify(keys, xx, w, b),
                        "unbind_classify", view)
    with pytest.raises(ValueError, match="contiguous"):
        uc_ops._launch(keys, view, w, b)
    big_w = torch.zeros(4, 128, uc_ops.MAX_CLASSES + 1, device="cuda")
    big_b = torch.zeros(1, uc_ops.MAX_CLASSES + 1, device="cuda")
    with pytest.raises(ValueError, match="classes"):
        uc_ops.fused_unbind_classify(keys, x, big_w, big_b)
    with pytest.raises(ValueError, match="do not agree"):
        uc_ops.fused_unbind_classify(keys, x[:, :2].contiguous(), w, b)


# -- gradients -----------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["bind", "unbind"])
@pytest.mark.parametrize("d", [128, 256])
def test_bind_unbind_gradient_on_the_card(gen, d, op, dtype):
    """vsa.bind / vsa.unbind at d >= 128 on the card are differentiable:
    the backward is two circ_conv launches, and the gradients (a (1, B, d)
    key broadcast against (N, B, d) codes) are within 1e-4 of the CPU's;
    at bf16 both round an f32 sum to bf16, so they may also sit one bf16
    step (2^-7 relative) apart."""
    a = torch.randn(9, 4, d, device="cuda", generator=gen) / d ** 0.5
    b = torch.randn(1, 4, d, device="cuda", generator=gen) / d ** 0.5
    w = torch.randn(9, 4, d, device="cuda", generator=gen)
    a, b, w = (t.to(dtype) for t in (a, b, w))
    grads = {}
    for dev in ("cuda", "cpu"):
        aa = a.to(dev).clone().requires_grad_()
        bb = b.to(dev).clone().requires_grad_()
        out = getattr(vsa, op)(aa, bb)
        assert out.grad_fn is not None and out.dtype == dtype
        before = registry.LAUNCHES["circ_conv"]
        grads[dev] = torch.autograd.grad((w.to(dev) * out).sum(), (aa, bb))
        if dev == "cuda":
            torch.cuda.synchronize()
            assert registry.LAUNCHES["circ_conv"] == before + 2
    rtol = 0 if dtype == torch.float32 else 2 ** -7
    for g_gpu, g_cpu in zip(grads["cuda"], grads["cpu"]):
        assert g_gpu.dtype == dtype
        torch.testing.assert_close(g_gpu.cpu().float(), g_cpu.float(), atol=1e-4, rtol=rtol)


def _loss_grads_on(dev, fn, has_aux, params, *args):
    """``fn``'s loss and grads on ``dev`` (params and tensor args moved
    there), and the circ_conv launches of the value and its backward."""
    from repro_torch.common.tree import tree_map
    from repro_torch.train import optimizer as opt

    def move(t):
        return t.to(dev) if isinstance(t, torch.Tensor) else t

    args = [tree_map(move, a) for a in args]
    before = registry.LAUNCHES["circ_conv"]
    out, grads = opt.value_and_grad(fn, has_aux)(tree_map(move, params), *args)
    loss = float(out[0] if has_aux else out)
    return loss, grads, registry.LAUNCHES["circ_conv"] - before


@pytest.mark.parametrize("model", ["mimonet", "lvrf"])
def test_training_loss_backward_on_the_card(gen, model):
    """mimonet.loss_fn (4 problems of K = 2, d = 128) and lvrf.loss_fn (16
    oracle problems, d = 128) on the card against the CPU: the loss within
    1e-5, each grad leaf within 1e-4 of its max |grad|, TF32 off.  Their
    gradients run through circ_conv's backward, one launch per operand that
    needs a gradient: mimonet 2 forward + 2 backward launches (the keys are
    constants), lvrf 27 + 36 (the 18 role binds of constant codes need one
    product, the 9 rule binds two)."""
    from repro_torch.common.tree import tree_leaves
    from repro_torch.data import raven
    from repro_torch.models import lvrf, mimonet, nvsa
    from repro_torch.nn import init as nninit

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = torch.Generator().manual_seed(3)
    if model == "mimonet":
        cfg = mimonet.MIMONetConfig(d=128, cnn_width=4, trunk_hidden=128)
        params = nninit.materialize(mimonet.mimonet_spec(cfg), cpu)
        keys = mimonet.mimonet_keys(cfg, cpu)
        images = torch.rand(4, 2, 32, 32, 1, generator=cpu)
        labels = torch.randint(0, cfg.n_classes, (4, 2), generator=cpu)
        fn, has_aux, args, want = mimonet.loss_fn, True, (keys, cfg, images, labels), 2 + 2
    else:
        cfg = lvrf.LVRFConfig(d=128)
        params = nninit.materialize(lvrf.lvrf_spec(cfg), cpu)
        books = lvrf.lvrf_codebooks(cfg, cpu)
        batch = raven.generate_batch(cfg.raven, seed=5, n=16)
        ncfg = nvsa.NVSAConfig()
        ctx = nvsa.oracle_pmfs(ncfg, torch.from_numpy(batch["context_attrs"]))
        cand = nvsa.oracle_pmfs(ncfg, torch.from_numpy(batch["candidate_attrs"]))
        answers = torch.from_numpy(batch["answer"])
        fn, has_aux, args, want = lvrf.loss_fn, False, (books, cfg, ctx, cand, answers), 27 + 36
    got = {dev: _loss_grads_on(dev, fn, has_aux, params, *args) for dev in ("cuda", "cpu")}
    assert got["cuda"][2] == want and got["cpu"][2] == 0
    assert abs(got["cuda"][0] - got["cpu"][0]) <= 1e-5
    for g_gpu, g_cpu in zip(tree_leaves(got["cuda"][1]), tree_leaves(got["cpu"][1])):
        assert (g_gpu is None) == (g_cpu is None)
        if g_cpu is not None:
            scale = max(float(g_cpu.abs().max()), 1e-30)
            torch.testing.assert_close(g_gpu.cpu(), g_cpu, atol=1e-4 * scale, rtol=0)


def test_unbind_classify_gradient_on_the_card(gen):
    """fused_unbind_classify on the card: the forward is one kernel launch,
    the backward the plain chain's autograd (no launch); gradients in all
    four inputs within 1e-4 of the CPU's."""
    args = _uc_inputs(gen, 13, 256)
    w = torch.randn(13, 2, 5, device="cuda", generator=gen)
    grads = {}
    for dev in ("cuda", "cpu"):
        leaves = [t.to(dev).clone().requires_grad_() for t in args]
        before = registry.LAUNCHES["unbind_classify"]
        out = uc_ops.fused_unbind_classify(*leaves)
        grads[dev] = torch.autograd.grad((w.to(dev) * out).sum(), leaves)
        if dev == "cuda":
            torch.cuda.synchronize()
            assert registry.LAUNCHES["unbind_classify"] == before + 1
    for g_gpu, g_cpu in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(g_gpu.cpu(), g_cpu, atol=1e-4, rtol=0)


def test_forward_only_kernels_refuse_grad_on_the_card(gen):
    """circ_bind_dict has no backward (nor has its Pallas twin): on the card
    it raises where autograd would need one, and runs under no_grad or on
    inputs that need none.  flash_mha has one: under grad its kernel
    forward returns a result with a ``grad_fn``, whose gradient (the plain
    chain's, recomputed) lies within 1e-4 of each input's max |grad| of
    autograd through the plain version."""
    q = torch.randn(1, 16, 2, 64, device="cuda", generator=gen)
    x = torch.randn(4, 2, 64, device="cuda", generator=gen)
    qg, xg = q.clone().requires_grad_(), x.clone().requires_grad_()
    out = flash_ops.flash_mha(qg, q, q, 0.125)
    assert out.grad_fn is not None
    (got,) = torch.autograd.grad(out.sum(), [qg])
    (want,) = torch.autograd.grad(flash_ops._plain(qg, q, q, 0.125, True).sum(), [qg])
    torch.testing.assert_close(got, want, atol=1e-4 * float(want.abs().max()), rtol=0)
    with pytest.raises(RuntimeError, match="no backward"):
        circ_ops.circ_bind_dict(xg, x)
    with torch.no_grad():
        assert torch.equal(flash_ops.flash_mha(qg, q, q, 0.125),
                           flash_ops.flash_mha(q, q, q, 0.125))
        assert torch.equal(circ_ops.circ_bind_dict(xg, x), circ_ops.circ_bind_dict(x, x))


@pytest.mark.parametrize("shape, skv", [((1, 256, 4, 128), 256), ((2, 100, 3, 64), 300)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_mha_gradients_on_the_card(gen, shape, skv, dtype):
    """``_FlashMHA`` on the card: one kernel launch a forward and none in
    the backward; the output within the forward's limits (2e-5 at f32, 1e-3
    + one bf16 step at bf16) and the gradients of q, k and v within 1e-4 of
    each one's max |grad| of autograd through the plain version on the same
    inputs (the backward is that chain, recomputed)."""
    b, sq, h, hd = shape
    q = torch.randn(b, sq, h, hd, device="cuda", generator=gen).to(dtype)
    k, v = (torch.randn(b, skv, h, hd, device="cuda", generator=gen).to(dtype) for _ in "kv")
    g = torch.randn(b, sq, h, hd, device="cuda", generator=gen).to(dtype)
    grads = {}
    for name, fn in (("kernel", flash_ops.flash_mha), ("plain", flash_ops._plain)):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        before = registry.LAUNCHES["flash_attn"]
        out = fn(*leaves, hd ** -0.5, True)
        grads[name] = (out, torch.autograd.grad(out, leaves, g))
        torch.cuda.synchronize()
        assert registry.LAUNCHES["flash_attn"] == before + (name == "kernel")
    (out_k, g_k), (out_p, g_p) = grads["kernel"], grads["plain"]
    atol, rtol = (2e-5, 0) if dtype == torch.float32 else (1e-3, 2 ** -7)
    torch.testing.assert_close(out_k.float(), out_p.float(), atol=atol, rtol=rtol)
    for a, w in zip(g_k, g_p):
        assert a.dtype == dtype
        torch.testing.assert_close(a.float(), w.float(), rtol=0,
                                   atol=1e-4 * float(w.float().abs().max()))


def test_lm_loss_and_grads_on_the_card():
    """llama3.2-3b's smoke width at f32 compute, remat on: the loss and
    grads of ``configs.base.loss_fn`` on the card against the CPU (loss
    within 1e-5 relative, each grad leaf within 1e-4 of its max |grad|),
    with two flash_attn launches a layer (the forward and remat's
    recompute)."""
    import dataclasses

    from repro_torch.common.tree import tree_leaves
    from repro_torch.configs import ARCHS
    from repro_torch.configs import base as cbase
    from repro_torch.nn import init as nninit
    from repro_torch.train import optimizer as opt

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    arch = ARCHS["llama3.2-3b"]
    cfg = dataclasses.replace(arch.make_smoke(), compute_dtype=torch.float32, remat=True)
    params = nninit.materialize(cbase.model_spec(arch, cfg), torch.Generator().manual_seed(3))
    cpu_gen = torch.Generator().manual_seed(4)
    batch = {k: torch.randint(0, cfg.vocab, (2, 64), generator=cpu_gen) for k in
             ("tokens", "targets")}
    out = {}
    for dev in ("cuda", "cpu"):
        before = registry.LAUNCHES["flash_attn"]
        out[dev] = opt.value_and_grad(cbase.loss_fn(arch, cfg))(_to(params, dev),
                                                                 _to(batch, dev))
        if dev == "cuda":
            torch.cuda.synchronize()
            assert registry.LAUNCHES["flash_attn"] == before + 2 * cfg.n_layers
    (lg, gg), (lc, gc) = out["cuda"], out["cpu"]
    assert abs(float(lg) - float(lc)) <= 1e-5 * abs(float(lc))
    for a, w in zip(tree_leaves(gg), tree_leaves(gc), strict=True):
        torch.testing.assert_close(a.cpu(), w, rtol=0, atol=1e-4 * float(w.abs().max()))


def _to(tree, dev):
    from repro_torch.common.tree import tree_map

    return tree_map(lambda t: t.to(dev), tree)


KIND_ARCHS = ("granite-moe-1b-a400m", "deepseek-v3-671b", "rwkv6-7b", "recurrentgemma-9b",
              "internvl2-26b", "seamless-m4t-large-v2")


def _kind_cfg_and_batch(arch, gen):
    """The arch's smoke config at f32 compute and f32 parameters, remat on,
    and one batch of its kind: tokens (2, 32) (after 16 patch embeddings
    for the VLM), or (2, 48) frames and (2, 32) targets for the enc-dec
    kind."""
    import dataclasses

    cfg = arch.make_smoke()
    f32 = dict(compute_dtype=torch.float32, param_dtype=torch.float32, remat=True)
    if arch.kind == "vlm":
        cfg = dataclasses.replace(cfg, lm=dataclasses.replace(cfg.lm, **f32))
        vocab, d = cfg.lm.vocab, cfg.lm.d_model
    else:
        cfg = dataclasses.replace(cfg, **f32)
        vocab, d = cfg.vocab, cfg.d_model
    ids = lambda: torch.randint(0, vocab, (2, 32), generator=gen)  # noqa: E731
    if arch.kind == "encdec":
        return cfg, {"frames": torch.randn(2, 48, d, generator=gen), "tgt_tokens": ids(),
                     "tgt_targets": ids()}
    batch = {"tokens": ids(), "targets": ids()}
    if arch.kind == "vlm":
        batch["patch_embeds"] = torch.randn(2, cfg.n_img_tokens, d, generator=gen)
    return cfg, batch


@pytest.mark.parametrize("arch_id", KIND_ARCHS)
def test_kind_loss_and_grads_on_the_card(arch_id):
    """Every other kind's ``configs.base.loss_fn`` at its smoke width, f32
    compute and remat on, with the bounds of
    ``test_lm_loss_and_grads_on_the_card``: the MoE aux (granite-moe), MLA
    and the MTP head (deepseek-v3, its bf16 parameters drawn in f32: a bf16
    leaf's gradient rounds an f32 sum, and a last-bit difference between
    the devices moves it a bf16 step, past 1e-4 of the leaf's max), the
    recurrent kinds, the VLM and the enc-dec kind.  The card launches
    flash_attn once for each ``flash_mha`` call the same loss makes on the
    CPU (the forward and remat's recompute; MLA, windowed and recurrent
    layers make none)."""
    from repro_torch.common.tree import tree_leaves
    from repro_torch.configs import ARCHS
    from repro_torch.configs import base as cbase
    from repro_torch.nn import init as nninit
    from repro_torch.train import optimizer as opt

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    arch = ARCHS[arch_id]
    cpu_gen = torch.Generator().manual_seed(5 + KIND_ARCHS.index(arch_id))
    cfg, batch = _kind_cfg_and_batch(arch, cpu_gen)
    params = nninit.materialize(cbase.model_spec(arch, cfg), cpu_gen)
    out = {}
    for dev in ("cpu", "cuda"):
        before = registry.LAUNCHES["flash_attn"]
        with registry.record_kernels() as calls:
            out[dev] = opt.value_and_grad(cbase.loss_fn(arch, cfg))(_to(params, dev),
                                                                     _to(batch, dev))
        if dev == "cuda":
            torch.cuda.synchronize()
            assert registry.LAUNCHES["flash_attn"] - before == want_launches
        else:
            want_launches = sum(1 for k, _ in calls if k == "flash_attn")
    if arch.kind in ("lm", "vlm", "encdec") and arch_id != "deepseek-v3-671b":
        assert want_launches > 0
    (lc, gc), (lg, gg) = out["cpu"], out["cuda"]
    assert abs(float(lg) - float(lc)) <= 1e-5 * abs(float(lc))
    for a, w in zip(tree_leaves(gg), tree_leaves(gc), strict=True):
        assert (a is None) == (w is None)
        if w is not None:
            torch.testing.assert_close(a.cpu(), w, rtol=0, atol=1e-4 * float(w.abs().max()))


# -- circ_dict -----------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["conv", "corr"])
@pytest.mark.parametrize("nmbd", [(256, 16, 4, 256), (67, 5, 4, 128), (13, 3, 2, 130)])
def test_circ_dict_kernel(gen, nmbd, mode, dtype):
    """circ_bind_dict's (N, M, B, d) and circ_dict's (N, B, M, d) view of it
    within the registry epsilon (1e-3) of the plain version in f32, one bf16
    step apart in bf16; one launch per call."""
    n, m, b, d = nmbd
    x = torch.randn(n, b, d, device="cuda", generator=gen).to(dtype)
    dic = torch.randn(m, b, d, device="cuda", generator=gen).to(dtype)
    before = registry.LAUNCHES["circ_dict"]
    got = circ_ops.circ_dict(x, dic, mode)
    bound = circ_ops.circ_bind_dict(x, dic, mode)
    torch.cuda.synchronize()
    assert registry.LAUNCHES["circ_dict"] == before + 2
    want = circ_ref.circ_dict_ref(x, dic, mode)
    assert got.dtype == dtype and got.shape == (n, b, m, d) and bound.shape == (n, m, b, d)
    rtol = 0 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(got.float(), want.float(), atol=1e-3, rtol=rtol)
    torch.testing.assert_close(bound, got.transpose(1, 2), atol=0, rtol=0)


def test_circ_dict_rejects_what_the_kernel_does_not_take(gen):
    x = torch.randn(4, 2, 64, device="cuda", generator=gen)
    with pytest.raises(TypeError):
        circ_ops.circ_dict(x.half(), x.half())
    with pytest.raises(TypeError):
        circ_ops.circ_dict(x, x.bfloat16())
    with pytest.raises(ValueError, match="wants"):
        circ_ops.circ_dict(x, x[:, :1].contiguous())
    _same_as_contiguous(circ_ops.circ_dict, "circ_dict", x.transpose(0, 1),
                        x.transpose(0, 1))
    with pytest.raises(ValueError, match="contiguous"):
        circ_ops._launch_dict(x.transpose(0, 1), x.transpose(0, 1), "conv")
    big = torch.zeros(1, 1, circ_ops.DICT_MAX_D + 1, device="cuda")
    with pytest.raises(ValueError, match="shared memory"):
        circ_ops.circ_bind_dict(big, big)
    edge = torch.randn(2, 1, circ_ops.DICT_MAX_D, device="cuda", generator=gen)
    torch.testing.assert_close(circ_ops.circ_dict(edge, edge[:1]),
                               circ_ref.circ_dict_ref(edge, edge[:1]), atol=1e-3, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["conv", "corr"])
def test_circ_dict_is_bit_identical_across_launches_and_n(gen, mode, dtype):
    """Each output's k-sum runs in an order that depends on d alone: two
    launches agree bit for bit, and row n of circ_bind_dict(x, dic) equals
    the same row computed from x[n0:n1], whatever tile of 16 or 32 queries
    it lands in (N = 1, 13, 67, 257, at offsets that move the tiles)."""
    x = torch.randn(300, 4, 256, device="cuda", generator=gen).to(dtype)
    dic = torch.randn(16, 4, 256, device="cuda", generator=gen).to(dtype)
    full = circ_ops.circ_bind_dict(x, dic, mode)
    assert torch.equal(circ_ops.circ_bind_dict(x, dic, mode), full)
    for n in (1, 13, 67, 257):
        for n0 in (0, 5, 300 - n):
            part = circ_ops.circ_bind_dict(x[n0:n0 + n], dic, mode)
            assert torch.equal(part, full[n0:n0 + n]), (n, n0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["conv", "corr"])
@pytest.mark.parametrize("d", [1, 7, 8, 16, 130, 512, "max"])
def test_circ_dict_kernel_block_dims(gen, d, mode, dtype):
    """circ_dict at block dims around its 64-column tiles, up to the
    largest d its shared memory takes (DICT_MAX_D, DICT_MAX_D_BF16): within
    1e-3 of the plain version in f32 and one bf16 step more in bf16 (the
    limits of test_circ_dict_kernel), on x that starts at an odd element
    (element loads) as well as on an aligned one."""
    if d == "max":
        d = circ_ops.DICT_MAX_D if dtype == torch.float32 else circ_ops.DICT_MAX_D_BF16
    n, m, b = 21, 3, 2
    flat = torch.randn(n * b * d + 1, device="cuda", generator=gen).to(dtype)
    dic = torch.randn(m, b, d, device="cuda", generator=gen).to(dtype)
    rtol = 0 if dtype == torch.float32 else 2 ** -7
    for x in (flat[: n * b * d].view(n, b, d), flat[1:].view(n, b, d)):
        got = circ_ops.circ_bind_dict(x, dic, mode)
        want = circ_ref.circ_dict_ref(x, dic, mode).transpose(1, 2)
        assert got.dtype == dtype and got.shape == (n, m, b, d)
        torch.testing.assert_close(got.float(), want.float(), atol=1e-3, rtol=rtol)


# -- fused match_prob ----------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nmbd,temp", [((512, 16, 4, 256), 0.1), ((67, 5, 4, 128), 1.0),
                                       ((64, 1024, 4, 256), 0.1)])
def test_match_prob_kernel(gen, nmbd, temp, dtype):
    """Within 1e-6 + 1e-4 relative of the plain version (far inside the
    registry epsilon, 1e-3, and far below a probability of 1/M), rows
    summing to 1; M = 1024 splits the dictionary over a cluster of 8 CTAs."""
    n, m, b, d = nmbd
    q = torch.randn(n, b, d, device="cuda", generator=gen).to(dtype)
    dic = torch.randn(m, b, d, device="cuda", generator=gen).to(dtype)
    before = registry.LAUNCHES["simd_fused"]
    got = simd_ops.fused_match_prob(q, dic, temp)
    torch.cuda.synchronize()
    assert registry.LAUNCHES["simd_fused"] == before + 1
    assert got.dtype == torch.float32 and got.shape == (n, m)
    torch.testing.assert_close(got, simd_ref.fused_match_prob_ref(q, dic, temp),
                               atol=1e-6, rtol=1e-4)
    torch.testing.assert_close(got.sum(dim=-1), torch.ones(n, device="cuda"),
                               atol=1e-5, rtol=0)


def test_match_prob_gradient_on_the_card(gen):
    """vsa.match_prob at d >= 128 goes through the kernel and back through
    the plain chain: gradients within 1e-4 of the CPU's."""
    q = torch.randn(32, 4, 128, device="cuda", generator=gen)
    dic = torch.randn(7, 4, 128, device="cuda", generator=gen)
    w = torch.randn(32, 7, device="cuda", generator=gen)
    grads = {}
    for dev in ("cuda", "cpu"):
        qq = q.to(dev).clone().requires_grad_()
        dd = dic.to(dev).clone().requires_grad_()
        (w.to(dev) * vsa.match_prob(qq, dd, 0.1)).sum().backward()
        grads[dev] = (qq.grad, dd.grad)
    for g_gpu, g_cpu in zip(*grads.values()):
        torch.testing.assert_close(g_gpu.cpu(), g_cpu, atol=1e-4, rtol=0)


def test_match_prob_rejects_what_the_kernel_does_not_take(gen):
    q = torch.randn(8, 4, 256, device="cuda", generator=gen)
    with pytest.raises(TypeError):
        simd_ops.fused_match_prob(q.double(), q.double())
    with pytest.raises(TypeError):
        simd_ops.fused_match_prob(q, q.bfloat16())
    with pytest.raises(ValueError, match="wants"):
        simd_ops.fused_match_prob(q, q[:, :2].contiguous())
    limit = simd_ops.max_entries(4, 256)
    dic = torch.randn(limit + 1, 4, 256, device="cuda", generator=gen)
    with pytest.raises(ValueError, match=f"M <= {limit}"):
        simd_ops.fused_match_prob(q, dic)
    got = simd_ops.fused_match_prob(q, dic[:limit], 1.0)
    torch.testing.assert_close(got, simd_ref.fused_match_prob_ref(q, dic[:limit], 1.0),
                               atol=1e-6, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nmbd,splits", [
    ((20, 1003, 4, 256), 8),    # M not a multiple of S (7 x 126 + 121)
    ((67, 300, 4, 128), 7),     # N not a multiple of the query tile, M of S
    ((8, 1, 4, 256), 1),        # one entry
    ((8, 13249, 4, 256), 8),    # above the first design's limit: 13 passes a CTA
    ((9, 37, 3, 130), 2),       # rows of 130 elements: element copies, zero padding
])
def test_match_prob_kernel_cluster_split(gen, nmbd, splits, dtype):
    """The dictionary split over a cluster of S CTAs, at the edges of its
    geometry: within the limit of test_match_prob_kernel (1e-6 + 1e-4
    relative of the plain version), rows summing to 1."""
    n, m, b, d = nmbd
    assert simd_ops.cluster_size(n, m, b, d) == splits
    q = torch.randn(n, b, d, device="cuda", generator=gen).to(dtype)
    dic = torch.randn(m, b, d, device="cuda", generator=gen).to(dtype)
    got = simd_ops.fused_match_prob(q, dic, 0.1)
    torch.testing.assert_close(got, simd_ref.fused_match_prob_ref(q, dic, 0.1),
                               atol=1e-6, rtol=1e-4)
    torch.testing.assert_close(got.sum(dim=-1), torch.ones(n, device="cuda"),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_match_prob_rows_across_n(gen, dtype):
    """Each (query, entry) sum runs in an order fixed by B and d: a row of
    q[n0:n0 + n] equals the same row of every other call with the same
    cluster size S bit for bit, whatever tile it lands in, and the full
    call's within the kernel's limit where S differs.  An operand that
    starts one element into its storage (copied element by element, not
    by cp.async) gives the aligned call's bits."""
    q = torch.randn(300, 4, 256, device="cuda", generator=gen).to(dtype)
    dic = torch.randn(1024, 4, 256, device="cuda", generator=gen).to(dtype)
    full = simd_ops.fused_match_prob(q, dic, 0.1)
    seen = {}
    for n in (1, 13, 64, 257, 295, 300):
        for n0 in sorted({0, min(5, 300 - n), 300 - n}):
            part = simd_ops.fused_match_prob(q[n0:n0 + n], dic, 0.1)
            s = simd_ops.cluster_size(n, 1024, 4, 256)
            torch.testing.assert_close(part, full[n0:n0 + n], atol=1e-6, rtol=1e-4)
            for i in range(n):
                if (s, n0 + i) in seen:
                    assert torch.equal(part[i], seen[s, n0 + i]), (n, n0, i)
                seen[s, n0 + i] = part[i]
    assert {s for s, _ in seen} == {1, 2, 8}
    shifted = simd_ops.fused_match_prob(_offset_by_one(q[:64]), _offset_by_one(dic), 0.1)
    assert torch.equal(shifted, simd_ops.fused_match_prob(q[:64], dic, 0.1))


def test_match_prob_is_one_device_launch(gen):
    """A call runs one kernel on the card (no normalisation pass) and
    allocates its output and nothing else."""
    q = torch.randn(512, 4, 256, device="cuda", generator=gen)
    dic = torch.randn(16, 4, 256, device="cuda", generator=gen)
    simd_ops.fused_match_prob(q, dic, 0.1)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = simd_ops.fused_match_prob(q, dic, 0.1)
        torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() - before == out.numel() * 4
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "match_prob_kernel" in kernels[0], kernels


# -- flash attention -----------------------------------------------------------


def _offset_by_one(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` whose data starts one element into its
    storage, so that it is not 16-byte aligned."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


FLASH_CASES = [
    ((1, 1024, 8, 128), 1024, True), ((2, 100, 4, 64), 300, True),
    ((2, 100, 4, 64), 300, False), ((1, 300, 2, 128), 100, True),
    ((1, 1000, 2, 80), 1000, True), ((1, 200, 2, 256), 200, True),
    ((2, 130, 3, 36), 250, True), ((2, 130, 3, 36), 250, False),
    ((1, 77, 2, 128), 333, True), ((1, 77, 2, 128), 333, False),
]
FLASH_UNALIGNED_CASES = [((1, 130, 2, 128), 250, True), ((2, 100, 4, 64), 300, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,skv,causal", FLASH_CASES)
def test_flash_attn_kernel(gen, shape, skv, causal, dtype):
    """Within 1e-3 of the plain version at f32 and 1e-3 plus one bf16 step
    (2^-7 relative) at bf16, far inside the registry epsilon (3e-2); Sq !=
    Skv pins the top-left causal alignment, S = 1000, Sq = 77 or 130 and hd
    = 80 the ragged tiles, hd = 36 the element loads of the bf16 kernel
    (hd % 8 != 0) and hd = 256 its largest head dim."""
    _check_flash(gen, shape, skv, causal, dtype, aligned=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,skv,causal", FLASH_UNALIGNED_CASES)
def test_flash_attn_kernel_unaligned(gen, shape, skv, causal, dtype):
    """Inputs that start off a 16-byte boundary (contiguous views at an
    offset) take the bf16 kernel's element loads at hd % 8 == 0; same
    limits as ``test_flash_attn_kernel``."""
    _check_flash(gen, shape, skv, causal, dtype, aligned=False)


@pytest.mark.parametrize("shape,skv,causal,aligned",
                         [case + (True,) for case in FLASH_CASES]
                         + [case + (False,) for case in FLASH_UNALIGNED_CASES])
def test_flash_attn_f32_keeps_f32_accuracy(gen, shape, skv, causal, aligned):
    """The f32 kernel's 3xTF32 products keep f32 accuracy: within 2e-5 of
    the plain version on every f32 case above.  One tf32 product per f32
    product (the hi/lo split lost) is off by about 1e-3 here: a causal
    row 0 returns v rounded to tf32."""
    _check_flash(gen, shape, skv, causal, torch.float32, aligned, atol=2e-5)


def _check_flash(gen, shape, skv, causal, dtype, aligned, atol=1e-3):
    b, sq, h, hd = shape
    q = torch.randn(b, sq, h, hd, device="cuda", generator=gen).to(dtype)
    k = torch.randn(b, skv, h, hd, device="cuda", generator=gen).to(dtype)
    v = torch.randn(b, skv, h, hd, device="cuda", generator=gen).to(dtype)
    if not aligned:
        q, k, v = (_offset_by_one(t) for t in (q, k, v))
        assert q.data_ptr() % 16 != 0 and q.is_contiguous()
    before = registry.LAUNCHES["flash_attn"]
    got = flash_ops.flash_mha(q, k, v, hd ** -0.5, causal)
    torch.cuda.synchronize()
    assert registry.LAUNCHES["flash_attn"] == before + 1
    flat = lambda t: t.transpose(1, 2).reshape(b * h, t.shape[1], hd)
    want = flash_ref.flash_attention_ref(flat(q), flat(k), flat(v), scale=hd ** -0.5,
                                         causal=causal)
    want = want.reshape(b, h, sq, hd).transpose(1, 2)
    assert got.dtype == dtype and got.shape == q.shape
    rtol = 0 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


def test_flash_attn_rejects_what_the_kernel_does_not_take(gen):
    q = torch.randn(1, 16, 2, 64, device="cuda", generator=gen)
    with pytest.raises(TypeError):
        flash_ops.flash_mha(q.half(), q.half(), q.half(), 0.125)
    with pytest.raises(TypeError):
        flash_ops.flash_mha(q, q.bfloat16(), q.bfloat16(), 0.125)
    with pytest.raises(ValueError, match="wants"):
        flash_ops.flash_mha(q, q[:, :, :1].contiguous(), q, 0.125)
    qt = q.transpose(1, 2)
    _same_as_contiguous(lambda a, b, c: flash_ops.flash_mha(a, b, c, 0.125), "flash_attn",
                        qt, qt, qt)
    with pytest.raises(ValueError, match="contiguous"):
        flash_ops._launch(qt, qt, qt, 0.125, True)
    big = torch.zeros(1, 4, 1, flash_ops.MAX_HEAD_DIM + 1, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        flash_ops.flash_mha(big, big, big, 0.0625)


def test_new_kernels_are_deterministic(gen):
    """No atomics and fixed reduction orders: repeated launches of the three
    kernels (flash_attn at f32 and bf16) give bit-identical outputs."""
    x = torch.randn(67, 4, 256, device="cuda", generator=gen)
    dic = torch.randn(16, 4, 256, device="cuda", generator=gen)
    q = torch.randn(1, 300, 4, 128, device="cuda", generator=gen)
    qb = q.bfloat16()
    calls = [lambda: circ_ops.circ_bind_dict(x, dic),
             lambda: simd_ops.fused_match_prob(x, dic, 0.1),
             lambda: flash_ops.flash_mha(q, q, q, 128 ** -0.5),
             lambda: flash_ops.flash_mha(qb, qb, qb, 128 ** -0.5)]
    for call in calls:
        first = call()
        for _ in range(3):
            assert torch.equal(call(), first)


# -- the MoE / MLA substrate -----------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 2048, 16, 64), (4, 512, 16, 64)])
def test_flash_attn_bf16_at_granite_head_dim(gen, shape):
    """The bf16 kernel's head-dim-64 instantiation at granite-moe's forward
    shapes (16 heads of 64), the limits of ``test_flash_attn_kernel``."""
    _check_flash(gen, shape, shape[1], True, torch.bfloat16, aligned=True)


@pytest.mark.parametrize("arch_id", ["granite-moe-1b-a400m", "deepseek-v3-671b"])
def test_moe_forward_on_the_card(gen, arch_id):
    """A tiny MoE / MLA forward (the smoke arch) on the card against the
    same parameters on the CPU: last-token logits within 3e-2 of their
    scale, the same experts chosen and the same pairs kept in each MoE
    layer's routing of the first layer's input, one flash_attn launch per
    GQA layer, and a decode step's logits finite."""
    from repro_torch import interop
    from repro_torch.configs import base as cb
    from repro_torch.configs import get_arch
    from repro_torch.models import lm
    from repro_torch.nn import init as nninit
    from repro_torch.nn import moe

    arch = get_arch(arch_id)
    cfg = arch.make_smoke()
    cpu = nninit.materialize(cb.model_spec(arch, cfg), torch.Generator().manual_seed(0))
    card = interop.to_device(cpu, "cuda")
    toks = torch.randint(0, cfg.vocab, (2, 40), generator=torch.Generator().manual_seed(1))
    before = registry.LAUNCHES["flash_attn"]
    got = cb.prefill_fn(arch, cfg)(card, toks.cuda())
    torch.cuda.synchronize()
    gqa_layers = 0 if cfg.attn_kind == "mla" else cfg.n_layers
    assert registry.LAUNCHES["flash_attn"] == before + gqa_layers
    want = cb.prefill_fn(arch, cfg)(cpu, toks)
    scale = max(1.0, float(want.float().abs().max()))
    torch.testing.assert_close(got.float().cpu(), want.float(), atol=3e-2 * scale, rtol=0)
    layer = lm._unstack(cpu["body"], 1)[0]["u0"]["ffn"]
    x = torch.randn(80, cfg.d_model, generator=torch.Generator().manual_seed(2))
    _, idx, _ = moe.route(layer, cfg.moe, x)
    _, idx_card, _ = moe.route(interop.to_device(layer, "cuda"), cfg.moe, x.cuda())
    assert torch.equal(idx_card.cpu(), idx)
    cap = moe._capacity(cfg.moe, 80)
    for a, b in zip(moe.dispatch(idx, cfg.moe.n_experts, cap),
                    moe.dispatch(idx_card, cfg.moe.n_experts, cap)):
        assert torch.equal(b.cpu(), a)
    caches = lm.init_caches(cfg, 2, 8, device="cuda")
    _, logits = lm.decode_step(card, cfg, caches, toks[:, 0].cuda(), 0)
    assert bool(logits.isfinite().all())


def test_analyzer_probes_on_the_card(gen):
    """``repro_torch.analyze``'s probes of all six kernels on the card:
    each within its registry epsilon of its plain version (and of the
    gather lowering where one exists) at d in (5, 12, 33, 8, 32, 128, 256)
    (flash_attn at head dims 64 / 128 / 256), each refused size raising
    with its size named and refused by a direct launch too."""
    from repro_torch.analyze import registry_check

    report, rows = registry_check.run_probes("cuda")
    assert report.ok and report.findings == [], report.render()
    for row in rows:
        assert row.probed > row.refused == 1, row.record()
        assert row.max_err_plain <= row.epsilon, row.record()
    assert report.coverage["kernel_probes_refused"] == len(registry.KERNELS)


def test_deploy_through_the_preflight_gate_on_the_card(gen):
    """``deploy(["nvsa"])`` on the card through the default
    ``preflight="error"`` gate: the cheap tier runs on ``meta`` and
    launches nothing, and the report is recorded as passing."""
    from repro_torch.serve.deploy import Budget, deploy

    registry.reset_launches()
    dep = deploy(["nvsa"], options={"nvsa": {"d": 256}},
                 budget=Budget(max_batch=2), device="cuda")
    assert registry.LAUNCHES == dict.fromkeys(registry.KERNELS, 0)
    rec = dep.report()["analysis"]
    assert rec["ok"] and rec["coverage"]["schedules"] == 1, rec
    assert "preflight PASS" in dep.summary()


@pytest.mark.parametrize("arch_id", ["llama3.2-3b", "granite-moe-1b-a400m"])
def test_tensor_parallel_world_on_the_card(gen, arch_id):
    """Two ranks on one card over gloo (``devices=("cuda:0", "cuda:0")``):
    at f32 compute and smoke width, the greedy streams equal the
    single-device engine's and the forward's logits lie within 1e-4 of
    its; each rank launches flash_attn once per layer of the forward, on
    its own heads."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import base as cb
    from repro_torch.configs import get_arch
    from repro_torch.distributed import world
    from repro_torch.nn import init as nninit
    from repro_torch.serve.engine import Engine, Request, ServeConfig

    arch = get_arch(arch_id)
    cfg = dataclasses.replace(arch.make_smoke(), compute_dtype=torch.float32)
    serve = ServeConfig(max_new_tokens=8, max_slots=3, max_len=64, decode_block=4)
    key = torch.Generator("cuda").manual_seed(3)
    seeded = world.SeededParams.of(key)
    params = nninit.materialize(cb.model_spec(arch, cfg), key)
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(1, cfg.vocab, int(n)).astype(np.int32))
            for i, n in enumerate(rng.integers(3, 30, 4))]
    step, init = cb.serve_fns(arch, cfg, 64)
    want = Engine(step, init, serve, params=params).run(reqs)
    eng = world.tp_engine(arch_id, cfg, seeded, 2, ("cuda:0", "cuda:0"), serve)
    try:
        got = eng.run(reqs)
        assert {u: r.tokens.tolist() for u, r in got.items()} == \
            {u: r.tokens.tolist() for u, r in want.items()}
        eng.world.reset_launches()
        registry.reset_launches()
        toks = torch.randint(0, cfg.vocab, (2, 40), device="cuda", generator=gen)
        logits = eng.forward(toks)
        launches = [c["flash_attn"] for c in eng.world.launches()]
        assert launches == [cfg.n_layers] * 2
        forward, readout = cb.forward_fn(arch, cfg)
        torch.testing.assert_close(logits, readout(params, forward(params, toks)),
                                   atol=1e-4, rtol=0)
    finally:
        eng.close()


@pytest.mark.parametrize("arch_id", ["rwkv6-7b", "recurrentgemma-9b", "deepseek-v3-671b"])
def test_tensor_parallel_kinds_on_the_card(gen, arch_id):
    """The recurrent kinds and MLA on two ranks of one card over gloo, at
    f32 compute and smoke width: the greedy streams equal the single-device
    engine's, the forward's logits lie within 1e-4 of its, and no rank
    launches flash_attn (the WKV and RG-LRU recurrences, griffin's
    windowed attention and MLA run plain)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import base as cb
    from repro_torch.configs import get_arch
    from repro_torch.distributed import world
    from repro_torch.nn import init as nninit
    from repro_torch.serve.engine import Engine, Request, ServeConfig

    arch = get_arch(arch_id)
    cfg = dataclasses.replace(arch.make_smoke(), compute_dtype=torch.float32)
    serve = ServeConfig(max_new_tokens=8, max_slots=3, max_len=64, decode_block=4)
    key = torch.Generator("cuda").manual_seed(3)
    seeded = world.SeededParams.of(key)
    params = nninit.materialize(cb.model_spec(arch, cfg), key)
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(1, cfg.vocab, int(n)).astype(np.int32))
            for i, n in enumerate(rng.integers(3, 30, 4))]
    step, init = cb.serve_fns(arch, cfg, 64)
    want = Engine(step, init, serve, params=params).run(reqs)
    eng = world.tp_engine(arch_id, cfg, seeded, 2, ("cuda:0", "cuda:0"), serve)
    try:
        got = eng.run(reqs)
        assert {u: r.tokens.tolist() for u, r in got.items()} == \
            {u: r.tokens.tolist() for u, r in want.items()}
        eng.world.reset_launches()
        toks = torch.randint(0, cfg.vocab, (2, 40), device="cuda", generator=gen)
        logits = eng.forward(toks)
        assert [c["flash_attn"] for c in eng.world.launches()] == [0, 0]
        forward, readout = cb.forward_fn(arch, cfg)
        torch.testing.assert_close(logits, readout(params, forward(params, toks)),
                                   atol=1e-4, rtol=0)
    finally:
        eng.close()


def test_tensor_parallel_vlm_and_encdec_on_the_card(gen):
    """internvl2-26b's prefill and seamless-m4t-large-v2's encode,
    ``decode_train`` and decode steps held by a ``TPModel`` of two ranks on
    one card, at f32 compute and smoke width: within 1e-4 of the single
    device (the decode steps from caches the world built itself, each
    within one bf16 step of the single device's, so the logits within
    1e-3 of their scale), flash_attn once per attention call on each
    rank's heads."""
    import dataclasses

    from repro_torch.configs import base as cb
    from repro_torch.configs import get_arch
    from repro_torch.distributed import world
    from repro_torch.models import encdec
    from repro_torch.nn import init as nninit
    from repro_torch.nn import layers

    devices = ("cuda:0", "cuda:0")
    arch = get_arch("internvl2-26b")
    smoke = arch.make_smoke()
    cfg = dataclasses.replace(smoke, lm=dataclasses.replace(smoke.lm,
                                                            compute_dtype=torch.float32))
    key = torch.Generator("cuda").manual_seed(4)
    seeded = world.SeededParams.of(key)
    params = nninit.materialize(cb.model_spec(arch, cfg), key)
    batch = {"patch_embeds": torch.randn(2, 16, cfg.lm.d_model, device="cuda", generator=gen),
             "tokens": torch.randint(0, cfg.lm.vocab, (2, 12), device="cuda", generator=gen)}
    model = world.tp_model(arch.id, cfg, seeded, 2, devices)
    try:
        model.world.reset_launches()
        got = model.same(world.model_prefill, batch)
        assert [c["flash_attn"] for c in model.world.launches()] == [cfg.lm.n_layers] * 2
        torch.testing.assert_close(got, cb.prefill_fn(arch, cfg)(params, batch),
                                   atol=1e-4, rtol=0)
    finally:
        model.close()

    arch = get_arch("seamless-m4t-large-v2")
    cfg = dataclasses.replace(arch.make_smoke(), compute_dtype=torch.float32)
    key = torch.Generator("cuda").manual_seed(5)
    seeded = world.SeededParams.of(key)
    params = nninit.materialize(cb.model_spec(arch, cfg), key)
    frames = torch.randn(2, 24, cfg.d_model, device="cuda", generator=gen)
    tgt = torch.randint(0, cfg.vocab, (2, 16), device="cuda", generator=gen)
    enc = encdec.encode(params, cfg, frames)
    model = world.tp_model(arch.id, cfg, seeded, 2, devices)

    def kept(fn, *args):      # an enc-dec serving step on every rank, the bits compared
        return model.same(world.model_call, fn, *args)

    try:
        model.world.reset_launches()
        torch.testing.assert_close(kept(encdec.kept_encode, frames), enc, atol=1e-4, rtol=0)
        logits = kept(encdec.kept_decode_train, tgt)
        assert [c["flash_attn"] for c in model.world.launches()] == \
            [cfg.n_enc_layers + 2 * cfg.n_dec_layers] * 2
        hidden = encdec.decode_train(params, cfg, enc, tgt)
        torch.testing.assert_close(logits, layers.logits(params["embed"], hidden,
                                                         cfg.compute_dtype), atol=1e-4, rtol=0)
        kept(encdec.kept_init_caches, 16)
        caches = encdec.init_caches(params, cfg, enc, 16, device="cuda")
        tok = torch.zeros(2, dtype=torch.long, device="cuda")
        for t in range(4):
            model.world.reset_launches()
            got = kept(encdec.kept_decode_step, tok, t)
            assert [c["flash_attn"] for c in model.world.launches()] == [cfg.n_dec_layers] * 2
            caches, want = encdec.decode_step(params, cfg, caches, tok, t)
            scale = float(want.abs().max().clamp(min=1.0))
            torch.testing.assert_close(got, want, atol=1e-3 * scale, rtol=0)
            tok = want.argmax(-1)
    finally:
        model.close()


def test_tensor_parallel_training_on_the_card(gen, tmp_path):
    """One tp-2 training step on two ranks of one card (``TPTrainer``) at
    f32 compute and smoke width, against the single device's on the card:
    the loss within 1e-5 relative, each leaf's gradient (the ranks' cuts
    put together) within 1e-4 of its max |g|, none missing, the parameters
    after the AdamW step within 2 lr (a sanity bound: a first step moves
    each element by about lr), the ranks' norms and kept wholes the same
    bits, flash_attn once per layer a forward on each rank; the world's
    optimizer fed the single device's gradients of three steps, within
    1e-2 lr of the single device's ``apply_updates`` fed the same; then
    ``TPTrainer.run`` of two steps, whose whole checkpoint one device's
    ``Trainer`` restores."""
    import dataclasses

    import _torch_tp_ranks as ranks
    import numpy as np

    from repro_torch.common.tree import tree_leaves
    from repro_torch.configs import base as cb
    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import TokenPipelineConfig
    from repro_torch.distributed import world
    from repro_torch.nn import init as nninit
    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainer import Trainer, TrainerConfig

    arch = get_arch("llama3.2-3b")
    cfg = dataclasses.replace(arch.make_smoke(), compute_dtype=torch.float32)
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    key = torch.Generator("cuda").manual_seed(5)
    seeded = world.SeededParams.of(key)
    params = nninit.materialize(cb.model_spec(arch, cfg), key)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16))) for k in ("tokens", "targets")}
    loss_fn = cb.loss_fn(arch, cfg)
    loss, grads = opt.value_and_grad(loss_fn)(params, {k: v.cuda() for k, v in batch.items()})
    stepped, state, m = opt.apply_updates(params, grads, opt.init_state(params, ocfg), ocfg)
    fed, fed_norms, p_k = [grads], [float(m["grad_norm"])], stepped
    for _ in range(2):
        fed.append(opt.value_and_grad(loss_fn)(p_k, {k: v.cuda() for k, v in batch.items()})[1])
        p_k, state, m = opt.apply_updates(p_k, fed[-1], state, ocfg)
        fed_norms.append(float(m["grad_norm"]))
    tcfg = TrainerConfig(total_steps=2, ckpt_every=2, ckpt_dir=str(tmp_path))
    data = TokenPipelineConfig(vocab_size=cfg.vocab, seq_len=16, global_batch=2, seed=1)
    trainer = world.tp_trainer("llama3.2-3b", cfg, seeded, 2, ("cuda:0", "cuda:0"), tcfg, ocfg,
                               data)
    try:
        got_fed = trainer.on_every_rank(
            ranks.fed_updates, [[g.cpu() for g in tree_leaves(t)] for t in fed])
        got_fed = [got_fed[0], *got_fed[1]]
        trainer.world.reset_launches()
        mine, theirs = trainer.on_every_rank(ranks.grads_then_step, batch)
        assert [c["flash_attn"] for c in trainer.world.launches()] == [2 * cfg.n_layers] * 2
        every = [mine, *theirs]
        for r in every:
            assert abs(r["loss"] - float(loss)) <= 1e-5 * abs(float(loss))
            assert r["grad_norm"] == mine["grad_norm"] and r["digests"] == mine["digests"]
            assert r["slices"]
        for i, (g, p) in enumerate(zip(tree_leaves(grads), tree_leaves(stepped))):
            dim = mine["dims"][i]
            cuts = [r["grads"][i] for r in every]
            got = cuts[0] if dim is None else torch.cat(cuts, dim)
            assert float((got - g.cpu()).abs().max()) <= 1e-4 * float(g.abs().max()), i
            cuts = [r["params"][i] for r in every]
            got = cuts[0] if dim is None else torch.cat(cuts, dim)
            assert float((got - p.cpu()).abs().max()) <= 2 * ocfg.lr, i
        for r in got_fed:
            assert r["norms"] == got_fed[0]["norms"] and r["digests"] == got_fed[0]["digests"]
            assert r["slices"]
        np.testing.assert_allclose(got_fed[0]["norms"], fed_norms, rtol=1e-5)
        for i, p in enumerate(tree_leaves(p_k)):
            dim = mine["dims"][i]
            cuts = [r["params"][i] for r in got_fed]
            got = cuts[0] if dim is None else torch.cat(cuts, dim)
            assert float((got - p.cpu()).abs().max()) <= 1e-2 * ocfg.lr, i
        losses = [m["loss"] for m in trainer.run(2)]
        assert all(np.isfinite(losses)) and trainer.step == 2
    finally:
        trainer.close()
    one = Trainer(loss_fn, params, tcfg, ocfg, None, device="cuda")
    assert one.try_restore() and one.step == 2


def test_compression_quantize_rounds_like_the_cpu(gen):
    """``compression.quantize`` divides by a 0-d tensor, so the card rounds
    ``g / scale`` as the CPU does, ties included: payloads and scales
    bit-equal, on random gradients and on values built to land near .5
    steps."""
    from repro_torch.distributed import compression

    g = torch.randn(1 << 16, device="cuda", generator=gen) * 0.05
    steps = torch.arange(-127, 127, device="cuda", dtype=torch.float32) + 0.5
    for x in (g, steps * 0.01, torch.cat([steps, torch.tensor([127.0], device="cuda")]) / 3):
        q, s = compression.quantize(x)
        qc, sc = compression.quantize(x.cpu())
        assert torch.equal(q.cpu(), qc) and torch.equal(s.cpu(), sc)
        torch.testing.assert_close(compression.dequantize(q, s).cpu(),
                                   compression.dequantize(qc, sc), atol=0, rtol=0)


def test_gpipe_world_on_the_card(gen):
    """A pipeline of two stages on two ranks of one card (gloo): the
    reference test's tanh dense stages, 4 microbatches of (2, 16): the
    outputs within 1e-5 and each stage's gradients within 1e-4 of the
    sequential loop on the CPU."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import _torch_dist_ranks as ranks

    from repro_torch.distributed import world

    cpu = torch.Generator().manual_seed(1)
    w = torch.randn(2, 16, 16, generator=cpu) / 4
    b = torch.randn(2, 16, generator=cpu) * 0.1
    x = torch.randn(4, 2, 16, generator=cpu)
    wd = world.World(("cuda:0", "cuda:0"))
    try:
        res = wd.spmd(ranks.gpipe_dense, [(w, b, x)] * 2, axis="pod")
    finally:
        wd.close()
    pw, pb = w.clone().requires_grad_(), b.clone().requires_grad_()
    h = x
    for s in range(2):
        h = ranks.tanh_dense({"w": pw[s], "b": pb[s]}, h)
    (h ** 2).sum().backward()
    torch.testing.assert_close(res[0][0].cpu(), h.detach(), atol=1e-5, rtol=0)
    assert torch.equal(res[0][0].cpu(), res[1][0])
    torch.testing.assert_close(torch.stack([res[0][1]["w"].cpu(), res[1][1]["w"]]), pw.grad,
                               atol=1e-4, rtol=0)
    torch.testing.assert_close(torch.stack([res[0][1]["b"].cpu(), res[1][1]["b"]]), pb.grad,
                               atol=1e-4, rtol=0)
