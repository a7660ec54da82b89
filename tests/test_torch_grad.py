"""Gradients and input layouts of the port's kernel calls against the JAX
reference, on the CPU.

The port's wrappers get CPU tensors and run their plain versions: the
backward of ``circ_elem`` is ``circ_elem`` again (the reference's custom
VJP calculus), that of ``fused_unbind_classify`` the autograd of the plain
chain.  The reference runs under the negotiated CPU plan, so its Pallas
kernels run in interpret mode, and ``jax.grad`` goes through its custom
VJPs.  The same numpy inputs go through both.  On the card the same
gradients are held against these by ``test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.backend import registry as jregistry
from repro.kernels.circ_conv import ops as jcirc_ops
from repro.kernels.flash_attn import ops as jflash_ops
from repro.kernels.simd_fused import ops as jsimd_ops
from repro.kernels.unbind_classify import ops as juc_ops
from repro.vsa import ops as jvsa
from repro_torch.backend import registry
from repro_torch.kernels.circ_conv import ops as circ_ops
from repro_torch.kernels.flash_attn import ops as flash_ops
from repro_torch.kernels.simd_fused import ops as simd_ops
from repro_torch.kernels.unbind_classify import ops as uc_ops
from repro_torch.vsa import ops as vsa

torch.set_num_threads(2)

CPU_PLAN = jregistry.negotiate(platform="cpu", override="")


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _codes(seed, *shape):
    """Block codes of unit norm per block, as the VSA binds them."""
    v = _normal(seed, *shape)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- vsa.bind / vsa.unbind -----------------------------------------------------


@pytest.mark.parametrize("broadcast", [False, True])
@pytest.mark.parametrize("op", ["bind", "unbind"])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_bind_unbind_gradient_matches_jax(d, op, broadcast):
    """The gradients of sum(w * op(a, b)) in a and b agree with jax.grad
    through the reference's op within 1e-5; d = 64 is below circ_conv's
    dispatch floor (the gather reference on both sides), 128 and 256 go
    through the kernel wrappers and their custom backward.  A (1, B, d)
    key against (N, B, d) codes sums its broadcast gradient."""
    n, blocks = 3, 2
    a = _codes(d, n, blocks, d)
    b = _codes(d + 1, 1 if broadcast else n, blocks, d)
    w = _normal(d + 2, n, blocks, d)
    jop, top = getattr(jvsa, op), getattr(vsa, op)

    def loss(aa, bb):
        return jnp.sum(jnp.asarray(w) * jop(aa, bb))

    with jregistry.use_plan(CPU_PLAN):
        jga, jgb = jax.grad(loss, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    ta, tb = _t(a).requires_grad_(), _t(b).requires_grad_()
    out = top(ta, tb)
    assert out.grad_fn is not None
    ga, gb = torch.autograd.grad((_t(w) * out).sum(), (ta, tb))
    assert ga.shape == ta.shape and gb.shape == tb.shape
    np.testing.assert_allclose(ga.numpy(), np.asarray(jga), atol=1e-5, rtol=0)
    np.testing.assert_allclose(gb.numpy(), np.asarray(jgb), atol=1e-5, rtol=0)


@pytest.mark.parametrize("mode", ["conv", "corr"])
def test_circ_elem_backward_is_two_kernel_calls(mode):
    """circ_elem's backward is the reference's calculus through circ_elem
    itself: two calls of the circ_conv wrapper (on the card, two launches),
    gradients in the inputs' dtype.  A CPU run launches nothing."""
    x, y = _t(_normal(1, 4, 2, 128)).requires_grad_(), _t(_normal(2, 4, 2, 128))
    out = circ_ops.circ_elem(x, y.requires_grad_(), mode)
    before = dict(registry.LAUNCHES)
    with registry.record_kernels() as rec:
        out.sum().backward()
    assert rec == [("circ_conv", "kernel")] * 2
    assert registry.LAUNCHES == before
    assert x.grad.dtype == x.dtype and y.grad.dtype == y.dtype


def test_circ_elem_without_grad_skips_autograd():
    """Inputs that need no gradient (the served paths) give an output with
    no grad_fn, under grad mode or not."""
    x = _t(_normal(3, 2, 2, 128))
    assert circ_ops.circ_elem(x, x).grad_fn is None
    with torch.no_grad():
        assert circ_ops.circ_elem(x.requires_grad_(), x).grad_fn is None


# -- unbind_classify -----------------------------------------------------------


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("d", [128, 256])
def test_unbind_classify_gradient_matches_jax(d, bias):
    """Gradients of sum(w * logits) in the head's w and b, the keys and x
    agree within 1e-5 with jax.grad through the reference's
    ``unbind_classify(..., use_kernel=True)`` (Pallas forward in interpret
    mode, backward through its plain chain); without a bias the head is
    {"w"} alone."""
    k, blocks, n, c = 2, 2, 3, 5
    keys = _codes(d, k, blocks, d)
    x = _normal(d + 1, n, blocks * d)
    head = {"w": _normal(d + 2, blocks * d, c) / np.sqrt(blocks * d)}
    if bias:
        head["b"] = _normal(d + 3, c)
    w = _normal(d + 4, n, k, c)

    def loss(hh, kk, xx):
        return jnp.sum(jnp.asarray(w) * juc_ops.unbind_classify(hh, kk, xx,
                                                               use_kernel=True))

    with jregistry.use_plan(CPU_PLAN):
        jgrads = jax.grad(loss, argnums=(0, 1, 2))(
            jax.tree.map(jnp.asarray, head), jnp.asarray(keys), jnp.asarray(x))
    th = {name: _t(v).requires_grad_() for name, v in head.items()}
    tk, tx = _t(keys).requires_grad_(), _t(x).requires_grad_()
    out = uc_ops.unbind_classify(th, tk, tx)
    assert out.grad_fn is not None and out.shape == (n, k, c)
    names = sorted(th)
    grads = torch.autograd.grad((_t(w) * out).sum(), [th[m] for m in names] + [tk, tx])
    want = [jgrads[0][m] for m in names] + [jgrads[1], jgrads[2]]
    for got, ref in zip(grads, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


# -- any layout ----------------------------------------------------------------


def _transposed(a: np.ndarray, dims=(0, 1)) -> torch.Tensor:
    """A non-contiguous torch view with ``a``'s shape and values: the
    contiguous tensor of the two dims swapped, transposed back."""
    t = _t(np.swapaxes(a, *dims)).transpose(*dims)
    assert not t.is_contiguous()
    return t


def _layout_case(name):
    """(port call, reference call, inputs, tolerance) of one public kernel
    call on small shapes."""
    x, y = _normal(1, 5, 2, 128), _normal(2, 5, 2, 128)
    dic = _normal(3, 4, 2, 128)
    if name == "circ_elem":
        return (lambda a, b: circ_ops.circ_elem(a, b, "corr"),
                lambda a, b: jcirc_ops.circ_bind(a, b, "corr"), (x, y), 1e-5)
    if name == "circ_bind_dict":
        return (circ_ops.circ_bind_dict, jcirc_ops.circ_bind_dict, (x, dic), 1e-5)
    if name == "fused_match_prob":
        return (lambda q, m: simd_ops.fused_match_prob(q, m, 0.1),
                lambda q, m: jsimd_ops.fused_match_prob(q, m, 0.1, use_kernel=True),
                (x, dic), 1e-5)
    if name == "fused_unbind_classify":
        keys = _codes(4, 3, 2, 128)
        w, b = _normal(5, 2, 128, 5) / 16.0, _normal(6, 1, 5)

        def ref(kk, xx, ww, bb):
            head = {"w": ww.reshape(-1, 5), "b": bb.reshape(5)}
            return juc_ops.unbind_classify(head, kk, xx.reshape(xx.shape[0], -1),
                                           use_kernel=True)

        return uc_ops.fused_unbind_classify, ref, (keys, x, w, b), 1e-5
    q, kv = _normal(7, 2, 24, 2, 16), _normal(8, 2, 24, 2, 16)
    return (lambda a, b, c: flash_ops.flash_mha(a, b, c, 0.25),
            lambda a, b, c: jflash_ops.flash_mha(a, b, c, 0.25, causal=True,
                                                 use_kernel=True),
            (q, kv, kv * 0.5), 1e-4)


@pytest.mark.parametrize("name", ["circ_elem", "circ_bind_dict", "fused_match_prob",
                                  "fused_unbind_classify", "flash_mha"])
def test_kernel_calls_take_transposed_views(name):
    """Each public kernel call takes a non-contiguous view (for flash_mha
    the (B, S, H, hd) view of a (B, H, S, hd) tensor): bit for bit the
    result of its contiguous copy, and within the stated tolerance of the
    reference on the same values (1e-5; 1e-4 for flash_mha, as
    ``test_flash_mha_matches_reference``)."""
    port, ref, args, atol = _layout_case(name)
    dims = (1, 2) if name == "flash_mha" else (0, 1)
    views = [_transposed(a, dims) if a.ndim >= 3 else _t(a) for a in args]
    got = port(*views)
    assert torch.equal(got, port(*[v.contiguous() for v in views]))
    with jregistry.use_plan(CPU_PLAN):
        want = np.asarray(ref(*[jnp.asarray(a) for a in args]))
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)
