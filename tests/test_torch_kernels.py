"""Parity of the PyTorch port's kernel modules with the JAX reference.

On this host the port's wrappers get CPU tensors and run their plain
versions; the reference runs its Pallas kernels in interpret mode.  The
same numpy inputs go through both.  The CUDA kernels themselves are
tested on the card by ``test_torch_cuda.py``.
"""

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.circ_conv import kernel as jcirc
from repro.kernels.circ_conv import ops as jcirc_ops
from repro.kernels.qmatmul import kernel as jqmm
from repro.kernels.qmatmul import ops as jqops
from repro.vsa import ops as jvsa
from repro_torch.backend import registry
from repro_torch.kernels.circ_conv import ops as circ_ops
from repro_torch.kernels.qmatmul import ops as qops
from repro_torch.kernels.qmatmul import ref as qref
from repro_torch.vsa import ops as vsa

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]


# -- circ_conv ---------------------------------------------------------------


@pytest.mark.parametrize("mode", ["conv", "corr"])
@pytest.mark.parametrize("d", [64, 128, 130])
def test_circ_elem_matches_pallas_interpret(d, mode):
    """The port's circ_elem (plain version on the CPU) against the Pallas
    circ_elem kernel in interpret mode; atol 1e-5 (f32, sums of d terms
    taken in another order)."""
    rng = np.random.default_rng(d)
    x = rng.standard_normal((5, 2, d)).astype(np.float32)
    y = rng.standard_normal((5, 2, d)).astype(np.float32)
    want = np.asarray(jcirc.circ_elem(jnp.asarray(x), jnp.asarray(y), mode=mode,
                                      interpret=True))
    got = circ_ops.circ_elem(torch.from_numpy(x), torch.from_numpy(y), mode)
    assert got.dtype == torch.float32 and got.shape == (5, 2, d)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("mode", ["conv", "corr"])
def test_circ_bind_broadcasts_like_reference(mode):
    """Leading dims broadcast as in ``circ_conv/ops.py:circ_bind``
    (``roles[ai][None, None]`` against (N, 8, B, d) panel codes)."""
    rng = np.random.default_rng(7)
    a = rng.standard_normal((3, 8, 2, 128)).astype(np.float32)
    b = rng.standard_normal((1, 1, 2, 128)).astype(np.float32)
    want = np.asarray(jcirc_ops.circ_bind(jnp.asarray(a), jnp.asarray(b), mode))
    got = circ_ops.circ_bind(torch.from_numpy(a), torch.from_numpy(b), mode)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("d", [64, 128, 130])
def test_dispatch_path_matches_reference(d):
    """Below circ_conv's dispatch floor (128) bind/unbind take the gather
    reference, at and above it the kernel, as the reference routes."""
    assert vsa.dispatch_path(d) == jvsa.dispatch_path(d)
    assert registry.KERNELS["circ_conv"].dispatch_min_size == 128
    assert registry.KERNELS["circ_conv"].epsilon == 1e-3
    assert registry.KERNELS["qmatmul"].epsilon == 1e-3


def test_bind_counts_no_launch_on_cpu():
    """CPU tensors take the plain version: the launch counter stays put."""
    before = dict(registry.LAUNCHES)
    a = torch.randn(2, 2, 128)
    vsa.bind(a, a)
    vsa.unbind(a, a)
    assert registry.LAUNCHES == before


def test_fft_oracles_agree_with_gather():
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((4, 2, 130)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((4, 2, 130)).astype(np.float32))
    torch.testing.assert_close(vsa.circ_conv_fft(a, b), vsa.circ_conv_ref(a, b),
                               atol=1e-4, rtol=0)
    torch.testing.assert_close(vsa.circ_corr_fft(a, b), vsa.circ_corr_ref(a, b),
                               atol=1e-4, rtol=0)


# -- qmatmul -----------------------------------------------------------------


def _quant_inputs(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
    return x, w


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_and_pack_bit_identical(bits):
    x, w = _quant_inputs(16, 128, 5)
    jq, js = jqops.quantize_rows(jnp.asarray(x), 8)
    tq, ts = qops.quantize_rows(torch.from_numpy(x), 8)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jwq, jws = jqops.quantize_cols(jnp.asarray(w), bits)
    twq, tws = qops.quantize_cols(torch.from_numpy(w), bits)
    np.testing.assert_array_equal(twq.numpy(), np.asarray(jwq))
    np.testing.assert_array_equal(tws.numpy(), np.asarray(jws))
    if bits == 4:  # odd N = 5: padded with a zero column before packing
        packed = qops.pack_int4(twq)
        assert packed.shape == (128, 3)
        np.testing.assert_array_equal(packed.numpy(),
                                      np.asarray(jqops.pack_int4(jwq)))
        np.testing.assert_array_equal(qref.unpack_int4_ref(packed)[:, :5].numpy(),
                                      twq.numpy())


@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("mkn", [(16, 128, 6), (67, 130, 8)])
def test_qmatmul_matches_pallas_interpret(mkn, int4):
    """Integer-exact accumulators, f32 outputs within 1e-6 relative of the
    Pallas kernel (interpret mode), whose epilogue association the port
    keeps."""
    m, k, n = mkn
    rng = np.random.default_rng(m + k + n)
    xq = rng.integers(-128, 128, (m, k)).astype(np.int8)
    wq = rng.integers(-8 if int4 else -128, 8 if int4 else 128, (k, n)).astype(np.int8)
    xs = rng.uniform(0.01, 0.1, m).astype(np.float32)
    ws = rng.uniform(0.01, 0.1, n).astype(np.float32)
    wt = torch.from_numpy(wq)
    jw = jnp.asarray(wq)
    if int4:
        wt, jw = qops.pack_int4(wt), jqops.pack_int4(jw)
        np.testing.assert_array_equal(wt.numpy(), np.asarray(jw))
    acc = qref.qmatmul_acc_ref(torch.from_numpy(xq), wt, int4)
    np.testing.assert_array_equal(acc.numpy(), xq.astype(np.int64) @ wq.astype(np.int64))
    want = np.asarray(jqmm.qmatmul(jnp.asarray(xq), jw, jnp.asarray(xs),
                                   jnp.asarray(ws), int4=int4, interpret=True))
    got = qops.qmatmul(torch.from_numpy(xq), wt, torch.from_numpy(xs),
                       torch.from_numpy(ws), int4=int4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("bits_w", [8, 4])
def test_qdense_matches_reference(bits_w):
    """qdense at the heads' shape (K = cnn_feat, N = 5 for attr 0: odd N
    pads the int4 packing and its scales)."""
    x, w = _quant_inputs(24, 32, 5, seed=bits_w)
    want = np.asarray(jqops.qdense(jnp.asarray(x), jnp.asarray(w), bits_w=bits_w,
                                   out_dtype=jnp.float32, use_kernel=True))
    got = qops.qdense(torch.from_numpy(x), torch.from_numpy(w), bits_w=bits_w)
    assert got.shape == (24, 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


# -- the port imports neither JAX nor the reference ---------------------------


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_port_imports_no_jax_and_no_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py"] + sorted((ROOT / "examples").glob("*_torch.py"))
    assert len(files) > 10
    bad = [(f.relative_to(ROOT), name) for f in files for name in _imports(f)
           if name.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad
