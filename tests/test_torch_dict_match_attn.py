"""Parity of the port's circ_dict, fused match_prob and flash attention
modules with the JAX reference.

On this host the port's wrappers get CPU tensors and run their plain
versions; the reference runs its Pallas kernels in interpret mode.  The
same numpy inputs go through both.  The CUDA kernels themselves are
tested on the card by ``test_torch_cuda.py``.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.backend import registry as jregistry
from repro.kernels.circ_conv import kernel as jcirc
from repro.kernels.circ_conv import ops as jcirc_ops
from repro.kernels.flash_attn import ops as jflash_ops
from repro.kernels.simd_fused import kernel as jsimd
from repro.kernels.simd_fused import ops as jsimd_ops
from repro.vsa import ops as jvsa
from repro_torch.backend import registry
from repro_torch.kernels.circ_conv import ops as circ_ops
from repro_torch.kernels.flash_attn import ops as flash_ops
from repro_torch.kernels.simd_fused import ops as simd_ops
from repro_torch.kernels.simd_fused import ref as simd_ref
from repro_torch.vsa import ops as vsa

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# -- circ_dict -----------------------------------------------------------------

# the last three sit on the CUDA kernel's tiling edges: one query (a
# 16-row tile almost empty), 65 queries (one past two 32-row tiles), one
# entry, one block, and d = 8 and 24 (one 64-column tile, mostly padding)
DICT_SHAPES = [(5, 3, 2, 64), (13, 4, 4, 128), (1, 1, 1, 8), (65, 1, 1, 24),
               (65, 2, 3, 8)]


@pytest.mark.parametrize("mode", ["conv", "corr"])
@pytest.mark.parametrize("nmbd", DICT_SHAPES)
def test_circ_dict_matches_pallas_interpret(nmbd, mode):
    """(N, B, M, d) output of the port's circ_dict (plain version on the
    CPU) against the Pallas circ_dict in interpret mode; atol 1e-4 (f32,
    sums of d terms taken in another order)."""
    n, m, b, d = nmbd
    x, dic = _normal(n, n, b, d), _normal(m + 100, m, b, d)
    want = np.asarray(jcirc.circ_dict(jnp.asarray(x), jnp.asarray(dic), mode=mode,
                                      interpret=True))
    got = circ_ops.circ_dict(torch.from_numpy(x), torch.from_numpy(dic), mode)
    assert got.dtype == torch.float32 and got.shape == (n, b, m, d)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("mode", ["conv", "corr"])
@pytest.mark.parametrize("nmbd", DICT_SHAPES)
def test_circ_bind_dict_matches_reference(nmbd, mode):
    """circ_bind_dict returns (N, M, B, d), as reference ``ops.py:95``, and
    equals binding each query to each entry one pair at a time."""
    n, m, b, d = nmbd
    x, dic = _normal(n + 1, n, b, d), _normal(m + 200, m, b, d)
    want = np.asarray(jcirc_ops.circ_bind_dict(jnp.asarray(x), jnp.asarray(dic), mode))
    got = circ_ops.circ_bind_dict(torch.from_numpy(x), torch.from_numpy(dic), mode)
    assert got.shape == (n, m, b, d)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    pairs = circ_ops.circ_bind(torch.from_numpy(x)[:, None], torch.from_numpy(dic)[None],
                               mode)
    torch.testing.assert_close(got, pairs, atol=1e-4, rtol=0)


def test_circ_dict_shared_memory_geometry():
    """The wrapper's copy of circ_dict.cu's shared-memory formula, and the
    raise where it says a launch would fail: the query tile as tf32 hi and
    lo (f32) or bf16, rows padded by 16 bytes, and each staged entry's row
    (hi and lo over 2·dp words, or two bf16 word copies of dp words, 16
    words apart, and at bf16 the 16 x 64 output buffers of 8 warps), with
    d padded to a multiple of 64."""
    assert circ_ops.dict_smem_bytes(256, 4, rows=32, entries=2) == 8 * 32 * 260 + 16 * 2 * 256
    assert circ_ops.dict_smem_bytes(256, 2, rows=32, entries=2) == \
        2 * 32 * 264 + 4 * 2 * 528 + 2 * 8 * 16 * 72
    assert circ_ops.dict_smem_bytes(1, 4) == circ_ops.dict_smem_bytes(64, 4) == 8 * 16 * 68 + 16 * 64
    assert circ_ops.dict_smem_bytes(130, 2) == circ_ops.dict_smem_bytes(192, 2)
    limit = 227 * 1024
    for elt, max_d in ((4, circ_ops.DICT_MAX_D), (2, circ_ops.DICT_MAX_D_BF16)):
        assert max_d % 64 == 0
        assert circ_ops.dict_smem_bytes(max_d, elt) <= limit
        assert circ_ops.dict_smem_bytes(max_d + 1, elt) > limit
    assert (circ_ops.DICT_MAX_D, circ_ops.DICT_MAX_D_BF16) == (1600, 5312)
    for dtype, max_d in ((torch.float32, circ_ops.DICT_MAX_D),
                         (torch.bfloat16, circ_ops.DICT_MAX_D_BF16)):
        big = torch.zeros(1, 1, max_d + 1, dtype=dtype)
        with pytest.raises(ValueError, match="shared memory"):
            circ_ops._launch_dict(big, big, "conv")


@pytest.mark.parametrize("mode", ["conv", "corr"])
def test_codebook_circulant_exact(mode):
    """The circulant expansion equals the reference's bit for bit, and its
    einsum is the binding (conv) or unbinding (corr) of a query."""
    dic = _normal(5, 3, 2, 64)
    got = vsa.codebook_circulant(torch.from_numpy(dic), mode)
    want = np.asarray(jvsa.codebook_circulant(jnp.asarray(dic), mode))
    assert got.shape == (3, 2, 64, 64)
    np.testing.assert_array_equal(got.numpy(), want)
    x = torch.from_numpy(_normal(6, 2, 64))
    bound = torch.einsum("bk,mbnk->mbn", x, got)
    torch.testing.assert_close(bound, circ_ops.circ_bind_dict(x[None], torch.from_numpy(dic),
                                                              mode)[0], atol=1e-5, rtol=0)


# -- fused match_prob ----------------------------------------------------------


@pytest.mark.parametrize("n,m,d,temp,dtype", [
    (5, 3, 32, 1.0, "float32"),
    (40, 7, 128, 0.1, "float32"),
    (40, 7, 128, 0.1, "bfloat16"),
])
def test_fused_match_prob_matches_pallas_interpret(n, m, d, temp, dtype):
    """The port's fused_match_prob (plain version of the kernel's
    arithmetic) against the Pallas kernel in interpret mode, on the same
    values (bf16 inputs rounded from the same f32 draws); f32 out, atol
    1e-5."""
    q, dic = _normal(n, n, 4, d), _normal(m, m, 4, d)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    want = np.asarray(jsimd.fused_match_prob(jnp.asarray(q, jdt), jnp.asarray(dic, jdt),
                                             temp, interpret=True))
    got = simd_ops.fused_match_prob(torch.from_numpy(q).to(tdt),
                                    torch.from_numpy(dic).to(tdt), temp)
    assert got.dtype == torch.float32 and got.shape == (n, m)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("d", [64, 128])
def test_match_prob_matches_reference(d):
    """vsa.match_prob on both routes: similarity_matrix + softmax at d = 64,
    the fused kernel at d = 128 (simd_fused's floor), as the reference."""
    q, dic = _normal(d, 9, 4, d), _normal(d + 1, 6, 4, d)
    want = np.asarray(jvsa.match_prob(jnp.asarray(q), jnp.asarray(dic), 0.1))
    got = vsa.match_prob(torch.from_numpy(q), torch.from_numpy(dic), 0.1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.sum(dim=-1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("d,temp", [(128, 0.1), (32, 1.0)])
def test_fused_match_prob_gradient_matches_jax(d, temp):
    """The backward is the autograd of the reference's plain chain: the
    gradients of sum(w * probs) in q and in the dictionary agree with
    jax.grad through the reference's fused_match_prob (custom VJP) within
    1e-5."""
    q, dic, w = _normal(1, 8, 4, d), _normal(2, 5, 4, d), _normal(3, 8, 5)

    def loss(qq, dd):
        return jnp.sum(jnp.asarray(w) * jsimd_ops.fused_match_prob(qq, dd, temp,
                                                                   use_kernel=True))

    jgq, jgd = jax.grad(loss, argnums=(0, 1))(jnp.asarray(q), jnp.asarray(dic))
    tq = torch.from_numpy(q).requires_grad_()
    td = torch.from_numpy(dic).requires_grad_()
    (torch.from_numpy(w) * simd_ops.fused_match_prob(tq, td, temp)).sum().backward()
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(jgq), atol=1e-5, rtol=0)
    np.testing.assert_allclose(td.grad.numpy(), np.asarray(jgd), atol=1e-5, rtol=0)


def test_match_prob_plain_versions_agree():
    """The kernel's arithmetic (rsqrt(Σx² + 1e-18)) and the reference's
    chain (norm clamped at 1e-9) differ only in rounding on nonzero rows."""
    q, dic = torch.from_numpy(_normal(4, 16, 4, 256)), torch.from_numpy(_normal(5, 16, 4, 256))
    torch.testing.assert_close(simd_ref.fused_match_prob_ref(q, dic, 0.1),
                               simd_ref.match_prob_chain(q, dic, 0.1), atol=1e-6, rtol=0)


def test_match_prob_entry_limit():
    """The kernel holds a tile's logits on chip: M is bounded by shared
    memory, and the bound is at least 1024 at NVSA's 4 x 256 (83408: eight
    CTAs of a cluster with 10426 logits per query each)."""
    assert simd_ops.max_entries(4, 256) == 83408
    assert simd_ops.max_entries(4, 256) >= 1024
    assert simd_ops.max_entries(8, 1024) >= 1024


def test_match_prob_cluster_geometry():
    """The wrapper's copy of simd_fused.cu's shared-memory formula (48 KB
    of the threads' rings, the query tile with rows padded to 16 bytes, the
    tile's B scales, 8 exchange floats and 4 logits per entry) and its
    cluster size: S = 1 at (512, 16, 4, 256) and wherever M is one pass of
    32 entries, 8 at (64, 1024, 4, 256), never above M or 8, every rank
    owning an entry and fitting shared memory; the limit at least the first design's 13248 at (4, 256), and
    the raise where it says a launch would fail."""
    ring, limit = 16 * 256 * 3 * 4, 227 * 1024
    assert simd_ops.smem_bytes(128, 4, 256) == 4 * 4 * 256 * 4 + ring + 64 + 32 + 16 * 128
    assert simd_ops.smem_bytes(16, 4, 256, elt=2) == 4 * 4 * 256 * 2 + ring + 64 + 32 + 16 * 16
    assert simd_ops.smem_bytes(1, 1, 7) == 4 * 8 * 4 + ring + 16 + 32 + 16
    assert simd_ops.smem_bytes(1, 1, 130, elt=2) == 4 * 136 * 2 + ring + 16 + 32 + 16
    assert simd_ops.cluster_size(512, 16, 4, 256) == 1
    assert simd_ops.cluster_size(64, 1024, 4, 256) == 8
    assert simd_ops.cluster_size(67, 5, 4, 128) == 1       # one pass: no split
    assert simd_ops.cluster_size(67, 300, 4, 128) == 7
    for b, d in ((4, 256), (4, 128), (8, 1024), (1, 7)):
        cap = simd_ops.slice_entries(b, d)
        assert simd_ops.smem_bytes(cap, b, d) <= limit < simd_ops.smem_bytes(cap + 1, b, d)
        assert simd_ops.max_entries(b, d) == 8 * cap
        for n in (1, 8, 64, 67, 512, 5000):
            for m in {1, 2, 5, 9, 16, 1003, 1024, 13249, simd_ops.max_entries(b, d)}:
                if m > simd_ops.max_entries(b, d):
                    continue
                s = simd_ops.cluster_size(n, m, b, d)
                ms = -(-m // s)
                assert 1 <= s <= min(m, 8) and (s - 1) * ms < m, (n, m, s)
                assert simd_ops.smem_bytes(ms, b, d) <= limit, (n, m, s)
    assert simd_ops.max_entries(4, 256) >= 13248
    big = torch.empty(simd_ops.max_entries(4, 256) + 1, 4, 256, device="meta")
    with pytest.raises(ValueError, match=f"M <= {simd_ops.max_entries(4, 256)}"):
        simd_ops._launch(big[:1], big, 1.0)


# -- flash attention -----------------------------------------------------------


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 step (8 significant bits) at each value of ``x``."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


@pytest.mark.parametrize("shape,skv,causal,dtype", [
    ((2, 40, 4, 16), 40, True, "float32"),
    ((2, 32, 4, 16), 40, True, "float32"),
    ((2, 32, 4, 16), 40, False, "float32"),
    ((2, 40, 4, 16), 40, True, "bfloat16"),
])
def test_flash_mha_matches_reference(shape, skv, causal, dtype):
    """flash_mha against the reference's (Pallas kernel in interpret mode)
    on (B, S, H, hd): 1e-4 at f32; at bf16 within one bf16 step of the
    reference (both round an f32 result).  Sq = 32 against Skv = 40 pins
    the causal mask's alignment at position 0."""
    b, sq, h, hd = shape
    q, k, v = _normal(1, b, sq, h, hd), _normal(2, b, skv, h, hd), _normal(3, b, skv, h, hd)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    scale = hd ** -0.5
    want = np.asarray(jflash_ops.flash_mha(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                                           jnp.asarray(v, jdt), scale, causal=causal,
                                           use_kernel=True).astype(jnp.float32))
    got = flash_ops.flash_mha(torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt),
                              torch.from_numpy(v).to(tdt), scale, causal=causal)
    assert got.dtype == tdt and got.shape == (b, sq, h, hd)
    diff = np.abs(got.float().numpy() - want)
    if dtype == "float32":
        assert diff.max() <= 1e-4, diff.max()
    else:
        assert (diff <= _bf16_ulp(want)).all(), diff.max()


# -- routes, launch counts, the registry ---------------------------------------


def test_cpu_calls_count_no_launch_and_routes_are_recorded():
    """CPU tensors take the plain versions: no launch is counted.  Below
    simd_fused's floor match_prob records the gather route, at it the
    kernel; circ_bind_dict and flash_mha are kernel-level entry points
    that ignore any floor."""
    before = dict(registry.LAUNCHES)
    x = torch.randn(3, 2, 64)
    with registry.record_kernels() as rec:
        vsa.match_prob(x, x)
        vsa.match_prob(torch.randn(3, 2, 128), torch.randn(4, 2, 128))
        circ_ops.circ_bind_dict(x, x)
        a = torch.randn(1, 8, 2, 16)
        flash_ops.flash_mha(a, a, a, 0.25)
    assert rec == [("simd_fused", "gather"), ("simd_fused", "kernel"),
                   ("circ_dict", "kernel"), ("flash_attn", "kernel")]
    assert registry.LAUNCHES == before


def test_registry_names_each_pallas_kernel_once():
    """One spec per Pallas function, with the reference's epsilons and
    floors; ``replaces`` points at the def of a function that reaches
    ``pl.pallas_call``, and ``source`` exists."""
    assert len(registry.KERNELS) == 6
    assert len({s.replaces for s in registry.KERNELS.values()}) == 6
    for name, spec in registry.KERNELS.items():
        assert (ROOT / "src" / "repro_torch" / "csrc" / spec.source).is_file()
        path, line = spec.replaces.split(":")
        lines = (ROOT / path).read_text().splitlines()
        assert lines[int(line) - 1].startswith("def "), spec.replaces
        body = "\n".join(lines[int(line) - 1:int(line) + 40])
        assert "pl.pallas_call(" in body, spec.replaces
    for name in ("simd_fused", "flash_attn"):
        assert registry.KERNELS[name].epsilon == \
            jregistry.KERNELS[name].lowerings[0].epsilon
        assert registry.KERNELS[name].dispatch_min_size == \
            jregistry.KERNELS[name].dispatch_min_size
    assert registry.KERNELS["circ_dict"].epsilon == \
        jregistry.KERNELS["circ_conv"].lowerings[0].epsilon == 1e-3
    assert registry.KERNELS["circ_dict"].dispatch_min_size == 0
    assert registry.KERNELS["simd_fused"].dispatch_min_size == 128
    assert registry.KERNELS["flash_attn"].epsilon == 3e-2
