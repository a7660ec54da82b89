"""Strided and broadcast operands of the port's binds, on the CPU.

``circ_bind`` (``vsa.bind`` / ``vsa.unbind``) hands ``circ_elem`` the views
NVSA's served binds make: row slices ``codes[:, r0]`` of an (n, 8, B, d)
tensor, keys broadcast over one lead dim (``shifts[i][None]``) and over two
(``roles[a][None, None]`` against (n, 8, B, d) panels).  The kernel reads
them by stride on the card; here the plain version gets the same views.
The same numpy inputs go through the JAX reference (its Pallas kernels in
interpret mode under the negotiated CPU plan).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.backend import registry as jregistry
from repro.vsa import ops as jvsa
from repro_torch.kernels.circ_conv import ops as circ_ops
from repro_torch.kernels.circ_conv import ref as circ_ref
from repro_torch.models import nvsa
from repro_torch.vsa import ops as vsa

torch.set_num_threads(2)

CPU_PLAN = jregistry.negotiate(platform="cpu", override="")


def _operands(kind: str, d: int, seed: int = 0):
    """(a, b) as numpy arrays and the port's torch views of them: ``a`` the
    row slice or the panels, ``b`` the other slice or the broadcast key;
    block codes of unit norm per block, as the VSA binds them."""
    rng = np.random.default_rng(seed + d)
    codes = rng.standard_normal((3, 8, 2, d)).astype(np.float32)
    key = rng.standard_normal((2, d)).astype(np.float32)
    codes /= np.linalg.norm(codes, axis=-1, keepdims=True)
    key /= np.linalg.norm(key, axis=-1, keepdims=True)
    t_codes, t_key = torch.from_numpy(codes), torch.from_numpy(key)
    if kind == "row slices":
        return (codes[:, 1], codes[:, 0]), (t_codes[:, 1], t_codes[:, 0])
    if kind == "key over one lead dim":
        return (codes[:, 1], key[None]), (t_codes[:, 1], t_key[None])
    return (codes, key[None, None]), (t_codes, t_key[None, None])


KINDS = ["row slices", "key over one lead dim", "key over two lead dims"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("op", ["bind", "unbind"])
@pytest.mark.parametrize("d", [128, 256])
def test_bind_unbind_on_views_match_reference(d, op, kind):
    """vsa.bind (conv) and vsa.unbind (corr) at and above the dispatch floor
    on each kind of view, against the reference's op on the same values,
    within 1e-5 (f32 sums of d terms in another order)."""
    (a, b), (ta, tb) = _operands(kind, d)
    assert not (ta.is_contiguous() and torch.broadcast_tensors(ta, tb)[1].is_contiguous())
    got = getattr(vsa, op)(ta, tb)
    with jregistry.use_plan(CPU_PLAN):
        want = np.asarray(getattr(jvsa, op)(jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_circ_bind_hands_views_to_the_plain_version(monkeypatch, kind):
    """circ_bind makes no copy: the operands reaching circ_elem's plain
    version (the kernel's, on the card) share storage with the caller's
    tensors, and a broadcast key keeps stride 0 over the merged lead dims."""
    seen = []
    plain = circ_ref.circ_elem_ref

    def spy(x, y, mode):
        seen.append((x, y))
        return plain(x, y, mode)

    monkeypatch.setattr(circ_ref, "circ_elem_ref", spy)
    _, (ta, tb) = _operands(kind, 128)
    out = circ_ops.circ_bind(ta, tb, "conv")
    assert len(seen) == 1
    x, y = seen[0]
    assert x.untyped_storage().data_ptr() == ta.untyped_storage().data_ptr()
    assert y.untyped_storage().data_ptr() == tb.untyped_storage().data_ptr()
    assert x.shape == y.shape == (out.numel() // (2 * 128), 2, 128)
    if kind == "row slices":
        assert x.stride() == y.stride() == (8 * 2 * 128, 128, 1)
    else:
        assert y.stride() == (0, 128, 1)
    torch.testing.assert_close(out, plain(*torch.broadcast_tensors(ta, tb), "conv"),
                               atol=0, rtol=0)


def test_reason_unchanged_by_views(monkeypatch):
    """nvsa.reason with binds that pass views gives the log-probs and rule
    posteriors of binds that copy every operand contiguous first (the
    previous circ_bind), bit for bit; test_torch_nvsa.py holds the same
    reason against the reference's."""
    cfg = nvsa.NVSAConfig(d=128, blocks=2)
    books = nvsa.quantize_codebooks(
        cfg, nvsa.nvsa_codebooks(cfg, torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(1)
    pmfs = [[torch.from_numpy(rng.dirichlet(np.ones(v), size=(3, 8)).astype(np.float32))
             for v in cfg.raven.attr_sizes] for _ in range(2)]
    got = nvsa.reason(cfg, books, *pmfs)

    def copying(a, b, mode="conv"):
        a, b = torch.broadcast_tensors(a, b)
        lead, (blocks, d) = a.shape[:-2], a.shape[-2:]
        out = circ_ops.circ_elem(a.reshape(-1, blocks, d).contiguous(),
                                 b.reshape(-1, blocks, d).contiguous(), mode)
        return out.reshape(*lead, blocks, d)

    monkeypatch.setattr(circ_ops, "circ_bind", copying)
    want = nvsa.reason(cfg, books, *pmfs)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
