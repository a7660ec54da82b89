"""Vector-Symbolic Architecture algebra on block codes ``(..., blocks, d)``.

The port of ``repro.vsa.ops``.  Binding is the blockwise circular
convolution ``C[n] = Σ_k A[k]·B[(n−k) mod d]``, unbinding the circular
correlation.  ``bind`` / ``unbind`` route through the kernel registry: at
block dims at or above circ_conv's ``dispatch_min_size`` (128) they call
the circ_conv kernel wrapper (the Hopper kernel on a CUDA tensor, its plain
version on a CPU tensor); below it they take the exact gather reference on
every device, as the reference does on every platform.  ``match_prob``
routes the same way at simd_fused's floor (128): the fused match_prob
kernel at and above it, ``similarity_matrix`` + softmax below.
"""

from __future__ import annotations

import math

import torch

from repro_torch.backend import registry
from repro_torch.kernels.circ_conv import ops as k_ops
from repro_torch.kernels.circ_conv.ref import circ_elem_ref, circ_index
from repro_torch.kernels.simd_fused import ops as simd_ops


# ---------------------------------------------------------------------------
# Reference (oracle) implementations
# ---------------------------------------------------------------------------


def circ_conv_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Blockwise circular convolution by gather. a, b: (..., blocks, d),
    leading dims broadcast."""
    return circ_elem_ref(a, b, "conv")


def circ_corr_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Blockwise circular correlation: Σ_k a[k]·b[(n+k) % d]."""
    return circ_elem_ref(a, b, "corr")


def circ_conv_fft(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """FFT oracle (float path, for cross-validation in tests)."""
    fa = torch.fft.rfft(a.float(), dim=-1)
    fb = torch.fft.rfft(b.float(), dim=-1)
    return torch.fft.irfft(fa * fb, n=a.shape[-1], dim=-1).to(a.dtype)


def circ_corr_fft(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    fa = torch.fft.rfft(a.float(), dim=-1)
    fb = torch.fft.rfft(b.float(), dim=-1)
    return torch.fft.irfft(torch.conj(fa) * fb, n=a.shape[-1], dim=-1).to(a.dtype)


# ---------------------------------------------------------------------------
# Public API (kernel-dispatching)
# ---------------------------------------------------------------------------


def dispatch_path(d: int) -> str:
    """``"kernel"`` when ``bind`` / ``unbind`` at block dim ``d`` go to the
    circ_conv kernel wrapper, ``"gather"`` for the exact reference."""
    return registry.dispatch_path("circ_conv", d)


def bind(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Binding = blockwise circular convolution. Shapes broadcast on lead dims."""
    if dispatch_path(a.shape[-1]) == "kernel":
        return k_ops.circ_bind(a, b, mode="conv")
    return circ_conv_ref(a, b)


def unbind(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inverse binding = blockwise circular correlation of ``a`` against ``b``."""
    if dispatch_path(a.shape[-1]) == "kernel":
        return k_ops.circ_bind(a, b, mode="corr")
    return circ_corr_ref(a, b)


def normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-9)


def bundle(*vs: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """Superposition of block codes."""
    s = sum(vs[1:], start=vs[0])
    if normalize:
        s = s / torch.clamp(torch.linalg.vector_norm(s, dim=-1, keepdim=True), min=1e-9)
    return s


def similarity(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Blockwise cosine similarity, averaged over blocks.

    a: (..., blocks, d), b: (..., blocks, d) -> (...)
    """
    an = normalize(a.float())
    bn = normalize(b.float())
    return (an * bn).sum(dim=-1).mean(dim=-1)


def similarity_matrix(q: torch.Tensor, dictionary: torch.Tensor) -> torch.Tensor:
    """q: (n, blocks, d) vs dictionary: (m, blocks, d) -> (n, m)."""
    qn = normalize(q.float())
    dn = normalize(dictionary.float())
    return torch.einsum("nbd,mbd->nm", qn, dn) / q.shape[-2]


def match_prob(q: torch.Tensor, dictionary: torch.Tensor,
               temp: float = 1.0) -> torch.Tensor:
    """Paper Listing 1 ``match_prob_multi_batched``: probability that each
    query matches each dictionary entry, a softmax over scaled
    similarities.  q: (n, blocks, d), dictionary: (m, blocks, d) -> (n, m)
    f32.  At block dims at or above simd_fused's floor (128) it is the fused
    kernel (differentiable; its backward is the plain chain's), below it
    ``similarity_matrix`` and a softmax, on every device."""
    if registry.dispatch_path("simd_fused", q.shape[-1]) == "kernel":
        return simd_ops.fused_match_prob(q, dictionary, temp)
    return torch.softmax(similarity_matrix(q, dictionary) / temp, dim=-1)


def codebook_circulant(dictionary: torch.Tensor, mode: str = "conv") -> torch.Tensor:
    """Circulant expansion of a static codebook: dictionary (m, blocks, d)
    -> (m, blocks, d, d) such that ``bind(x, dict_i) ==
    einsum('bk,bnk->bn', x, out_i)`` (``unbind`` likewise with
    ``mode="corr"``)."""
    return dictionary[..., circ_index(dictionary.shape[-1], mode, dictionary.device)]


def random_codebook(generator: torch.Generator, n: int, blocks: int, d: int,
                    dtype=torch.float32) -> torch.Tensor:
    """Random unit-norm block codes (CPU tensor)."""
    v = torch.randn((n, blocks, d), generator=generator, dtype=torch.float32)
    return normalize(v).to(dtype)


def unitary_codebook(generator: torch.Generator, n: int, blocks: int, d: int,
                     dtype=torch.float32) -> torch.Tensor:
    """Unitary block codes (|FFT| = 1, CPU tensor): binding is exactly
    invertible, unbind(bind(a, u), u) == a.  The phase is uniform on
    [−π, π); the DC bin, and the Nyquist bin for even d, are 0 so the codes
    are real."""
    u = torch.rand((n, blocks, d // 2 + 1), generator=generator,
                   dtype=torch.float32)
    phase = u * (2 * math.pi) - math.pi
    phase[..., 0] = 0.0
    if d % 2 == 0:
        phase[..., -1] = 0.0
    spec = torch.polar(torch.ones_like(phase), phase)
    return torch.fft.irfft(spec, n=d, dim=-1).to(dtype)
