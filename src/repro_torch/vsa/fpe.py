"""Fractional Power Encoding (FPE) over unitary block codes.

The port of ``repro.vsa.fpe``: a base phase φ per attribute encodes value
``v`` as ``irfft(exp(i·v·φ))``, so binding adds values and unbinding
subtracts them.
"""

from __future__ import annotations

import math

import torch


def fpe_base_phase(generator: torch.Generator, blocks: int, d: int) -> torch.Tensor:
    """Random base phase φ in [−π, π) (CPU tensor); the DC bin, and the
    Nyquist bin for even d, are 0 so the codes are real."""
    u = torch.rand((blocks, d // 2 + 1), generator=generator, dtype=torch.float32)
    phase = u * (2 * math.pi) - math.pi
    phase[..., 0] = 0.0
    if d % 2 == 0:
        phase[..., -1] = 0.0
    return phase


def fpe_encode(phase: torch.Tensor, v, d: int) -> torch.Tensor:
    """Encode value(s) ``v`` (scalar or (n,) sequence) -> (n, blocks, d)."""
    v = torch.atleast_1d(torch.as_tensor(v, dtype=torch.float32,
                                         device=phase.device))
    spec = torch.exp(1j * v[:, None, None] * phase[None])
    return torch.fft.irfft(spec, n=d, dim=-1)


def fpe_codebook(phase: torch.Tensor, n_values: int, d: int) -> torch.Tensor:
    """Integer codebook for values 0..n_values-1 -> (n_values, blocks, d)."""
    return fpe_encode(phase, torch.arange(n_values), d)
