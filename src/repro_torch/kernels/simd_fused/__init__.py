"""Fused VSA match-probability kernel (the paper's SIMD unit)."""
