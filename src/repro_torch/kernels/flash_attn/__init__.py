"""Causal flash attention kernel (forward)."""
