"""Synthetic RAVEN data (numpy)."""
