"""Blockwise circular convolution / correlation kernel."""
