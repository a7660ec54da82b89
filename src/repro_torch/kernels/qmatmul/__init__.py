"""Quantised int8 / packed-int4 matmul kernel."""
