"""Workload registry and engine constructors."""
