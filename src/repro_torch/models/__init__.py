"""Neuro-symbolic models."""
