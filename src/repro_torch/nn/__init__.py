"""Layers, parameter specs and the ResNet frontend."""
