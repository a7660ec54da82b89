"""Kernel registry of the port (device-selected routing, launch counts)."""
