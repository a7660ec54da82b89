"""Staged-pipeline serving of reasoning workloads."""
