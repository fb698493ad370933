"""Workloads the operator launches, ported to PyTorch."""
