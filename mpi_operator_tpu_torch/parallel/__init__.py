"""Attention across devices; this slice ports only the single-device oracle."""
