"""Observability: output-quality comparison of two serves."""
