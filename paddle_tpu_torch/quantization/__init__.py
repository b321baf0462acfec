"""Quantization for serving: int8 / fp8 weights and K/V pages."""
