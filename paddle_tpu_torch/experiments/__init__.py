"""The kernel experiments on the card: ``dot_variants`` (formulations of
the lm_head dx product, the hand-written blocked matmul among them) and
``flash_variants`` (the packed flash-attention variants and ablations).

Counterparts of ``benchmarks/dot_variants.py`` and
``benchmarks/flash_variants.py``; run as ``python -m
paddle_tpu_torch.experiments.<name>``. They need a CUDA device.
"""
