"""The kernel experiments on the card: ``dot_variants`` (formulations of
the lm_head dx product, the hand-written blocked matmul among them) and
``flash_variants`` (the packed flash-attention variants and ablations).

Counterparts of ``benchmarks/dot_variants.py`` and
``benchmarks/flash_variants.py``; run as ``python -m
paddle_tpu_torch.experiments.<name>``. ``turns`` times the training step
and the production flash kernels of this checkout and another one in
turns on one card. They need a CUDA device. ``parity`` is a module, not a
script: the checks that hold the port's other optimizers and its losses
on a device against the CPU.
"""
