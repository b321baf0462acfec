"""Static and counting analyses of the port's serving stack.

Port of the parts of ``paddle_tpu/analysis/`` that do not read XLA's HLO:

* ``recompile``: counts the events a warmed serve must not meet (kernel
  library loads, split-KV ticket buffers made, program keys an engine had
  not run) in place of the JAX package's compile listener;
* ``coverage``: the program-space coverage passes (registry-only key
  construction, the envelope replay, enumerated against used keys) and
  ``aot_audit``;
* ``memory``: the chip fit, a byte count over the port's tensors (weights,
  the page pool, an analytic transient).
"""
