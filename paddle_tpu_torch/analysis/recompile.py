"""The zero-cold-start budget of a warmed serve.

Port of ``paddle_tpu/analysis/recompile.py``'s ``CompileWatch`` and
``enforce_zero_compiles``. The JAX package counts XLA compiles through a
``jax.monitoring`` listener; the port compiles nothing at serve time, so
it counts what a serve after ``ServingEngine.aot_warmup`` must not meet:

* ``loads``: kernel libraries loaded (``ops/kernels/_build.load_library``,
  which builds the library first if it is missing);
* ``tickets``: split-KV ticket buffers made (``decode_attention._tickets``:
  a CUDA-graph capture needs them to exist beforehand);
* ``unenumerated``: program keys an engine dispatched that it had not run
  (``serving.COLD_KEYS``): after ``aot_warmup``, keys outside its
  envelope's enumeration.

The counters are process-wide integers, so a watch sees every engine.
"""

from __future__ import annotations

import contextlib

__all__ = ["CompileWatch", "CompileBudgetError", "enforce_zero_compiles",
           "counts"]


def counts() -> dict:
    """The process's counters now: {"loads", "tickets", "unenumerated"}."""
    from ..inference import serving
    from ..ops.kernels import _build, decode_attention

    return {"loads": _build.LOADS[0],
            "tickets": decode_attention.TICKET_BUFFERS[0],
            "unenumerated": serving.COLD_KEYS[0]}


class CompileWatch:
    """Count the three events from entering the context (``as_dict()``;
    ``loads``, ``tickets``, ``unenumerated``, and ``compiles``, their
    sum)."""

    def __enter__(self):
        self._start = counts()
        return self

    def __exit__(self, *exc):
        return False

    def as_dict(self) -> dict:
        now = counts()
        return {k: now[k] - self._start[k] for k in now}

    @property
    def loads(self) -> int:
        return self.as_dict()["loads"]

    @property
    def tickets(self) -> int:
        return self.as_dict()["tickets"]

    @property
    def unenumerated(self) -> int:
        return self.as_dict()["unenumerated"]

    @property
    def compiles(self) -> int:
        return sum(self.as_dict().values())


class CompileBudgetError(AssertionError):
    """A warmed region met a library load, a ticket buffer or a key it
    had not run."""


@contextlib.contextmanager
def enforce_zero_compiles(label: str = "post-warmup serve"):
    """The zero budget of a serve after ``aot_warmup``: inside the region
    no kernel library loads, no ticket buffer is made and no engine
    dispatches a key it had not run, or ``CompileBudgetError`` is raised
    at its end::

        eng.aot_warmup(envelope)
        with analysis.recompile.enforce_zero_compiles("mixed serve"):
            scheduler.serve(trace)

    Yields the ``CompileWatch``."""
    with CompileWatch() as cw:
        yield cw
        got = cw.as_dict()
        if any(got.values()):
            raise CompileBudgetError(
                f"{got} during {label}: the post-warmup budget is 0 (a key "
                f"escaped the declared envelope, or the warmup missed an "
                f"enumerated key)")
