"""Error-reporting machinery: the error types the ops raise.

Port of ``paddle_tpu/enforce.py`` (the counterpart of Paddle's
``PADDLE_ENFORCE_*``): structured exceptions carrying an error-type
taxonomy and the raising frame, so op implementations can validate
inputs with one-liners.
"""

from __future__ import annotations

import traceback
from typing import Any, NoReturn

__all__ = [
    "EnforceNotMet",
    "InvalidArgumentError",
    "NotFoundError",
    "OutOfRangeError",
    "UnimplementedError",
    "UnavailableError",
    "PreconditionNotMetError",
    "enforce",
    "enforce_eq",
    "enforce_gt",
    "enforce_ge",
    "enforce_not_none",
    "raise_unimplemented",
]


class EnforceNotMet(RuntimeError):
    """Base class for framework errors (``platform::EnforceNotMet`` analog)."""

    def __init__(self, message: str):
        stack = "".join(traceback.format_stack()[:-2][-6:])
        super().__init__(f"{message}\n  [operator stack]\n{stack}")
        self.short_message = message


class InvalidArgumentError(EnforceNotMet, ValueError):
    pass


class NotFoundError(EnforceNotMet, KeyError):
    pass


class OutOfRangeError(EnforceNotMet, IndexError):
    pass


class UnimplementedError(EnforceNotMet, NotImplementedError):
    pass


class UnavailableError(EnforceNotMet):
    pass


class PreconditionNotMetError(EnforceNotMet):
    pass


def enforce(cond: Any, message: str, exc: type = InvalidArgumentError) -> None:
    if not cond:
        raise exc(message)


def enforce_eq(a: Any, b: Any, message: str = "") -> None:
    if a != b:
        raise InvalidArgumentError(f"Expected {a!r} == {b!r}. {message}")


def enforce_gt(a: Any, b: Any, message: str = "") -> None:
    if not a > b:
        raise InvalidArgumentError(f"Expected {a!r} > {b!r}. {message}")


def enforce_ge(a: Any, b: Any, message: str = "") -> None:
    if not a >= b:
        raise InvalidArgumentError(f"Expected {a!r} >= {b!r}. {message}")


def enforce_not_none(x: Any, what: str = "value") -> Any:
    if x is None:
        raise NotFoundError(f"Expected {what} to be set, got None.")
    return x


def raise_unimplemented(what: str) -> NoReturn:
    raise UnimplementedError(
        f"{what} is not implemented in paddle_tpu_torch yet "
        "(see ROADMAP.md, Queue A)."
    )
