"""Error enforcement utilities: a copy of `paddle_tpu/core/enforce.py`.

Analog of the reference's enforce macros (`paddle/phi/core/enforce.h`,
PADDLE_ENFORCE_*): raise rich, typed errors with an error-summary header.
"""
from __future__ import annotations


# distress hook injected by paddle_tpu.observability (kept injectable so
# this module stays dependency-free): fn(exc_type_name, message) — may
# dump the flight recorder under FLAGS_dump_on_enforce
_distress_hook = [None]


def set_distress_hook(fn):
    _distress_hook[0] = fn


class EnforceNotMet(RuntimeError):
    """Base framework error (reference: phi::enforce::EnforceNotMet)."""

    def __init__(self, *args):
        super().__init__(*args)
        hook = _distress_hook[0]
        if hook is not None:
            hook(type(self).__name__, str(args[0]) if args else "")


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


class DataLossError(EnforceNotMet):
    """Persisted data failed an integrity check (truncated/corrupted file,
    CRC mismatch). Reference: phi error code DATALOSS."""


def enforce(cond, msg: str = "Enforce condition failed", *args, exc=InvalidArgumentError):
    if not cond:
        raise exc(msg % args if args else msg)


def enforce_eq(a, b, msg: str = ""):
    if a != b:
        raise InvalidArgumentError(f"Expected {a!r} == {b!r}. {msg}")


def enforce_gt(a, b, msg: str = ""):
    if not a > b:
        raise InvalidArgumentError(f"Expected {a!r} > {b!r}. {msg}")


def not_implemented(what: str):
    raise UnimplementedError(what)
