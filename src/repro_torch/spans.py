"""Host spans and counters at the port's layer boundaries.

One process-wide recorder, off by default.  It records while a caller
holds ``recording()``, its one switch.  While it is off, ``span`` hands
back one shared no-op context and ``count`` returns after a flag test:
no allocation, no device operation.  On or off, it never reads or
synchronises the device.

    with spans.recording():
        final, stats = engine.batched_run_stats(batch, max_steps=n)
    rec = spans.take()      # {"spans": [(name, start, end, parent)],
    #                          "counters": {name: total}}

A span's start and end are ``time.perf_counter()`` seconds, the host
clock that marker kernels on the device can tie to the device's
timeline (a profiled call recorded this way names its idle gaps); its
parent is the index of the span open around it (-1: none).  Spans are
kept in memory until ``take()``; the simulator's loop runs in one
thread, and the recorder assumes so.  Names are fixed strings, one a
site; ``sync.<site>`` marks a call that waits for the device (a read of
a device value, or a copy from pageable host memory).
"""
from __future__ import annotations

import contextlib
import functools
import time

__all__ = ["span", "spanned", "count", "recording", "take", "NOOP"]

_clock = time.perf_counter
_on = False
_spans: list[list] = []     # [name, start, end, parent]
_open: list[int] = []       # indices of the open spans, innermost last
_counts: dict[str, int] = {}


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


class _Span:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        parent = _open[-1] if _open else -1
        _open.append(len(_spans))
        _spans.append([self.name, _clock(), None, parent])
        return self

    def __exit__(self, *exc):
        _spans[_open.pop()][2] = _clock()
        return False


def span(name: str):
    """A context manager that records ``name`` from entry to exit."""
    if _on:
        return _Span(name)
    return NOOP


def spanned(name: str):
    """Decorate a function so that each call is a span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, k: int = 1) -> None:
    """Add ``k`` to the counter ``name``."""
    if _on:
        _counts[name] = _counts.get(name, 0) + k


@contextlib.contextmanager
def recording():
    """Record spans and counters inside the block."""
    global _on
    was, _on = _on, True
    try:
        yield
    finally:
        _on = was


def take() -> dict:
    """The spans (``(name, start, end, parent)`` tuples, in the order they
    opened) and counters recorded since the last ``take()``, which are
    then cleared.  Raises inside an open span."""
    if _open:
        raise RuntimeError(f"take() inside the open span "
                           f"{_spans[_open[-1]][0]!r}")
    out = {"spans": [tuple(s) for s in _spans], "counters": dict(_counts)}
    _spans.clear()
    _counts.clear()
    return out
