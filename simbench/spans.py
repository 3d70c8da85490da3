"""The program's host spans (``repro_torch.spans``) as the benchmark reads
them.

A *recorded* call is a driver call made inside
``repro_torch.spans.recording()`` and outside the profiler, with what
``spans.take()`` returned after it kept in its record as ``program``.
The span readers (``boundary_ms``, ``provision_ms``, ``step_host_ms``,
``syncs_per_step``) read a run's ``recorded_calls``, a list of such
records beside ``calls``; a run without them (the harness makes none
yet, nor a program without the recorder) gives None.
``span_report.py`` makes them on the card.

``flatten`` cuts the harness's phases and the program's spans, which
nest, into disjoint intervals, each named by the innermost span or
phase that holds it: given to ``harness.reduce_trace`` as a call's
phases, it names each idle gap of the device by that span.
"""
from __future__ import annotations

__all__ = ["recorded", "steps", "total_ms", "sync_sites", "self_ms",
           "flatten"]


def recorded(run: dict) -> list[dict]:
    """The run's recorded calls that recorded a ``drive`` span."""
    return [c for c in run.get("recorded_calls") or ()
            if any(s[0] == "drive" for s in c["program"]["spans"])]


def steps(call: dict) -> int:
    """The steps a call evaluated: ``RunStats.n_steps + n_leap``."""
    return call["counters"]["n_steps"] + call["counters"]["n_leap"]


def total_ms(call: dict, names) -> float:
    """Milliseconds of a recorded call's spans called one of ``names``."""
    return 1e3 * sum(b - a for n, a, b, _ in call["program"]["spans"]
                     if n in names)


def sync_sites(call: dict) -> int:
    """A recorded call's ``sync.*`` spans inside its ``drive`` span: the
    sites where the run loop waits for the device, counted once a visit
    however many waits the site holds (``bincount`` makes 2), pageable
    host-to-device copies included."""
    s = call["program"]["spans"]

    def in_drive(i):
        p = s[i][3]
        while p >= 0:
            if s[p][0] == "drive":
                return True
            p = s[p][3]
        return False

    return sum(1 for i, sp in enumerate(s)
               if sp[0].startswith("sync.") and in_drive(i))


def self_ms(spans: list) -> dict[str, list]:
    """Per span name, [count, self milliseconds]: a span's duration less
    its children's."""
    out: dict[str, list] = {}
    for name, a, b, parent in spans:
        slot = out.setdefault(name, [0, 0.0])
        slot[0] += 1
        slot[1] += 1e3 * (b - a)
        if parent >= 0:
            out[spans[parent][0]][1] -= 1e3 * (b - a)
    return out


def flatten(phases, spans) -> list[tuple[str, float, float]]:
    """``(name, start, end)`` intervals, disjoint and in order, from the
    harness's phases (``(name, start, end)``) and the program's spans
    (``(name, start, end, parent)``): each piece of the line is named by
    the innermost interval that holds it.  Phases hold spans, and spans
    nest, so the intervals form a hierarchy; a span that outlasts the
    interval holding its start is cut at that interval's end."""
    items = sorted([(a, -b, 0, n) for n, a, b in phases]
                   + [(a, -b, 1, n) for n, a, b, _ in spans
                      if b is not None])
    out, stack, at = [], [], None

    def emit(a, b, name):
        if b > a:
            out.append((name, a, b))

    for a, neg_b, _, name in items:
        b = -neg_b
        while stack and stack[-1][0] <= a:
            end, top = stack.pop()
            emit(at, end, top)
            at = end
        if stack:
            emit(at, a, stack[-1][1])
            b = min(b, stack[-1][0])
        at = a
        stack.append((b, name))
    while stack:
        end, top = stack.pop()
        emit(at, end, top)
        at = end
    return out
