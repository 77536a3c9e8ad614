"""The program's spans in a profiled stretch.

The program marks stretches of its host time with spans
(``topk_rec_torch/tracing.py``); under the profiler each is a host event
named ``tkr.<name>`` on the clock of the device records, nested by time in
the span that encloses it. These read them out of a ``Trace``'s ``host``
events: each name's count, inclusive seconds and self seconds (its time
less the part its child spans cover), and the device's idle gaps divided
among the spans that ran during them. Names are given without ``tkr.``.
A trace of a program without spans reads as no spans: counts 0."""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Tuple

PREFIX = "tkr."
OUTSIDE = "outside any span"

Span = Tuple[str, float, float]  # (name, start s, end s)


def spans(trace) -> List[Span]:
    """The trace's spans, (name without ``tkr.``, start, end), in the
    order they started (an enclosing span before the spans inside it)."""
    return sorted(((n[len(PREFIX):], s, s + d) for n, s, d in trace.host
                   if n.startswith(PREFIX)), key=lambda x: (x[1], -x[2]))


def count(trace, name: str) -> int:
    return sum(1 for n, _, _ in spans(trace) if n == name)


def inclusive_s(trace, name: str) -> float:
    """Summed length of the spans named ``name``."""
    return sum(e - s for n, s, e in spans(trace) if n == name)


def _union(iv: List[Tuple[float, float]]) -> float:
    total, hi = 0.0, float("-inf")
    for s, e in sorted(iv):
        if e > hi:
            total += e - max(s, hi)
            hi = e
    return total


def self_s(trace, name: str) -> float:
    """Summed length of the spans named ``name``, each less the union of
    the other spans that lie inside it."""
    sp = spans(trace)
    total = 0.0
    for k, (n, s, e) in enumerate(sp):
        if n != name:
            continue
        inner = []
        for _, cs, ce in sp[k + 1:]:
            if cs >= e:
                break
            if ce <= e:
                inner.append((cs, ce))
        total += (e - s) - _union(inner)
    return total


def innermost(sp: List[Span]) -> List[Span]:
    """The spans' time cut into pieces, each labelled with the innermost
    span running then: (name, start, end), in time order, no overlaps."""
    out: List[Span] = []
    stack: List[Tuple[str, float]] = []  # (name, end), innermost last
    t = float("-inf")

    def advance(upto: float) -> None:
        nonlocal t
        while stack and stack[-1][1] <= upto:
            name, end = stack.pop()
            if end > t:
                out.append((name, t, end))
                t = end
        if stack and upto > t:
            out.append((stack[-1][0], t, upto))
        t = max(t, upto)

    for name, s, e in sp:
        advance(s)
        stack.append((name, e))
    advance(float("inf"))
    return out


def idle_gaps(trace) -> List[Tuple[float, float]]:
    """The device's idle gaps between its first and last record."""
    iv = sorted((s, s + d) for _, s, d in trace.device)
    gaps = []
    if iv:
        reach = iv[0][1]
        for s, e in iv[1:]:
            if s > reach:
                gaps.append((reach, s))
            reach = max(reach, e)
    return gaps


def idle_by_span(trace) -> Dict[str, float]:
    """Each idle gap of the device divided by overlap among the innermost
    spans running during it, the rest ``OUTSIDE``: seconds by span name,
    most first."""
    pieces = innermost(spans(trace))
    starts = [s for _, s, _ in pieces]
    out: Dict[str, float] = defaultdict(float)
    for a, b in idle_gaps(trace):
        covered = 0.0
        k = max(bisect.bisect_right(starts, a) - 1, 0)
        while k < len(pieces) and pieces[k][1] < b:
            name, s, e = pieces[k]
            part = min(e, b) - max(s, a)
            if part > 0:
                out[name] += part
                covered += part
            k += 1
        if b - a - covered > 0:
            out[OUTSIDE] += b - a - covered
    return dict(sorted(out.items(), key=lambda x: -x[1]))
