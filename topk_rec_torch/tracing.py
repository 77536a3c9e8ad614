"""Spans: named stretches of the program's host time.

``with span("train.step"): ...`` marks a stretch where the work happens.
It has two outputs and no switch of its own:

* under ``torch.profiler`` (``train --profile-dir``, or any profiler a
  caller opens) the span is a host event named ``tkr.<name>`` in
  ``prof.events()`` and in the Chrome trace, on the profiler's clock, so it
  lines up with the CUDA records, nested under the span that encloses it;
* under :func:`recording`, each span that closes is kept in memory with its
  seconds on the host clock (``evaluate``'s ``TKR_TIMING=1`` lines are
  printed from one).

When neither is on, ``span`` returns one shared no-op context: a call and a
test of the profiler's flag, about 0.6 µs a span with its ``with`` on an
H100 host, so spans can sit on a served batch's path. Under a profiler a
span costs about 3 µs.

The range is the profiler's function scope, not ``record_function``'s user
scope: the profiler projects a user-scope range onto the card's timeline as
a device record of its own (``gpu_user_annotation``), which would count as
device time. A span is host time only.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, List, Tuple

import torch

PREFIX = "tkr."  # the profiler's name of a span: PREFIX + name

Recording = List[Tuple[str, float]]  # (name, seconds) of closed spans

_profiling = torch.autograd._profiler_enabled
_recordings: List[Recording] = []  # the open recordings


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_OFF = _Off()


class _Span:
    __slots__ = ("name", "_range", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = None
        if _profiling():
            self._range = torch._C._profiler._RecordFunctionFast(
                PREFIX + self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self._t0
        for rec in _recordings:
            rec.append((self.name, seconds))
        if self._range is not None:
            self._range.__exit__(*exc)
        return None


def span(name: str):
    """A context that marks ``name``'s stretch of host time for the
    profiler and the open recordings; the shared no-op when neither is
    on."""
    if _recordings or _profiling():
        return _Span(name)
    return _OFF


@contextlib.contextmanager
def recording() -> Iterator[Recording]:
    """Keep (name, seconds) of every span that closes inside the block, in
    the order they close (a child before its parent)."""
    rec: Recording = []
    _recordings.append(rec)
    try:
        yield rec
    finally:  # by identity: two recordings may hold equal spans
        _recordings[:] = [r for r in _recordings if r is not rec]
