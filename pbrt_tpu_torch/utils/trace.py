"""Host spans of a render: where the host spends its time, on the
profiler's clock.

    with trace.recording():
        render(cs, options)
    spans = trace.take()

`span(name)` marks a stage of the render loop or of an integrator. While
recording is off, the default, it returns one shared no-op context after a
single test of a module flag. While on, each span keeps its name, its
start and end read with `time.time_ns()` (the clock torch.profiler stamps
its host and device events with, so a span can be matched to the kernels
launched inside it), the index of its parent (the span open when it
started, -1 for none) and a frame id: a span opened with none open starts
a new frame, and every span nested in it shares the id, so the spans of
one render() call share one. Spans are kept in memory until `take()`.

A span never touches the device: it launches, records and synchronises
nothing and reads no tensor, so a render's image and its kernels are the
same with recording on or off.
"""
from __future__ import annotations

import contextlib
import time
from typing import List, NamedTuple


class Span(NamedTuple):
    name: str
    t0_ns: int
    t1_ns: int
    parent: int    # index of the enclosing span in take()'s list, -1 for none
    frame: int


_ON = False
_SPANS: list = []    # [name, t0_ns, t1_ns, parent, frame] a span, in start order
_OPEN: list = []     # indices into _SPANS of the spans open now, innermost last
_FRAMES = 0


OFF = contextlib.nullcontext()


class _On:
    __slots__ = ("i",)

    def __init__(self, name):
        global _FRAMES
        parent = _OPEN[-1] if _OPEN else -1
        if parent < 0:
            _FRAMES += 1
        self.i = len(_SPANS)
        _SPANS.append([name, 0, 0, parent, _SPANS[parent][4] if parent >= 0 else _FRAMES])

    def __enter__(self):
        _OPEN.append(self.i)
        _SPANS[self.i][1] = time.time_ns()
        return self

    def __exit__(self, *exc):
        _SPANS[self.i][2] = time.time_ns()
        _OPEN.pop()
        return False


def span(name: str):
    """A context that records a span named `name` while recording is on."""
    if not _ON:
        return OFF
    return _On(name)


@contextlib.contextmanager
def recording():
    """Record spans inside the block (restoring the state before it)."""
    global _ON
    was, _ON = _ON, True
    try:
        yield
    finally:
        _ON = was


def take() -> List[Span]:
    """The spans recorded so far, in start order, and clear them."""
    out = [Span(*s) for s in _SPANS]
    _SPANS.clear()
    return out


def self_ns(spans: List[Span]) -> List[int]:
    """Each span's host time less the time of the spans directly in it."""
    out = [s.t1_ns - s.t0_ns for s in spans]
    for s in spans:
        if s.parent >= 0:
            out[s.parent] -= s.t1_ns - s.t0_ns
    return out


def report_timing(stats, spans: List[Span]):
    """Each span name's host self time a frame, in ms, into `stats` as the
    distribution "Timing/<name> self ms" over the frames."""
    by = {}
    for s, ns in zip(spans, self_ns(spans)):
        frames = by.setdefault(s.name, {})
        frames[s.frame] = frames.get(s.frame, 0) + ns
    for name, frames in by.items():
        stats.report_distribution(f"Timing/{name} self ms", [v / 1e6 for v in frames.values()])
