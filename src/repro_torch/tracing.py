"""Host spans and counters of the port: the engine's step and its
phases, each request's wait in the queue, Algorithm 2's iterations and
the graphed train step.

Off by default.  A caller turns it on with :func:`enable`, runs, and
takes what was recorded with :func:`drain`::

    from repro_torch import tracing
    tracing.enable()
    ...                       # engine steps, pruner.run, train steps
    rec = tracing.drain()     # {"spans": [...], "counters": {...}}
    tracing.disable()

While off, :func:`span` returns one shared object that does nothing and
:func:`count` returns at once: a traced call costs one check of a
module flag.  While on, each span is kept in memory as ``(name,
start_ns, end_ns, parent, rid, arg)``: ``parent`` is the index in the
drained list of the span open around it (-1 for none), ``rid`` a
request id and ``arg`` a number or a short string of the call (-1 when
unused).  Counters are integer totals by name.  Nothing is written
anywhere during a run.

The clock is ``time.time_ns()``: nanoseconds since the Unix epoch, the
clock of ``torch.profiler``'s host events, so the spans line up with a
device trace taken over the same run.  The recorder is not thread-safe:
spans belong to the thread that drives the engine, the pruner or the
train step.
"""
from __future__ import annotations

import time
from typing import Dict, List, Tuple

__all__ = ["add", "count", "disable", "drain", "enable", "enabled", "span"]

_on = False
_spans: List[list] = []             # [name, start_ns, end_ns, parent, rid, arg]
_open: List[int] = []               # indices of the open spans, innermost last
_counters: Dict[str, int] = {}


class _Off:
    """The span of a tracer that is off: records nothing."""
    __slots__ = ()
    start = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set_arg(self, arg) -> None:
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("name", "rid", "arg", "index", "row", "start")

    def __init__(self, name: str, rid: int, arg):
        self.name, self.rid, self.arg = name, rid, arg

    def __enter__(self):
        self.index = len(_spans)
        self.start = time.time_ns()
        self.row = [self.name, self.start, 0, _open[-1] if _open else -1,
                    self.rid, self.arg]
        _spans.append(self.row)
        _open.append(self.index)
        return self

    def __exit__(self, *exc) -> bool:
        self.row[2] = time.time_ns()        # a drained row is no longer listed
        if _open and _open[-1] == self.index:
            _open.pop()
        return False

    def set_arg(self, arg) -> None:
        """Set the span's ``arg`` once its value is known inside it."""
        self.row[5] = arg


def enabled() -> bool:
    return _on


def enable() -> None:
    """Start recording (what was recorded before stays until drained)."""
    global _on
    _on = True


def disable() -> None:
    """Stop recording; spans already open still close."""
    global _on
    _on = False


def span(name: str, rid: int = -1, arg=-1):
    """A context manager timing its block as span ``name``."""
    return _Span(name, rid, arg) if _on else _OFF


def add(name: str, start_ns: int, end_ns: int, rid: int = -1, arg=-1) -> None:
    """Record a finished span with no parent, from stamps taken earlier
    (``time.time_ns()``)."""
    if _on:
        _spans.append([name, start_ns, end_ns, -1, rid, arg])


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``."""
    if _on:
        _counters[name] = _counters.get(name, 0) + n


def drain() -> Dict[str, object]:
    """The spans and counters recorded so far, then forgets them.  Call
    it outside every span: a span still open is returned with end 0."""
    spans: List[Tuple] = [tuple(s) for s in _spans]
    out = {"spans": spans, "counters": dict(_counters)}
    _spans.clear()
    _open.clear()
    _counters.clear()
    return out
