"""Host spans and counters at the port's layer boundaries, in memory.

    from img_env_tpu_torch.utils import trace

    trace.enable()
    ...                                  # steps, acts, resets
    spans, counts = trace.drain()        # and clears
    trace.disable()

Off by default.  While off, ``span(name)`` returns one shared object that
does nothing and ``count`` returns at once, so a step pays a few no-op
context managers.  While on, each span appends ``(name, parent, start_ns,
end_ns)``: ``parent`` is the index in the same list of the span that was
open when it started (-1 for a top-level span, one call into the
program), and the times are ``time.time_ns()``, the system clock that
``torch.profiler``'s CUPTI timestamps share, so a device operation or an
idle gap can be matched to the host span it fell in.  A span never
synchronises the device: its time is the host's, the enqueue of what it
launches.  Nothing is written anywhere; whoever turned tracing on reads it
with ``drain()``.  ``self_ns`` gives each span's time less its children's.
Inside ``diverted()`` counts go to a dict of the caller's, tracing on or
off: a CUDA graph's capture records what each replay counts again
(``env/step_graph.py``).

The recorder is one per process and not thread-safe: the env, the
controller and the policy run on one host thread.
"""

from __future__ import annotations

import contextlib
import functools
import time


class _Off:
    """The span while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Recorder:
    def __init__(self):
        self.on = False
        self.spans = []         # [name, parent, start_ns, end_ns]
        self.open = []          # indices of the spans not yet closed
        self.counts = {}
        self.divert = None      # while set, counts go here (``diverted``)


_REC = _Recorder()


class _Span:
    __slots__ = ("name", "index")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        rec = _REC
        self.index = len(rec.spans)
        rec.spans.append([self.name, rec.open[-1] if rec.open else -1,
                          time.time_ns(), None])
        rec.open.append(self.index)
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        rec = _REC
        if rec.open and rec.open[-1] == self.index:
            rec.open.pop()
            rec.spans[self.index][3] = end
        return False


def enable() -> None:
    _REC.on = True


def disable() -> None:
    _REC.on = False


def enabled() -> bool:
    """Whether tracing is on."""
    return _REC.on


def span(name: str):
    """A context manager timing ``name`` on the host while tracing is on."""
    return _Span(name) if _REC.on else _OFF


def spanned(name: str):
    """Decorator: every call of the function is a span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _REC.on:
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to counter ``name`` while tracing is on."""
    rec = _REC
    if rec.divert is not None:
        rec.divert[name] = rec.divert.get(name, 0) + int(n)
    elif rec.on:
        rec.counts[name] = rec.counts.get(name, 0) + int(n)


@contextlib.contextmanager
def diverted():
    """Yields a dict that receives every count made inside the block,
    tracing on or off, in place of the recorder: what a CUDA graph's
    capture counts, which each replay then adds with ``count``."""
    rec = _REC
    saved, rec.divert = rec.divert, {}
    try:
        yield rec.divert
    finally:
        rec.divert = saved


def drain():
    """(spans, counts) recorded since the last drain, then clears them.
    spans: ``(name, parent, start_ns, end_ns)`` tuples in start order, the
    closed ones only (a parent index refers to this list); counts:
    {name: total}.  Call it between calls into the program."""
    rec = _REC
    keep = [i for i, s in enumerate(rec.spans) if s[3] is not None]
    where = {old: new for new, old in enumerate(keep)}
    spans = [(s[0], where.get(s[1], -1), s[2], s[3])
             for s in (rec.spans[i] for i in keep)]
    counts = dict(rec.counts)
    rec.spans, rec.open, rec.counts = [], [], {}
    return spans, counts


def self_ns(spans):
    """Each span's duration less the part its children cover (children
    of one span do not overlap: the program runs on one host thread)."""
    own = [e - s for _, _, s, e in spans]
    for _, parent, s, e in spans:
        if parent >= 0:
            own[parent] -= e - s
    return own
