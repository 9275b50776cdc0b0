"""Host spans of the port's model step, recorded while a torch profiler is.

    from repro_torch.obs import host

    with host.step("prefill", batch, length):     # a Model entry point
        rec = host.on and host.open("norm")       # a part inside it
        h = block.ln1(x)
        if rec:
            host.close()
    host.spans()                                  # the newest session

A span is a named interval of the host's ``time.perf_counter`` clock: the
time the host spent issuing one part of a step (launches return before the
card runs them; no span waits on the card).  The device trace of a
profiled window is put on the same clock by its marker kernels
(``bench/trace.py``), so the spans say what the host was issuing while the
card sat idle.

Recording follows the profiler and nothing else: a root (``step``,
``init_cache``) reads ``torch.autograd.profiler._is_profiler_enabled``
once, records while it is on, and leaves what it found in ``on``.  An
inner site reads ``on`` and nothing else unless it is set, so with the
profiler off a site costs one flag read and no call; ``open`` records only
inside a recorded root on its own thread and says whether it did.  A root
that finds the profiler on when the root before it found it off starts a
new session and drops the old record, so the record is the newest
profiled window's (two profiled windows with no root between them share
one).  Parents come from a per-thread stack: two loops on two threads keep
two trees.  A root closes on its way out whatever an exception left open
inside it.  A ``step`` span's ``args`` are (entry, batch, length, serial),
the serial counting the steps of its thread in the session from 0; a
``block``'s are (layer index, kind); other spans have none.
"""
from __future__ import annotations

import threading
import time
from typing import NamedTuple

from torch.autograd import profiler as _profiler


class Span(NamedTuple):
    name: str
    start: float          # time.perf_counter seconds
    end: float | None     # None while the span is open
    parent: int | None    # index in spans() of the enclosing span
    thread: str
    args: tuple


# A C call that takes any arguments and returns "", which is false: as
# ``__enter__`` and ``__exit__`` it costs no Python frame, and an exception
# propagates through it.
_NOTHING = staticmethod("".format)


class _Off:
    """The context of a root that does not record."""

    __enter__ = __exit__ = _NOTHING


class _Thread(threading.local):
    """One thread's record in a session, its stack of open spans (indexes
    into the record) and of its open roots (stack depths), and its step
    count; as a context it is the innermost open root."""

    def __init__(self):
        self.session = None
        self.record = []
        self.stack = []
        self.roots = []
        self.serial = 0

    __enter__ = _NOTHING

    def __exit__(self, *exc):
        now = time.perf_counter()
        depth = self.roots.pop()
        while len(self.stack) > depth:
            self.record[self.stack.pop()][2] = now
        return False


_OFF = _Off()
_local = _Thread()
_lock = threading.Lock()
_sessions = [[]]   # the newest session last: (thread name, record) pairs
on = False         # what the last root found: the profiler on


def _push(t: _Thread, name: str, args: tuple):
    parent = t.stack[-1] if t.stack else None
    t.stack.append(len(t.record))
    t.record.append([name, time.perf_counter(), None, parent, args])


def _root(name: str, args: tuple) -> _Thread:
    global on
    with _lock:
        if not on:
            _sessions[:] = [[]]
            on = True
        session = _sessions[-1]
        t = _local
        if t.session is not session:
            t.session, t.record, t.serial = session, [], 0
            t.stack, t.roots = [], []
            session.append((threading.current_thread().name, t.record))
    if name == "step":
        args += (t.serial,)
        t.serial += 1
    t.roots.append(len(t.stack))
    _push(t, name, args)
    return t


def step(entry: str, batch: int, length: int):
    """The span of one call of a model entry point (``forward``,
    ``prefill``, ``decode``), as a context: from its entry to its return,
    every launch issued."""
    global on
    if not _profiler._is_profiler_enabled:
        on = False
        return _OFF
    return _root("step", (entry, batch, length))


def init_cache():
    """The span of ``Model.init_cache``, as a context."""
    global on
    if not _profiler._is_profiler_enabled:
        on = False
        return _OFF
    return _root("init_cache", ())


def open(name: str, *args) -> bool:
    """Open a span inside this thread's recorded root; False, and nothing
    opened, outside one.  Call it where ``on`` is set."""
    t = _local
    if not t.roots:
        return False
    _push(t, name, args)
    return True


def close():
    """Close this thread's innermost open span (one that ``open`` returned
    True for)."""
    t = _local
    t.record[t.stack.pop()][2] = time.perf_counter()


def spans() -> list[Span]:
    """The newest session's spans, thread by thread, each thread's in the
    order they opened."""
    out = []
    for thread, record in list(_sessions[-1]):
        base = len(out)
        out += [Span(n, a, b, None if p is None else base + p, thread, args)
                for n, a, b, p, args in list(record)]
    return out
