"""The program's span log and counters.

A span marks one piece of the program's own work at a layer boundary:
``Span(id, parent, name, start_ns, end_ns, attrs)``, stamped with
``time.time_ns()``, the clock of ``torch.profiler``'s host events, so the
spans line up with the profiler's view of the card.  The log keeps the
last :data:`CAPACITY` spans in memory, and records only while a
``torch.profiler`` is recording: with none running, a span costs one read
of the profiler's enabled flag.  No span goes through the profiler's own
annotations, so none shows among its events, on the host or on the card.
:func:`~.profiling.trace` writes the spans of its block into its Chrome
trace.

The counters are plain integers, always on: ``graph_captures``,
``graph_cache_hits`` and ``graph_replays`` (:mod:`.graph`'s step graph,
once per call), ``edge_graph_captures`` and ``edge_graph_replays`` (its
init and finalize graphs, each capture and each replay: 2 replays a call
that captures its edges),
``host_copies`` and ``host_copy_bytes`` (the program's own transfer sites:
the host data that ``stft``/``istft`` take and their windows, a solver's
input, its drawn or warm-start state, the losses' one transfer back; on
the CPU the same sites count, so the counts are the card's).  The
kernels' ``launches`` are read through :func:`watch`.  A span opened with
no span open (a top-level span, such as ``stft`` or ``solve``) holds in
``attrs`` each counter's change over it.

The spans of a solver call nest ``solve`` > ``solve.init`` (>
``solve.state_copy_in`` around each copy of drawn or warm-start state from
the host), ``solve.eager_step`` (> ``solve.capture`` at a new signature),
``solve.replay``, ``solve.wait``, ``solve.finalize``; the eager loop has
``solve.steps`` in place of the first step and the replays.  Where a call
captures its edges (:class:`~.graph.EdgeRoute`), ``solve.init`` holds
``solve.capture_init`` and ``solve.finalize`` holds
``solve.capture_finalize`` at a new signature.  ``stft`` and
``istft`` hold ``stft.copy_in`` / ``istft.copy_in`` around each site that
can copy host data in.

This module imports nothing else of the package.
"""

import collections
import itertools
import threading
import time

import torch

# spans kept in memory; the oldest go first
CAPACITY = 65536

# whether a torch.profiler is recording: one call into the profiler's state
_recording = torch._C._autograd._profiler_enabled

Span = collections.namedtuple("Span", "id parent name start_ns end_ns attrs")

_log = collections.deque(maxlen=CAPACITY)
_ids = itertools.count(1)
_local = threading.local()

counters = {
    "graph_captures": 0, "graph_cache_hits": 0, "graph_replays": 0, "edge_graph_captures": 0, "edge_graph_replays": 0,
    "host_copies": 0, "host_copy_bytes": 0,
}
_probes = {}


def watch(name, read):
    """Report ``read()`` (a count that only grows, such as a kernel
    wrapper's ``launches``) as the counter ``name`` in top-level spans."""
    _probes[name] = read


def count_copy(nbytes):
    """One transfer of ``nbytes`` between the host and the device."""
    counters["host_copies"] += 1
    counters["host_copy_bytes"] += int(nbytes)


def _counts():
    values = dict(counters)
    for name, read in _probes.items():
        values[name] = read()
    return values


class _Open:
    __slots__ = ("id", "parent", "name", "start_ns", "before")

    def __init__(self, id, parent, name, before):
        self.id, self.parent, self.name, self.before = id, parent, name, before
        self.start_ns = time.time_ns()


def _stack():
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def begin(name):
    """Open a span; returns the token :func:`end` takes (``None`` when no
    profiler is recording)."""
    if not _recording():
        return None
    stack = _stack()
    parent = stack[-1].id if stack else None
    token = _Open(next(_ids), parent, name, None if stack else _counts())
    stack.append(token)
    return token


def end(token):
    """Close the span ``token`` opened and log it; a span still open inside
    it (whose end a raise skipped) is dropped."""
    if token is None:
        return
    end_ns = time.time_ns()
    stack = _stack()
    while stack and stack.pop() is not token:
        pass
    attrs = None
    if token.before is not None:
        attrs = {k: v - token.before.get(k, 0) for k, v in _counts().items()}
    _log.append(Span(token.id, token.parent, token.name, token.start_ns, end_ns, attrs))


class _Span:
    __slots__ = ("token",)

    def __init__(self, token):
        self.token = token

    def __enter__(self):
        return self.token

    def __exit__(self, *exc):
        end(self.token)
        return False


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name):
    """``with span(name):`` logs the block as a span while a profiler is
    recording, and does nothing else otherwise."""
    if not _recording():
        return _OFF
    return _Span(begin(name))


def spans(since_ns=None):
    """The logged spans, oldest first (each logged when it closes, so a
    child comes before its parent); with ``since_ns``, those that started
    at or after it."""
    if since_ns is None:
        return list(_log)
    return [s for s in _log if s.start_ns >= since_ns]


def clear():
    """Empty the log."""
    _log.clear()
