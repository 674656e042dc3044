"""The program's own spans in a traced run, read after the window.

The program keeps a log of spans at its layer boundaries while a profiler
records (``audio_source_separation_tpu_torch.runtime.profiling.spans``):
``(id, parent, name, start_ns, end_ns, attrs)``, stamped with
``time.time_ns()``, the clock of the profiler's events, so they share the
traced window (:class:`~portbench.harness.trace.Trace`) and its device
activity.  A top-level span (``stft``, ``solve``, ``istft``) holds in
``attrs`` the change of the program's counters over it: ``host_copies``,
``graph_captures``, ``graph_replays``, the kernels' ``k2_launches``, ...

There is nothing to read (``None``) where the program keeps no such log,
or where the window's spans do not hold one ``solve`` a profiled recording,
each with no capture and ``iteration - 1`` replays: the steady captured
loop that the readers describe.
"""

import importlib

PROGRAM = "audio_source_separation_tpu_torch.runtime.profiling"
SOLVE = "solve"
OUTSIDE = "outside the program"


def logged():
    """The program's logged spans, or ``None`` where it keeps no log."""
    try:
        profiling = importlib.import_module(PROGRAM)
    except ImportError:
        return None
    spans = getattr(profiling, "spans", None)
    return None if spans is None else list(spans())


def _ns(span):
    return span.end_ns - span.start_ns


class Spans:
    """The program's spans inside ``trace``'s window, and the number of
    profiled recordings they are shared by."""

    def __init__(self, trace, spans):
        self.trace = trace
        self.spans = [s for s in spans if s.start_ns >= trace.start and s.end_ns <= trace.end]
        self.n = len(trace.recordings)

    def named(self, name):
        return [s for s in self.spans if s.name == name]

    def children(self, parents, name):
        ids = {p.id for p in parents}
        return [s for s in self.spans if s.name == name and s.parent in ids]

    def top(self):
        return [s for s in self.spans if s.parent is None]


def window(run):
    """The program's spans of ``run``'s traced window (:class:`Spans`), or
    ``None`` (module docstring)."""
    trace = run.trace
    if trace is None or not trace.recordings:
        return None
    spans = logged()
    if spans is None:
        return None
    found = Spans(trace, spans)
    solves = found.named(SOLVE)
    if len(solves) != found.n:
        return None
    replays = run.config["system"]["iteration"] - 1
    for s in solves:
        attrs = s.attrs or {}
        if attrs.get("graph_captures", 0) > 0 or attrs.get("graph_replays") != replays:
            return None
    return found


def mean_ms(run, name, less=None):
    """The spans named ``name`` (less their children named ``less``), ms a
    profiled recording; ``None`` where there are none."""
    found = window(run)
    if found is None:
        return None
    spans = found.named(name)
    if not spans:
        return None
    total = sum(_ns(s) for s in spans)
    if less is not None:
        total -= sum(_ns(c) for c in found.children(spans, less))
    return total / found.n / 1e6


def mean_count(run, counter):
    """The counter ``counter`` summed over the top-level spans, a profiled
    recording; ``None`` where no top-level span holds it."""
    found = window(run)
    if found is None:
        return None
    values = [s.attrs[counter] for s in found.top() if s.attrs and counter in s.attrs]
    if not values:
        return None
    return float(sum(values)) / found.n


def _covered(start, end, busy):
    """Nanoseconds of ``[start, end]`` that the merged ``busy`` intervals
    cover."""
    return sum(max(0, min(e, end) - max(s, start)) for s, e in busy)


def solve_idle_ms(run):
    """Each ``solve`` span less the part of it in which the card was busy,
    ms a profiled recording; ``None`` without device activity."""
    found = window(run)
    if found is None or not found.trace.device:
        return None
    busy = found.trace.busy_intervals()
    idle = sum(_ns(s) - _covered(s.start_ns, s.end_ns, busy) for s in found.named(SOLVE))
    return idle / found.n / 1e6


def _innermost(spans, t):
    best = None
    for s in spans:
        if s.start_ns <= t < s.end_ns and (best is None or _ns(s) < _ns(best)):
            best = s
    return best


def idle_by_span(trace, spans):
    """``{name: seconds}``: the card's idle time in ``trace``'s window, each
    stretch charged to the innermost program span the host was in (or,
    outside the program, to ``"outside the program: <benchmark span>"``).
    ``spans`` are the program's logged spans."""
    inside = [s for s in spans if s.end_ns > trace.start and s.start_ns < trace.end]
    busy = trace.busy_intervals()
    edges = [trace.start] + [t for iv in busy for t in iv] + [trace.end]
    out = {}
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        cuts = sorted({a, b} | {t for s in inside for t in (s.start_ns, s.end_ns) if a < t < b})
        for lo, hi in zip(cuts, cuts[1:]):
            s = _innermost(inside, lo)
            name = s.name if s is not None else "{}: {}".format(OUTSIDE, trace._host_span((lo + hi) // 2))
            out[name] = out.get(name, 0.0) + (hi - lo) / 1e9
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))
