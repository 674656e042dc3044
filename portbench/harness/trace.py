"""The traced run's device timeline, read from ``torch.profiler``'s events
in memory (no trace file is written).

Device activity is every event the profiler saw on the card (kernels,
copies, fills) but the card's mirror of the benchmark's annotations.  The
host's spans are the benchmark's own annotations
(``portbench.*``, :func:`torch.profiler.record_function`), on the same
clock.  The traced window runs from the start of the first profiled
recording to the end of the last.
"""

import torch

RECORDING = "portbench.recording"
PREFIX = "portbench."


def profiler():
    """A profiler over the CPU and the card, not yet started."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=activities)


def warm_up(device):
    """Start and stop a profiler over one small op, so that the profiler's
    own start (its CUDA tracing library) is paid in set-up."""
    with profiler():
        torch.ones(1, device=device).add_(1)
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def recording_span():
    """The annotation around one profiled recording."""
    return torch.profiler.record_function(RECORDING)


def _on_device(event):
    return "CUDA" in str(event.device_type())


class Trace:
    """The profiled recordings' device activity and host spans.

    ``device``: ``[(name, start_ns, end_ns)]`` of each kernel, copy and
    fill; ``spans``: ``[(name, start_ns, end_ns)]`` of the benchmark's
    annotations; ``recordings``: the profiled recordings' descriptions, in
    order.
    """

    def __init__(self, events, recordings):
        self.recordings = recordings
        self.device, self.spans = [], []
        for e in events:
            name, start = e.name(), e.start_ns()
            end = start + e.duration_ns()
            if name.startswith(PREFIX):
                if not _on_device(e):
                    self.spans.append((name, start, end))
            elif _on_device(e):
                self.device.append((name, start, end))
        self.device.sort(key=lambda d: d[1])
        windows = [(s, e) for n, s, e in self.spans if n == RECORDING]
        self.start = min(s for s, _ in windows) if windows else 0
        self.end = max(e for _, e in windows) if windows else 0

    @property
    def window_s(self):
        return (self.end - self.start) / 1e9

    def busy_intervals(self):
        """The union of the device's activity inside the window, merged."""
        merged = []
        for _, s, e in self.device:
            s, e = max(s, self.start), min(e, self.end)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self):
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def kernels(self, substrings):
        """``(count, seconds)`` of the device activities whose names hold
        one of ``substrings``, inside the window."""
        hits = [e - s for n, s, e in self.device if s >= self.start and e <= self.end and any(k in n for k in substrings)]
        return len(hits), sum(hits) / 1e9

    def _host_span(self, t):
        """The innermost benchmark span (other than the recording's own)
        that holds the instant ``t``."""
        best = None
        for name, s, e in self.spans:
            if name != RECORDING and s <= t <= e and (best is None or e - s < best[2] - best[1]):
                best = (name, s, e)
        return best[0][len(PREFIX) :] if best else "between recordings"

    def breakdown(self, top=10):
        """``{"device_ops": [[name, seconds]], "idle_gaps": [[host span,
        seconds]]}``: the device operations that took most time, and the
        longest idle gaps named by what the host was doing."""
        totals = {}
        for name, s, e in self.device:
            if s >= self.start and e <= self.end:
                totals[name] = totals.get(name, 0) + (e - s)
        ops = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
        busy = self.busy_intervals()
        edges = [self.start] + [t for iv in busy for t in iv] + [self.end]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2) if edges[i + 1] > edges[i]]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        return {
            "device_ops": [[name[:160], ns / 1e9] for name, ns in ops],
            "idle_gaps": [[self._host_span((s + e) // 2), (e - s) / 1e9] for s, e in gaps],
        }
