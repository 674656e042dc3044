"""``device_idle_pct``: the share of the profiled recordings' wall time in
which the card ran no kernel, copy or fill (the profiler's CUDA
activity)."""


def read(run):
    trace = run.trace
    if trace is None or trace.window_s <= 0 or not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
