"""``frontend_ms``: the frontend's time per recording, from the traced
run's synchronised stage spans: the copy in and ``stft``, plus ``istft``
and the copy out; the mean over the window's recordings that the profiler
did not slow."""


def read(run):
    stages = [r["stages"] for r in run.recordings if r["stages"] and not r["profiled"] and not r["failed"]]
    if not stages:
        return None
    return 1e3 * sum(s[0] + s[2] for s in stages) / len(stages)
