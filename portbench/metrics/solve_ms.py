"""``solve_ms``: the solver call's time per recording (init, the eager
first step, capture at a new length, the replays, the loss transfer and
``finalize``), from the traced run's synchronised span; the mean over the
window's recordings that the profiler did not slow."""


def read(run):
    stages = [r["stages"] for r in run.recordings if r["stages"] and not r["profiled"] and not r["failed"]]
    if not stages:
        return None
    return 1e3 * sum(s[1] for s in stages) / len(stages)
