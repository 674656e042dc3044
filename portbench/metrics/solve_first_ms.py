"""``solve_first_ms``: the solver call's time on the recordings whose frame
count the run meets for the first time (the solver captures its step at
that length), from the traced run's synchronised span; the mean over those
the profiler did not slow.  Nothing to read where every length was met
before."""


def read(run):
    first = [r["stages"][1] for r in run.recordings if r["stages"] and r["first_sight"] and not r["profiled"] and not r["failed"]]
    if not first:
        return None
    return 1e3 * sum(first) / len(first)
