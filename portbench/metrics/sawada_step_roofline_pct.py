"""``sawada_step_roofline_pct``: Sawada's multichannel NMF solver call's
iterations against their least time on the card.

The least time of ``iteration`` iterations of each profiled recording (the
larger of the least bytes of ``portbench/work/sawada_step.py`` over the
peak bandwidth and its FLOPs over the float32 peak), over the time the card
was busy inside the program's ``solve`` spans of those recordings, on the
profiler's clock (the complement of :func:`portbench.harness.program_spans.solve_idle_ms`).
The eager init, the eager first step and the finalize lie in the busy time
too, so the share is a lower bound on the iterations'.  Nothing to read
where the program keeps no span log, off the steady captured loop, without
device activity, or where the card is not in the peak table.
"""

from portbench.harness import program_spans
from portbench.harness.peaks import least_seconds
from portbench.work.sawada_step import least_work


def read(run):
    peak = run.peak
    found = program_spans.window(run)
    if found is None or peak is None or not found.trace.device:
        return None
    busy = found.trace.busy_intervals()
    busy_ns = sum(program_spans._covered(s.start_ns, s.end_ns, busy) for s in found.named(program_spans.SOLVE))
    if busy_ns <= 0:
        return None
    config = run.config
    iteration, K = config["system"]["iteration"], config["system"]["kwargs"]["n_basis"]
    F = config["stft"]["fft_size"] // 2 + 1
    least = sum(iteration * least_seconds(*least_work(F, r["n_frames"], K), peak) for r in found.trace.recordings)
    return 100.0 * least / (busy_ns / 1e9)
