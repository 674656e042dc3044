"""``cov_roofline_pct``: the program's weighted covariance with per-bin
weights (K1, ``csrc/weighted_covariance.cu``), one launch an iteration of
FastMNMF's diagonaliser update, against its least time on the card.

The least time of the profiled recordings' launches (the larger of the
least bytes of ``portbench/work/cov_step.py`` over the peak bandwidth and
its FLOPs over the float32 peak, at ``C = N = 2``, complex64 and float32),
over the summed device time of K1's kernel events.  Nothing to read unless
the trace holds ``iteration`` such events a profiled recording and their
count equals the program's ``k1_launches`` counter over the same
recordings, or where the card is not in the peak table.
"""

from portbench.harness import program_spans
from portbench.harness.peaks import least_seconds
from portbench.work.cov_step import least_work

# K1 of the program: csrc/weighted_covariance.cu
KERNELS = ("covariance_kernel",)
C = N = 2


def read(run):
    trace, peak = run.trace, run.peak
    if trace is None or peak is None or not trace.recordings:
        return None
    iteration, n = run.config["system"]["iteration"], len(trace.recordings)
    launches = program_spans.mean_count(run, "k1_launches")
    count, seconds = trace.kernels(KERNELS)
    if count != iteration * n or launches is None or launches * n != count or seconds <= 0:
        return None
    F = run.config["stft"]["fft_size"] // 2 + 1
    least = sum(iteration * least_seconds(*least_work(C, N, F, r["n_frames"]), peak) for r in trace.recordings)
    return 100.0 * least / seconds
