"""``k3_roofline_pct``: the program's batched Hermitian eigensolver (K3,
``csrc/batched_eigh.cu``), three launches an iteration of Sawada's
spatial update, against its least time on the card.

Each launch takes the ``F S`` spatial matrices of order ``C`` at complex64
with the eigenvectors; its least time is the larger of the least bytes of
``portbench/work/eigh_step.py`` over the peak bandwidth and its FLOPs over
the float32 peak.  The share is the least time of the events' launches
over their summed device time.  The profiler can drop activities from a
long trace, so the share is read over the events the trace holds; nothing
to read where it holds none, or more than the program's ``k3_launches``
counter over the same recordings, or where the card is not in the peak
table.
"""

from portbench.harness import program_spans
from portbench.harness.peaks import least_seconds
from portbench.work.eigh_step import least_work

# K3 of the program: csrc/batched_eigh.cu
KERNELS = ("eigh_kernel",)


def read(run):
    trace, peak = run.trace, run.peak
    if trace is None or peak is None or not trace.recordings:
        return None
    launches = program_spans.mean_count(run, "k3_launches")
    count, seconds = trace.kernels(KERNELS)
    n = len(trace.recordings)
    if launches is None or count == 0 or count > launches * n or seconds <= 0:
        return None
    C, S = run.config["n_mics"], run.config["n_sources"]
    F = run.config["stft"]["fft_size"] // 2 + 1
    return 100.0 * count * least_seconds(*least_work(C, F * S), peak) / seconds
