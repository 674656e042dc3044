"""``ip_step_roofline_pct``: one whole C = 2 AuxIVA-IP iteration
(``portbench/work/ip_step.py``) against its least time on the card.

The least time of the profiled recordings' iterations (the larger of the
least bytes over the peak bandwidth and the FLOPs over the float32 peak),
over the summed device time of the kernels named below.  Nothing to read
where the trace does not show one such kernel per iteration, or where the
card is not in the peak table.
"""

from portbench.harness.peaks import least_seconds
from portbench.work.ip_step import least_work

# K2 of the program: csrc/fused_auxiva_ip.cu
KERNELS = ("fused_ip_kernel",)


def read(run):
    trace, peak = run.trace, run.peak
    if trace is None or peak is None or not trace.recordings:
        return None
    iteration = run.config["system"]["iteration"]
    F = run.config["stft"]["fft_size"] // 2 + 1
    count, seconds = trace.kernels(KERNELS)
    if count != iteration * len(trace.recordings) or seconds <= 0:
        return None
    least = sum(iteration * least_seconds(*least_work(F, r["n_frames"]), peak) for r in trace.recordings)
    return 100.0 * least / seconds
