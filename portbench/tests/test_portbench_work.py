"""The frozen work formula, pinned at the cells' shapes, and beside the
program's own count (which a later change to the program may move)."""

import pytest

from portbench.harness.peaks import PEAKS, least_seconds
from portbench.work import ip_step

H100 = PEAKS["NVIDIA H100 80GB HBM3"]


@pytest.mark.parametrize("F, T, n_bytes, seconds", [
    (1025, 939, 15_480_232, 4.621e-6),  # a 60 s song at fft 2048, hop 1024
    (2049, 469, 15_514_344, 4.631e-6),  # the shape of the kernel tables, fft 4096
])
def test_ip_step_at_a_song_shape(F, T, n_bytes, seconds):
    got_bytes, flops = ip_step.least_work(F, T)
    assert got_bytes == 2 * F * T * 8 + 2 * 4 * F * 8 + 2 * 2 * T * 4 + 2 * 4 == n_bytes
    assert flops == 64 * F * T
    # bound by the bytes on an H100
    assert got_bytes / H100["bytes_per_s"] > flops / H100["flops_per_s"]
    assert least_seconds(got_bytes, flops, H100) == pytest.approx(seconds, rel=1e-3)


@pytest.mark.parametrize("F", [1025, 2049])
def test_beside_the_program_count(F):
    from audio_source_separation_tpu_torch.ops.fused_ip import k2_cost

    for t in (17, 33, 189, 469, 939, 4688):
        # the same bytes as K2's charge; 64 FLOPs a bin and frame where
        # K2's charge counts 62
        b, f = ip_step.least_work(F, t)
        assert (b, f - 2 * F * t) == k2_cost(F, t, 8)
