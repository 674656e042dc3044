#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--profile]

Phases (each asserts; any failure exits non-zero):
  1. the card's name and power limit; build both CUDA kernels from
     ``audio_source_separation_tpu_torch/csrc`` with nvcc (one process per
     source, in parallel) and print the build time;
  2. kernels: K1 (weighted covariance) at C in {2, 3, 4} x 2049 x 469, at
     C = 4 x 65 x 16,384 and at C = 3 x 513 x 7501 (both with the frame
     axis split across blocks), and K2 (fused C = 2 AuxIVA-IP iteration,
     one launch) at 2 x 2049 x 469 and at 2 x 257 x 9000 (the frame axis
     streamed), each held against its plain PyTorch version on the same
     inputs and bit-identical across two launches; median times of 25
     launches by CUDA events, K1 also with L2 flushed before each launch,
     and K1's launch plan;
  3. main path, C = 2: a 60 s, 16 kHz stereo convolutive mixture ->
     stft(4096, 2048) -> AuxLaplaceIVA(IP) x 100 -> projection-back -> istft
     on the card; K2 once per iteration, loss finite and non-increasing,
     SI-SDR up by more than 5 dB, the first 20 losses against the port's
     own CPU float64 run;
  4. main path, C = 2, long: a 120 s mixture at stft(1024, 256), 2 x 513 x
     7501 (past the 6144 frames that once capped K2), 20 iterations, K2 once
     per iteration, loss non-increasing, SI-SDR up by more than 5 dB;
  5. main path, C = 3: 3 mics, 3 sources, 20 iterations through K1;
  6. the rest of the IVA family through the entry points, on the mixtures
     of phases 3 and 5: AuxGaussIVA(IP) at C = 2 x 100 (K2's Gauss
     instance once per iteration, SI-SDR up by more than 5 dB, the first 20
     losses against the CPU float64 run, ms per iteration); AuxLaplaceIVA
     ISS and IP2 at C = 2 x 50 (the same checks; IP2 through K1 every
     iteration); AuxLaplaceIVA IP2 and AuxGaussIVA(IP) at C = 3 x 20
     through K1; NaturalGradLaplaceIVA and GradLaplaceIVA at C = 2 x 20
     (finite losses, the last below the first); OverAuxLaplaceIVA, 4 mics
     -> 2 sources x 20 (finite output of shape (2, F, T)) and 4 mics -> 1
     source x 20 (K1 at C = N = 1); AuxLaplaceIVA(IP) at C = 5 x 10, the
     matrix path, through K1's generic instance every iteration; then
     C = 3 on a 120 s recording at stft(1024, 256), 3 x 513 x 7501, 20
     iterations, K1 (frame axis split) once per iteration, loss
     non-increasing, SI-SDR up by more than 5 dB;
  7. ILRMA through the entry points, K1 with per-bin (N, F, T) weights: on
     phase 3's mixture GaussILRMA(n_basis=10) IP x 50 (K1 once per
     iteration, the loss falls, SI-SDR up by more than 5 dB -- else
     n_basis=2 is held to that bar --, the first 20 losses against the CPU
     float64 run from the same seed-111 init, ms per iteration); then 20
     iterations each of IP2 (one K1 launch for the pair), ISS (no kernel),
     projection-back normalisation, partitioning, TILRMA(nu=1000) and
     ConsistentGaussILRMA(4096, 2048), each with falling finite losses and
     its launch count asserted; TILRMA(nu=1) x 150 at float32 (finite);
     and on phase 5's mixture GaussILRMA(n_basis=4) IP x 20 at C = 3;
  8. one ``{"kernels": [...]}`` line (K2 once per contrast), then the last
     line ``{"ok": true, "device": {...}}``.

Phase 2 also holds K2's Gauss instance at both shapes, K1 at C = 3 with
N = 2 weight rows (IP2's pair covariances), K1's generic instance at
C = N = 5, K1 at C = N = 1, and K1 with per-bin (N, F, T) weights at
2 x 2049 x 469 (N = 2), 3 x 2049 x 469 (N = 3 and IP2's N = 2),
5 x 2049 x 469 (generic), 2 x 513 x 7501 (split) and 3 x 129 x 7001 (odd
F T).

``--profile`` also writes a torch.profiler table of 20 C = 2 iterations to
``chiprun_out/profile_c2.txt``.  Exits non-zero without printing a result
when CUDA is not available.
"""

import argparse
import itertools
import json
import math
import re
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

from audio_source_separation_tpu_torch import (
    TILRMA,
    AuxGaussIVA,
    AuxLaplaceIVA,
    ConsistentGaussILRMA,
    GaussILRMA,
    GradLaplaceIVA,
    NaturalGradLaplaceIVA,
    OverAuxLaplaceIVA,
    istft,
    stft,
)
from audio_source_separation_tpu_torch.ops import _build
from audio_source_separation_tpu_torch.ops.cov_kernel import (
    k1_launch_plan,
    weighted_covariance_planes,
    weighted_covariance_planes_plain,
)
from audio_source_separation_tpu_torch.ops.fused_ip import (
    fused_auxiva_ip_iter,
    fused_auxiva_ip_iter_plain,
    k2_launch_plan,
)
from audio_source_separation_tpu_torch.ops.ip_components import (
    _covariance_planes,
    pair_products_planes,
    separate_components,
)
from audio_source_separation_tpu_torch.tools.timing import l2_flusher, median_ms

SEED = 111
SR = 16000
N_SAMPLES = 958_464  # ~60 s at 16 kHz -> 2049 bins x 469 frames
FFT_SIZE, HOP_SIZE = 4096, 2048
N_SAMPLES_LONG = 1_920_000  # 120 s at 16 kHz -> 513 bins x 7501 frames
FFT_SIZE_LONG, HOP_SIZE_LONG = 1024, 256
ITERS_C2, ITERS_C2_LONG, ITERS_C3, N_MATCH = 100, 20, 20, 20
ITERS_ISS_IP2, ITERS_SHORT, ITERS_C5 = 50, 20, 10
ITERS_ILRMA, ITERS_T_NU1 = 50, 150
EPS, THRESHOLD = 1e-12, 1e12
# published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, f32 non-tensor
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# tolerances, float32 kernel against float32 plain version on the same inputs
K1_RTOL = 1e-4  # max |err| / max |plain|
K2_RTOL = 1e-4  # the same, for W, psum and the NLL
K2_GAUSS_RTOL = 1e-5  # the Gauss instance's W and psum (its NLL: K2_RTOL)
LOSS_MONOTONE_RTOL = 1e-5  # f32 loss may rise by rounding noise only
LOSS_MATCH_RTOL = 1e-4  # card f32 vs CPU f64, first 20 losses
ROOT = Path(__file__).resolve().parent


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def synth_mixture(rng, n_sources, n_samples, taps=8, n_mics=None):
    """Amplitude-modulated noise sources through short random FIRs (the
    recipe of tests/conftest.py::synth_convolutive_mixture) at ``n_mics``
    microphones (default one per source); returns the mixture and each
    source's image at mic 0."""
    t = np.arange(n_samples) / SR
    mods = [3.0, 5.0, 7.0, 11.0, 13.0]
    sources = []
    for n in range(n_sources):
        env = 0.5 * (1 + np.sign(np.sin(2 * np.pi * mods[n] * t + 0.7 * n)))
        env = np.convolve(env, np.ones(64) / 64, mode="same")
        sources.append(env * rng.randn(n_samples))
    mixture = np.zeros((n_mics or n_sources, n_samples))
    images = np.zeros((n_sources, n_samples))
    for m in range(n_mics or n_sources):
        for n in range(n_sources):
            h = 0.2 * rng.randn(taps) * np.exp(-0.7 * np.arange(taps))
            h[(3 * m + 5 * n) % taps] += 1.0 if m == n else 0.8
            contribution = np.convolve(sources[n], h)[:n_samples]
            mixture[m] += contribution
            if m == 0:
                images[n] = contribution
    return mixture, images


def si_sdr(estimate, target):
    alpha = np.sum(estimate * target) / np.sum(target**2)
    projection = alpha * target
    noise = estimate - projection
    return 10 * np.log10(np.sum(projection**2) / np.sum(noise**2))


def best_pairing_si_sdr(estimates, targets):
    n = len(targets)
    table = [[si_sdr(estimates[i], targets[j]) for j in range(n)] for i in range(n)]
    return max(np.mean([table[i][p[i]] for i in range(n)]) for p in itertools.permutations(range(n)))


def bound(n_bytes, n_flops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_err(a, b):
    return float((a - b).abs().max() / b.abs().max())


# --------------------------------------------------------------------------- #
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------- #
def random_mixture(gen, C, F, T):
    env = torch.rand((C, 1, T), generator=gen, device="cuda") + 0.05
    re = torch.randn((C, F, T), generator=gen, device="cuda") * env
    im = torch.randn((C, F, T), generator=gen, device="cuda") * env
    return torch.complex(re, im).contiguous()


def k1_case(gen, C, F, T, N=None, per_bin=False):
    """K1 against its plain version, bit-identical across two launches;
    median times warm (X in L2 where it fits) and cold (L2 flushed before
    each call) of the kernel, the plain version and one ``torch.matmul``
    over precomputed planes (for per-bin weights ``(F, C^2, T) x (F, T,
    N)``)."""
    X = random_mixture(gen, C, F, T)
    # 1/R-like weights spanning three decades, N = C rows unless given;
    # (N, F, T) with per_bin, as ILRMA's
    shape = (N or C, F, T) if per_bin else (N or C, T)
    w = (10.0 ** (3 * torch.rand(shape, generator=gen, device="cuda") - 1.5)).contiguous()
    out = weighted_covariance_planes(X, w)
    again = weighted_covariance_planes(X, w)
    ref = weighted_covariance_planes_plain(X, w)
    torch.cuda.synchronize()
    plan = k1_launch_plan(C, w.shape[0], F, T, per_bin)
    assert torch.equal(out, again), ("K1 not bit-identical across launches", C, F, T, plan)
    err = rel_err(out, ref)
    assert math.isfinite(err) and err <= K1_RTOL, ("K1", C, F, T, per_bin, err)
    planes = pair_products_planes(X).contiguous()
    if per_bin:
        library = lambda: torch.matmul(planes.permute(1, 0, 2), w.permute(1, 2, 0))  # noqa: E731
    else:
        library = lambda: _covariance_planes(planes, w)  # noqa: E731
    flush = l2_flusher()
    times = {}
    for prefix, fn in [
        ("", lambda: weighted_covariance_planes(X, w)),
        ("plain_", lambda: weighted_covariance_planes_plain(X, w)),
        ("library_", library),  # one torch.matmul
    ]:
        times[prefix + "ms"] = median_ms(fn)
        times[prefix + "cold_ms"] = median_ms(fn, before=flush)
    n_bytes = X.numel() * 8 + w.numel() * 4 + out.numel() * 4
    n_flops = F * T * (3 * C * C + 2 * C * C * w.shape[0])  # pair products + contraction
    bound_ms, bound_by = bound(n_bytes, n_flops)
    return {
        "C": C, "N": w.shape[0], "F": F, "T": T, "per_bin": per_bin, "plan": plan._asdict(),
        "max_abs_err": float((out - ref).abs().max()), "rel_err": err, **times,
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def k2_case(gen, F, T, contrast="laplace"):
    X = random_mixture(gen, 2, F, T)
    zero_bin = F // 2
    X[:, zero_bin] = 0
    noise = torch.complex(
        torch.randn((2, 2, F), generator=gen, device="cuda"),
        torch.randn((2, 2, F), generator=gen, device="cuda"),
    )
    eye = torch.eye(2, dtype=torch.complex64, device="cuda")[:, :, None]
    W = (eye + 0.3 * noise).contiguous()
    W[:, :, zero_bin] = eye[:, :, 0]
    psum = torch.sum(
        torch.abs(separate_components([[W[s, c] for c in range(2)] for s in range(2)], X)) ** 2, dim=1
    ).contiguous()

    kw = {"eps": EPS, "threshold": THRESHOLD, "contrast": contrast}
    out = fused_auxiva_ip_iter(X, W, psum, **kw)
    again = fused_auxiva_ip_iter(X, W, psum, **kw)
    ref = fused_auxiva_ip_iter_plain(X, W, psum, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, again)), ("K2 not bit-identical across launches", contrast)
    assert torch.equal(out[0][:, :, zero_bin], W[:, :, zero_bin]), ("K2 changed an all-zero bin", contrast)
    w_err = rel_err(out[0], ref[0])
    p_err = rel_err(out[1], ref[1])
    nll_err = abs(float(out[3]) - float(ref[3])) / abs(float(ref[3]))
    rtol = K2_GAUSS_RTOL if contrast == "gauss" else K2_RTOL
    assert max(w_err, p_err) <= rtol and nll_err <= K2_RTOL, ("K2", contrast, w_err, p_err, nll_err)
    ms = median_ms(lambda: fused_auxiva_ip_iter(X, W, psum, **kw))
    plain_ms = median_ms(lambda: fused_auxiva_ip_iter_plain(X, W, psum, **kw))
    n_bytes = X.numel() * 8 + 2 * W.numel() * 8 + 2 * psum.numel() * 4 + 8
    n_flops = F * T * 62  # covariance (26) + separation power sums (36) per (f, t)
    bound_ms, bound_by = bound(n_bytes, n_flops)
    return {
        "F": F, "T": T, "contrast": contrast, "plan": k2_launch_plan(F, T)._asdict(),
        "max_abs_err": float(max((out[0] - ref[0]).abs().max(), (out[1] - ref[1]).abs().max())),
        "rel_err": {"W": w_err, "psum": p_err, "nll": nll_err},
        "ms": ms, "plain_ms": plain_ms, "library_ms": None,
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


# --------------------------------------------------------------------------- #
# phases 3-4: the main path
# --------------------------------------------------------------------------- #
def check_losses(loss, name):
    loss = np.asarray(loss)
    assert np.isfinite(loss).all(), (name, "non-finite loss")
    rises = np.diff(loss) - LOSS_MONOTONE_RTOL * np.abs(loss[:-1])
    assert (rises <= 0).all(), (name, "loss rose", float(rises.max()))


def per_iteration(X, record, make=AuxLaplaceIVA, n=100):
    """Per-iteration times of the solver loop of ``make(recordable_loss=)``:
    ``ms`` by CUDA events, differencing (10 + n)- and 10-iteration calls
    (init and finalize cancel), and ``host_ms``, the host's time to enqueue
    one iteration (``update_state`` and, when recording, ``nll``) without
    waiting for the device."""
    solver = make(recordable_loss=record)

    def run(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        solver(X, iteration=n)
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    run(10)
    short = min(run(10) for _ in range(3))
    long_ = min(run(10 + n) for _ in range(3))
    state = solver.init_state(X.contiguous(), **solver.prepare_state_kwargs(X, {}))
    losses = []
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(n):
        state = solver.update_state(state)
        if record:
            losses.append(solver.nll(state))
    host_ms = (time.perf_counter() - start) * 1e3 / n
    torch.cuda.synchronize()
    return {"ms": (long_ - short) / n, "host_ms": host_ms}


def main_path_c2(rng):
    mixture, images = synth_mixture(rng, 2, N_SAMPLES)
    fused_auxiva_ip_iter.launches = 0
    weighted_covariance_planes.launches = 0
    torch.cuda.synchronize()
    start = time.perf_counter()
    X = stft(mixture.astype(np.float32), fft_size=FFT_SIZE, hop_size=HOP_SIZE)
    solver = AuxLaplaceIVA(algorithm_spatial="IP")
    Y = solver(X, iteration=ITERS_C2)
    y = istft(Y, fft_size=FFT_SIZE, hop_size=HOP_SIZE, length=N_SAMPLES)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - start
    k2_launches = fused_auxiva_ip_iter.launches
    k1_launches = weighted_covariance_planes.launches

    assert tuple(X.shape) == (2, FFT_SIZE // 2 + 1, -(-N_SAMPLES // HOP_SIZE) + 1), X.shape
    assert k2_launches == ITERS_C2, ("K2 launches", k2_launches)
    assert k1_launches == 0, ("K1 launches on the C = 2 path", k1_launches)
    check_losses(solver.loss, "C=2")
    y = y.cpu().numpy()
    assert np.isfinite(y).all() and y.shape == mixture.shape
    before = best_pairing_si_sdr(mixture, images)
    after = best_pairing_si_sdr(y, images)
    assert after > before + 5.0, ("SI-SDR", before, after)

    X_cpu = stft(mixture, fft_size=FFT_SIZE, hop_size=HOP_SIZE, device="cpu")
    reference = AuxLaplaceIVA(device="cpu")
    reference(X_cpu, iteration=N_MATCH - 1)
    match = np.max(np.abs(np.asarray(solver.loss[:N_MATCH]) - reference.loss) / np.abs(reference.loss))
    assert match <= LOSS_MATCH_RTOL, ("loss vs CPU float64", match)

    return X, (mixture, images), {
        "iterations": ITERS_C2, "k2_launches": k2_launches, "wall_s": wall_s,
        "loss_first": solver.loss[0], "loss_last": solver.loss[-1],
        "si_sdr_before_db": before, "si_sdr_after_db": after,
        "loss_vs_cpu_f64_max_rel": float(match),
        "per_iter_loss_on": per_iteration(X, True),
        "per_iter_loss_off": per_iteration(X, False),
    }


def main_path_c2_long(rng):
    """C = 2 through the entry points at T > 6144 frames."""
    mixture, images = synth_mixture(rng, 2, N_SAMPLES_LONG)
    fused_auxiva_ip_iter.launches = 0
    weighted_covariance_planes.launches = 0
    torch.cuda.synchronize()
    start = time.perf_counter()
    X = stft(mixture.astype(np.float32), fft_size=FFT_SIZE_LONG, hop_size=HOP_SIZE_LONG)
    solver = AuxLaplaceIVA(algorithm_spatial="IP")
    Y = solver(X, iteration=ITERS_C2_LONG)
    y = istft(Y, fft_size=FFT_SIZE_LONG, hop_size=HOP_SIZE_LONG, length=N_SAMPLES_LONG)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - start
    k2_launches = fused_auxiva_ip_iter.launches
    k1_launches = weighted_covariance_planes.launches

    F, T = X.shape[1], X.shape[2]
    assert (F, T) == (FFT_SIZE_LONG // 2 + 1, N_SAMPLES_LONG // HOP_SIZE_LONG + 1) and T > 6144, X.shape
    assert k2_launches == ITERS_C2_LONG, ("K2 launches", k2_launches)
    assert k1_launches == 0, ("K1 launches on the C = 2 path", k1_launches)
    check_losses(solver.loss, "C=2 long")
    y = y.cpu().numpy()
    assert np.isfinite(y).all() and y.shape == mixture.shape
    before = best_pairing_si_sdr(mixture, images)
    after = best_pairing_si_sdr(y, images)
    assert after > before + 5.0, ("SI-SDR", before, after)
    return {
        "shape": [2, F, T], "plan": k2_launch_plan(F, T)._asdict(),
        "iterations": ITERS_C2_LONG, "k2_launches": k2_launches, "wall_s": wall_s,
        "loss_first": solver.loss[0], "loss_last": solver.loss[-1],
        "si_sdr_before_db": before, "si_sdr_after_db": after,
    }


def main_path_c3_long(rng):
    """C = 3 through the entry points on a 120 s recording: 3 x 513 x 7501,
    where K1 splits the frame axis across blocks."""
    mixture, images = synth_mixture(rng, 3, N_SAMPLES_LONG)
    fused_auxiva_ip_iter.launches = 0
    weighted_covariance_planes.launches = 0
    torch.cuda.synchronize()
    start = time.perf_counter()
    X = stft(mixture.astype(np.float32), fft_size=FFT_SIZE_LONG, hop_size=HOP_SIZE_LONG)
    solver = AuxLaplaceIVA(algorithm_spatial="IP")
    Y = solver(X, iteration=ITERS_C3)
    y = istft(Y, fft_size=FFT_SIZE_LONG, hop_size=HOP_SIZE_LONG, length=N_SAMPLES_LONG)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - start
    k1_launches = weighted_covariance_planes.launches
    k2_launches = fused_auxiva_ip_iter.launches

    C, F, T = X.shape
    plan = k1_launch_plan(C, C, F, T)
    assert (C, F, T) == (3, FFT_SIZE_LONG // 2 + 1, N_SAMPLES_LONG // HOP_SIZE_LONG + 1), X.shape
    assert plan.splits > 1, plan
    assert k1_launches == ITERS_C3 and k2_launches == 0, ("launches", k1_launches, k2_launches)
    check_losses(solver.loss, "C=3 long")
    y = y.cpu().numpy()
    assert np.isfinite(y).all() and y.shape == mixture.shape
    before = best_pairing_si_sdr(mixture, images)
    after = best_pairing_si_sdr(y, images)
    assert after > before + 5.0, ("SI-SDR", before, after)
    return {
        "shape": [C, F, T], "plan": plan._asdict(),
        "iterations": ITERS_C3, "k1_launches": k1_launches, "wall_s": wall_s,
        "loss_first": solver.loss[0], "loss_last": solver.loss[-1],
        "si_sdr_before_db": before, "si_sdr_after_db": after,
        "per_iter_loss_off": per_iteration(X, False, AuxLaplaceIVA, ITERS_C3),
    }


def main_path_c3(rng):
    mixture, images = synth_mixture(rng, 3, N_SAMPLES)
    fused_auxiva_ip_iter.launches = 0
    weighted_covariance_planes.launches = 0
    X = stft(mixture.astype(np.float32), fft_size=FFT_SIZE, hop_size=HOP_SIZE)
    solver = AuxLaplaceIVA(algorithm_spatial="IP")
    Y = solver(X, iteration=ITERS_C3)
    y = istft(Y, fft_size=FFT_SIZE, hop_size=HOP_SIZE, length=N_SAMPLES)
    torch.cuda.synchronize()
    k1_launches = weighted_covariance_planes.launches
    k2_launches = fused_auxiva_ip_iter.launches

    assert k1_launches >= ITERS_C3, ("K1 launches", k1_launches)
    assert k2_launches == 0, ("K2 launches on the C = 3 path", k2_launches)
    check_losses(solver.loss, "C=3")
    y = y.cpu().numpy()
    assert np.isfinite(y).all() and y.shape == mixture.shape
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    AuxLaplaceIVA(recordable_loss=False)(X, iteration=ITERS_C3)
    end.record()
    end.synchronize()
    return (mixture, images), {
        "iterations": ITERS_C3, "k1_launches": k1_launches,
        "loss_first": solver.loss[0], "loss_last": solver.loss[-1],
        "si_sdr_before_db": best_pairing_si_sdr(mixture, images),
        "si_sdr_after_db": best_pairing_si_sdr(y, images),
        "ms_per_call_20_iters": start.elapsed_time(end),
    }


# --------------------------------------------------------------------------- #
# phase 6: the rest of the IVA family
# --------------------------------------------------------------------------- #
def drive(make, mixture, iterations):
    """``stft -> make() -> istft`` on the card, with both kernels' counts set
    to 0 just before and read just after."""
    fused_auxiva_ip_iter.launches = 0
    weighted_covariance_planes.launches = 0
    torch.cuda.synchronize()
    start = time.perf_counter()
    X = stft(mixture.astype(np.float32), fft_size=FFT_SIZE, hop_size=HOP_SIZE)
    solver = make()
    Y = solver(X, iteration=iterations)
    y = istft(Y, fft_size=FFT_SIZE, hop_size=HOP_SIZE, length=mixture.shape[-1])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - start
    y = y.cpu().numpy()
    loss = np.asarray(solver.loss)
    assert np.isfinite(loss).all() and np.isfinite(y).all(), "non-finite loss or output"
    return X, Y, y, loss, {
        "iterations": iterations, "wall_s": wall_s,
        "k1_launches": weighted_covariance_planes.launches, "k2_launches": fused_auxiva_ip_iter.launches,
        "loss_first": float(loss[0]), "loss_last": float(loss[-1]),
    }


def loss_vs_cpu_f64(name, make_cpu, mixture, losses):
    """Max relative gap of the first ``N_MATCH`` losses to the port's own
    CPU float64 run from the same mixture, and the iteration where it is."""
    X_cpu = stft(mixture, fft_size=FFT_SIZE, hop_size=HOP_SIZE, device="cpu")
    reference = make_cpu()
    reference(X_cpu, iteration=N_MATCH - 1)
    gap = np.abs(np.asarray(losses[:N_MATCH]) - reference.loss) / np.abs(reference.loss)
    assert gap.max() <= LOSS_MATCH_RTOL, (name, "loss vs CPU float64", gap.max(), int(gap.argmax()))
    return float(gap.max())


def family_c2(mixture, images):
    """AuxGaussIVA(IP) x 100 and AuxLaplaceIVA ISS and IP2 x 50 (loss
    non-increasing, SI-SDR up by more than 5 dB, the first 20 losses against
    the CPU float64 run, ms per iteration), then the two gradient solvers
    x 20, on the C = 2 main path's mixture."""
    before = best_pairing_si_sdr(mixture, images)
    out = {}
    for key, cls, kw, iterations, timing_n in [
        ("gauss_ip", AuxGaussIVA, {}, ITERS_C2, 100),
        ("laplace_iss", AuxLaplaceIVA, {"algorithm_spatial": "ISS"}, ITERS_ISS_IP2, ITERS_SHORT),
        ("laplace_ip2", AuxLaplaceIVA, {"algorithm_spatial": "IP2"}, ITERS_ISS_IP2, ITERS_SHORT),
    ]:
        X, _, y, loss, res = drive(lambda: cls(**kw), mixture, iterations)
        if key == "gauss_ip":
            assert res["k2_launches"] == iterations and res["k1_launches"] == 0, (key, res)
        elif key == "laplace_ip2":
            assert res["k1_launches"] >= iterations and res["k2_launches"] == 0, (key, res)
        check_losses(loss, key)
        res["si_sdr_before_db"], res["si_sdr_after_db"] = before, best_pairing_si_sdr(y, images)
        assert res["si_sdr_after_db"] > before + 5.0, (key, "SI-SDR", res)
        res["loss_vs_cpu_f64_max_rel"] = loss_vs_cpu_f64(key, lambda: cls(device="cpu", **kw), mixture, loss)
        make = lambda recordable_loss: cls(recordable_loss=recordable_loss, **kw)  # noqa: E731
        res["per_iter_loss_on"] = per_iteration(X, True, make, timing_n)
        res["per_iter_loss_off"] = per_iteration(X, False, make, timing_n)
        out[key] = res
    for key, cls in [("natural_grad", NaturalGradLaplaceIVA), ("grad", GradLaplaceIVA)]:
        X, _, y, _, res = drive(cls, mixture, ITERS_SHORT)
        assert res["loss_last"] < res["loss_first"], (key, res)
        res["si_sdr_before_db"], res["si_sdr_after_db"] = before, best_pairing_si_sdr(y, images)
        res["per_iter_loss_off"] = per_iteration(X, False, cls, ITERS_SHORT)
        out[key] = res
    return out


def family_c3(mixture, images):
    """AuxLaplaceIVA IP2 and AuxGaussIVA(IP) x 20 at C = 3, through K1."""
    out = {}
    for key, cls, kw in [("laplace_ip2", AuxLaplaceIVA, {"algorithm_spatial": "IP2"}), ("gauss_ip", AuxGaussIVA, {})]:
        X, _, y, _, res = drive(lambda: cls(**kw), mixture, ITERS_SHORT)
        assert res["k1_launches"] >= ITERS_SHORT and res["k2_launches"] == 0, (key, res)
        res["si_sdr_before_db"] = best_pairing_si_sdr(mixture, images)
        res["si_sdr_after_db"] = best_pairing_si_sdr(y, images)
        res["per_iter_loss_off"] = per_iteration(X, False, lambda recordable_loss: cls(recordable_loss=recordable_loss, **kw), ITERS_SHORT)
        out[key] = res
    return out


def overdetermined(rng):
    """OverAuxLaplaceIVA, 4 mics -> 2 sources x 20 (PCA, then K2 at C = 2)
    and 4 mics -> 1 source x 20 (PCA, then K1 at C = N = 1)."""
    mixture, images = synth_mixture(rng, 2, N_SAMPLES, n_mics=4)
    X, Y, y, _, res = drive(lambda: OverAuxLaplaceIVA("IP", n_sources=2), mixture, ITERS_SHORT)
    assert tuple(Y.shape) == (2,) + tuple(X.shape[1:]) and torch.isfinite(Y).all(), Y.shape
    assert res["k2_launches"] == ITERS_SHORT, res
    res["shape_in"], res["shape_out"] = list(X.shape), list(Y.shape)
    res["si_sdr_before_db"] = best_pairing_si_sdr(mixture[:2], images)
    res["si_sdr_after_db"] = best_pairing_si_sdr(y, images)
    X, Y, _, _, one = drive(lambda: OverAuxLaplaceIVA("IP", n_sources=1), mixture, ITERS_SHORT)
    assert tuple(Y.shape) == (1,) + tuple(X.shape[1:]) and torch.isfinite(Y).all(), Y.shape
    assert one["k1_launches"] == ITERS_SHORT and one["k2_launches"] == 0, one
    return res, one


def five_channels(rng):
    """AuxLaplaceIVA(IP) at C = 5 x 10: the matrix path, K1's generic instance
    once per iteration; the loss falls, its rises are recorded."""
    mixture, images = synth_mixture(rng, 5, N_SAMPLES)
    X, Y, y, loss, res = drive(AuxLaplaceIVA, mixture, ITERS_C5)
    assert res["k1_launches"] == ITERS_C5 and res["k2_launches"] == 0, res
    assert tuple(Y.shape) == tuple(X.shape) and res["loss_last"] < res["loss_first"], res
    res["max_rise_rel"] = float(np.max(np.diff(loss) / np.abs(loss[:-1])))
    res["si_sdr_before_db"] = best_pairing_si_sdr(mixture, images)
    res["si_sdr_after_db"] = best_pairing_si_sdr(y, images)
    res["per_iter_loss_off"] = per_iteration(X, False, AuxLaplaceIVA, ITERS_C5)
    return res


# --------------------------------------------------------------------------- #
# phase 7: ILRMA, K1 with per-bin weights
# --------------------------------------------------------------------------- #
def ilrma_drive(make, mixture, iterations):
    """:func:`drive` from the seed-111 init (``np.random``, as the JAX
    package draws it); ISS's "in progress" warning silenced."""
    np.random.seed(SEED)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return drive(make, mixture, iterations)


def ilrma_c2(mixture, images):
    """GaussILRMA(n_basis=10) IP x 50, then the other ILRMA paths x 20 and
    TILRMA(nu=1) x 150, on the C = 2 main path's mixture."""
    before = best_pairing_si_sdr(mixture, images)

    def gauss(**kw):
        return lambda **more: GaussILRMA(n_basis=10, **kw, **more)

    X, _, y, loss, main = ilrma_drive(gauss(), mixture, ITERS_ILRMA)
    assert main["k1_launches"] == ITERS_ILRMA and main["k2_launches"] == 0, main
    assert loss[-1] < loss[0], ("ILRMA IP", loss[0], loss[-1])
    main["si_sdr_before_db"], main["si_sdr_after_db"] = before, best_pairing_si_sdr(y, images)
    if main["si_sdr_after_db"] <= before + 5.0:  # the bar stays; n_basis = 2 is held to it
        _, _, y2, _, two = ilrma_drive(lambda: GaussILRMA(n_basis=2), mixture, ITERS_ILRMA)
        two["si_sdr_after_db"] = best_pairing_si_sdr(y2, images)
        main["n_basis_2"] = two
        assert two["si_sdr_after_db"] > before + 5.0, ("ILRMA SI-SDR", before, main["si_sdr_after_db"], two)
    np.random.seed(SEED)
    main["loss_vs_cpu_f64_max_rel"] = loss_vs_cpu_f64("ilrma_ip", gauss(device="cpu"), mixture, loss)
    main["per_iter_loss_on"] = per_iteration(X, True, gauss(), ITERS_ILRMA)
    main["per_iter_loss_off"] = per_iteration(X, False, gauss(), ITERS_ILRMA)
    out = {"gauss_ip": main}
    for key, make, k1 in [
        ("gauss_ip2", gauss(algorithm_spatial="IP2"), ITERS_SHORT),  # one launch for the pair
        ("gauss_iss", gauss(algorithm_spatial="ISS"), 0),
        ("gauss_projection_back", gauss(normalize="projection-back"), ITERS_SHORT),
        ("gauss_partitioning", gauss(partitioning=True), ITERS_SHORT),
        ("t_nu1000", lambda **kw: TILRMA(n_basis=10, nu=1000, **kw), ITERS_SHORT),
        ("consistent", lambda **kw: ConsistentGaussILRMA(n_basis=10, fft_size=FFT_SIZE, hop_size=HOP_SIZE, **kw),
         ITERS_SHORT),
    ]:
        X, _, y, loss, res = ilrma_drive(make, mixture, ITERS_SHORT)
        assert res["k1_launches"] == k1 and res["k2_launches"] == 0, (key, res)
        assert loss[-1] < loss[0], (key, loss[0], loss[-1])
        res["si_sdr_before_db"], res["si_sdr_after_db"] = before, best_pairing_si_sdr(y, images)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            res["per_iter_loss_off"] = per_iteration(X, False, make, ITERS_SHORT)
        out[key] = res
    # the JAX package's float32 regression (tests/test_ilrma.py, nu = 1):
    # weights over about 10 decades; the guard and denom_floor keep it finite
    _, _, y, loss, res = ilrma_drive(lambda: TILRMA(n_basis=10, nu=1), mixture, ITERS_T_NU1)
    assert res["k1_launches"] == ITERS_T_NU1, res
    res["si_sdr_before_db"], res["si_sdr_after_db"] = before, best_pairing_si_sdr(y, images)
    out["t_nu1_f32"] = res
    return out


def ilrma_c3(mixture, images):
    """GaussILRMA(n_basis=4) IP x 20 at C = 3: K1 per bin with N = 3."""
    X, _, y, loss, res = ilrma_drive(lambda: GaussILRMA(n_basis=4), mixture, ITERS_SHORT)
    assert res["k1_launches"] == ITERS_SHORT and res["k2_launches"] == 0, res
    assert loss[-1] < loss[0], ("ILRMA C = 3", loss[0], loss[-1])
    res["si_sdr_before_db"] = best_pairing_si_sdr(mixture, images)
    res["si_sdr_after_db"] = best_pairing_si_sdr(y, images)
    make = lambda recordable_loss: GaussILRMA(n_basis=4, recordable_loss=recordable_loss)  # noqa: E731
    res["per_iter_loss_off"] = per_iteration(X, False, make, ITERS_SHORT)
    return res


def profile_c2(X, path):
    """torch.profiler table of a 20-iteration C = 2 solver call, and the
    device time of each kernel per iteration."""
    from torch.profiler import ProfilerActivity, profile

    solver = AuxLaplaceIVA(recordable_loss=True)
    solver(X, iteration=5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        solver(X, iteration=20)
        torch.cuda.synchronize()
    events = prof.key_averages()
    key = "self_device_time_total" if hasattr(events[0], "self_device_time_total") else "self_cuda_time_total"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(events.table(sort_by=key, row_limit=25))
    per_iter_us = {
        re.search(r"fused_ip_\w+", e.key).group(0): getattr(e, key) / 20
        for e in events
        if re.search(r"fused_ip_\w+", e.key)
    }
    assert len(per_iter_us) == 1, ("K2 is one kernel per iteration", per_iter_us)
    return {"device_busy_ms_20_iters": sum(getattr(e, key) for e in events) / 1e3, "kernel_us_per_iter": per_iter_us}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true", help="write a torch.profiler table")
    args = parser.parse_args()

    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print("card: " + card, flush=True)

    start = time.perf_counter()
    outputs = _build.build_all(verbose=True)
    build_s = time.perf_counter() - start
    for name, out in outputs.items():
        log("nvcc {}:\n{}".format(name, out))
    print(json.dumps({"build_s": build_s, "built": sorted(outputs)}), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    F, T = 2049, 469
    k1 = [k1_case(gen, C, F, T) for C in (2, 3, 4)]
    k1_long = k1_case(gen, 4, 65, 16_384)
    k1_long_c3 = k1_case(gen, 3, 513, 7501)  # a 120 s recording at stft(1024, 256)
    k2 = k2_case(gen, F, T)
    k2_long = k2_case(gen, 257, 9000)
    print(json.dumps({"k1_cases": k1, "k1_long": k1_long, "k1_long_c3": k1_long_c3, "k2_case": k2,
                      "k2_long": k2_long}), flush=True)
    k1_pair = k1_case(gen, 3, F, T, N=2)  # IP2's pair covariances at C = 3
    k1_any = [k1_case(gen, 5, F, T), k1_case(gen, 1, F, T)]  # generic at C = 5; C = 1
    print(json.dumps({"k1_any": k1_any}), flush=True)
    k2_gauss = k2_case(gen, F, T, contrast="gauss")
    k2_gauss_long = k2_case(gen, 257, 9000, contrast="gauss")
    print(json.dumps({"k1_pair": k1_pair, "k2_gauss": k2_gauss, "k2_gauss_long": k2_gauss_long}), flush=True)
    # per-bin (N, F, T) weights, ILRMA's: IP at C = 2 and 3, IP2's pair at
    # C = 3, the generic instance, the frame axis split, odd F T
    k1_per_bin = [
        k1_case(gen, C, F_, T_, N=N, per_bin=True)
        for C, N, F_, T_ in [(2, 2, F, T), (3, 3, F, T), (3, 2, F, T), (5, 5, F, T), (2, 2, 513, 7501),
                             (3, 3, 129, 7001)]
    ]
    print(json.dumps({"k1_per_bin": k1_per_bin}), flush=True)

    rng = np.random.RandomState(SEED)
    X2, mix2, c2 = main_path_c2(rng)
    print(json.dumps({"main_path_c2": c2}), flush=True)
    c2_long = main_path_c2_long(rng)
    print(json.dumps({"main_path_c2_long": c2_long}), flush=True)
    mix3, c3 = main_path_c3(rng)
    print(json.dumps({"main_path_c3": c3}), flush=True)

    fam2 = family_c2(*mix2)
    fam3 = family_c3(*mix3)
    over, over1 = overdetermined(rng)
    c5 = five_channels(rng)
    c3_long = main_path_c3_long(rng)  # last: the earlier phases keep their mixtures
    print(json.dumps({"main_path_c3_long": c3_long}), flush=True)
    print(json.dumps({
        "family_c2": fam2, "family_c3": fam3, "overdetermined_4to2": over, "overdetermined_4to1": over1,
        "laplace_ip_c5": c5,
    }), flush=True)
    ilrma2 = ilrma_c2(*mix2)
    ilrma3 = ilrma_c3(*mix3)
    print(json.dumps({"ilrma_c2": ilrma2, "ilrma_c3": ilrma3}), flush=True)
    if args.profile:
        prof = profile_c2(X2, ROOT / "chiprun_out" / "profile_c2.txt")
        print(json.dumps({"profile_c2": prof}), flush=True)

    k1_main = k1[1]  # C = 3, the shape of the K1 main path
    k1_all = k1 + [k1_long, k1_long_c3, k1_pair] + k1_any + k1_per_bin

    def k2_entry(name, case, case_long, launches, launches_by_path, rtol):
        return {
            "name": name, "route": "cuda",
            "source": "audio_source_separation_tpu_torch/csrc/fused_auxiva_ip.cu",
            "replaces": "audio_source_separation_tpu/ops/pallas_fused.py:231",
            "launches": launches, "launches_by_path": launches_by_path,
            "max_abs_err": max(case["max_abs_err"], case_long["max_abs_err"]),
            "max_rel_err": max(*case["rel_err"].values(), *case_long["rel_err"].values()),
            "tolerance": "W, psum max_rel_err <= {}; NLL <= {}".format(rtol, K2_RTOL),
            "ms": case["ms"], "plain_ms": case["plain_ms"], "ms_long": case_long["ms"],
            "bound_ms": case["bound_ms"], "bound_us": case["bound_ms"] * 1e3, "bound_by": case["bound_by"],
            "library_ms": None, "shape": [2, F, T],
        }

    kernels = [
        {
            "name": "weighted_covariance (K1)", "route": "cuda",
            "source": "audio_source_separation_tpu_torch/csrc/weighted_covariance.cu",
            "replaces": "audio_source_separation_tpu/ops/pallas_kernels.py:96",
            "launches": c3["k1_launches"],
            "launches_by_path": {
                "laplace_ip_c3": c3["k1_launches"],
                "laplace_ip_c3_long": c3_long["k1_launches"],
                "laplace_ip2_c2": fam2["laplace_ip2"]["k1_launches"],
                "laplace_ip2_c3": fam3["laplace_ip2"]["k1_launches"],
                "gauss_ip_c3": fam3["gauss_ip"]["k1_launches"],
                "laplace_ip_c5": c5["k1_launches"],
                "over_4to1": over1["k1_launches"],
                **{"ilrma_{}_c2".format(key): res["k1_launches"] for key, res in ilrma2.items()},
                "ilrma_gauss_ip_c3": ilrma3["k1_launches"],
            },
            "max_abs_err": max(c["max_abs_err"] for c in k1_all),
            "max_rel_err": max(c["rel_err"] for c in k1_all),
            "tolerance": "max_rel_err <= {}".format(K1_RTOL),
            "ms": k1_main["ms"], "plain_ms": k1_main["plain_ms"],
            "bound_ms": k1_main["bound_ms"], "bound_us": k1_main["bound_ms"] * 1e3, "bound_by": k1_main["bound_by"],
            "library_ms": k1_main["library_ms"], "shape": [3, F, T],
            "cases": [
                {key: case[key] for key in (
                    "C", "N", "F", "T", "per_bin", "ms", "cold_ms", "plain_ms", "plain_cold_ms", "library_ms",
                    "library_cold_ms", "bound_ms", "bound_by", "rel_err",
                )}
                for case in k1_all
            ],
        },
        k2_entry(
            "fused_auxiva_ip (K2, Laplace contrast)", k2, k2_long, c2["k2_launches"],
            {"laplace_ip_c2": c2["k2_launches"], "laplace_ip_c2_long": c2_long["k2_launches"],
             "over_4to2": over["k2_launches"]},
            K2_RTOL,
        ),
        k2_entry(
            "fused_auxiva_ip (K2, Gauss contrast)", k2_gauss, k2_gauss_long, fam2["gauss_ip"]["k2_launches"],
            {"gauss_ip_c2": fam2["gauss_ip"]["k2_launches"]}, K2_GAUSS_RTOL,
        ),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print("card: " + card, flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
