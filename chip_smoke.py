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
  8. the factorisation models through the entry points at n_basis = 10, on
     the targets the JAX package's benchmark rows take (benchmarks/
     run_all.py) from phase 3's mixture: |X[0]|^2 (2049 x 469) for EUCNMF,
     KLNMF, ISNMF (mm, me), TNMF and CauchyNMF (all four rules) x 50,
     X[0] for ComplexEUCNMF x 20, |X|^2 (2 x 2049 x 469) for EUCNTF x 50,
     the covariances (2049 x 469 x 2 x 2) for CovarianceISNMF x 20, and
     phase 5's C = 3 covariances through its eigh path x 20; finite
     losses, the last below the first where tests/test_nmf.py holds it,
     the first 20 losses against the CPU float64 run from the same
     seed-111 init (CovarianceISNMF at C = 3: the first 5), neither kernel
     launched, ms and host ms per iteration, and the batched eigh's time;
  9. slice 5 and IDLMA through the entry points, on phase 3's mixture:
     GaussIDLMA x 20 with the JAX benchmark row's variance network (2049 ->
     512 -> 2049, seed-111 weights; K1 per bin once per iteration, the first
     20 losses against the CPU float64 run from the same weights) and with
     an oracle network returning the sources' image amplitudes (SI-SDR up
     by more than 5 dB); NaturalGradLaplaceFDICA and GradLaplaceFDICA x 100
     (the permutation on its native route) and ProxLaplaceIVA x 100 (the
     loss falls, SI-SDR up by more than 3 dB -- GradLaplaceFDICA, which
     misses that bar at float64 in both packages, within 0.1 dB of its CPU
     float64 run --, the first 20 losses against the CPU float64 run);
     then, on a 2-mic mixture drawn after every other phase's, the
     delay-and-sum and MVDR beamformers with oracle steering and MaxSNR with
     the oracle covariances, each against its CPU float64 run, MVDR closer
     to the image than the mixture is; no kernel launched
     by FDICA, Prox or the beamformers; ms, host ms and the device's busy
     time per iteration (IDLMA against GaussILRMA IP);
 10. MNMF through the entry points at n_basis = 10 from the seed-111 init, on
     phase 3's mixture: FastMultichannelISNMF x 100 (K1 per bin, N = 2, once
     per iteration, SI-SDR up by more than 5 dB), MultichannelISNMF Sawada x
     100 and Ozerov x 50 (no kernel, SI-SDR within 0.1 dB of the port's CPU
     float64 run); for each, finite losses, the last below the first, the
     first 20 losses against the CPU float64 run (Sawada: the increments
     L_k - L_0 at 1e-4, its first loss and its output apart; Ozerov at its
     float32 tolerance) with a CPU float32 run's gaps beside, ms and host ms
     per iteration, the device's busy time (FastMNMF, Sawada); then on phase
     5's mixture FastMNMF x 20 (K1 per bin, N = 3), Sawada x 10 (the matrix
     Riccati) and Ozerov x 10, finite;
 11. block-PSD through the entry points at n_basis = 2 from the seed-111
     init, on phase 3's mixture at the JAX benchmark rows' widths (1024
     blocks, B = 3): GaussIPSDTA Kondo x 20 (K1 per bin, N = 2, once per
     iteration), Ikeshita and TIPSDTA(nu=1000) x 20 (no kernel); finite
     losses, the last below the first (not Ikeshita's), the SI-SDR, the
     first 5 losses against the port's CPU float64 run (Kondo at float32's
     gap; Ikeshita's first loss, its spike amplifying rounding after) with
     a CPU float32 run's gaps beside, ms and host ms
     per iteration, Kondo's device time; Kondo at 256 blocks (B = 9, the
     matrix route) x 20, K1 per bin every iteration, SI-SDR up by more than
     2 dB; Kondo x 5 on phase 5's mixture (the planes VCD at C = 3, K1 per
     bin with N = 3); LDPSDTF at K = 2 (the pencil) x 60 and K = 3 x 20 on
     the JAX benchmark's Gram targets (64 taps x 469 frames), the first 20
     losses against CPU float64 (at float32's gap), no kernel, ms per
     iteration;
 12. the harness, batch_separate and the sharded steps at full width, on
     eight seeded 60 s two-source mixtures (8 x 2 x 2049 x 469, drawn after
     every other phase's): batch_separate over AuxLaplaceIVA IP (K2 240 in
     240), GaussILRMA(10) and FastMultichannelISNMF(10) (K1 per bin 240 in
     240 each) x 30, each member against its own call (1e-6), the (8, 30)
     losses finite, SI-SDR up by more than 5 dB on every member for IVA and
     ILRMA, ms per iteration and mixtures/s; auxiva_ip_step(use_pallas=True)
     x 100 (K1 100 in 100) and auxiva_ip_step_binsmajor x 100 on pair
     products, their first 20 NLLs against the port's CPU float64 run (the
     reference cut to 20 steps); batched_auxiva_ip_step on (8, 2, 2, 2049,
     469) against the eight single steps; the port's convolutive_mixture
     with synthetic_room_impulse_responses(2, 2, taps=64) on the card
     against the CPU (1e-12); AuxLaplaceIVA IP x 50 with
     SDRImprovementCallback and BSSEvalCallback(stride=10) (K2 50 in 50),
     its histories against a CPU float64 run's (0.1 dB); bss_eval_sources
     on the separated 60 s signals on the card and the CPU (1e-4 dB), both
     times; the example scripts ``examples.separate --method auxiva`` and
     ``examples.walkthrough`` on the card, their artefacts in
     ``build/phase12``;
 13. one ``{"kernels": [...]}`` line (K2 once per contrast), then the last
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
import functools
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
    EUCNMF,
    EUCNTF,
    ISNMF,
    KLNMF,
    LDPSDTF,
    TILRMA,
    TIPSDTA,
    TNMF,
    AuxGaussIVA,
    AuxLaplaceIVA,
    CauchyNMF,
    ComplexEUCNMF,
    ConsistentGaussILRMA,
    CovarianceISNMF,
    DelaySumBeamformer,
    FastMultichannelISNMF,
    GaussIDLMA,
    GaussILRMA,
    GaussIPSDTA,
    GradLaplaceFDICA,
    GradLaplaceIVA,
    MaxSNRBeamformer,
    MultichannelISNMF,
    MVDRBeamformer,
    NaturalGradLaplaceFDICA,
    NaturalGradLaplaceIVA,
    OverAuxLaplaceIVA,
    ProxLaplaceIVA,
    istft,
    stft,
    torch_dnn,
)
from audio_source_separation_tpu_torch.algorithm.permutation import solve_permutation
from audio_source_separation_tpu_torch.examples import separate, walkthrough
from audio_source_separation_tpu_torch.ops import _build
from audio_source_separation_tpu_torch.ops.covariance import pair_products
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
from audio_source_separation_tpu_torch.parallel import (
    auxiva_ip_step,
    auxiva_ip_step_binsmajor,
    auxiva_ip_step_stacked,
    batch_separate,
    batched_auxiva_ip_step,
)
from audio_source_separation_tpu_torch.tools.timing import l2_flusher, median_ms
from audio_source_separation_tpu_torch.utils import (
    BSSEvalCallback,
    SDRImprovementCallback,
    bss_eval_sources,
    convolutive_mixture,
    synthetic_room_impulse_responses,
    write_wav,
)

SEED = 111
SR = 16000
N_SAMPLES = 958_464  # ~60 s at 16 kHz -> 2049 bins x 469 frames
FFT_SIZE, HOP_SIZE = 4096, 2048
N_SAMPLES_LONG = 1_920_000  # 120 s at 16 kHz -> 513 bins x 7501 frames
FFT_SIZE_LONG, HOP_SIZE_LONG = 1024, 256
ITERS_C2, ITERS_C2_LONG, ITERS_C3, N_MATCH = 100, 20, 20, 20
ITERS_ISS_IP2, ITERS_SHORT, ITERS_C5 = 50, 20, 10
ITERS_ILRMA, ITERS_T_NU1 = 50, 150
ITERS_FACTOR, FACTOR_BASIS = 50, 10
ITERS_IDLMA, ITERS_SLICE5, IDLMA_HIDDEN = 20, 100, 512
ITERS_MNMF, ITERS_OZEROV, ITERS_MNMF_C3 = 100, 50, 10
ITERS_IPSDTA, IPSDTA_MATCH, ITERS_IPSDTA_C3 = 20, 5, 5
ITERS_PSDTF2, ITERS_PSDTF3, PSDTF_TAPS = 60, 20, 64
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


def synth_images(rng, n_sources, n_samples, taps=8, n_mics=None):
    """Amplitude-modulated noise sources through short random FIRs (the
    recipe of tests/conftest.py::synth_convolutive_mixture) at ``n_mics``
    microphones (default one per source); returns the mixture and every
    source's image at every mic, ``(n_sources, n_mics, n_samples)``."""
    t = np.arange(n_samples) / SR
    mods = [3.0, 5.0, 7.0, 11.0, 13.0]
    sources = []
    for n in range(n_sources):
        env = 0.5 * (1 + np.sign(np.sin(2 * np.pi * mods[n] * t + 0.7 * n)))
        env = np.convolve(env, np.ones(64) / 64, mode="same")
        sources.append(env * rng.randn(n_samples))
    n_mics = n_mics or n_sources
    mixture = np.zeros((n_mics, n_samples))
    images = np.zeros((n_sources, n_mics, n_samples))
    for m in range(n_mics):
        for n in range(n_sources):
            h = 0.2 * rng.randn(taps) * np.exp(-0.7 * np.arange(taps))
            h[(3 * m + 5 * n) % taps] += 1.0 if m == n else 0.8
            images[n, m] = np.convolve(sources[n], h)[:n_samples]
            mixture[m] += images[n, m]
    return mixture, images


def synth_mixture(rng, n_sources, n_samples, taps=8, n_mics=None):
    """:func:`synth_images`' mixture and each source's image at mic 0."""
    mixture, images = synth_images(rng, n_sources, n_samples, taps=taps, n_mics=n_mics)
    return mixture, images[:, 0]


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


def per_iteration(X, record, make=AuxLaplaceIVA, n=100, warm=10, **call):
    """Per-iteration times of the solver loop of ``make(recordable_loss=)``
    called with ``call``: ``ms`` by CUDA events, differencing (warm + n)-
    and warm-iteration calls (init and finalize cancel), and ``host_ms``,
    the host's time to enqueue one iteration (``update_state`` and, when
    recording, ``nll``) without waiting for the device."""
    solver = make(recordable_loss=record)

    def run(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        solver(X, iteration=n, **call)
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    run(warm)
    short = min(run(warm) for _ in range(3))
    long_ = min(run(warm + n) for _ in range(3))
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
def drive(make, mixture, iterations, **call):
    """``stft -> make()(X, iteration=iterations, **call) -> istft`` on the
    card, with both kernels' counts set to 0 just before and read just
    after."""
    fused_auxiva_ip_iter.launches = 0
    weighted_covariance_planes.launches = 0
    torch.cuda.synchronize()
    start = time.perf_counter()
    X = stft(mixture.astype(np.float32), fft_size=FFT_SIZE, hop_size=HOP_SIZE)
    solver = make()
    Y = solver(X, iteration=iterations, **call)
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


def loss_gaps_cpu_f64(make_cpu, mixture, losses, **call):
    """Relative gaps of the first ``N_MATCH`` losses to the port's own CPU
    float64 run from the same mixture, ``make_cpu()(X, **call)``."""
    X_cpu = stft(mixture, fft_size=FFT_SIZE, hop_size=HOP_SIZE, device="cpu")
    reference = make_cpu()
    reference(X_cpu, iteration=N_MATCH - 1, **call)
    return np.abs(np.asarray(losses[:N_MATCH]) - reference.loss) / np.abs(reference.loss)


def loss_vs_cpu_f64(name, make_cpu, mixture, losses):
    """The largest of :func:`loss_gaps_cpu_f64`, held to ``LOSS_MATCH_RTOL``."""
    gap = loss_gaps_cpu_f64(make_cpu, mixture, losses)
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
def seeded_drive(make, mixture, iterations):
    """:func:`drive` from the seed-111 init (``np.random``, as the JAX
    package draws it); the "in progress" warnings (ILRMA ISS, Ozerov MNMF)
    silenced."""
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

    X, _, y, loss, main = seeded_drive(gauss(), mixture, ITERS_ILRMA)
    assert main["k1_launches"] == ITERS_ILRMA and main["k2_launches"] == 0, main
    assert loss[-1] < loss[0], ("ILRMA IP", loss[0], loss[-1])
    main["si_sdr_before_db"], main["si_sdr_after_db"] = before, best_pairing_si_sdr(y, images)
    if main["si_sdr_after_db"] <= before + 5.0:  # the bar stays; n_basis = 2 is held to it
        _, _, y2, _, two = seeded_drive(lambda: GaussILRMA(n_basis=2), mixture, ITERS_ILRMA)
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
        X, _, y, loss, res = seeded_drive(make, mixture, ITERS_SHORT)
        assert res["k1_launches"] == k1 and res["k2_launches"] == 0, (key, res)
        assert loss[-1] < loss[0], (key, loss[0], loss[-1])
        res["si_sdr_before_db"], res["si_sdr_after_db"] = before, best_pairing_si_sdr(y, images)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            res["per_iter_loss_off"] = per_iteration(X, False, make, ITERS_SHORT)
        out[key] = res
    # the JAX package's float32 regression (tests/test_ilrma.py, nu = 1):
    # weights over about 10 decades; the guard and denom_floor keep it finite
    _, _, y, loss, res = seeded_drive(lambda: TILRMA(n_basis=10, nu=1), mixture, ITERS_T_NU1)
    assert res["k1_launches"] == ITERS_T_NU1, res
    res["si_sdr_before_db"], res["si_sdr_after_db"] = before, best_pairing_si_sdr(y, images)
    out["t_nu1_f32"] = res
    return out


def ilrma_c3(mixture, images):
    """GaussILRMA(n_basis=4) IP x 20 at C = 3: K1 per bin with N = 3."""
    X, _, y, loss, res = seeded_drive(lambda: GaussILRMA(n_basis=4), mixture, ITERS_SHORT)
    assert res["k1_launches"] == ITERS_SHORT and res["k2_launches"] == 0, res
    assert loss[-1] < loss[0], ("ILRMA C = 3", loss[0], loss[-1])
    res["si_sdr_before_db"] = best_pairing_si_sdr(mixture, images)
    res["si_sdr_after_db"] = best_pairing_si_sdr(y, images)
    make = lambda recordable_loss: GaussILRMA(n_basis=4, recordable_loss=recordable_loss)  # noqa: E731
    res["per_iter_loss_off"] = per_iteration(X, False, make, ITERS_SHORT)
    return res


# --------------------------------------------------------------------------- #
# phase 8: the factorisation models, no kernel
# --------------------------------------------------------------------------- #
# key, class, kwargs, target, iterations, whether tests/test_nmf.py holds the
# loss to fall (not CauchyNMF's naive rule; not ComplexEUCNMF at its default
# regularizer, whose fit loss may rise)
# key, class, kwargs, target, iterations, whether the loss must fall; then,
# where the comparison with the CPU float64 run differs from the others', a
# dict with its tolerance ``rtol`` (default LOSS_MATCH_RTOL) and the number
# of losses compared ``n_match`` (default N_MATCH).  The covariance model's
# loss holds the target's own log-determinant, and a rank-1 snapshot
# covariance's small eigenvalue is rounding noise at float32 (floored at eps
# at float64), about 10% (C = 2) and 20% (C = 3) of the loss on this mixture
# (PERF.md gives each gap); its references take most of the phase's time,
# so C = 3's runs 5 iterations and C = 2's 10
FACTOR_CASES = [
    ("eucnmf", EUCNMF, {}, "power", ITERS_FACTOR, True),
    ("klnmf", KLNMF, {}, "power", ITERS_FACTOR, True),
    ("isnmf_mm", ISNMF, {}, "power", ITERS_FACTOR, True),
    ("isnmf_me", ISNMF, {"algorithm": "me"}, "power", ITERS_FACTOR, True),
    ("tnmf", TNMF, {}, "power", ITERS_FACTOR, True),
    ("cauchy_naive", CauchyNMF, {}, "power", ITERS_FACTOR, False),
    ("cauchy_mm", CauchyNMF, {"algorithm": "mm"}, "power", ITERS_FACTOR, True),
    ("cauchy_me", CauchyNMF, {"algorithm": "me"}, "power", ITERS_FACTOR, True),
    ("cauchy_mm_fast", CauchyNMF, {"algorithm": "mm_fast"}, "power", ITERS_FACTOR, True),
    ("complex_eucnmf", ComplexEUCNMF, {}, "spectrogram", ITERS_SHORT, False),
    ("eucntf", EUCNTF, {}, "power_tensor", ITERS_FACTOR, True),
    ("covariance_isnmf_c2", CovarianceISNMF, {}, "covariance", ITERS_SHORT, True, {"rtol": 0.15, "n_match": 10}),
    ("covariance_isnmf_c3", CovarianceISNMF, {}, "covariance_c3", ITERS_SHORT, True, {"rtol": 0.3, "n_match": 5}),
]


def with_loss(model, recordable_loss):
    """The factorisation constructors take no ``recordable_loss``, as in the
    JAX package: the loss is switched on the instance."""
    model.recordable_loss = recordable_loss
    model.loss = [] if recordable_loss else None
    return model


def factor_targets(X, X3):
    """The targets of the JAX package's benchmark rows (benchmarks/
    run_all.py) from the mixtures ``X (2, F, T)`` and ``X3 (3, F, T)``."""
    return {
        "power": X[0].abs() ** 2,
        "spectrogram": X[0],
        "power_tensor": X.abs() ** 2,
        "covariance": torch.einsum("cft,dft->ftcd", X, X.conj()),
        "covariance_c3": torch.einsum("cft,dft->ftcd", X3, X3.conj()),
    }


def factorisation(mixture, mixture3):
    """Every case of ``FACTOR_CASES`` from the seed-111 init on the card, its
    first ``N_MATCH`` losses against the port's CPU float64 run from the
    same draws, then its ms and host ms per iteration.  Returns the results
    and the list of failed checks (the caller prints, then fails)."""
    stfts = [
        [stft(m.astype(np.float32), fft_size=FFT_SIZE, hop_size=HOP_SIZE) for m in (mixture, mixture3)],
        [stft(m, fft_size=FFT_SIZE, hop_size=HOP_SIZE, device="cpu") for m in (mixture, mixture3)],
    ]
    targets, targets_cpu = (factor_targets(*pair) for pair in stfts)
    out, failed = {}, []
    phase_start = time.perf_counter()
    for key, cls, kw, target, iterations, falls, *match in FACTOR_CASES:
        match = match[0] if match else {}
        np.random.seed(SEED)
        fused_auxiva_ip_iter.launches = 0
        weighted_covariance_planes.launches = 0
        torch.cuda.synchronize()
        start = time.perf_counter()
        model = cls(n_basis=FACTOR_BASIS, **kw)
        factors = model(targets[target], iteration=iterations)
        torch.cuda.synchronize()
        loss = np.asarray(model.loss)
        res = out[key] = {
            "target_shape": list(targets[target].shape), "iterations": iterations,
            "wall_s": time.perf_counter() - start,
            "k1_launches": weighted_covariance_planes.launches, "k2_launches": fused_auxiva_ip_iter.launches,
            "loss_first": float(loss[0]), "loss_last": float(loss[-1]),
            "factor_shapes": [list(f.shape) for f in factors],
        }
        np.random.seed(SEED)
        start = time.perf_counter()
        reference = cls(n_basis=FACTOR_BASIS, device="cpu", **kw)
        n_match = match.get("n_match", N_MATCH)
        reference(targets_cpu[target], iteration=n_match)
        gap = np.abs(loss[:n_match] - reference.loss) / np.abs(reference.loss)
        rtol = match.get("rtol", LOSS_MATCH_RTOL)
        res.update(
            cpu_f64_s=time.perf_counter() - start, loss_vs_cpu_f64_max_rel=float(gap.max()),
            at_iteration=int(gap.argmax()), tolerance=rtol, losses_compared=n_match,
        )
        checks = {
            "loss length": len(loss) == iterations,
            "finite losses": bool(np.isfinite(loss).all()),
            "finite factors": all(bool(torch.isfinite(f).all()) for f in factors),
            "no kernel": res["k1_launches"] == res["k2_launches"] == 0,
            "loss falls": loss[-1] < loss[0] or not falls,
            "loss vs CPU float64 within {}".format(rtol): gap.max() <= rtol,
        }
        failed += ["{}: {}".format(key, name) for name, ok in checks.items() if not ok]
    for key, cls, kw, target, *_ in FACTOR_CASES:
        make = lambda recordable_loss: with_loss(cls(n_basis=FACTOR_BASIS, **kw), recordable_loss)  # noqa: E731
        out[key]["per_iter_loss_on"] = per_iteration(targets[target], True, make, ITERS_SHORT)
        out[key]["per_iter_loss_off"] = per_iteration(targets[target], False, make, ITERS_SHORT)
    # the C = 3 spatial update's batched eigh: (F, K) = 2049 x 10 Hermitian
    # 3 x 3 complex64 matrices, three calls an iteration
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    A = torch.randn((2049, FACTOR_BASIS, 3, 3), dtype=torch.complex64, device="cuda", generator=gen)
    A = A @ A.mH
    out["eigh_3x3_ms"] = median_ms(lambda: torch.linalg.eigh(A))
    out["phase_s"] = time.perf_counter() - phase_start
    return out, failed


# --------------------------------------------------------------------------- #
# phase 9: slice 5 and IDLMA
# --------------------------------------------------------------------------- #
class VarianceMLP(torch.nn.Module):
    """The variance network of the JAX package's IDLMA benchmark row
    (benchmarks/run_all.py): ``F -> hidden -> F`` without biases, shared
    over the sources and run over the frames, ReLU, then ``softplus +
    1e-3``; ``W1 (hidden, F)`` and ``W2 (F, hidden)`` as given.  The port's
    tests build the same network from it."""

    def __init__(self, W1, W2):
        super().__init__()
        self.hidden = torch.nn.Parameter(torch.as_tensor(W1))
        self.out = torch.nn.Parameter(torch.as_tensor(W2))

    def forward(self, amplitude):  # (S, F, T)
        h = torch.relu(torch.matmul(self.hidden, amplitude))
        return torch.nn.functional.softplus(torch.matmul(self.out, h)) + 1e-3


class OracleNetwork(torch.nn.Module):
    """Returns the sources' true amplitudes whatever its input (the oracle
    of tests/test_idlma.py)."""

    def __init__(self, amplitude):
        super().__init__()
        self.register_buffer("amplitude", amplitude)

    def forward(self, amplitude):
        return self.amplitude


def variance_mlp_weights(n_bins):
    """The benchmark row's weights: ``randn x 0.01`` in float32 from
    ``RandomState(111)``, W1 then W2."""
    rng = np.random.RandomState(SEED)
    W1 = (rng.randn(IDLMA_HIDDEN, n_bins) * 0.01).astype(np.float32)
    W2 = (rng.randn(n_bins, IDLMA_HIDDEN) * 0.01).astype(np.float32)
    return W1, W2


def device_ms_per_iteration(make, X, n=10, **call):
    """The kernels' device time per iteration (``update_state`` and ``nll``)
    in a torch.profiler trace of ``n`` iterations; ``None`` where the trace
    holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    solver = make(recordable_loss=True)
    solver(X, iteration=2, **call)
    state = solver.init_state(X.contiguous(), **solver.prepare_state_kwargs(X, {}))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            state = solver.update_state(state)
            solver.nll(state)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    key = "self_device_time_total" if events and hasattr(events[0], "self_device_time_total") else "self_cuda_time_total"
    total_us = sum(getattr(e, key) for e in events)
    return total_us / 1e3 / n if total_us > 0 else None


def rel_gap(card, cpu):
    """:func:`rel_err` of a card tensor against a CPU one, at complex128."""
    return rel_err(card.cpu().to(torch.complex128), cpu.to(torch.complex128))


def image_error(estimate, image):
    """Distance of ``estimate`` to the best multiple of ``image`` (STFT
    domain), relative to the image (tests/test_fdica_beamform_prox.py)."""
    alpha = np.vdot(image, estimate) / np.vdot(image, image)
    return float(np.linalg.norm(estimate - alpha * image) / np.linalg.norm(image))


def record_checks(failed, key, checks):
    """Add the names of ``checks`` (name -> passed) that failed to ``failed``."""
    failed += ["{}: {}".format(key, name) for name, ok in checks.items() if not ok]


def match_cpu_f64(res, make_cpu, mixture, loss, **call):
    """The first ``N_MATCH`` losses against the CPU float64 run, recorded in
    ``res``; whether they hold ``LOSS_MATCH_RTOL``."""
    gap = loss_gaps_cpu_f64(make_cpu, mixture, loss, **call)
    res.update(loss_vs_cpu_f64_max_rel=float(gap.max()), at_iteration=int(gap.argmax()), tolerance=LOSS_MATCH_RTOL)
    return bool(gap.max() <= LOSS_MATCH_RTOL)


def idlma(mixture, images, failed):
    """GaussIDLMA x 20 with the benchmark row's network and with an oracle
    network: K1 per bin once per iteration, finite losses; the network's
    first 20 losses against the CPU float64 run, the oracle's SI-SDR."""
    before = best_pairing_si_sdr(mixture, images)
    W1, W2 = variance_mlp_weights(FFT_SIZE // 2 + 1)
    mlp = torch_dnn(VarianceMLP(W1, W2).cuda())
    X, _, y, loss, res = drive(GaussIDLMA, mixture, ITERS_IDLMA, dnn=mlp)
    res["si_sdr_before_db"], res["si_sdr_after_db"] = before, best_pairing_si_sdr(y, images)
    mlp_cpu = torch_dnn(VarianceMLP(W1.astype(np.float64), W2.astype(np.float64)))
    record_checks(failed, "idlma_mlp", {
        "one K1 launch per iteration": res["k1_launches"] == ITERS_IDLMA and res["k2_launches"] == 0,
        "loss length": len(loss) == ITERS_IDLMA + 1,
        "loss vs CPU float64": match_cpu_f64(res, lambda: GaussIDLMA(device="cpu"), mixture, loss, dnn=mlp_cpu),
    })
    make = lambda recordable_loss: with_loss(GaussIDLMA(), recordable_loss)  # noqa: E731
    res["per_iter_loss_on"] = per_iteration(X, True, make, ITERS_IDLMA, dnn=mlp)
    res["per_iter_loss_off"] = per_iteration(X, False, make, ITERS_IDLMA, dnn=mlp)
    res["device_ms_per_iter"] = device_ms_per_iteration(make, X, dnn=mlp)
    np.random.seed(SEED)
    ilrma = lambda recordable_loss: GaussILRMA(n_basis=10, recordable_loss=recordable_loss)  # noqa: E731
    res["ilrma_ip_device_ms_per_iter"] = device_ms_per_iteration(ilrma, X)
    out = {"idlma_mlp": res}

    amplitude = stft(images.astype(np.float32), fft_size=FFT_SIZE, hop_size=HOP_SIZE).abs()
    _, _, y, loss, res = drive(GaussIDLMA, mixture, ITERS_IDLMA, dnn=torch_dnn(OracleNetwork(amplitude)))
    res["si_sdr_before_db"], res["si_sdr_after_db"] = before, best_pairing_si_sdr(y, images)
    record_checks(failed, "idlma_oracle", {
        "one K1 launch per iteration": res["k1_launches"] == ITERS_IDLMA and res["k2_launches"] == 0,
        "SI-SDR up by more than 5 dB": res["si_sdr_after_db"] > before + 5.0,
    })
    out["idlma_oracle"] = res
    return out


def fdica_prox(mixture, images, failed):
    """NaturalGradLaplaceFDICA and GradLaplaceFDICA at lr = 0.1 and
    ProxLaplaceIVA at its defaults, x 100: no kernel, finite losses, the
    last below the first, SI-SDR up by more than 3 dB, the first 20 losses
    against the CPU float64 run; FDICA's permutation on its native route,
    and its host time.

    A row's last entry, where it is not ``None``, holds that path's SI-SDR
    to the port's CPU float64 run within that many dB instead of the bar:
    GradLaplaceFDICA misses the bar at this FFT size in both packages at
    float64 (``tests/check_fdica_si_sdr.py``; PERF.md)."""
    before = best_pairing_si_sdr(mixture, images)
    out = {}
    for key, cls, kw, si_sdr_vs_f64_db in [
        ("natural_grad_fdica", NaturalGradLaplaceFDICA, {"lr": 0.1}, None),
        ("grad_fdica", GradLaplaceFDICA, {"lr": 0.1}, 0.1),
        ("prox", ProxLaplaceIVA, {}, None),
    ]:
        solve_permutation.route = None
        X, Y, y, loss, res = drive(lambda: cls(**kw), mixture, ITERS_SLICE5)
        res["si_sdr_before_db"], res["si_sdr_after_db"] = before, best_pairing_si_sdr(y, images)
        checks = {
            "no kernel": res["k1_launches"] == res["k2_launches"] == 0,
            "loss falls": loss[-1] < loss[0],
            "loss vs CPU float64": match_cpu_f64(res, lambda: cls(device="cpu", **kw), mixture, loss),
        }
        if si_sdr_vs_f64_db is not None:
            X_cpu = stft(mixture, fft_size=FFT_SIZE, hop_size=HOP_SIZE, device="cpu")
            Y_cpu = cls(device="cpu", **kw)(X_cpu, iteration=ITERS_SLICE5)
            y_cpu = istft(Y_cpu, fft_size=FFT_SIZE, hop_size=HOP_SIZE, length=mixture.shape[-1], device="cpu")
            res["si_sdr_cpu_f64_db"] = best_pairing_si_sdr(y_cpu.numpy(), images)
            checks["SI-SDR within {} dB of CPU float64".format(si_sdr_vs_f64_db)] = (
                abs(res["si_sdr_after_db"] - res["si_sdr_cpu_f64_db"]) <= si_sdr_vs_f64_db
            )
        else:
            checks["SI-SDR up by more than 3 dB"] = res["si_sdr_after_db"] > before + 3.0
        if cls is not ProxLaplaceIVA:
            res["permutation_route"] = solve_permutation.route
            checks["native permutation"] = res["permutation_route"] == "native"
            W = torch.eye(2, dtype=X.dtype, device=X.device).repeat(X.shape[1], 1, 1)
            times = []
            for _ in range(5):
                torch.cuda.synchronize()
                start = time.perf_counter()
                solve_permutation(W, Y)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - start) * 1e3)
            res["permutation_host_ms"] = float(np.median(times))
        record_checks(failed, key, checks)
        make = lambda recordable_loss: cls(recordable_loss=recordable_loss, **kw)  # noqa: E731
        res["per_iter_loss_off"] = per_iteration(X, False, make, ITERS_SHORT)
        out[key] = res
    return out


def beamformers(rng, failed):
    """On a 2-mic mixture drawn with every mic's source images: delay-and-sum
    and MVDR with oracle steering (the principal eigenvector of each
    source's spatial covariance, benchmarks/quality.py's recipe) and MaxSNR
    with the oracle covariances, each against its CPU float64 run; MVDR
    with and without ``covariance=``, and closer to each source's image
    than the mixture is; no kernel; ms per call.  Reads MVDR's gap with its
    covariance formed at complex64 too, where float32 loses its digits."""
    mixture, images = synth_images(rng, 2, N_SAMPLES)
    X_cpu = stft(mixture, fft_size=FFT_SIZE, hop_size=HOP_SIZE, device="cpu")
    Ximg = np.stack([stft(im, fft_size=FFT_SIZE, hop_size=HOP_SIZE, device="cpu").numpy() for im in images])
    scm = np.einsum("scft,sdft->sfcd", Ximg, Ximg.conj()) / Ximg.shape[-1]  # (S, F, C, C)
    steering = np.linalg.eigh(scm)[1][..., -1].transpose(1, 2, 0)  # (F, C, S)
    Xb = X_cpu.numpy().transpose(1, 0, 2)
    covariance = Xb @ Xb.transpose(0, 2, 1).conj() / Xb.shape[-1]
    cases = {
        "delay_sum": lambda device: (DelaySumBeamformer(steering_vector=steering, device=device), {}),
        "mvdr": lambda device: (MVDRBeamformer(steering_vector=steering, device=device), {}),
        "mvdr_covariance": lambda device: (
            MVDRBeamformer(steering_vector=steering, device=device), {"covariance": covariance}
        ),
        **{
            "max_snr_{}".format(s): (lambda device, s=s: (
                MaxSNRBeamformer(device=device), {"signal_covariance": scm[s], "noise_covariance": scm[1 - s]}
            ))
            for s in range(2)
        },
    }
    fused_auxiva_ip_iter.launches = 0
    weighted_covariance_planes.launches = 0
    X = stft(mixture.astype(np.float32), fft_size=FFT_SIZE, hop_size=HOP_SIZE)
    X_cpu32 = X_cpu.to(torch.complex64)
    out, Y, expected, checks = {}, {}, {}, {}
    for key, make in cases.items():
        bf, kw = make(None)
        Y[key] = bf(X, **kw)
        torch.cuda.synchronize()
        reference, kw_cpu = make("cpu")
        expected[key] = reference(X_cpu, **kw_cpu)
        gap = rel_gap(Y[key], expected[key])
        checks[key + " finite"] = bool(torch.isfinite(Y[key]).all())
        checks[key + " vs CPU float64"] = gap <= LOSS_MATCH_RTOL
        out[key] = {
            "vs_cpu_f64_max_rel": gap, "tolerance": LOSS_MATCH_RTOL, "shape": list(Y[key].shape),
            "cpu_f32_vs_cpu_f64_max_rel": rel_gap(reference(X_cpu32, **kw_cpu), expected[key]),
            "ms": median_ms(lambda: bf(X, **kw)),
        }
    out["k1_launches"], out["k2_launches"] = weighted_covariance_planes.launches, fused_auxiva_ip_iter.launches
    out["mvdr_covariance_vs_estimated_max_rel"] = rel_gap(Y["mvdr_covariance"], Y["mvdr"].cpu())
    # where float32 lost MVDR's digits (a reading, not a check): the
    # covariance formed at complex64, on the card and on the CPU, then the
    # class's complex128 solve
    for where, X_ in (("card", X), ("cpu", X_cpu32)):
        Xb_ = X_.permute(1, 0, 2)
        Y_ = MVDRBeamformer(steering_vector=steering, device=X_.device)(X_, covariance=Xb_ @ Xb_.mH / Xb_.shape[-1])
        out["mvdr_complex64_covariance_{}_vs_cpu_f64_max_rel".format(where)] = rel_gap(Y_, expected["mvdr"])
    mvdr = Y["mvdr"].cpu().numpy()
    out["mvdr_image_error"] = [image_error(mvdr[s], Ximg[s, 0]) for s in range(2)]
    out["mixture_image_error"] = [image_error(X_cpu[0].numpy(), Ximg[s, 0]) for s in range(2)]
    checks["no kernel"] = out["k1_launches"] == out["k2_launches"] == 0
    checks["mvdr with and without covariance="] = out["mvdr_covariance_vs_estimated_max_rel"] <= LOSS_MATCH_RTOL
    checks["mvdr closer to the image than the mixture"] = all(
        a < b for a, b in zip(out["mvdr_image_error"], out["mixture_image_error"])
    )
    record_checks(failed, "beamformers", checks)
    return out


# --------------------------------------------------------------------------- #
# phase 10: MNMF
# --------------------------------------------------------------------------- #
# key, class, kwargs, iterations on the card, K1 launches per iteration, the
# SI-SDR's hold (None: up by more than 5 dB; else within that many dB of the
# port's CPU float64 run, as Sawada separates slowly from the seed-111 init
# and Ozerov's posterior mean from a random init scores far below the mixture,
# benchmarks/QUALITY.md), the tolerance of the first N_MATCH losses against the
# CPU float64 run, then, where not None, the tolerance of the first loss alone
# (the row then holds the increments L_k - L_0 relative to |L_0| at the one
# before) and of the output against the CPU float64 run's, relative to its
# largest entry.  Sawada's loss holds the log-determinant of the rank-1
# observed covariance, whose small eigenvalue is rounding noise at float32: a
# constant of the data, 1.8e-2 of the first loss on this mixture in a CPU
# float32 run.  Its output leaves float64 in a few bins where float32's
# Riccati solve is ill-conditioned (2.6e-3 of the largest entry after 10
# iterations in a CPU float32 run), and Ozerov's losses leave it by 2.8e-4
# through its float32 guards (the noise floor at 100 eps_machine, not 1e-12)
# and the EM's growth of rounding (tests/check_mnmf_float32.py; the CPU
# float32 gaps move with the CPU's thread count).  Ozerov's output at -36 dB
# barely correlates with the sources, so its SI-SDR moves by tenths of a dB
# with that drift (0.16 dB apart on an H100 at float32).  This run reads
# each CPU float32 loss gap again (N_MATCH losses), beside the card's
# (PERF.md)
MNMF_CASES = [
    ("fast_mnmf", FastMultichannelISNMF, {}, ITERS_MNMF, 1, None, LOSS_MATCH_RTOL, None, None),
    ("sawada", MultichannelISNMF, {"author": "Sawada"}, ITERS_MNMF, 0, 0.1, LOSS_MATCH_RTOL, 0.1, 0.05),
    ("ozerov", MultichannelISNMF, {"author": "Ozerov"}, ITERS_OZEROV, 0, 0.5, 1e-3, None, None),
]


def loss_gaps(loss, reference, first_rtol):
    """Relative gaps of ``loss`` to ``reference`` over its length: of the
    losses, or where ``first_rtol`` is given, of the increments ``L_k - L_0``
    relative to ``|L_0|``, with the first loss's gap apart."""
    b = np.asarray(reference)
    a = np.asarray(loss[: len(b)])
    if first_rtol is None:
        return np.abs(a - b) / np.abs(b), None
    return np.abs((a - a[0]) - (b - b[0])) / abs(b[0]), float(abs(a[0] - b[0]) / abs(b[0]))


def mnmf(mixture, images, mixture3, images3, failed):
    """Every case of ``MNMF_CASES`` on the C = 2 mixture from the seed-111
    init: K1 launches, falling finite losses, the SI-SDR, the first
    ``N_MATCH`` losses against the port's CPU float64 run (and a CPU float32
    run's gap beside), ms and host ms per iteration, the device's busy time
    (FastMNMF, Sawada); then FastMNMF, Sawada (the matrix Riccati) and Ozerov
    on the C = 3 mixture, finite."""
    before = best_pairing_si_sdr(mixture, images)
    X_cpu = stft(mixture, fft_size=FFT_SIZE, hop_size=HOP_SIZE, device="cpu")
    X_cpu32 = stft(mixture.astype(np.float32), fft_size=FFT_SIZE, hop_size=HOP_SIZE, device="cpu")
    out = {}
    for key, cls, kw, iterations, k1_per_iteration, si_sdr_db, rtol, first_rtol, output_rtol in MNMF_CASES:

        def make(cls=cls, kw=kw, **more):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                return cls(n_basis=FACTOR_BASIS, **kw, **more)

        X, Y, y, loss, res = seeded_drive(make, mixture, iterations)
        res["si_sdr_before_db"], res["si_sdr_after_db"] = before, best_pairing_si_sdr(y, images)
        # the CPU float64 run from the same draws, to the card's count where
        # the SI-SDR and the output are held to float64's, and a CPU float32
        # run of N_MATCH losses for float32's share of the loss gaps
        start = time.perf_counter()
        references, Y_cpu = {}, {}
        for precision, X_, cpu_iterations in (
            ("f64", X_cpu, N_MATCH - 1 if si_sdr_db is None else iterations), ("f32", X_cpu32, N_MATCH - 1),
        ):  # fmt: skip
            np.random.seed(SEED)
            references[precision] = make(device="cpu")
            Y_cpu[precision] = references[precision](X_, iteration=cpu_iterations)
        res["cpu_s"] = time.perf_counter() - start
        expected = references["f64"].loss[:N_MATCH]
        gaps, first_gap = loss_gaps(loss, expected, first_rtol)
        gaps32, first_gap32 = loss_gaps(references["f32"].loss, expected, first_rtol)
        res.update(
            loss_vs_cpu_f64_max_rel=float(gaps.max()), at_iteration=int(gaps.argmax()), tolerance=rtol,
            cpu_f32_vs_cpu_f64_max_rel=float(gaps32.max()), cpu_f32_at_iteration=int(gaps32.argmax()),
        )
        checks = {
            "K1 launches": res["k1_launches"] == iterations * k1_per_iteration and res["k2_launches"] == 0,
            "loss length": len(loss) == iterations + 1,
            "loss falls": loss[-1] < loss[0],
            "loss vs CPU float64 within {}".format(rtol): gaps.max() <= rtol,
        }
        if first_rtol is not None:
            res.update(
                held="increments L_k - L_0 over |L_0|; the first loss apart",
                first_loss_vs_cpu_f64_rel=first_gap, first_tolerance=first_rtol,
                cpu_f32_first_loss_vs_cpu_f64_rel=first_gap32,
            )
            checks["first loss vs CPU float64 within {}".format(first_rtol)] = first_gap <= first_rtol
        if si_sdr_db is None:
            checks["SI-SDR up by more than 5 dB"] = res["si_sdr_after_db"] > before + 5.0
        else:
            y_cpu = istft(Y_cpu["f64"], fft_size=FFT_SIZE, hop_size=HOP_SIZE, length=mixture.shape[-1], device="cpu")
            res["si_sdr_cpu_f64_db"] = best_pairing_si_sdr(y_cpu.numpy(), images)
            res["output_vs_cpu_f64_max_rel"] = rel_gap(Y, Y_cpu["f64"])
            res["si_sdr_tolerance_db"] = si_sdr_db
            checks["SI-SDR within {} dB of CPU float64".format(si_sdr_db)] = (
                abs(res["si_sdr_after_db"] - res["si_sdr_cpu_f64_db"]) <= si_sdr_db
            )
        if output_rtol is not None:
            res["output_tolerance"] = output_rtol
            output_ok = res["output_vs_cpu_f64_max_rel"] <= output_rtol
            checks["output vs CPU float64 within {}".format(output_rtol)] = output_ok
        record_checks(failed, key, checks)
        timed = lambda recordable_loss, make=make: make(recordable_loss=recordable_loss)  # noqa: E731
        res["per_iter_loss_on"] = per_iteration(X, True, timed, ITERS_SHORT)
        res["per_iter_loss_off"] = per_iteration(X, False, timed, ITERS_SHORT)
        if key != "ozerov":
            res["device_ms_per_iter"] = device_ms_per_iteration(timed, X)
        out[key] = res

    before3 = best_pairing_si_sdr(mixture3, images3)
    for key, make, iterations, k1_per_iteration in [
        ("fast_mnmf_c3", functools.partial(FastMultichannelISNMF, n_basis=FACTOR_BASIS), ITERS_SHORT, 1),  # N = 3
        ("sawada_c3", functools.partial(MultichannelISNMF, n_basis=FACTOR_BASIS), ITERS_MNMF_C3, 0),  # matrix Riccati
        ("ozerov_c3", functools.partial(MultichannelISNMF, n_basis=FACTOR_BASIS, author="Ozerov"), ITERS_MNMF_C3, 0),
    ]:
        X, Y, y, loss, res = seeded_drive(make, mixture3, iterations)
        res["si_sdr_before_db"], res["si_sdr_after_db"] = before3, best_pairing_si_sdr(y, images3)
        record_checks(failed, key, {
            "K1 launches": res["k1_launches"] == iterations * k1_per_iteration and res["k2_launches"] == 0,
            "loss length": len(loss) == iterations + 1,
            "output shape": tuple(Y.shape) == tuple(X.shape),
        })
        if key == "fast_mnmf_c3":
            res["per_iter_loss_off"] = per_iteration(X, False, make, ITERS_SHORT)
        out[key] = res
    return out


# --------------------------------------------------------------------------- #
# phase 11: block-PSD
# --------------------------------------------------------------------------- #
# key, class, kwargs, K1 launches per iteration, whether the loss must fall,
# the tolerance of the first IPSDTA_MATCH losses against the port's CPU
# float64 run, and whether it holds only those outside the float64 run's
# transient (a loss that rose, and the one after it).
# At float32 the closed-form eigenvalues of a few near-singular 3 x 3 blocks
# of R round below zero and are projected to the eps trace floor, which
# moves their log-determinant terms: at this shape the port's CPU float32
# run leaves float64 by 4.5e-4 (Kondo), so the float32 holds are
# IPSDTA_F32_RTOL, about twice that (tests/check_block_psd_float32.py
# --holds reads it, and lower-precision controls against it).
# Ikeshita's float64 loss spikes to about 1e9 at iteration 2 and rises again
# at 6. In and after those transients float32 runs leave float64 by 1.7e-2
# (the CPU) and 0.62 (the card) at 3, by 0.1 to 2 on either at 6, while the
# card at complex128 stays within 1e-12 of the CPU's through 5 (--holds,
# PERF.md): its float32 run is held outside the transient, and its
# complex128 run on the card at IPSDTA_F64_RTOL everywhere.
IPSDTA_F32_RTOL, IPSDTA_F64_RTOL = 1e-3, 1e-9
IPSDTA_CASES = [
    ("kondo", GaussIPSDTA, {"author": "Kondo"}, 1, True, IPSDTA_F32_RTOL, False),
    ("ikeshita", GaussIPSDTA, {"author": "Ikeshita"}, 0, False, IPSDTA_F32_RTOL, True),
    ("t_nu1000", TIPSDTA, {"nu": 1000}, 0, True, LOSS_MATCH_RTOL, False),
]
# key, n_basis, iterations, the tolerance of the first N_MATCH losses (no
# CPU float32 run: the float32 ridges, 100 eps_machine, not 1e-12, move
# LDPSDTF's loss by 6.6e-3 at K = 2 and 3.4e-3 at K = 3 on the CPU in both
# packages, tests/check_block_psd_float32.py), the timing's n and warm-up
PSDTF_CASES = [("ldpsdtf_k2", 2, ITERS_PSDTF2, 1e-2, ITERS_SHORT, 10), ("ldpsdtf_k3", 3, ITERS_PSDTF3, 5e-3, 2, 1)]
# every IPSDTA timing: 5 iterations against 2 (host-bound, 20-600 ms each);
# the slow rows (over 0.2 s an iteration) are timed with the loss off only
IPSDTA_TIMING = (5, 2)
LOSS_OFF_ONLY = {"t_nu1000", "kondo_b9", "ldpsdtf_k3"}
IPSDTA_SI_SDR_BAR = 2.0  # dB, tests/test_ipsdta.py's


def at_complex128(solver):
    """``solver`` running at complex128 on the card, where the runtime
    would cast its input to complex64: a float64 witness of the card's
    path for a solver without a kernel."""
    solver.input_dtype = lambda X: torch.complex128
    return solver


def gram_target(n_basis, n_frames, taps=PSDTF_TAPS):
    """The JAX benchmark's LDPSDTF target (benchmarks/run_all.py:258-265):
    ``n_basis`` PSD Gram bases ``a a^T + 0.5 I`` over positive activations,
    ``RandomState(7)``, ``(taps, taps, n_frames)`` float64."""
    rng = np.random.RandomState(7)
    bases = [rng.randn(taps, taps) for _ in range(n_basis)]
    stacked = np.stack([a @ a.T + 0.5 * np.eye(taps) for a in bases])
    return np.einsum("kij,kt->ijt", stacked, np.abs(rng.randn(n_basis, n_frames)) + 0.2)


def cpu_loss_gaps(make_cpu, inputs, loss, n_match):
    """The first ``n_match`` losses of the port's CPU runs from the seed-111
    draws on ``inputs`` (precision -> CPU input, "f64" first): the float64
    run's losses, and the relative gaps of ``loss`` and of each other
    precision's run to them, ``{"card": gaps, precision: gaps, ...}``."""
    runs = {}
    for precision, X_ in inputs.items():
        np.random.seed(SEED)
        model = make_cpu()
        model(X_, iteration=n_match - 1 if model.record_initial_loss else n_match)
        runs[precision] = np.asarray(model.loss[:n_match])
    ref = runs.pop("f64")
    runs["card"] = np.asarray(loss[:n_match])
    return ref, {key: np.abs(run - ref) / np.abs(ref) for key, run in runs.items()}


def outside_transient(loss):
    """Whether each loss is outside the transient of ``loss``: it did not
    rise, nor did the one before it."""
    rose = np.concatenate([[False], np.diff(loss) > 0])
    return ~(rose | np.concatenate([[False], rose[:-1]]))


def timings(res, key, X, make, n, warm):
    """:func:`per_iteration` with the loss off, and on unless ``key`` is a
    slow row's (``LOSS_OFF_ONLY``), into ``res``."""
    start = time.perf_counter()
    for record in (False,) if key in LOSS_OFF_ONLY else (True, False):
        res["per_iter_loss_on" if record else "per_iter_loss_off"] = per_iteration(X, record, make, n, warm)
    res["timing_s"] = time.perf_counter() - start


def block_psd(mixture, images, mixture3, images3, failed):
    """GaussIPSDTA (Kondo, Ikeshita) and TIPSDTA(nu=1000) x 20 at the JAX
    benchmark rows' widths (n_basis = 2, 1024 blocks: B = 3, the compact
    route) from the seed-111 init on the C = 2 mixture: K1 per bin once a
    Kondo iteration and never else, finite losses (falling but Ikeshita's),
    the SI-SDR, the first 5 losses against the port's CPU float64 run (of
    Ikeshita those outside the transient, and its card float64 run's all)
    with a CPU float32 run's gaps beside, ms and host ms per iteration,
    Kondo's device time; Kondo at 256 blocks (B = 9, the matrix route) x 20,
    its SI-SDR held to the bar; Kondo x 5 on the C = 3 mixture (the planes
    VCD, K1 per bin with N = 3); LDPSDTF at K = 2 x 60 and K = 3 x 20 on the
    benchmark's Gram targets, the first 20 losses against CPU float64, no
    kernel.  Each row's wall time, timings included, is its ``row_s``."""
    before = best_pairing_si_sdr(mixture, images)
    inputs = {
        "f64": stft(mixture, fft_size=FFT_SIZE, hop_size=HOP_SIZE, device="cpu"),
        "f32": stft(mixture.astype(np.float32), fft_size=FFT_SIZE, hop_size=HOP_SIZE, device="cpu"),
    }
    out = {}
    for key, cls, kw, k1_per_iteration, falls, rtol, transient in IPSDTA_CASES:
        row_start = time.perf_counter()

        def make(cls=cls, kw=kw, **more):
            return cls(n_basis=2, **kw, **more)

        X, Y, y, loss, res = seeded_drive(make, mixture, ITERS_IPSDTA)
        res["si_sdr_before_db"], res["si_sdr_after_db"] = before, best_pairing_si_sdr(y, images)
        start = time.perf_counter()
        ref, gaps = cpu_loss_gaps(lambda make=make: make(device="cpu"), inputs, loss, IPSDTA_MATCH)
        held = outside_transient(ref) if transient else np.ones(IPSDTA_MATCH, dtype=bool)
        res.update(
            cpu_s=time.perf_counter() - start, loss_vs_cpu_f64_max_rel=float(gaps["card"].max()),
            at_iteration=int(gaps["card"].argmax()), cpu_f32_vs_cpu_f64_max_rel=float(gaps["f32"].max()),
            cpu_f32_at_iteration=int(gaps["f32"].argmax()), losses_compared=IPSDTA_MATCH,
            losses_held=np.flatnonzero(held).tolist(), held_max_rel=float(gaps["card"][held].max()),
            gaps=gaps["card"].tolist(), cpu_f32_gaps=gaps["f32"].tolist(), tolerance=rtol,
        )
        checks = {
            "K1 launches": res["k1_launches"] == ITERS_IPSDTA * k1_per_iteration and res["k2_launches"] == 0,
            "loss length": len(loss) == ITERS_IPSDTA + 1,
            "loss falls": loss[-1] < loss[0] or not falls,
            "losses {} vs CPU float64 within {}".format(res["losses_held"], rtol): res["held_max_rel"] <= rtol,
        }
        if transient:  # the same init at float64 on the card: the whole trajectory
            np.random.seed(SEED)
            card64 = at_complex128(make())
            card64(inputs["f64"].cuda(), iteration=IPSDTA_MATCH - 1)
            gaps64 = np.abs(np.asarray(card64.loss) - ref) / np.abs(ref)
            res.update(card_f64_gaps=gaps64.tolist(), card_f64_tolerance=IPSDTA_F64_RTOL)
            checks["card float64 vs CPU float64 within {}".format(IPSDTA_F64_RTOL)] = gaps64.max() <= IPSDTA_F64_RTOL
        record_checks(failed, key, checks)
        timed = lambda recordable_loss, make=make: make(recordable_loss=recordable_loss)  # noqa: E731
        np.random.seed(SEED)  # the timed runs' draws follow from the seed too
        timings(res, key, X, timed, *IPSDTA_TIMING)
        if key == "kondo":
            res["device_ms_per_iter"] = device_ms_per_iteration(timed, X, n=3)  # 4000 kernels an iteration
        res["row_s"] = time.perf_counter() - row_start
        out[key] = res

    # the quality geometry: 256 blocks, B = 9, the matrix source step and VCD
    def b9(**more):
        return GaussIPSDTA(n_basis=2, n_blocks=256, **more)

    row_start = time.perf_counter()
    X, _, y, loss, res = seeded_drive(b9, mixture, ITERS_IPSDTA)
    res["si_sdr_before_db"], res["si_sdr_after_db"] = before, best_pairing_si_sdr(y, images)
    checks = {
        "K1 launches": res["k1_launches"] == ITERS_IPSDTA and res["k2_launches"] == 0,
        "loss falls": loss[-1] < loss[0],
    }
    if res["si_sdr_after_db"] > before + IPSDTA_SI_SDR_BAR:
        checks["SI-SDR up by more than {} dB".format(IPSDTA_SI_SDR_BAR)] = True
    else:  # the bar missed: held to the port's CPU float64 run, within 0.5 dB
        np.random.seed(SEED)
        Y_cpu = b9(device="cpu")(inputs["f64"], iteration=ITERS_IPSDTA)
        y_cpu = istft(Y_cpu, fft_size=FFT_SIZE, hop_size=HOP_SIZE, length=mixture.shape[-1], device="cpu")
        res["si_sdr_cpu_f64_db"] = best_pairing_si_sdr(y_cpu.numpy(), images)
        checks["SI-SDR within 0.5 dB of CPU float64"] = abs(res["si_sdr_after_db"] - res["si_sdr_cpu_f64_db"]) <= 0.5
    record_checks(failed, "kondo_b9", checks)
    np.random.seed(SEED)
    timings(res, "kondo_b9", X, lambda recordable_loss: b9(recordable_loss=recordable_loss), *IPSDTA_TIMING)
    res["row_s"] = time.perf_counter() - row_start
    out["kondo_b9"] = res

    # C = 3: the planes VCD, K1 per bin with N = 3 weight rows
    row_start = time.perf_counter()
    X, Y, y, loss, res = seeded_drive(lambda **more: GaussIPSDTA(n_basis=2, **more), mixture3, ITERS_IPSDTA_C3)
    res["si_sdr_before_db"] = best_pairing_si_sdr(mixture3, images3)
    res["si_sdr_after_db"] = best_pairing_si_sdr(y, images3)
    record_checks(failed, "kondo_c3", {
        "K1 launches": res["k1_launches"] == ITERS_IPSDTA_C3 and res["k2_launches"] == 0,
        "loss length": len(loss) == ITERS_IPSDTA_C3 + 1,
        "output shape": tuple(Y.shape) == tuple(X.shape),
    })
    res["row_s"] = time.perf_counter() - row_start
    out["kondo_c3"] = res

    # LDPSDTF on the benchmark's Gram targets: the K = 2 pencil, the K = 3 eigh
    n_frames = inputs["f64"].shape[-1]
    for key, n_basis, iterations, rtol, timing_n, warm in PSDTF_CASES:
        row_start = time.perf_counter()
        target = gram_target(n_basis, n_frames)
        np.random.seed(SEED)
        weighted_covariance_planes.launches = fused_auxiva_ip_iter.launches = 0
        torch.cuda.synchronize()
        start = time.perf_counter()
        model = LDPSDTF(n_basis=n_basis)
        factors = model(target, iteration=iterations)
        torch.cuda.synchronize()
        loss = np.asarray(model.loss)
        res = out[key] = {
            "target_shape": list(target.shape), "iterations": iterations, "wall_s": time.perf_counter() - start,
            "k1_launches": weighted_covariance_planes.launches, "k2_launches": fused_auxiva_ip_iter.launches,
            "loss_first": float(loss[0]), "loss_last": float(loss[-1]),
        }
        start = time.perf_counter()
        make_cpu = lambda n_basis=n_basis: LDPSDTF(n_basis=n_basis, device="cpu")  # noqa: E731
        gaps = cpu_loss_gaps(make_cpu, {"f64": target}, loss, N_MATCH)[1]["card"]
        res.update(
            cpu_s=time.perf_counter() - start, loss_vs_cpu_f64_max_rel=float(gaps.max()),
            at_iteration=int(gaps.argmax()), losses_compared=N_MATCH, tolerance=rtol,
        )
        record_checks(failed, key, {
            "no kernel": res["k1_launches"] == res["k2_launches"] == 0,
            "loss length": len(loss) == iterations,
            "finite": bool(np.isfinite(loss).all()) and all(bool(torch.isfinite(f).all()) for f in factors),
            "loss falls": loss[-1] < loss[0],
            "loss vs CPU float64 within {}".format(rtol): gaps.max() <= rtol,
        })
        timed = lambda recordable_loss, n_basis=n_basis: with_loss(LDPSDTF(n_basis=n_basis), recordable_loss)  # noqa: E731
        card_target = torch.as_tensor(target, dtype=torch.float32, device="cuda")
        timings(res, key, card_target, timed, timing_n, warm)
        res["row_s"] = time.perf_counter() - row_start
    return out


# --------------------------------------------------------------------------- #
# phase 12: the harness, batch_separate and the sharded steps at full width
# --------------------------------------------------------------------------- #
BATCH, ITERS_BATCH, BATCH_BASIS = 8, 30, 10  # benchmarks/throughput.py's N_ITER
ITERS_STEP, ITERS_STEP_CPU = 100, N_MATCH  # sharded steps on the card; the CPU float64 reference's
ITERS_HARNESS, BSS_STRIDE = 50, 10
HARNESS_DB_TOL = 0.1  # card f32 callbacks vs the CPU f64 run's, dB (phase 9's FDICA hold)
BSS_DB_TOL = 1e-4  # bss_eval_sources on the card vs the CPU, both f64, dB
MEMBER_RTOL = 1e-6  # a batch member vs its own call (both kernels reduce in a fixed order)


def counts_zero():
    fused_auxiva_ip_iter.launches = 0
    weighted_covariance_planes.launches = 0
    torch.cuda.synchronize()


def counts():
    return {"k1_launches": weighted_covariance_planes.launches, "k2_launches": fused_auxiva_ip_iter.launches}


def batch_rows(Xs, mixtures, images, failed):
    """batch_separate over AuxLaplaceIVA IP, GaussILRMA(10) and
    FastMultichannelISNMF(10) x 30 on the (8, 2, 2049, 469) batch: launch
    counts, each member against its own call, losses, SI-SDR, times."""
    out = {}
    rows = [
        ("batch_laplace_ip_c2", lambda: AuxLaplaceIVA(), "k2_launches", True),
        ("batch_ilrma_c2", lambda: GaussILRMA(n_basis=BATCH_BASIS), "k1_launches", True),
        ("batch_fast_mnmf_c2", lambda: FastMultichannelISNMF(n_basis=BATCH_BASIS), "k1_launches", False),
    ]
    for key, make, kernel, sdr_bar in rows:
        np.random.seed(SEED)
        solver = make()
        counts_zero()
        start = time.perf_counter()
        outputs, losses = batch_separate(solver, Xs, iteration=ITERS_BATCH, host=False)
        torch.cuda.synchronize()
        device_s = time.perf_counter() - start
        launched = counts()
        host_start = time.perf_counter()
        outputs_host, losses_host = outputs.cpu().numpy(), losses.cpu().numpy()
        host_s = time.perf_counter() - host_start
        # each member against its own call, from the same draws in example order
        np.random.seed(SEED)
        single = make()
        member_err, loss_err = [], []
        for b in range(BATCH):
            single.loss = []
            Y = single(Xs[b], iteration=ITERS_BATCH)
            member_err.append(rel_err(outputs[b], Y))
            ref = np.asarray(single.loss[-ITERS_BATCH:])
            loss_err.append(float(np.max(np.abs(losses_host[b] - ref) / np.abs(ref))))
        y = istft(outputs, fft_size=FFT_SIZE, hop_size=HOP_SIZE, length=N_SAMPLES).cpu().numpy()
        gains = [best_pairing_si_sdr(y[b], images[b]) - best_pairing_si_sdr(mixtures[b], images[b]) for b in range(BATCH)]
        res = out[key] = {
            "batch": BATCH, "iterations": ITERS_BATCH, **launched, "wall_s": device_s + host_s,
            "ms_per_iteration": device_s * 1e3 / (BATCH * ITERS_BATCH), "host_transfer_ms": host_s * 1e3,
            "mixtures_per_s": BATCH / (device_s + host_s), "member_max_rel_err": max(member_err),
            "member_loss_max_rel_err": max(loss_err), "si_sdr_gain_db_min": min(gains), "si_sdr_gain_db": gains,
            "losses_shape": list(losses_host.shape), "outputs_shape": list(outputs_host.shape),
        }
        checks = {
            "{} {} in {}".format(kernel, BATCH * ITERS_BATCH, BATCH * ITERS_BATCH): res[kernel] == BATCH * ITERS_BATCH,
            "the other kernel 0": res["k1_launches" if kernel == "k2_launches" else "k2_launches"] == 0,
            "members equal their calls": max(member_err) <= MEMBER_RTOL and max(loss_err) <= MEMBER_RTOL,
            "losses (8, 30) finite": losses_host.shape == (BATCH, ITERS_BATCH) and bool(np.isfinite(losses_host).all()),
            "outputs finite": bool(np.isfinite(outputs_host).all()),
        }
        if sdr_bar:
            checks["SI-SDR up by more than 5 dB on every member"] = min(gains) > 5.0
        record_checks(failed, key, checks)
    return out


def step_nlls(step, carry, n):
    """``n`` steps of ``step(carry) -> (carry, nll)``; the NLLs and the
    time per step (host clock, synchronised)."""
    nlls = []
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(n):
        carry, nll = step(carry)
        nlls.append(nll)
    nlls = torch.stack(nlls).cpu().numpy()
    return carry, nlls, (time.perf_counter() - start) * 1e3 / n


def sharded_rows(Xs, X_cpu, failed):
    """The sharded steps at 2 x 2049 x 469: auxiva_ip_step(use_pallas=True)
    and auxiva_ip_step_binsmajor x 100 with their first 20 NLLs against the
    port's CPU float64 run, and batched_auxiva_ip_step on (8, 2, 2, 2049,
    469) against the eight single steps."""
    X = Xs[0].contiguous()
    F = X.shape[1]
    eye = torch.eye(2, dtype=X.dtype, device=X.device).expand(F, 2, 2).contiguous()
    eye_cpu = torch.eye(2, dtype=X_cpu.dtype).expand(F, 2, 2).contiguous()
    out = {}

    counts_zero()
    _, nlls, ms = step_nlls(lambda W: auxiva_ip_step(X, W, use_pallas=True), eye, ITERS_STEP)
    res = out["sharded_auxiva_ip_step"] = {"steps": ITERS_STEP, **counts(), "ms_per_step": ms}
    _, ref, cpu_ms = step_nlls(lambda W: auxiva_ip_step(X_cpu, W, use_pallas=True), eye_cpu, ITERS_STEP_CPU)
    gap = np.abs(nlls[:ITERS_STEP_CPU] - ref) / np.abs(ref)
    res.update(nll_vs_cpu_f64_max_rel=float(gap.max()), nlls_compared=ITERS_STEP_CPU, cpu_ms_per_step=cpu_ms,
               nll_first=float(nlls[0]), nll_last=float(nlls[-1]))
    record_checks(failed, "sharded_auxiva_ip_step", {
        "K1 {} in {}".format(ITERS_STEP, ITERS_STEP): res["k1_launches"] == ITERS_STEP and res["k2_launches"] == 0,
        "finite": bool(np.isfinite(nlls).all()), "NLL vs CPU float64 within {}".format(LOSS_MATCH_RTOL):
        gap.max() <= LOSS_MATCH_RTOL,
    })

    def binsmajor(Xf, PP):
        def step(carry):
            W, Yf, nll = auxiva_ip_step_binsmajor(Xf, *carry, PP)
            return (W, Yf), nll

        return step

    Xf, Xf_cpu = X.permute(1, 0, 2).contiguous(), X_cpu.permute(1, 0, 2).contiguous()
    counts_zero()
    _, nlls, ms = step_nlls(binsmajor(Xf, pair_products(X)), (eye, eye @ Xf), ITERS_STEP)
    res = out["sharded_binsmajor"] = {"steps": ITERS_STEP, **counts(), "ms_per_step": ms}
    _, ref, _ = step_nlls(binsmajor(Xf_cpu, pair_products(X_cpu)), (eye_cpu, eye_cpu @ Xf_cpu), ITERS_STEP_CPU)
    gap = np.abs(nlls[:ITERS_STEP_CPU] - ref) / np.abs(ref)
    res.update(nll_vs_cpu_f64_max_rel=float(gap.max()), nlls_compared=ITERS_STEP_CPU)
    record_checks(failed, "sharded_binsmajor", {
        "no kernel": res["k1_launches"] == res["k2_launches"] == 0, "finite": bool(np.isfinite(nlls).all()),
        "NLL vs CPU float64 within {}".format(LOSS_MATCH_RTOL): gap.max() <= LOSS_MATCH_RTOL,
    })

    X2 = torch.stack([Xs.real, Xs.imag], dim=1).contiguous()  # (8, 2, 2, F, T)
    W2 = torch.stack([eye.real, eye.imag]).expand(BATCH, 2, F, 2, 2).contiguous()
    counts_zero()
    torch.cuda.synchronize()
    start = time.perf_counter()
    W2_out, nll_out = batched_auxiva_ip_step(X2, W2)
    torch.cuda.synchronize()
    batched_ms = (time.perf_counter() - start) * 1e3
    # float32 rounding of the two contractions' orders, amplified by each
    # bin's IP solve, parts the batched step from the single ones; it is
    # held to the single step's own distance from CPU float64, twice over
    w_errs, nll_errs, f32_errs, nll_f32_errs = [], [], [], []
    for b in range(BATCH):
        W_b, nll_b = auxiva_ip_step_stacked(X2[b], W2[b])
        W64, nll64 = auxiva_ip_step_stacked(X2[b].cpu().double(), W2[b].cpu().double())
        w_errs.append(rel_err(W2_out[b], W_b))
        nll_errs.append(abs(float(nll_out[b]) - float(nll_b)) / abs(float(nll_b)))
        f32_errs.append(rel_err(W_b.cpu().double(), W64))
        nll_f32_errs.append(abs(float(nll_b) - float(nll64)) / abs(float(nll64)))
    per_bin = (W2_out - torch.stack([auxiva_ip_step_stacked(X2[b], W2[b])[0] for b in range(BATCH)])).abs()
    worst_bins = per_bin.amax(dim=(0, 1, 3, 4)).topk(3).indices.tolist()
    res = out["sharded_batched"] = {
        "batch": BATCH, **counts(), "ms_per_step": batched_ms, "w_max_rel_err": max(w_errs),
        "nll_max_rel_err": max(nll_errs), "single_w_vs_cpu_f64_max_rel_err": max(f32_errs),
        "single_nll_vs_cpu_f64_max_rel_err": max(nll_f32_errs), "worst_bins": worst_bins,
    }
    record_checks(failed, "sharded_batched", {
        "W and NLL within twice the single step's float32 error": all(
            e <= max(MEMBER_RTOL, 2 * f) for e, f in zip(w_errs + nll_errs, f32_errs + nll_f32_errs)
        ),
        "no kernel": res["k1_launches"] == res["k2_launches"] == 0,
    })
    return out


def harness_rows(rng, failed, workdir):
    """The port's synthesis on the card against the CPU at float64;
    AuxLaplaceIVA IP x 50 with SDRImprovementCallback and
    BSSEvalCallback(stride=10) against the CPU float64 run's histories;
    bss_eval_sources on the separated signals on the card and the CPU; the
    example scripts ``separate --method auxiva`` and ``walkthrough`` on the card."""
    out = {}
    t = np.arange(N_SAMPLES) / SR
    env = np.stack([0.5 * (1 + np.sign(np.sin(2 * np.pi * f * t + 0.7 * n))) for n, f in enumerate((3.0, 5.0))])
    sources = np.stack([np.convolve(e, np.ones(64) / 64, mode="same") for e in env]) * rng.randn(2, N_SAMPLES)
    start = time.perf_counter()
    rirs = synthetic_room_impulse_responses(2, 2, taps=64)
    mixture, images = convolutive_mixture(sources, rirs)  # on the card, where the RIRs are
    torch.cuda.synchronize()
    synthesis_ms = (time.perf_counter() - start) * 1e3
    mixture_cpu, images_cpu = convolutive_mixture(sources, synthetic_room_impulse_responses(2, 2, taps=64, device="cpu"))
    synth_err = max(rel_err(mixture.cpu(), mixture_cpu), rel_err(images.cpu(), images_cpu))
    out["synthesis"] = {"shape": list(mixture.shape), "max_rel_err_vs_cpu_f64": synth_err, "ms": synthesis_ms}
    record_checks(failed, "synthesis", {"card vs CPU float64 within 1e-12": synth_err <= 1e-12})

    targets = images[:, 0]
    runs = {}
    for device, mix, tgt in (("cuda", mixture, targets), ("cpu", mixture_cpu, images_cpu[:, 0])):
        callbacks = [
            SDRImprovementCallback(tgt, fft_size=FFT_SIZE, hop_size=HOP_SIZE),
            BSSEvalCallback(tgt, fft_size=FFT_SIZE, hop_size=HOP_SIZE, stride=BSS_STRIDE),
        ]
        X = stft(mix.to(torch.float32) if device == "cuda" else mix, fft_size=FFT_SIZE, hop_size=HOP_SIZE,
                 device=device)
        counts_zero()
        start = time.perf_counter()
        solver = AuxLaplaceIVA(callbacks=callbacks, device=device)
        Y = solver(X, iteration=ITERS_HARNESS)
        y = istft(Y, fft_size=FFT_SIZE, hop_size=HOP_SIZE, length=N_SAMPLES, device=device)
        torch.cuda.synchronize()
        runs[device] = (callbacks, y, time.perf_counter() - start, counts())
    (sdr_cb, bss_cb), y, wall_s, launched = runs["cuda"]
    (sdr_ref, bss_ref), _, cpu_s, _ = runs["cpu"]
    # the init's entry is held apart: with W = I each estimate is a filtered
    # mixture inside the references' span, so its SAR and the SI-SDR of a
    # near-orthogonal estimate sit at rounding noise, float32 and float64
    # apart by dB there (tests/test_torch_utils_harness.py holds it so)
    si_gap = float(np.max(np.abs(np.asarray(sdr_cb.history[1:]) - sdr_ref.history[1:])))
    bss_gap = max(float((a - b.to(a.device)).abs().max()) for t1, t2 in zip(bss_cb.history[1:], bss_ref.history[1:])
                  for a, b in zip(t1, t2))
    sdri_gap = float(np.max(np.abs(np.asarray(bss_cb.sdri_history[1:]) - bss_ref.sdri_history[1:])))
    res = out["harness_laplace_ip_c2"] = {
        "iterations": ITERS_HARNESS, **launched, "wall_s": wall_s, "cpu_f64_wall_s": cpu_s,
        "si_sdr_history_len": len(sdr_cb.history), "bss_history_len": len(bss_cb.history),
        "si_sdr_first_db": sdr_cb.history[0], "si_sdr_last_db": sdr_cb.history[-1],
        "sdri_last_db": bss_cb.sdri_history[-1], "si_sdr_max_gap_db": si_gap, "bss_max_gap_db": bss_gap,
        "sdri_max_gap_db": sdri_gap, "init_entry_si_sdr_gap_db": sdr_cb.history[0] - sdr_ref.history[0],
    }
    record_checks(failed, "harness_laplace_ip_c2", {
        "K2 {} in {} with callbacks".format(ITERS_HARNESS, ITERS_HARNESS):
        launched["k2_launches"] == ITERS_HARNESS and launched["k1_launches"] == 0,
        "one SI-SDR entry per iteration and init": len(sdr_cb.history) == ITERS_HARNESS + 1 == len(sdr_ref.history),
        "BSS entries every 10": len(bss_cb.history) == ITERS_HARNESS // BSS_STRIDE + 1 == len(bss_ref.history),
        "histories after init vs CPU float64 within {} dB".format(HARNESS_DB_TOL):
        max(si_gap, bss_gap, sdri_gap) <= HARNESS_DB_TOL,
    })

    # the separated 60 s signals on the card and the same signals on the CPU
    y64 = y.to(torch.float64)
    torch.cuda.synchronize()
    start = time.perf_counter()
    card = bss_eval_sources(targets, y64)
    torch.cuda.synchronize()
    card_ms = (time.perf_counter() - start) * 1e3
    start = time.perf_counter()
    cpu = bss_eval_sources(targets.cpu(), y64.cpu())
    cpu_ms = (time.perf_counter() - start) * 1e3
    gap = max(float((a.cpu() - b).abs().max()) for a, b in zip(card[:3], cpu[:3]))
    out["bss_eval_sources_60s"] = {
        "n_samples": N_SAMPLES, "filter_length": 512, "card_ms": card_ms, "cpu_f64_ms": cpu_ms, "max_gap_db": gap,
        "sdr": card[0].tolist(), "sir": card[1].tolist(), "sar": card[2].tolist(), "perm": card[3].tolist(),
    }
    record_checks(failed, "bss_eval_sources_60s", {
        "card vs CPU float64 within {} dB".format(BSS_DB_TOL): gap <= BSS_DB_TOL,
        "same permutation": list(card[3]) == list(cpu[3]),
    })

    wav = str(workdir / "mixture.wav")
    excerpt = mixture[:, : 20 * SR]
    write_wav(wav, (excerpt / (1.1 * excerpt.abs().max())).T, SR)
    counts_zero()
    start = time.perf_counter()
    summary = separate.main(["--input", wav, "--method", "auxiva", "--iterations", "50", "--out",
                             str(workdir / "separated")])
    res = out["examples_separate_auxiva"] = {**summary, **counts(), "wall_s": time.perf_counter() - start}
    record_checks(failed, "examples_separate_auxiva", {
        "K2 50 in 50": res["k2_launches"] == 50,
        "sources written": all((workdir / "separated" / "source_{}.wav".format(n)).exists() for n in range(2)),
        "summary on the card": summary["device"] == "cuda" and np.isfinite(summary["loss_last"]),
    })
    counts_zero()
    start = time.perf_counter()
    summary = walkthrough.main(["--out", str(workdir / "walkthrough")])
    res = out["examples_walkthrough"] = {**summary, **counts(), "wall_s": time.perf_counter() - start}
    artefacts = ["loss_curve.csv", "sdri_curve.csv", "source_0.wav", "source_1.wav", "summary.json"]
    record_checks(failed, "examples_walkthrough", {
        "K1 per bin 50 in 50": res["k1_launches"] == 50,
        "artefacts": all((workdir / "walkthrough" / name).exists() for name in artefacts),
        "snapshots": len(list((workdir / "walkthrough" / "state").glob("state_*.npz"))) == 51,
        "finite": np.isfinite(summary["si_sdr_improvement_db"]) and np.isfinite(summary["loss_last"]),
    })
    return out


def harness_and_batch(failed):
    """Phase 12: eight seeded 60 s mixtures through batch_separate, the
    sharded steps, the harness and the example scripts."""
    rng = np.random.RandomState(SEED + 12)  # its own draws: the earlier phases keep their mixtures
    pairs = [synth_mixture(rng, 2, N_SAMPLES) for _ in range(BATCH)]
    mixtures = np.stack([m for m, _ in pairs])
    images = np.stack([i for _, i in pairs])
    Xs = stft(mixtures.astype(np.float32), fft_size=FFT_SIZE, hop_size=HOP_SIZE).contiguous()  # (8, 2, F, T)
    assert tuple(Xs.shape) == (BATCH, 2, FFT_SIZE // 2 + 1, -(-N_SAMPLES // HOP_SIZE) + 1), Xs.shape
    out = {"input_mb": Xs.numel() * Xs.element_size() / 1e6}
    start = time.perf_counter()
    out.update(batch_rows(Xs, mixtures, images, failed))
    out["batch_s"] = time.perf_counter() - start
    start = time.perf_counter()
    X_cpu = stft(mixtures[0], fft_size=FFT_SIZE, hop_size=HOP_SIZE, device="cpu")
    out.update(sharded_rows(Xs, X_cpu, failed))
    out["sharded_s"] = time.perf_counter() - start
    start = time.perf_counter()
    workdir = ROOT / "build" / "phase12"
    workdir.mkdir(parents=True, exist_ok=True)
    out.update(harness_rows(rng, failed, workdir))
    out["harness_s"] = time.perf_counter() - start
    return out


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
    factor, factor_failed = factorisation(mix2[0], mix3[0])
    print(json.dumps({"factorisation": factor}), flush=True)
    assert not factor_failed, factor_failed
    factor_launches = {
        kernel: sum(factor[key][kernel + "_launches"] for key, *_ in FACTOR_CASES) for kernel in ("k1", "k2")
    }
    start = time.perf_counter()
    slice5_failed = []
    slice5 = idlma(*mix2, slice5_failed)
    slice5.update(fdica_prox(*mix2, slice5_failed))
    slice5["beamformers"] = beamformers(rng, slice5_failed)  # last: the earlier phases keep their mixtures
    slice5["phase_s"] = time.perf_counter() - start
    print(json.dumps({"slice5": slice5}), flush=True)
    assert not slice5_failed, slice5_failed
    no_kernel_paths = ("natural_grad_fdica", "grad_fdica", "prox", "beamformers")
    slice5_launches = {
        kernel: sum(slice5[key][kernel + "_launches"] for key in no_kernel_paths) for kernel in ("k1", "k2")
    }
    start = time.perf_counter()
    mnmf_failed = []
    mnmf_runs = mnmf(*mix2, *mix3, mnmf_failed)
    mnmf_runs["phase_s"] = time.perf_counter() - start
    print(json.dumps({"mnmf": mnmf_runs}), flush=True)
    assert not mnmf_failed, mnmf_failed
    mnmf_keys = [key for key in mnmf_runs if key != "phase_s"]
    mnmf_k1_no_kernel = sum(mnmf_runs[key]["k1_launches"] for key in mnmf_keys if not key.startswith("fast"))
    mnmf_k2 = sum(mnmf_runs[key]["k2_launches"] for key in mnmf_keys)
    start = time.perf_counter()
    block_failed = []
    block = block_psd(*mix2, *mix3, block_failed)
    block["phase_s"] = time.perf_counter() - start
    print(json.dumps({"block_psd": block}), flush=True)
    assert not block_failed, block_failed
    block_keys = [key for key in block if key != "phase_s"]
    block_k1_no_kernel = sum(block[key]["k1_launches"] for key in block_keys if not key.startswith("kondo"))
    block_k2 = sum(block[key]["k2_launches"] for key in block_keys)
    start = time.perf_counter()
    phase12_failed = []
    phase12 = harness_and_batch(phase12_failed)
    phase12["phase_s"] = time.perf_counter() - start
    print(json.dumps({"harness_and_batch": phase12}), flush=True)
    assert not phase12_failed, phase12_failed
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
                "factorisation": factor_launches["k1"],
                "idlma_mlp_c2": slice5["idlma_mlp"]["k1_launches"],
                "idlma_oracle_c2": slice5["idlma_oracle"]["k1_launches"],
                "fdica_prox_beamformers": slice5_launches["k1"],
                "fast_mnmf_c2": mnmf_runs["fast_mnmf"]["k1_launches"],
                "fast_mnmf_c3": mnmf_runs["fast_mnmf_c3"]["k1_launches"],
                "sawada_ozerov": mnmf_k1_no_kernel,
                "ipsdta_kondo_c2": block["kondo"]["k1_launches"],
                "ipsdta_kondo_b9_c2": block["kondo_b9"]["k1_launches"],
                "ipsdta_kondo_c3": block["kondo_c3"]["k1_launches"],
                "ipsdta_ikeshita_t_psdtf": block_k1_no_kernel,
                "batch_ilrma_c2": phase12["batch_ilrma_c2"]["k1_launches"],
                "batch_fast_mnmf_c2": phase12["batch_fast_mnmf_c2"]["k1_launches"],
                "sharded_auxiva_ip_step": phase12["sharded_auxiva_ip_step"]["k1_launches"],
                "examples_walkthrough_ilrma": phase12["examples_walkthrough"]["k1_launches"],
                "batch_laplace_ip_c2": phase12["batch_laplace_ip_c2"]["k1_launches"],
                "harness_laplace_ip_c2": phase12["harness_laplace_ip_c2"]["k1_launches"],
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
             "over_4to2": over["k2_launches"], "factorisation": factor_launches["k2"],
             "fdica_prox_beamformers": slice5_launches["k2"], "mnmf": mnmf_k2, "block_psd": block_k2,
             "batch_laplace_ip_c2": phase12["batch_laplace_ip_c2"]["k2_launches"],
             "harness_laplace_ip_c2": phase12["harness_laplace_ip_c2"]["k2_launches"],
             "examples_separate_auxiva": phase12["examples_separate_auxiva"]["k2_launches"],
             "batch_ilrma_c2": phase12["batch_ilrma_c2"]["k2_launches"],
             "batch_fast_mnmf_c2": phase12["batch_fast_mnmf_c2"]["k2_launches"],
             "sharded_auxiva_ip_step": phase12["sharded_auxiva_ip_step"]["k2_launches"]},
            K2_RTOL,
        ),
        k2_entry(
            "fused_auxiva_ip (K2, Gauss contrast)", k2_gauss, k2_gauss_long, fam2["gauss_ip"]["k2_launches"],
            {"gauss_ip_c2": fam2["gauss_ip"]["k2_launches"], "factorisation": factor_launches["k2"],
             "fdica_prox_beamformers": slice5_launches["k2"], "mnmf": mnmf_k2, "block_psd": block_k2},
            K2_GAUSS_RTOL,
        ),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print("card: " + card, flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
