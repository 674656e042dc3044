#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--profile]

Phases (each asserts; any failure exits non-zero):
  1. the card's name and power limit; build the four CUDA kernels from
     ``audio_source_separation_tpu_torch/csrc`` with nvcc (one process per
     source, in parallel) and print the build time;
  2. kernels: K1 (weighted covariance) at C in {2, 3, 4} x 2049 x 469, at
     C = 4 x 65 x 16,384 and at C = 3 x 513 x 7501 (both with the frame
     axis split across blocks), and K2 (fused C = 2 AuxIVA-IP iteration,
     one launch) at 2 x 2049 x 469 and at 2 x 257 x 9000 (the frame axis
     streamed), each held against its plain PyTorch version on the same
     inputs and bit-identical across two launches; median times of 25
     launches by CUDA events, K1 also with L2 flushed before each launch,
     and K1's launch plan; then K3 (batched Hermitian eigensolver) at the
     main paths' batches (K3_CASES: Kondo's R at 1024 blocks, 2 x 469 x
     1024 of 3 x 3 complex64; Kondo at 256 blocks, 240,128 of 9 x 9; the
     C = 3 Riccati's 2049 x 469 of 3 x 3, full rank and rank 1; LDPSDTF's
     469 of 64 x 64 float32, at complex128, and of 128 x 128 on the
     workspace route) against its plain version: the eigenvalue error,
     |HV - VL| / |H| and |V^H V - I| (1e-5 single, 1e-10 double), NaN
     exactly for matrices given a non-finite entry, one launch a call,
     bit-identical launches; ms against the bound, the plain version and
     one torch.linalg.eigh call (cuSOLVER), and the sweeps taken; then K4
     (FastMNMF's row sweep and power normalisation) at 2049 bins, K = 10,
     C = 2, 3, 4 complex64 and C = 2 complex128 (K4_CASES) against its
     plain version under both guards (1e-4 single, 1e-10 double), one
     launch a call, bit-identical launches; ms against the bound and the
     plain version's chain; then K5 (FastMNMF's MU sweeps, K1's weights and
     the NLL's fit) at 2049 bins, 470 frames, C = 2 (K = 10) and 3 (K = 8)
     float32 and C = 2 float64 (K5_CASES), each entry against its plain version
     fused and with the statistics written for a mesh (1e-5 single, 1e-12
     double), one launch a call, bit-identical launches; ms against the
     bound and the plain version's chain;
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
     seed-111 init (CovarianceISNMF at C = 3: the first 5), neither K1 nor
     K2 launched (CovarianceISNMF at C = 3 runs its eigensolves on K3), ms
     and host ms per iteration, and the batched eigh's time;
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
     100 and Ozerov x 50 (no K1 or K2, SI-SDR within 0.1 dB of the port's CPU
     float64 run); for each, finite losses, the last below the first, the
     first 20 losses against the CPU float64 run (Sawada: the increments
     L_k - L_0 at 1e-4, its first loss and its output apart; Ozerov at its
     float32 tolerance) with a CPU float32 run's gaps beside, ms and host ms
     per iteration, the device's busy time (FastMNMF, Sawada); then on phase
     5's mixture FastMNMF x 20 (K1 per bin, N = 3), Sawada x 10 (the matrix
     Riccati on K3) and Ozerov x 10, finite;
 11. block-PSD through the entry points at n_basis = 2 from the seed-111
     init, on phase 3's mixture at the JAX benchmark rows' widths (1024
     blocks, B = 3): GaussIPSDTA Kondo x 20 (K1 per bin, N = 2, once per
     iteration), Ikeshita and TIPSDTA(nu=1000) x 20 (no K1); every
     eigensolve on K3; finite
     losses, the last below the first (not Ikeshita's), the SI-SDR, the
     first 5 losses against the port's CPU float64 run (Kondo at float32's
     gap; Ikeshita's first loss, its spike amplifying rounding after) with
     a CPU float32 run's gaps beside, ms and host ms
     per iteration, Kondo's device time; Kondo at 256 blocks (B = 9, the
     matrix route) x 20, K1 per bin every iteration, SI-SDR up by more than
     2 dB; Kondo x 5 on phase 5's mixture (the planes VCD at C = 3, K1 per
     bin with N = 3); LDPSDTF at K = 2 (the pencil) x 60 and K = 3 x 20 on
     the JAX benchmark's Gram targets (64 taps x 469 frames), the first 20
     losses against CPU float64 (at float32's gap), their eigensolves on
     K3, ms per iteration; then the off-default source routes at 1024 blocks x 5,
     each against its default route on the card at that row's float32
     hold: Kondo, Ikeshita and TIPSDTA(1000) with source_compact=False
     (the complex planes), Kondo and TIPSDTA with source_pencil=True (the
     K = 2 pencil streams, also held at float64: TIPSDTA at complex128 on
     the card, Kondo on the CPU, at tests/test_ipsdta.py's pencil holds);
     Kondo's K1 per bin 5 in 5 on every route; ms an iteration beside the
     default route's;
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
     ``build/phase12``; then auxiva_ip_step_components (no kernel) x 20
     from the identity on phase 3's mixture against K2 x 20 (20 in 20):
     each step's NLL within 1e-4, W within twice the runs' own float32 gap
     from CPU float64, its NLLs against the port's CPU float64 run;
 13. the profiling tools and the mesh (``torch.distributed``, one rank
     per device): ``benchmark_solver`` on the main path (1000 against 100
     iterations) beside phase 3's ms per iteration, and
     ``measure_memory_bandwidth`` beside the data sheet's 3.35 TB/s; then
     at world size 1 under NCCL in this process,
     AuxLaplaceIVA and AuxGaussIVA IP x 100 in bins mode on phase 3's
     mixture (K2 100 in 100, one all-reduce and no all-gather an
     iteration), AuxLaplaceIVA IP x 20 in frames mode (K1 20 in 20, no K2)
     and GaussILRMA(10) x 20 in bins mode (K1 per bin 20 in 20), each
     against the same call unsharded, batch_separate on a (1, 1) mesh and
     make_sharded_train_step x 100 against batched_auxiva_ip_step; then
     slice 10c's families in bins and frames mode, each against the same
     call unsharded (1e-5), with the collectives and ms an iteration sharded
     and unsharded: FastMultichannelISNMF(10) x 20 and GaussIDLMA with phase
     9's network x 20 (K1 per bin 20 in 20 each; IDLMA's bins mode
     gathers the network's input once an iteration), MNMF Sawada(10) x 5
     and Ozerov(10) x 10, ISNMF(10) and ComplexEUCNMF(10) x 50 on X[0],
     CovarianceISNMF(10) at C = 2 x 20, ProxLaplaceIVA x 50, and LDPSDTF at
     K = 2 x 20 in frames mode on phase 11's Gram target; at world
     size 2, two gloo ranks on the one card (spawned; they load phase 2's
     kernels): AuxLaplaceIVA IP x 100 with pad_bins (2049 bins, 1025 a rank
     through K2) and AuxGaussIVA IP x 100 on the first 2048 bins (1024 a
     rank through K2 with the whole bin count), AuxLaplaceIVA IP
     x 20 in frames mode on a seeded 470-frame mixture (235 a rank), Kondo
     GaussIPSDTA x 5 on the first 2048 bins in 1024 blocks (512 a rank, K1
     per bin), FastMNMF(10) x 20 on the first 2048 bins (K1 per bin 20 in
     20 a rank), GaussIDLMA x 20 in frames mode at 470 frames (K1 per bin
     20 in 20 a rank), CovarianceISNMF(10) x 20 at 2048 bins, ProxLaplaceIVA
     x 50 at 2048 bins and LDPSDTF(2) x 20 in frames mode at 470 frames,
     each against the same call unsharded here at its family's tolerance
     (slice 10c's outputs within 1e-3 of their largest entry), and the
     stages of ``tools/dryrun_multichip.py``;
 14. the cost model (``runtime/profiling.py::iteration_cost``, the count
     behind ``scan_cost_analysis``) at 2 x 2049 x 469 on phase 3's mixture
     (C = 3 on phase 5's): one iteration of AuxLaplaceIVA and AuxGaussIVA
     IP (K2), AuxLaplaceIVA IP at C = 3 (K1), GaussILRMA(10) IP,
     FastMultichannelISNMF(10), GaussIDLMA with phase 9's network and Kondo
     GaussIPSDTA (K1 per bin, K3 twice), LDPSDTF(2) on phase 11's Gram
     target (K3 twice), and with no kernel MNMF Sawada(10) and Ozerov(10),
     ISNMF(10) on |X[0]|^2, CovarianceISNMF(10) on the covariances,
     GradLaplaceFDICA and ProxLaplaceIVA; each counted on the card (the
     kernels' launches during the count equal its charges, as listed) and
     on the CPU at the card's dtype (equal on the K2 path, the ratio printed
     for the others), its rate by ``benchmark_solver`` (short windows above
     10 ms an iteration), and one line of bytes and FLOPs an iteration, GB/s,
     the share of phase 13's ``measure_memory_bandwidth`` reading and FLOP/s;
 15. the captured loop (``runtime/graph.py``: one step captured as a CUDA
     graph per signature and replayed) against the eager one
     (the same entry point with the step declared not capturable), on
     phase 3's mixture at 2 x 2049 x 469 (C = 3 on phase 5's, 4 mics on a
     seeded 4 x 2049 x 469 draw), the factorisation targets of phase 8 and
     phase 11's Gram targets: for each family (GRAPH_CASES: AuxLaplaceIVA
     and AuxGaussIVA IP at C = 2, K2, and C = 3, K1; ISS; IP2;
     GaussILRMA(10) IP, ISS and IP2; TILRMA; ConsistentGaussILRMA;
     FastMultichannelISNMF(10); the NMF models, ComplexEUCNMF and EUCNTF;
     and since K3 the gradient IVAs and FDICAs, OverAuxLaplaceIVA 4 -> 2
     (K2), ProxLaplaceIVA at C = 2, Sawada(10) at C = 2 and 3 (K3),
     Ozerov(10), CovarianceISNMF(10) at C = 2 and 3 (K3), GaussIDLMA with
     phase 9's network and jax_dnn=True (K1), Kondo GaussIPSDTA at 1024
     blocks (K1, K3), Ikeshita and TIPSDTA(1000) (K3), LDPSDTF at K = 2 and
     3 on 64 x 64 x 469 (K3)) x 20 (x 10 where the eager loop is slow,
     GRAPH_SLOW) from the same draws, one line: bits or gap (equal bits
     held on the K2 and K5 paths, 1e-5 elsewhere), the launches of K1, K2,
     K3, K4 and K5 per call as the eager loop's, one capture across two
     calls, ms an
     iteration for both by
     ``per_iteration``'s differencing, the replay's host ms and the capture
     seconds; ``batch_separate`` over AuxLaplaceIVA IP x 30 on 8 x 2 x 2049
     x 469 (one capture, mixtures/s against the eager loop's) and
     ``benchmark_solver`` on the main path, graph against eager.  Every
     earlier phase runs through the captured loop too;
 16. the script's seconds, one ``{"kernels": [...]}`` line (K1, K2 once
     per contrast, K3, K4, K5), then the last line ``{"ok": true, "device":
     {...}}``.

Phase 2 also holds K2's Gauss instance at both shapes, K2 (both contrasts)
on phase 13's shard of 1025 of 2050 padded bins with the whole count, K1 at C = 3 with
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
import torch.distributed as dist

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
    k1_cost,
    k1_launch_plan,
    weighted_covariance_planes,
    weighted_covariance_planes_plain,
)
from audio_source_separation_tpu_torch.ops.eigh_kernel import (
    batched_eigh,
    batched_eigh_plain,
    eigh_cost,
    k3_launch_plan,
)
from audio_source_separation_tpu_torch.ops.fused_ip import (
    fused_auxiva_ip_iter,
    fused_auxiva_ip_iter_plain,
    k2_cost,
    k2_launch_plan,
)
from audio_source_separation_tpu_torch.ops.mnmf_mu import ENTRIES as K5_ENTRIES
from audio_source_separation_tpu_torch.ops.mnmf_mu import fastmnmf_mu, fastmnmf_mu_plain, k5_cost
from audio_source_separation_tpu_torch.ops.mnmf_mu import takes as k5_takes
from audio_source_separation_tpu_torch.ops.mnmf_rows import fastmnmf_rows, fastmnmf_rows_plain, k4_cost
from audio_source_separation_tpu_torch.ops.ip_components import (
    _covariance_planes,
    auxiva_ip_step_components,
    pair_products_planes,
    separate_components,
)
from audio_source_separation_tpu_torch.parallel import (
    auxiva_ip_step,
    auxiva_ip_step_binsmajor,
    auxiva_ip_step_stacked,
    batch_separate,
    batched_auxiva_ip_step,
    make_mesh,
    make_mesh_2d,
    make_sharded_train_step,
)
from audio_source_separation_tpu_torch.parallel.mesh import (
    all_reduce_sum,
    collective_counts,
    mesh_device,
    reset_collective_counts,
)
from audio_source_separation_tpu_torch.runtime import benchmark_solver, measure_memory_bandwidth
from audio_source_separation_tpu_torch.runtime.profiling import _init_state, iteration_cost
from audio_source_separation_tpu_torch.tools import dryrun_multichip
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
# published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, f32 non-tensor;
# f64 through the FP64 tensor cores (the card's peak for the type), K3's
# bound on float64 and complex128 matrices
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
F64_FLOPS_PER_S = 67e12
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


def bound(n_bytes, n_flops, flops_per_s=F32_FLOPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / flops_per_s * 1e3
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
    bound_ms, bound_by = bound(*k1_cost(C, w.shape[0], F, T, per_bin, X.element_size(), w.element_size()))
    return {
        "C": C, "N": w.shape[0], "F": F, "T": T, "per_bin": per_bin, "plan": plan._asdict(),
        "max_abs_err": float((out - ref).abs().max()), "rel_err": err, **times,
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def k2_case(gen, F, T, contrast="laplace", n_bins=None):
    """K2 against its plain version, bit-identical across two launches, and
    their median times; ``n_bins`` is a bin-sharded caller's whole bin
    count (phase 13's shard of 1025 of 2050 padded bins)."""
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

    kw = {"eps": EPS, "threshold": THRESHOLD, "contrast": contrast, "n_bins": n_bins}
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
    bound_ms, bound_by = bound(*k2_cost(F, T, X.element_size()))
    return {
        "F": F, "T": T, "n_bins": n_bins or F, "contrast": contrast, "plan": k2_launch_plan(F, T)._asdict(),
        "max_abs_err": float(max((out[0] - ref[0]).abs().max(), (out[1] - ref[1]).abs().max())),
        "rel_err": {"W": w_err, "psum": p_err, "nll": nll_err},
        "ms": ms, "plain_ms": plain_ms, "library_ms": None,
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


# K4's cases at the FastMNMF cell's 2049 bins and K = 10, S = C sources:
# (C, type)
K4_CASES = [(2, torch.complex64), (3, torch.complex64), (4, torch.complex64), (2, torch.complex128)]
# K4 against its plain version, max |err| / max |plain| of each output
K4_RTOL = {torch.complex64: 1e-4, torch.complex128: 1e-10}


def k4_case(gen, C, dtype, F=2049, T=470, K=10):
    """K4 against its plain version, with the power normalisation, under
    both guards, on K1-shaped planes of a seeded mixture's covariances
    (weights over three decades) and a diagonaliser near the identity:
    bit-identical across two launches, one launch counted a call; median
    times of K4 and of the plain version's chain of small kernels, beside
    the bound from ``k4_cost``."""
    real = torch.float64 if dtype == torch.complex128 else torch.float32
    X = random_mixture(gen, C, F, T).to(dtype)
    w = 10.0 ** (3 * torch.rand((C, F, T), generator=gen, device="cuda") - 1.5)
    U = _covariance_planes(pair_products_planes(X), w.to(real)).contiguous()
    noise = torch.complex(
        torch.randn((F, C, C), generator=gen, device="cuda"), torch.randn((F, C, C), generator=gen, device="cuda")
    )
    Q = (torch.eye(C, device="cuda") + 0.3 * noise).to(dtype).contiguous()
    g = torch.rand((C, F, C), generator=gen, device="cuda").to(real)
    W = torch.rand((C, F, K), generator=gen, device="cuda").to(real)
    args = (U, Q, g, W, EPS, THRESHOLD)
    errs = {}
    for guard in ("one_norm", "none"):
        before = fastmnmf_rows.launches
        out = fastmnmf_rows(*args, guard=guard)
        again = fastmnmf_rows(*args, guard=guard)
        ref = fastmnmf_rows_plain(*args, guard=guard)
        torch.cuda.synchronize()
        assert fastmnmf_rows.launches == before + 2, ("K4 launches", fastmnmf_rows.launches - before)
        assert all(torch.equal(a, b) for a, b in zip(out, again)), ("K4 not bit-identical across launches", C, dtype)
        errs[guard] = max(rel_err(a, b) for a, b in zip(out, ref))
        assert math.isfinite(errs[guard]) and errs[guard] <= K4_RTOL[dtype], ("K4", C, dtype, guard, errs[guard])
    ms = median_ms(lambda: fastmnmf_rows(*args))
    plain_ms = median_ms(lambda: fastmnmf_rows_plain(*args))
    bound_ms, bound_by = bound(*k4_cost(C, C, K, F, True, Q.element_size()))
    return {
        "C": C, "S": C, "K": K, "F": F, "dtype": str(dtype).replace("torch.", ""), "rel_err": errs,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_us": bound_ms * 1e3, "bound_by": bound_by,
    }


# K5's cases at the FastMNMF cell's 2049 bins and 470 frames, S = C sources:
# (C, K, real type), K = 10 but at C = 3, where S K = 30 is past the
# kernel's 24; against its plain version, max |err| / max |plain|
K5_CASES = [(2, 10, torch.float32), (3, 8, torch.float32), (2, 10, torch.float64)]
K5_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def k5_case(gen, C, dtype, F=2049, T=470, K=10):
    """Each of K5's entries against its plain version on powers over five
    decades and uniform factors: bit-identical across two launches, one
    launch counted a call, the statistics written for a mesh as close as the
    fused update; median times of K5 and of the plain version's einsum
    chain, beside the bound from ``k5_cost``."""
    x = (10 ** (5 * torch.rand((C, F, T), generator=gen, device="cuda", dtype=torch.float64) - 3)).to(dtype)
    W, g, H = (
        (0.05 + 0.95 * torch.rand(shape, generator=gen, device="cuda", dtype=torch.float64)).to(dtype)
        for shape in ((C, F, K), (C, F, C), (C, K, T))
    )
    args = (x, W, g, H, EPS)
    entries = {}
    for entry in K5_ENTRIES:
        before = fastmnmf_mu.launches
        out = fastmnmf_mu(entry, *args)
        again = fastmnmf_mu(entry, *args)
        ref = fastmnmf_mu_plain(entry, *args)
        torch.cuda.synchronize()
        assert fastmnmf_mu.launches == before + 2, ("K5 launches", entry, fastmnmf_mu.launches - before)
        assert torch.equal(out, again), ("K5 not bit-identical across launches", entry, C, dtype)
        err = rel_err(out, ref)
        if entry in ("basis", "gains", "activation"):
            err = max(err, rel_err(fastmnmf_mu(entry, *args, whole=lambda sums: list(sums)), ref))
        assert math.isfinite(err) and err <= K5_RTOL[dtype], ("K5", entry, C, dtype, err)
        bound_ms, bound_by = bound(*k5_cost(entry, C, C, K, F, T, x.element_size()))
        entries[entry] = {
            "rel_err": err, "ms": median_ms(lambda: fastmnmf_mu(entry, *args)),
            "plain_ms": median_ms(lambda: fastmnmf_mu_plain(entry, *args)), "bound_ms": bound_ms, "bound_by": bound_by,
        }
    return {"C": C, "S": C, "K": K, "F": F, "T": T, "dtype": str(dtype).replace("torch.", ""), "entries": entries}


# K3 against its plain version (both at float64 arithmetic, the result at the
# input's type), relative to each matrix's largest eigenvalue modulus or norm
K3_RTOL = {torch.float32: 1e-5, torch.complex64: 1e-5, torch.float64: 1e-10, torch.complex128: 1e-10}
# K3's cases: the main paths' batches (name, batch shape, n, type, rank):
# Kondo's R at 1024 blocks (S, T, nb, B, B), Kondo at 256 blocks (its 9 x 9
# blocks), the C = 3 Riccati's (F, T, 3, 3), the same of rank 1 (Sawada's
# covariances x x^H), LDPSDTF's model covariances (T, 64, 64), the same at
# complex128, and at 128 taps, past the order a block holds in shared memory
# (the workspace route)
K3_CASES = [
    ("kondo_r_1024_blocks", (2, 469, 1024), 3, torch.complex64, None),
    ("kondo_256_blocks", (240_128,), 9, torch.complex64, None),
    ("riccati_c3", (2049, 469), 3, torch.complex64, None),
    ("sawada_rank1_c3", (2049, 469), 3, torch.complex64, 1),
    ("ldpsdtf_64", (469,), 64, torch.float32, None),
    ("ldpsdtf_64_complex128", (469,), 64, torch.complex128, None),
    ("ldpsdtf_128_workspace", (469,), 128, torch.float32, None),
]


def synced_ms(fn, reps=3):
    """Median of ``reps`` calls of ``fn`` by CUDA events around each, after
    one call: for calls that read on the host (``torch.linalg.eigh``), which
    ``median_ms``'s queue behind a spin kernel cannot hold."""
    fn()
    times = []
    for _ in range(reps):
        begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        begin.record()
        fn()
        end.record()
        end.synchronize()
        times.append(begin.elapsed_time(end))
    return float(np.median(times))


def hermitian_batch(gen, batch, n, dtype, rank=None):
    """PSD ``(*batch, n, n)`` matrices ``A diag(s) A^H`` with ``s`` spanning
    three decades, as the solvers' covariances do; ``A`` of ``rank``
    columns (default ``n``)."""
    complex_ = dtype.is_complex
    real = torch.float64 if dtype in (torch.float64, torch.complex128) else torch.float32
    rank = n if rank is None else rank
    shape = (*batch, n, rank)
    A = torch.randn(shape, generator=gen, device="cuda", dtype=real)
    if complex_:
        A = torch.complex(A, torch.randn(shape, generator=gen, device="cuda", dtype=real))
    s = 10.0 ** (3 * torch.rand((*batch, 1, rank), generator=gen, device="cuda", dtype=real) - 1.5)
    H = (A * s.to(A.dtype)) @ A.mH
    return ((H + H.mH) / 2).to(dtype).contiguous()


def k3_errors(H, w, V):
    """``(eigenvalue error, |HV - VL| / |H|, |V^H V - I|)``, each the
    largest over the batch, at double precision against the plain version."""
    wide = torch.complex128 if H.is_complex() else torch.float64
    w_ref = batched_eigh_plain(H.to(wide), vectors=False)
    wd = w.to(torch.float64)
    scale = w_ref.abs().amax(dim=-1, keepdim=True).clamp(min=1e-300)
    eig = float(((wd - w_ref).abs() / scale).max())
    Hd, Vd = H.to(wide), V.to(wide)
    norm = torch.linalg.matrix_norm(Hd).clamp(min=1e-300)
    resid = float((torch.linalg.matrix_norm(Hd @ Vd - Vd * wd[..., None, :].to(wide)) / norm).max())
    eye = torch.eye(H.shape[-1], dtype=wide, device=H.device)
    ortho = float((Vd.mH @ Vd - eye).abs().max())
    return eig, resid, ortho, float((wd - w_ref).abs().max())


def k3_case(gen, name, batch, n, dtype, rank):
    """K3 against its plain version on the card: the errors of
    :func:`k3_errors`, ascending eigenvalues, bit-identical across two
    launches, NaN exactly for the matrices given a non-finite entry, one
    launch counted a call; median times of K3, the plain version and one
    ``torch.linalg.eigh`` call (cuSOLVER) at the input's type (``None``,
    with the reason, where that call refuses the batch), beside the
    bound; the sweeps the matrices took."""
    H = hermitian_batch(gen, batch, n, dtype, rank)
    before = batched_eigh.launches
    w, V = batched_eigh(H)
    again = batched_eigh(H)
    values = batched_eigh(H, vectors=False)
    torch.cuda.synchronize()
    calls = batched_eigh.launches - before
    eig, resid, ortho, abs_err = k3_errors(H, w, V)
    bad = H.clone()
    flat = bad.reshape(-1, n, n)
    poisoned = [0, flat.shape[0] // 2, flat.shape[0] - 1]
    flat[poisoned[0], n - 1, 0] = float("nan")
    flat[poisoned[1], 0, n - 1] = float("inf")
    flat[poisoned[2], n // 2, n // 2] = float("-inf")
    w_bad, V_bad = batched_eigh(bad)
    mask = torch.zeros(flat.shape[0], dtype=torch.bool, device="cuda")
    mask[poisoned] = True
    w_bad, V_bad = w_bad.reshape(-1, n), V_bad.reshape(-1, n, n)
    nan_exact = bool(torch.isnan(w_bad[mask]).all() and torch.isnan(V_bad[mask]).all()
                     and torch.isfinite(w_bad[~mask]).all() and torch.isfinite(V_bad[~mask]).all())
    sweeps = torch.zeros(flat.shape[0], dtype=torch.int32, device="cuda")
    batched_eigh(H, sweeps=sweeps)
    rtol = K3_RTOL[dtype]
    checks = {
        "one launch a call": calls == 3,
        "finite (every matrix converged)": bool(torch.isfinite(w).all() and torch.isfinite(V).all()),
        "bit-identical across launches": torch.equal(w, again[0]) and torch.equal(V, again[1]),
        "eigenvalues alone as with vectors": torch.equal(values, w),
        "ascending": bool((w[..., 1:] >= w[..., :-1]).all()),
        "eigenvalues within {}".format(rtol): eig <= rtol,
        "|HV - VL| / |H| within {}".format(10 * rtol): resid <= 10 * rtol,
        "|V^H V - I| within {}".format(10 * rtol): ortho <= 10 * rtol,
        "NaN exactly for the non-finite matrices": nan_exact,
    }
    assert all(checks.values()), ("K3", name, {k: v for k, v in checks.items() if not v})
    ms = median_ms(lambda: batched_eigh(H), warmup=2, reps=10)
    plain_ms = synced_ms(lambda: batched_eigh_plain(H))
    try:
        library_ms, library_note = synced_ms(lambda: torch.linalg.eigh(H)), None
    except RuntimeError as err:  # cuSOLVER refuses some batches (ops/eigh_kernel.py::EIGH_CHUNK)
        library_ms, library_note = None, str(err).splitlines()[0][:200]
    matrices = flat.shape[0]
    rate = F32_FLOPS_PER_S if dtype in (torch.float32, torch.complex64) else F64_FLOPS_PER_S
    bound_ms, bound_by = bound(*eigh_cost(n, matrices, dtype.is_complex, True, H.element_size()), rate)
    return {
        "name": name, "batch": list(batch), "n": n, "rank": rank or n, "dtype": str(dtype).replace("torch.", ""),
        "plan": k3_launch_plan(n, matrices, dtype.is_complex, True)._asdict(),
        "eig_rel_err": eig, "residual": resid, "orthogonality": ortho, "max_abs_err": abs_err,
        "nan_exact": nan_exact, "launches": calls, "calls": 3, "tolerance": rtol,
        "sweeps_mean": float(sweeps.double().mean()), "sweeps_max": int(sweeps.max()),
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "library_note": library_note,
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
    counts_zero()
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
    counts_zero()
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
    counts_zero()
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
    counts_zero()
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
    counts_zero()
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
        **counts(),
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
        counts_zero()
        start = time.perf_counter()
        model = cls(n_basis=FACTOR_BASIS, **kw)
        factors = model(targets[target], iteration=iterations)
        torch.cuda.synchronize()
        loss = np.asarray(model.loss)
        res = out[key] = {
            "target_shape": list(targets[target].shape), "iterations": iterations,
            "wall_s": time.perf_counter() - start,
            **counts(),
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
    counts_zero()
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
# largest entry.  Sawada's output leaves float64 in a few bins where float32's
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
            "K4 launches": res["k4_launches"] == iterations * k1_per_iteration,
            # FastMNMF: four sweeps an iteration and one a loss, the first in the init
            "K5 launches": res["k5_launches"] == (5 * iterations + 1) * k1_per_iteration * k5_takes(2, 2, FACTOR_BASIS),
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
            "K4 launches": res["k4_launches"] == iterations * k1_per_iteration,
            # at C = 3, S K = 30 takes the plain version
            "K5 launches": res["k5_launches"] == (5 * iterations + 1) * k1_per_iteration * k5_takes(3, 3, FACTOR_BASIS),
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
# the off-default source routes at 1024 blocks (B = 3) x ITERS_ROUTE: key,
# class, kwargs, the route switches, K1 launches per iteration, the default
# row it is held against.  Each float32 run is held to its default row's
# float32 hold (IPSDTA_CASES: the losses it compares, at its tolerance).  The
# pencil's floors differ from the default route's by design, so it is held
# at float64 too, at the holds of
# tests/test_ipsdta.py::test_source_pencil_full_solver_trajectory (and its
# TIPSDTA twin; losses rtol, output atol and rtol): TIPSDTA at complex128 on
# the card against the default route at complex128, Kondo (whose K1 has no
# complex128 instance) on the CPU, its losses against the default row's CPU
# float64 run
ITERS_ROUTE = 5
IPSDTA_ROUTE_CASES = [
    ("kondo_planes", GaussIPSDTA, {"author": "Kondo"}, {"source_compact": False}, 1, "kondo"),
    ("ikeshita_planes", GaussIPSDTA, {"author": "Ikeshita"}, {"source_compact": False}, 0, "ikeshita"),
    ("t_nu1000_planes", TIPSDTA, {"nu": 1000}, {"source_compact": False}, 0, "t_nu1000"),
    ("kondo_pencil", GaussIPSDTA, {"author": "Kondo"}, {"source_pencil": True}, 1, "kondo"),
    ("t_nu1000_pencil", TIPSDTA, {"nu": 1000}, {"source_pencil": True}, 0, "t_nu1000"),
]
PENCIL_HOLDS = {"kondo": (1e-8, 1e-8, 1e-6), "t_nu1000": (3e-5, 1e-6, 1e-4)}


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


def with_switches(solver, switches):
    for switch, value in switches.items():
        setattr(solver, switch, value)
    return solver


def block_psd_routes(mixture, default_rows, failed):
    """The off-default IPSDTA source routes (``IPSDTA_ROUTE_CASES``) x 5 from
    the seed-111 init at 1024 blocks, each against its default route on the
    card: K1 per bin once a Kondo iteration on every route and never else,
    the losses against the default route's at that row's float32 hold (the
    output's gap beside), the pencil also at float64, ms an iteration (loss
    off) beside the default row's."""
    X64 = stft(mixture, fft_size=FFT_SIZE, hop_size=HOP_SIZE, device="cpu")
    runs, out = {}, {}

    def run(cls, kw, switches, precision):
        """A route's seeded run, made once: on the card at float32 (through
        ``drive``, counts included) or complex128, or on the CPU at float64
        (``IPSDTA_MATCH`` losses): ``(Y, loss, res)``."""
        key = (cls.__name__, tuple(kw.items()), tuple(switches.items()), precision)
        if key not in runs:
            make = lambda **more: with_switches(cls(n_basis=2, **kw, **more), switches)  # noqa: E731
            np.random.seed(SEED)
            if precision == "f32":
                _, Y, _, loss, res = seeded_drive(make, mixture, ITERS_ROUTE)
            elif precision == "c128":
                model = at_complex128(make())
                counts_zero()
                Y = model(X64.cuda(), iteration=ITERS_ROUTE)
                loss, res = np.asarray(model.loss), counts()
            else:
                model = make(device="cpu")
                Y = model(X64, iteration=IPSDTA_MATCH - 1)
                loss, res = np.asarray(model.loss), {}
            runs[key] = (Y.cpu(), loss, res)
        return runs[key]

    X = stft(mixture.astype(np.float32), fft_size=FFT_SIZE, hop_size=HOP_SIZE)
    for key, cls, kw, switches, k1_per_iteration, default in IPSDTA_ROUTE_CASES:
        row_start = time.perf_counter()
        Y, loss, res = run(cls, kw, switches, "f32")
        Y0, loss0, _ = run(cls, kw, {}, "f32")
        held, rtol = default_rows[default]["losses_held"], default_rows[default]["tolerance"]
        gaps = np.abs(loss - loss0) / np.abs(loss0)
        res = dict(res, switches=switches, default_row=default, output_gap_f32=output_gap(Y, Y0),
                   loss_gaps_f32=gaps.tolist(), losses_held=held, tolerance=rtol)  # fmt: skip
        checks = {
            "K1 {} in {}".format(ITERS_ROUTE * k1_per_iteration, ITERS_ROUTE):
            res["k1_launches"] == ITERS_ROUTE * k1_per_iteration and res["k2_launches"] == 0,
            "loss length": len(loss) == ITERS_ROUTE + 1,
            "losses {} within {} of the default route's".format(held, rtol): gaps[held].max() <= rtol,
        }  # fmt: skip
        if "source_pencil" in switches:
            rtol64, atol_out, rtol_out = PENCIL_HOLDS[default]
            res["holds_f64"] = PENCIL_HOLDS[default]
            if k1_per_iteration:  # on the CPU, against the default row's CPU float64 losses
                start = time.perf_counter()
                _, loss64, _ = run(cls, kw, switches, "cpu")
                ref = np.asarray(default_rows[default]["cpu_f64_losses"])
                res["loss_gaps_cpu_f64"] = (np.abs(loss64 - ref) / np.abs(ref)).tolist()
                res["cpu_s"] = time.perf_counter() - start
            else:
                Y64, loss64, _ = run(cls, kw, switches, "c128")
                Y064, loss064, _ = run(cls, kw, {}, "c128")
                res["loss_gaps_c128"] = (np.abs(loss64 - loss064) / np.abs(loss064)).tolist()
                res["output_gap_c128"] = output_gap(Y64, Y064)
                checks["complex128 output within atol {} rtol {}".format(atol_out, rtol_out)] = bool(
                    torch.all((Y64 - Y064).abs() <= atol_out + rtol_out * Y064.abs())
                )
            float64_gaps = res.get("loss_gaps_cpu_f64", res.get("loss_gaps_c128"))
            checks["float64 losses within {} of the default route's".format(rtol64)] = max(float64_gaps) <= rtol64
        record_checks(failed, "route_" + key, checks)
        make = lambda recordable_loss, cls=cls, kw=kw, switches=switches: with_switches(  # noqa: E731
            cls(n_basis=2, recordable_loss=recordable_loss, **kw), switches
        )
        np.random.seed(SEED)
        res["per_iter_loss_off"] = per_iteration(X, False, make, *IPSDTA_TIMING)
        res["default_per_iter_loss_off"] = default_rows[default]["per_iter_loss_off"]
        res["row_s"] = time.perf_counter() - row_start
        out[key] = res
    return out


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
            gaps=gaps["card"].tolist(), cpu_f32_gaps=gaps["f32"].tolist(), tolerance=rtol, cpu_f64_losses=ref.tolist(),
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

    start = time.perf_counter()
    out["routes"] = block_psd_routes(mixture, out, failed)
    out["routes"]["phase_s"] = time.perf_counter() - start

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
        counts_zero()
        torch.cuda.synchronize()
        start = time.perf_counter()
        model = LDPSDTF(n_basis=n_basis)
        factors = model(target, iteration=iterations)
        torch.cuda.synchronize()
        loss = np.asarray(model.loss)
        res = out[key] = {
            "target_shape": list(target.shape), "iterations": iterations, "wall_s": time.perf_counter() - start,
            **counts(),
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
    batched_eigh.launches = 0
    fastmnmf_rows.launches = 0
    fastmnmf_mu.launches = 0
    torch.cuda.synchronize()


def counts():
    return {
        "k1_launches": weighted_covariance_planes.launches, "k2_launches": fused_auxiva_ip_iter.launches,
        "k3_launches": batched_eigh.launches, "k4_launches": fastmnmf_rows.launches,
        "k5_launches": fastmnmf_mu.launches,
    }


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
        if key == "batch_fast_mnmf_c2":  # K5: four sweeps and a loss a step (a member records no initial loss)
            checks["K5 {} in {}".format(BATCH * 5 * ITERS_BATCH, BATCH * ITERS_BATCH)] = (
                res["k5_launches"] == BATCH * 5 * ITERS_BATCH
            )
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


ITERS_COMPONENTS = N_MATCH  # auxiva_ip_step_components against K2, and its CPU float64 reference


def components_row(X, X_cpu, failed):
    """``auxiva_ip_step_components`` (the plain AuxIVA-IP iteration in
    component layout) x 20 from the identity on phase 3's mixture against K2
    x 20 from the same start: each step's NLL, and ``W`` at the end held to
    twice the larger of the two runs' own distance from the CPU float64
    run's; its 20 NLLs against the port's CPU float64 run."""
    start = time.perf_counter()
    X = X.contiguous()  # K2 takes a contiguous mixture
    F = X.shape[1]

    def components(X_, n):
        eye = torch.eye(2, dtype=X_.dtype, device=X_.device)
        rows = [[eye[n, c].expand(F) for c in range(2)] for n in range(2)]
        Y, planes, nlls = X_, pair_products_planes(X_), []
        for _ in range(n):
            rows, Y, nll = auxiva_ip_step_components(X_, rows, Y, planes, eps=EPS, threshold=THRESHOLD)
            nlls.append(nll)
        return torch.stack([torch.stack(row) for row in rows]), torch.stack(nlls).cpu().numpy()

    def fused(X_, n):
        W = torch.eye(2, dtype=X_.dtype, device=X_.device)[:, :, None].expand(2, 2, F).contiguous()
        psum = (X_.abs() ** 2).sum(dim=1).contiguous()
        nlls = []
        for _ in range(n):
            W, psum, _, nll = fused_auxiva_ip_iter(X_, W, psum, eps=EPS, threshold=THRESHOLD)
            nlls.append(nll)
        return W, torch.stack(nlls).cpu().numpy()

    counts_zero()
    step_start = time.perf_counter()
    W_c, nll_c = components(X, ITERS_COMPONENTS)  # the NLLs' transfer synchronises
    components_ms = (time.perf_counter() - step_start) * 1e3 / ITERS_COMPONENTS
    components_counts = counts()
    counts_zero()
    step_start = time.perf_counter()
    W_k, nll_k = fused(X, ITERS_COMPONENTS)
    k2_ms = (time.perf_counter() - step_start) * 1e3 / ITERS_COMPONENTS
    res = {"steps": ITERS_COMPONENTS, "components_counts": components_counts, **counts(),
           "components_ms_per_step": components_ms, "k2_ms_per_step": k2_ms}  # fmt: skip
    W64, nll64 = components(X_cpu, ITERS_COMPONENTS)
    W64_k, _ = fused(X_cpu, ITERS_COMPONENTS)  # K2's plain version at float64
    w_gap, own = rel_err(W_c, W_k), max(rel_err(W_c.cpu().to(W64.dtype), W64), rel_err(W_k.cpu().to(W64.dtype), W64_k))
    nll_gaps, cpu_gaps = np.abs(nll_c - nll_k) / np.abs(nll_k), np.abs(nll_c - nll64) / np.abs(nll64)
    res.update(w_gap=w_gap, w_own_f32_gap=own, nll_gaps_vs_k2=nll_gaps.tolist(),
               nll_vs_cpu_f64_max_rel=float(cpu_gaps.max()), nll_first=float(nll_c[0]), nll_last=float(nll_c[-1]),
               row_s=time.perf_counter() - start)  # fmt: skip
    record_checks(failed, "auxiva_ip_step_components", {
        "K2 {0} in {0}".format(ITERS_COMPONENTS): res["k2_launches"] == ITERS_COMPONENTS and res["k1_launches"] == 0,
        "no kernel in the components' steps": components_counts["k1_launches"] == components_counts["k2_launches"] == 0,
        "NLLs within {} of K2's".format(LOSS_MATCH_RTOL): nll_gaps.max() <= LOSS_MATCH_RTOL,
        "W within twice the runs' own float32 gap of K2's": w_gap <= 2 * own,
        "NLLs within {} of CPU float64".format(LOSS_MATCH_RTOL): cpu_gaps.max() <= LOSS_MATCH_RTOL,
        "finite": bool(np.isfinite(nll_c).all() and torch.isfinite(W_c).all()),
    })  # fmt: skip
    return res


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


# --------------------------------------------------------------------------- #
# phase 13: the mesh (torch.distributed), profiling
# --------------------------------------------------------------------------- #
ITERS_MESH, ITERS_MESH_SHORT, ITERS_MESH_IPSDTA = 100, 20, 5
ITERS_MESH_SAWADA, ITERS_MESH_OZEROV, ITERS_MESH_FACTOR = 5, 10, 50
# world size 2 against the unsharded call, slice 10c's outputs: the float32
# order of the shards' sums, amplified by the per-bin solves (this phase's
# IVA rows read up to 1.9e-4 of the largest entry on an H100).  CovarianceISNMF's
# float32 Riccati chain is ill-conditioned in some bins (its float32 loss
# leaves float64 by up to 0.15, phase 8): a 1e-7 change of its sums' order
# moved its factors by 0.11 of their largest entry on an H100, so its
# float32 output is held to twice the larger of the two calls' own distance
# from the same call at complex128 on the card, and the sharded call at
# complex128 to that distance
MESH_W2_OUTPUT_RTOL = 1e-3
WORLD2_F64_WITNESS = ("cov_isnmf_bins",)
N_SAMPLES_470 = 960_512  # 470 frames at stft(4096, 2048): 235 a rank
MESH_W1_RTOL = 1e-5  # world size 1 against the unsharded call: the same kernels, the NLL by another formula
# 900 differenced iterations: 400 against 40 left the window on an H100
# under the 10 ms below which benchmark_solver warns of jitter
BENCH_ITERS, BENCH_SHORT = 1000, 100


def mesh_counts_zero():
    counts_zero()
    reset_collective_counts()


def mesh_counts():
    return {**counts(), **collective_counts()}


def output_gap(a, b):
    """The largest gap of ``a`` to ``b`` relative to ``b``'s largest entry;
    of factor models' outputs (tuples), the largest over the factors."""
    if isinstance(b, tuple):
        return max(output_gap(x, y) for x, y in zip(a, b))
    a, b = torch.as_tensor(a).cpu(), torch.as_tensor(b).cpu()
    return float((a - b).abs().max() / b.abs().max())


def output_shapes(Y):
    """The shape of an output, or of each factor of a factor model's."""
    return [tuple(p.shape) for p in Y] if isinstance(Y, tuple) else tuple(Y.shape)


def loss_gap(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b) / np.abs(b)))


def mesh_call(make, X, iteration, mesh=None, mode="bins", pad=False, **call):
    """``make()(X, iteration, **call)`` from the seed-111 init, under
    ``mesh`` where given; the output on the host (a factor model's factors
    as a tuple), the losses, the kernels' and the collectives' counts (set
    to 0 just before, read just after) and the seconds."""
    np.random.seed(SEED)
    solver = make()
    if mesh is not None:
        solver.use_mesh(mesh, mode=mode, pad_bins=pad)
    mesh_counts_zero()
    start = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # Ozerov's "in progress"
        Y = solver(X, iteration=iteration, **call)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    loss = np.asarray(solver.loss)
    pieces = Y if isinstance(Y, tuple) else (Y,)
    assert np.isfinite(loss).all() and all(bool(torch.isfinite(p).all()) for p in pieces), "non-finite loss or output"
    Y = tuple(p.cpu() for p in pieces) if isinstance(Y, tuple) else Y.cpu()
    return Y, loss, {"iterations": iteration, "seconds": seconds, **mesh_counts()}


def mesh_per_iteration(make, X, mesh=None, mode="bins", pad=False, n=ITERS_MESH, **call):
    """All-reduces, all-gathers and ms an iteration (loss on): an
    ``n``-iteration call less a 0-iteration call, the least of two each
    (init, the gathers and finalize cancel)."""
    runs = {k: [mesh_call(make, X, k, mesh, mode, pad, **call)[2] for _ in range(2)] for k in (0, n)}
    per = {k: (runs[n][0][k] - runs[0][0][k]) / n for k in ("all_reduce", "all_gather")}
    per["ms"] = (min(r["seconds"] for r in runs[n]) - min(r["seconds"] for r in runs[0])) * 1e3 / n
    return per


def all_reduce_ms(mesh, numel, reps=100):
    """Host-clock ms of one all-reduce of ``numel`` float32 on the card over
    ``mesh``'s sharding group, synchronised after ``reps`` of them."""
    group = mesh.get_group(mesh.mesh_dim_names[-1])
    x = torch.ones(numel, device=mesh_device(mesh))
    all_reduce_sum(x, group)
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(reps):
        all_reduce_sum(x, group)
    torch.cuda.synchronize()
    return (time.perf_counter() - start) * 1e3 / reps


def slice_10c_rows(X):
    """Slice 10c's world-1 rows on phase 3's mixture: ``(key, make, input,
    iterations, mode, call, K1 launches per iteration)``, with phase 9's
    benchmark network and phase 8's and 11's targets."""
    W1, W2 = variance_mlp_weights(X.shape[1])
    idlma_call = {"dnn": torch_dnn(VarianceMLP(W1, W2).cuda())}
    fast = functools.partial(FastMultichannelISNMF, n_basis=BATCH_BASIS)
    sawada = functools.partial(MultichannelISNMF, n_basis=FACTOR_BASIS)
    ozerov = functools.partial(MultichannelISNMF, n_basis=FACTOR_BASIS, author="Ozerov")
    isnmf = functools.partial(ISNMF, n_basis=FACTOR_BASIS)
    complex_euc = functools.partial(ComplexEUCNMF, n_basis=FACTOR_BASIS)
    cov = functools.partial(CovarianceISNMF, n_basis=FACTOR_BASIS)
    targets = factor_targets(X, X)
    gram = torch.as_tensor(gram_target(2, X.shape[-1]), dtype=torch.float32, device=X.device)
    rows = []
    for mode in ("bins", "frames"):
        rows += [
            ("fastmnmf_" + mode, fast, X, ITERS_MESH_SHORT, mode, {}, 1),
            ("idlma_" + mode, GaussIDLMA, X, ITERS_MESH_SHORT, mode, idlma_call, 1),
            ("sawada_" + mode, sawada, X, ITERS_MESH_SAWADA, mode, {}, 0),
            ("ozerov_" + mode, ozerov, X, ITERS_MESH_OZEROV, mode, {}, 0),
            ("isnmf_" + mode, isnmf, targets["power"], ITERS_MESH_FACTOR, mode, {}, 0),
            ("complex_eucnmf_" + mode, complex_euc, targets["spectrogram"], ITERS_MESH_FACTOR, mode, {}, 0),
            ("cov_isnmf_" + mode, cov, targets["covariance"], ITERS_MESH_SHORT, mode, {}, 0),
            ("prox_" + mode, ProxLaplaceIVA, X, ITERS_MESH_FACTOR, mode, {}, 0),
        ]
    return rows + [("ldpsdtf_frames", functools.partial(LDPSDTF, n_basis=2), gram, ITERS_MESH_SHORT, "frames", {}, 0)]


def slice_10c_world_one(X, mesh, failed):
    """Slice 10c's families at world size 1: each call against the same call
    unsharded (output and losses within ``MESH_W1_RTOL``), its K1 count,
    the collectives an iteration (no all-gather in the loop but GaussIDLMA's
    network input in bins mode, one), ms an iteration sharded and
    unsharded."""
    start = time.perf_counter()
    out = {}
    for key, make, Xk, iteration, mode, call, k1_per_iteration in slice_10c_rows(X):
        Y, loss, res = mesh_call(make, Xk, iteration, mesh, mode, **call)
        Y1, loss1, single = mesh_call(make, Xk, iteration, **call)
        res.update(mode=mode, shape=list(Xk.shape), output_gap=output_gap(Y, Y1), loss_gap=loss_gap(loss, loss1),
                   unsharded_seconds=single["seconds"],
                   per_iteration=mesh_per_iteration(make, Xk, mesh, mode, n=iteration, **call),
                   unsharded_per_iteration=mesh_per_iteration(make, Xk, n=iteration, **call))  # fmt: skip
        out[key] = res
        gathers = 1 if key == "idlma_bins" else 0
        k5 = 5 * iteration + 1 if key.startswith("fastmnmf") else 0  # four sweeps and a loss a step, a loss at init
        record_checks(failed, "mesh_w1_" + key, {
            "K1 {} in {}, no K2".format(iteration * k1_per_iteration, iteration):
            res["k1_launches"] == iteration * k1_per_iteration and res["k2_launches"] == 0,
            "K5 {} in {}".format(k5, iteration): res["k5_launches"] == k5,
            "{} all-gather an iteration".format(gathers): res["per_iteration"]["all_gather"] == gathers,
            "an all-reduce an iteration": res["per_iteration"]["all_reduce"] >= 1,
            "output and losses within {}".format(MESH_W1_RTOL): max(res["output_gap"], res["loss_gap"]) <= MESH_W1_RTOL,
        })  # fmt: skip
    out["phase_s"] = time.perf_counter() - start
    return out


def mesh_world_one(X, failed):
    """World size 1 under NCCL, in this process: AuxLaplaceIVA and
    AuxGaussIVA IP x 100 in bins mode, AuxLaplaceIVA IP x 20 in frames mode,
    GaussILRMA(10) x 20 in bins mode, batch_separate on a (1, 1) mesh and
    the sharded train step x 100, each against the same call unsharded."""
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    out = {}
    try:
        mesh = make_mesh(axis_name="bins")
        out["all_reduce_ms_939_floats"] = all_reduce_ms(mesh, 2 * X.shape[-1] + 1)
        for key, make in (("laplace_ip_bins", AuxLaplaceIVA), ("gauss_ip_bins", AuxGaussIVA)):
            Y, loss, res = mesh_call(make, X, ITERS_MESH, mesh)
            Y1, loss1, single = mesh_call(make, X, ITERS_MESH)
            res.update(per_iteration=mesh_per_iteration(make, X, mesh), unsharded_per_iteration=mesh_per_iteration(make, X),
                       output_gap=output_gap(Y, Y1), loss_gap=loss_gap(loss, loss1),
                       unsharded_seconds=single["seconds"])  # fmt: skip
            out[key] = res
            record_checks(failed, "mesh_w1_" + key, {
                "K2 {0} in {0}".format(ITERS_MESH): res["k2_launches"] == ITERS_MESH and res["k1_launches"] == 0,
                "one all-reduce an iteration": res["per_iteration"]["all_reduce"] == 1,
                "no all-gather in the loop": res["per_iteration"]["all_gather"] == 0,
                "output and losses within {}".format(MESH_W1_RTOL):
                max(res["output_gap"], res["loss_gap"]) <= MESH_W1_RTOL,
            })  # fmt: skip
        Y, loss, res = mesh_call(AuxLaplaceIVA, X, ITERS_MESH_SHORT, mesh, "frames")
        Y1, loss1, _ = mesh_call(AuxLaplaceIVA, X, ITERS_MESH_SHORT)
        res.update(output_gap=output_gap(Y, Y1), loss_gap=loss_gap(loss, loss1),
                   per_iteration=mesh_per_iteration(AuxLaplaceIVA, X, mesh, "frames", n=ITERS_MESH_SHORT))
        out["laplace_ip_frames"] = res
        record_checks(failed, "mesh_w1_laplace_ip_frames", {
            "K1 {0} in {0}, no K2".format(ITERS_MESH_SHORT):
            res["k1_launches"] == ITERS_MESH_SHORT and res["k2_launches"] == 0,
            "losses within {} of the K2 route's".format(LOSS_MATCH_RTOL): res["loss_gap"] <= LOSS_MATCH_RTOL,
        })  # fmt: skip
        ilrma = functools.partial(GaussILRMA, n_basis=BATCH_BASIS)
        Y, loss, res = mesh_call(ilrma, X, ITERS_MESH_SHORT, mesh)
        Y1, loss1, single = mesh_call(ilrma, X, ITERS_MESH_SHORT)
        res.update(output_gap=output_gap(Y, Y1), loss_gap=loss_gap(loss, loss1), unsharded_seconds=single["seconds"])
        out["gauss_ilrma_bins"] = res
        record_checks(failed, "mesh_w1_gauss_ilrma_bins", {
            "K1 per bin {0} in {0}".format(ITERS_MESH_SHORT): res["k1_launches"] == ITERS_MESH_SHORT,
            "output and losses within {}".format(MESH_W1_RTOL):
            max(res["output_gap"], res["loss_gap"]) <= MESH_W1_RTOL,
        })  # fmt: skip

        mesh2 = make_mesh_2d()
        Xs = torch.stack([X, X.flip(0)]).contiguous()
        mesh_counts_zero()
        outputs, losses = batch_separate(AuxLaplaceIVA(), Xs, ITERS_MESH_SHORT, mesh=mesh2, host=False)
        res = mesh_counts()
        single = batch_separate(AuxLaplaceIVA(), Xs, ITERS_MESH_SHORT, host=False)
        res.update(members=2, output_gap=output_gap(outputs, single[0]), loss_gap=loss_gap(losses.cpu(), single[1].cpu()))
        out["batch_separate_1x1"] = res
        record_checks(failed, "mesh_w1_batch_separate", {
            "K2 {} in {}".format(2 * ITERS_MESH_SHORT, 2 * ITERS_MESH_SHORT): res["k2_launches"] == 2 * ITERS_MESH_SHORT,
            "output and losses within {}".format(MESH_W1_RTOL):
            max(res["output_gap"], res["loss_gap"]) <= MESH_W1_RTOL,
        })  # fmt: skip

        step, _, _ = make_sharded_train_step(mesh2)
        X2 = torch.stack([Xs.real, Xs.imag], dim=1).contiguous()
        eye = torch.eye(2, device=X.device)
        W2 = torch.stack([eye.expand(X.shape[1], 2, 2), torch.zeros_like(eye).expand(X.shape[1], 2, 2)])
        W_sh = W_ref = W2.expand(2, *W2.shape).contiguous()
        mesh_counts_zero()
        start = time.perf_counter()
        for _ in range(ITERS_MESH):
            W_sh, nll_sh = step(X2, W_sh)
        torch.cuda.synchronize()
        res = {"steps": ITERS_MESH, "ms_per_step": (time.perf_counter() - start) * 1e3 / ITERS_MESH, **mesh_counts()}
        for _ in range(ITERS_MESH):
            W_ref, nll_ref = batched_auxiva_ip_step(X2, W_ref)
        res.update(w_gap=output_gap(W_sh, W_ref), nll_gap=loss_gap(nll_sh.cpu(), nll_ref.cpu()))
        out["train_step_1x1"] = res
        record_checks(failed, "mesh_w1_train_step", {
            "W and NLL within {}".format(MESH_W1_RTOL): max(res["w_gap"], res["nll_gap"]) <= MESH_W1_RTOL,
            "finite": bool(torch.isfinite(W_sh).all() and torch.isfinite(nll_sh).all()),
        })
        out["slice_10c"] = slice_10c_world_one(X, mesh, failed)
    finally:
        dist.destroy_process_group()
    return out


def mesh_rank(rank, world, store, workdir):
    """One of phase 13's gloo ranks, both on ``cuda:0``: the sharded calls
    of :func:`mesh_world_two` and the dry run's stages; rank 0 saves the
    outputs, losses and counts."""
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method="file://" + str(store), rank=rank, world_size=world)
    try:
        mesh = make_mesh(axis_name="bins")
        inputs = torch.load(workdir / "inputs.pt")
        X, X470 = inputs["X"].cuda(), inputs["X470"].cuda()
        saved = {"all_reduce_ms_939_floats": all_reduce_ms(mesh, 2 * X.shape[-1] + 1)}
        for key, make, Xk, iteration, mode, pad, call in mesh_world_two_calls(X, X470):
            Y, loss, res = mesh_call(make, Xk, iteration, mesh, mode, pad, **call)
            saved[key] = {"output": Y, "loss": loss, **res}
            # init's and finalize's gathers: the loop's are the difference
            saved[key]["all_gather_no_loop"] = mesh_call(make, Xk, 0, mesh, mode, pad, **call)[2]["all_gather"]
            if key in WORLD2_F64_WITNESS:
                witness = functools.partial(lambda make: at_complex128(make()), make)
                saved[key]["output_c128"] = mesh_call(witness, Xk, iteration, mesh, mode, pad, **call)[0]
            if key == "laplace_ip_bins_pad":
                saved[key]["per_iteration"] = mesh_per_iteration(make, Xk, mesh, mode, pad)
        start = time.perf_counter()
        report, _ = dryrun_multichip.stages(world, "cuda")
        saved["dryrun_multichip"] = {"stages": report, "seconds": time.perf_counter() - start}
        if rank == 0:
            torch.save(saved, workdir / "world2.pt")
    finally:
        dist.destroy_process_group()


# the world-2 calls' K1 launches per iteration a rank (K2 for the IVA IP
# bins calls, one)
WORLD2_K1 = {"laplace_ip_frames": 1, "kondo_bins": 1, "fastmnmf_bins": 1, "idlma_frames": 1, "cov_isnmf_bins": 0,
             "prox_bins": 0, "ldpsdtf_frames": 0}  # fmt: skip


def mesh_world_two_calls(X, X470):
    """``(key, make, input, iterations, mode, pad_bins, call)`` of each
    world-2 call."""
    kondo = functools.partial(GaussIPSDTA, n_basis=2, n_blocks=1024)
    # the Gauss contrast divides by the bin count, so padded bins are not
    # neutral for it (it takes no padding, as in the JAX package): 2048 bins
    even = X[:, :2048].contiguous()
    W1, W2 = variance_mlp_weights(X470.shape[1])
    gram = torch.as_tensor(gram_target(2, X470.shape[-1]), dtype=torch.float32, device=X.device)
    return [
        ("laplace_ip_bins_pad", AuxLaplaceIVA, X, ITERS_MESH, "bins", True, {}),
        ("gauss_ip_bins", AuxGaussIVA, even, ITERS_MESH, "bins", False, {}),
        ("laplace_ip_frames", AuxLaplaceIVA, X470, ITERS_MESH_SHORT, "frames", False, {}),
        ("kondo_bins", kondo, even, ITERS_MESH_IPSDTA, "bins", False, {}),
        # slice 10c
        ("fastmnmf_bins", functools.partial(FastMultichannelISNMF, n_basis=BATCH_BASIS), even, ITERS_MESH_SHORT,
         "bins", False, {}),
        ("idlma_frames", GaussIDLMA, X470, ITERS_MESH_SHORT, "frames", False,
         {"dnn": torch_dnn(VarianceMLP(W1, W2).to(X.device))}),
        ("cov_isnmf_bins", functools.partial(CovarianceISNMF, n_basis=FACTOR_BASIS),
         torch.einsum("cft,dft->ftcd", even, even.conj()).contiguous(), ITERS_MESH_SHORT, "bins", False, {}),
        ("prox_bins", ProxLaplaceIVA, even, ITERS_MESH_FACTOR, "bins", False, {}),
        ("ldpsdtf_frames", functools.partial(LDPSDTF, n_basis=2), gram, ITERS_MESH_SHORT, "frames", False, {}),
    ]  # fmt: skip


def mesh_world_two(X, X470, failed):
    """World size 2 on the one card: two gloo ranks on ``cuda:0`` (NCCL
    refuses two ranks on one card; gloo takes the CUDA tensors as they are);
    each sharded call against the same call unsharded here, at its family's
    tolerance (PERF.md section 2)."""
    workdir = ROOT / "build" / "phase13"
    workdir.mkdir(parents=True, exist_ok=True)
    torch.save({"X": X.cpu(), "X470": X470.cpu()}, workdir / "inputs.pt")
    store = workdir / "store"
    store.unlink(missing_ok=True)
    start = time.perf_counter()
    torch.multiprocessing.spawn(mesh_rank, args=(2, store, workdir), nprocs=2)
    spawn_s = time.perf_counter() - start
    saved = torch.load(workdir / "world2.pt", weights_only=False)
    out = {"spawn_s": spawn_s, "dryrun_multichip": saved.pop("dryrun_multichip"),
           "all_reduce_ms_939_floats_rank0": saved.pop("all_reduce_ms_939_floats")}
    for key, make, Xk, iteration, mode, pad, call in mesh_world_two_calls(X, X470):
        res = saved[key]
        Y1, loss1, single = mesh_call(make, Xk, iteration, **call)
        n = IPSDTA_MATCH if key == "kondo_bins" else N_MATCH
        rtol = 1e-3 if key == "kondo_bins" else LOSS_MATCH_RTOL
        out[key] = {k: v for k, v in res.items() if k not in ("output", "loss", "output_c128")}
        out[key].update(mode=mode, pad_bins=pad, shape=list(Xk.shape), output_gap=output_gap(res["output"], Y1),
                        loss_gap=loss_gap(res["loss"][:n], loss1[:n]), losses_compared=n,
                        unsharded_seconds=single["seconds"], unsharded_k1=single["k1_launches"],
                        unsharded_k2=single["k2_launches"])  # fmt: skip
        checks = {
            "output shape": output_shapes(res["output"]) == output_shapes(Y1),
            "first {} losses within {}".format(n, rtol): out[key]["loss_gap"] <= rtol,
            "no all-gather in the loop": res["all_gather"] == res["all_gather_no_loop"],
        }
        if key.endswith(("_ip_bins_pad", "_ip_bins")):
            checks["K2 {0} in {0} a rank".format(iteration)] = res["k2_launches"] == iteration
        else:
            k1 = iteration * WORLD2_K1[key]
            checks["K1 {} in {} a rank, no K2".format(k1, iteration)] = (
                res["k1_launches"] == k1 and res["k2_launches"] == 0
            )
        if key in WORLD2_F64_WITNESS:
            Y1_64 = mesh_call(lambda make=make: at_complex128(make()), Xk, iteration, **call)[0]
            own = max(output_gap(Y1, Y1_64), output_gap(res["output"], res["output_c128"]))
            out[key].update(own_f32_vs_c128=own, output_gap_c128=output_gap(res["output_c128"], Y1_64))
            checks["output within twice the calls' own float32 gap"] = out[key]["output_gap"] <= 2 * own
            checks["complex128 output within that gap"] = out[key]["output_gap_c128"] <= own
        elif key in ("fastmnmf_bins", "idlma_frames", "prox_bins", "ldpsdtf_frames"):
            checks["output within {}".format(MESH_W2_OUTPUT_RTOL)] = out[key]["output_gap"] <= MESH_W2_OUTPUT_RTOL
        record_checks(failed, "mesh_w2_" + key, checks)
    return out


def profiling_rows(X, c2):
    """benchmark_solver on the main path beside phase 3's per-iteration ms
    (loss off), and measure_memory_bandwidth beside the data sheet's."""
    ips, first_s = benchmark_solver(AuxLaplaceIVA(), X, iteration=BENCH_ITERS, short=BENCH_SHORT)
    gbps = measure_memory_bandwidth()
    return {
        "benchmark_solver_iters_per_s": ips, "benchmark_solver_ms": 1e3 / ips, "benchmark_first_call_s": first_s,
        "phase3_per_iter_loss_off_ms": c2["per_iter_loss_off"]["ms"],
        "memory_bandwidth_gb_s": gbps, "datasheet_gb_s": HBM_BYTES_PER_S / 1e9,
        "share_of_datasheet": gbps / (HBM_BYTES_PER_S / 1e9),
    }


def mesh_phase(X, c2, failed):
    """Phase 13: the profiling tools on the main path, then world size 1
    under NCCL and world size 2 on the one card over gloo."""
    start = time.perf_counter()
    profiling = profiling_rows(X, c2)
    rng = np.random.RandomState(SEED + 13)
    mixture470, _ = synth_mixture(rng, 2, N_SAMPLES_470)
    X470 = stft(mixture470.astype(np.float32), fft_size=FFT_SIZE, hop_size=HOP_SIZE)
    assert X470.shape[-1] == 470, X470.shape
    out = {"world_1_nccl": mesh_world_one(X, failed)}
    out["world_2_gloo"] = mesh_world_two(X, X470, failed)
    out["profiling"] = profiling
    out["card"] = card_line()
    out["phase_s"] = time.perf_counter() - start
    return out


# --------------------------------------------------------------------------- #
# phase 14: the cost model
# --------------------------------------------------------------------------- #
# benchmark_solver's (iteration, short) by a family's time an iteration (§5
# of PERF.md): under 0.1 ms, 0.1-10 ms, over 10 ms
COST_WINDOWS = {"fast": (1000, 100), "mid": (30, 3), "slow": (4, 2)}


def cost_rows(mlp_weights):
    """Phase 14's families: ``(key, make(device), input key, the kernels'
    charges an iteration, benchmark window)``; ``mlp_weights`` are phase
    9's network's."""
    W1, W2 = mlp_weights

    def idlma(device):
        solver = GaussIDLMA(device=device)
        solver.dnn = torch_dnn(VarianceMLP(W1, W2).to(device))
        return solver

    return [
        ("laplace_ip_c2", lambda d: AuxLaplaceIVA(device=d), "X", {"K2": 1}, "fast"),
        ("gauss_ip_c2", lambda d: AuxGaussIVA(device=d), "X", {"K2": 1}, "fast"),
        ("laplace_ip_c3", lambda d: AuxLaplaceIVA(device=d), "X3", {"K1": 1}, "mid"),
        ("gauss_ilrma_10", lambda d: GaussILRMA(n_basis=10, device=d), "X", {"K1": 1}, "mid"),
        ("fast_mnmf_10", lambda d: FastMultichannelISNMF(n_basis=10, device=d), "X", {"K1": 1, "K4": 1, "K5": 4},
         "mid"),
        ("gauss_idlma", idlma, "X", {"K1": 1}, "mid"),
        # the source step's square-root chain: two K3 calls
        ("ipsdta_kondo", lambda d: GaussIPSDTA(n_basis=2, device=d), "X", {"K1": 1, "K3": 2}, "slow"),
        ("mnmf_sawada_10", lambda d: MultichannelISNMF(n_basis=10, device=d), "X", {}, "slow"),
        ("mnmf_ozerov_10", lambda d: MultichannelISNMF(n_basis=10, author="Ozerov", device=d), "X", {}, "mid"),
        ("isnmf_10", lambda d: ISNMF(n_basis=10, device=d), "power", {}, "mid"),
        ("cov_isnmf_10", lambda d: CovarianceISNMF(n_basis=10, device=d), "covariance", {}, "slow"),
        # the basis step's and the pencil's eigensolves
        ("ldpsdtf_2", lambda d: LDPSDTF(n_basis=2, device=d), "gram", {"K3": 2}, "mid"),
        ("grad_fdica", lambda d: GradLaplaceFDICA(lr=0.1, device=d), "X", {}, "mid"),
        ("prox", lambda d: ProxLaplaceIVA(device=d), "X", {}, "mid"),
    ]


def cost_model(X, X3, copy_gb_s, failed):
    """Phase 14: ``iteration_cost`` of one iteration of each family on the
    card (the kernels' launches during the count equal their charges) and
    on the CPU at the card's dtype (equal on the K2 path; the ratio
    elsewhere), the rate by ``benchmark_solver``, and from them GB/s, its
    share of phase 13's copy rate, and FLOP/s."""
    start = time.perf_counter()
    inputs = {
        "X": X, "X3": X3, "power": X[0].abs() ** 2,
        "covariance": torch.einsum("cft,dft->ftcd", X, X.conj()),
        "gram": torch.as_tensor(gram_target(2, X.shape[-1]), dtype=torch.float32, device=X.device),
    }
    out = {"copy_gb_s": copy_gb_s}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # Ozerov's "in progress"
        for key, make, input_key, charges, window in cost_rows(variance_mlp_weights(X.shape[1])):
            row_start = time.perf_counter()
            target = inputs[input_key]
            # the init's launches (LDPSDTF's eigensolves), outside the count
            np.random.seed(SEED)
            counts_zero()
            _init_state(make("cuda"), target)
            init = counts()
            np.random.seed(SEED)
            counts_zero()
            card = iteration_cost(make("cuda"), target)
            launched = {
                "K1": weighted_covariance_planes.launches - init["k1_launches"],
                "K2": fused_auxiva_ip_iter.launches - init["k2_launches"],
                "K3": batched_eigh.launches - init["k3_launches"],
                "K4": fastmnmf_rows.launches - init["k4_launches"],
                "K5": fastmnmf_mu.launches - init["k5_launches"],
            }
            np.random.seed(SEED)
            cpu = iteration_cost(make("cpu"), target.cpu())
            iteration, short = COST_WINDOWS[window]
            np.random.seed(SEED)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always", RuntimeWarning)
                ips, _ = benchmark_solver(make("cuda"), target, iteration=iteration, short=short)
            res = out[key] = {
                "shape": list(target.shape), "dtype": str(target.dtype).replace("torch.", ""),
                "bytes_per_iter": card.bytes, "flops_per_iter": card.flops,
                "charges": card.charges, "launches_during_count": launched,
                "cpu_bytes_per_iter": cpu.bytes, "cpu_flops_per_iter": cpu.flops,
                "cpu_over_card_bytes": cpu.bytes / card.bytes, "cpu_over_card_flops": cpu.flops / card.flops,
                "iters_per_s": ips, "ms_per_iter": 1e3 / ips, "window": [iteration, short],
                "jitter_warning": bool(caught),
                "gb_s": card.bytes * ips / 1e9, "share_of_copy_rate": card.bytes * ips / 1e9 / copy_gb_s,
                "flops_per_s": card.flops * ips,
                "ops_per_iter": sum(row[0] for row in card.by_op.values()),
                "costly_ops_per_iter": sum(row[0] for row in card.by_op.values() if row[1] or row[2]),
                "top_ops_by_bytes": sorted(card.by_op, key=lambda op: -card.by_op[op][1])[:4],
                "row_s": time.perf_counter() - row_start,
            }
            print("cost_model {}: {:.0f} B/it, {:.0f} FLOP/it, {:.4g} ms/it, {:.1f} GB/s, {:.4f} of the copy rate, "
                  "{:.4g} GFLOP/s, {} ops/it ({} that count); CPU/card bytes {:.4f}, FLOPs {:.4f}".format(
                      key, card.bytes, card.flops, res["ms_per_iter"], res["gb_s"], res["share_of_copy_rate"],
                      res["flops_per_s"] / 1e9, res["ops_per_iter"], res["costly_ops_per_iter"],
                      res["cpu_over_card_bytes"], res["cpu_over_card_flops"]), flush=True)
            checks = {
                "launches equal charges": launched == {k: card.charges.get(k, 0) for k in launched},
                "its kernels' charges": card.charges == charges,
                "positive finite counts": all(math.isfinite(v) and v > 0 for v in (card.bytes, card.flops)),
            }
            if charges == {"K2": 1}:
                checks["CPU count equals the card's"] = (cpu.bytes, cpu.flops) == (card.bytes, card.flops)
            record_checks(failed, "cost_" + key, checks)
    out["phase_s"] = time.perf_counter() - start
    return out


# --------------------------------------------------------------------------- #
# phase 15: the captured loop against the eager one
# --------------------------------------------------------------------------- #
ITERS_GRAPH, GRAPH_N, GRAPH_WARM = 20, 50, 5
# graph against eager off the K2 path: the same kernels and cuBLAS calls are
# replayed, so equal bits are expected; the hold allows float32 sums taken in
# another order (of the loss; of the output's largest entry)
GRAPH_RTOL = 1e-5
# key, constructor, input (phase 3's mixture "X2", phase 5's "X3", a seeded
# 4-mic "X4", phase 11's Gram targets "gram2" and "gram3", or a
# factorisation target of factor_targets), K1, K2, K3, K4 and K5 launches an
# iteration (K5: FastMNMF's four sweeps and its loss)
GRAPH_CASES = [
    ("laplace_ip_c2", lambda: AuxLaplaceIVA(), "X2", (0, 1, 0, 0, 0)),
    ("gauss_ip_c2", lambda: AuxGaussIVA(), "X2", (0, 1, 0, 0, 0)),
    ("laplace_ip_c3", lambda: AuxLaplaceIVA(), "X3", (1, 0, 0, 0, 0)),
    ("gauss_ip_c3", lambda: AuxGaussIVA(), "X3", (1, 0, 0, 0, 0)),
    ("laplace_iss_c2", lambda: AuxLaplaceIVA(algorithm_spatial="ISS"), "X2", (0, 0, 0, 0, 0)),
    ("laplace_ip2_c2", lambda: AuxLaplaceIVA(algorithm_spatial="IP2"), "X2", (1, 0, 0, 0, 0)),
    ("gauss_ilrma_ip_c2", lambda: GaussILRMA(n_basis=BATCH_BASIS), "X2", (1, 0, 0, 0, 0)),
    ("gauss_ilrma_iss_c2", lambda: GaussILRMA(n_basis=BATCH_BASIS, algorithm_spatial="ISS"), "X2", (0, 0, 0, 0, 0)),
    ("gauss_ilrma_ip2_c2", lambda: GaussILRMA(n_basis=BATCH_BASIS, algorithm_spatial="IP2"), "X2", (1, 0, 0, 0, 0)),
    ("tilrma_c2", lambda: TILRMA(n_basis=BATCH_BASIS), "X2", (1, 0, 0, 0, 0)),
    ("consistent_ilrma_c2", lambda: ConsistentGaussILRMA(n_basis=BATCH_BASIS, fft_size=FFT_SIZE), "X2",
     (1, 0, 0, 0, 0)),
    ("fast_mnmf_c2", lambda: FastMultichannelISNMF(n_basis=BATCH_BASIS), "X2", (1, 0, 0, 1, 5)),
    ("eucnmf", lambda: EUCNMF(n_basis=FACTOR_BASIS), "power", (0, 0, 0, 0, 0)),
    ("klnmf", lambda: KLNMF(n_basis=FACTOR_BASIS), "power", (0, 0, 0, 0, 0)),
    ("isnmf_mm", lambda: ISNMF(n_basis=FACTOR_BASIS), "power", (0, 0, 0, 0, 0)),
    ("tnmf", lambda: TNMF(n_basis=FACTOR_BASIS), "power", (0, 0, 0, 0, 0)),
    ("cauchy_mm_fast", lambda: CauchyNMF(n_basis=FACTOR_BASIS, algorithm="mm_fast"), "power", (0, 0, 0, 0, 0)),
    ("complex_eucnmf", lambda: ComplexEUCNMF(n_basis=FACTOR_BASIS), "spectrogram", (0, 0, 0, 0, 0)),
    ("eucntf", lambda: EUCNTF(n_basis=FACTOR_BASIS), "power_tensor", (0, 0, 0, 0, 0)),
    # captured since K3 made their eigensolves capturable
    ("grad_iva_c2", lambda: GradLaplaceIVA(), "X2", (0, 0, 0, 0, 0)),
    ("natural_grad_iva_c2", lambda: NaturalGradLaplaceIVA(), "X2", (0, 0, 0, 0, 0)),
    ("grad_fdica_c2", lambda: GradLaplaceFDICA(lr=0.1), "X2", (0, 0, 0, 0, 0)),
    ("natural_grad_fdica_c2", lambda: NaturalGradLaplaceFDICA(lr=0.1), "X2", (0, 0, 0, 0, 0)),
    ("over_4to2", lambda: OverAuxLaplaceIVA("IP", n_sources=2), "X4", (0, 1, 0, 0, 0)),
    ("prox_c2", lambda: ProxLaplaceIVA(), "X2", (0, 0, 0, 0, 0)),
    ("sawada_c2", lambda: MultichannelISNMF(n_basis=FACTOR_BASIS), "X2", (0, 0, 0, 0, 0)),
    ("sawada_c3", lambda: MultichannelISNMF(n_basis=FACTOR_BASIS), "X3", (0, 0, 3, 0, 0)),  # the Riccati's three
    ("ozerov_c2", lambda: MultichannelISNMF(n_basis=FACTOR_BASIS, author="Ozerov"), "X2", (0, 0, 0, 0, 0)),
    ("cov_isnmf_c2", lambda: CovarianceISNMF(n_basis=FACTOR_BASIS), "covariance", (0, 0, 0, 0, 0)),
    ("cov_isnmf_c3", lambda: CovarianceISNMF(n_basis=FACTOR_BASIS), "covariance_c3", (0, 0, 3, 0, 0)),
    ("idlma_mlp_c2", lambda: GaussIDLMA(jax_dnn=True), "X2", (1, 0, 0, 0, 0)),
    ("kondo_c2", lambda: GaussIPSDTA(n_basis=2), "X2", (1, 0, 2, 0, 0)),  # 1024 blocks, B = 3
    ("ikeshita_c2", lambda: GaussIPSDTA(n_basis=2, author="Ikeshita"), "X2", (0, 0, 1, 0, 0)),
    ("t_nu1000_c2", lambda: TIPSDTA(n_basis=2, nu=1000), "X2", (0, 0, 2, 0, 0)),
    ("ldpsdtf_k2", lambda: LDPSDTF(n_basis=2), "gram2", (0, 0, 2, 0, 0)),
    ("ldpsdtf_k3", lambda: LDPSDTF(n_basis=3), "gram3", (0, 0, 3, 0, 0)),
]
# the rows whose eager loop takes tens of ms an iteration or more: their
# iterations a call and loop_ms's (n, warm, repeats), so the phase stays
# within its time
GRAPH_SLOW = {
    "kondo_c2": (10, (10, 2, 2)), "ikeshita_c2": (10, (10, 2, 2)), "t_nu1000_c2": (10, (10, 2, 2)),
    "ldpsdtf_k3": (10, (10, 2, 2)), "sawada_c2": (20, (20, 2, 2)), "sawada_c3": (10, (10, 2, 2)),
    "cov_isnmf_c3": (10, (10, 2, 2)),
}


def quiet(make):
    """``make()`` without GaussILRMA ISS's "in progress" warning."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return make()


def eager_only(solver):
    """``solver`` on the eager loop in every entry point (the comparison's
    other side): its step declared not capturable on this instance."""
    solver.capturable = lambda X: False
    return solver


def step_graphs(solver):
    """The step graphs of ``solver``'s graph cache, over its call
    signatures."""
    return [g for entry in vars(solver).get("_graph_cache", {}).values() for g in entry.steps.values()]


def loop_ms(solver, X, eager, n=GRAPH_N, warm=GRAPH_WARM, repeats=3, call=None):
    """ms an iteration of ``solver``'s call on ``X`` by CUDA events, (warm +
    n)- less warm-iteration calls (``per_iteration``'s differencing), through
    the eager loop or the captured one.  The init's host draws are made once
    and passed to every call as warm starts on the card: a draw inside the
    window (ComplexEUCNMF's phase, 2049 x 10 x 469 doubles) would leave the
    card idle for tens of ms a call, more than the differencing can cancel."""
    entry = eager_only(solver) if eager else solver
    np.random.seed(SEED)
    drawn = solver.prepare_state_kwargs(solver._to_input(X), {})
    warm_start = {k: torch.as_tensor(v, device="cuda") for k, v in drawn.items() if v is not None}
    warm_start.update(call or {})

    def run(k):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        entry(X, iteration=k, **warm_start)
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    run(warm)
    short = min(run(warm) for _ in range(repeats))
    long_ = min(run(warm + n) for _ in range(repeats))
    return (long_ - short) / n


def parts(output):
    return output if isinstance(output, tuple) else (output,)


def graph_row(key, make, X, per_iteration, failed, call=None):
    """One family through the captured loop and the eager one (module
    docstring, phase 15); ``per_iteration`` its K1, K2, K3, K4 and K5 launches an
    iteration, ``call`` its call's keywords (GaussIDLMA's network)."""
    call = call or {}
    iterations, (n, warm, repeats) = GRAPH_SLOW.get(key, (ITERS_GRAPH, (GRAPH_N, GRAPH_WARM, 3)))
    # the launches of a call outside its iterations (init, the first loss,
    # finalize: LDPSDTF's init eigensolves), from a call of none
    np.random.seed(SEED)
    counts_zero()
    eager_only(quiet(make))(X, iteration=0, **call)
    outside = counts()
    runs = {}
    for mode in ("eager", "graph"):
        np.random.seed(SEED)
        solver = quiet(make)
        counts_zero()
        start = time.perf_counter()
        # the eager side through the same entry point (OverAuxLaplaceIVA's
        # PCA and projection-back are in its __call__)
        entry = eager_only(solver) if mode == "eager" else solver
        out = entry(X, iteration=iterations, **call)
        torch.cuda.synchronize()
        runs[mode] = (parts(out), np.asarray(solver.loss), counts(), solver, time.perf_counter() - start)
    (Y_e, L_e, launched_e, _, _), (Y_g, L_g, launched_g, solver, first_s) = runs["eager"], runs["graph"]
    bits = L_e.tobytes() == L_g.tobytes() and all(torch.equal(a, b) for a, b in zip(Y_e, Y_g))
    loss_gap = float(np.max(np.abs(L_g - L_e) / np.abs(L_e)))
    out_gap = max(rel_err(b, a) for a, b in zip(Y_e, Y_g))
    (graph,) = step_graphs(solver)
    np.random.seed(SEED + 1)
    counts_zero()
    solver(X, iteration=iterations, **call)
    launched_second = counts()
    captures = len(step_graphs(solver))
    same_graph = step_graphs(solver) == [graph]
    ms_graph = loop_ms(solver, X, eager=False, n=n, warm=warm, repeats=repeats, call=call)
    ms_eager = loop_ms(quiet(make), X, eager=True, n=n, warm=warm, repeats=repeats, call=call)
    torch.cuda.synchronize()
    start = time.perf_counter()
    graph.replay(n)
    host_ms = (time.perf_counter() - start) * 1e3 / n
    torch.cuda.synchronize()
    expected = {
        k + "_launches": outside[k + "_launches"] + per * iterations
        for k, per in zip(("k1", "k2", "k3", "k4", "k5"), per_iteration)
    }
    res = {
        "iterations": iterations, "bits_equal": bits, "loss_max_rel_gap": loss_gap, "output_max_rel_gap": out_gap,
        "launches_graph": launched_g, "launches_eager": launched_e, "launches_second_call": launched_second,
        "launches_outside_the_iterations": outside,
        "captures_across_two_calls": captures, "ms_graph": ms_graph, "ms_eager": ms_eager,
        "speedup": ms_eager / ms_graph, "replay_host_ms": host_ms, "capture_s": graph.capture_s,
        "first_call_s": first_s, "loss_last": float(L_g[-1]),
    }
    checks = {
        "launches as the eager loop's, per iteration": launched_g == launched_e == launched_second == expected,
        "one capture across two calls": captures == 1 and same_graph,
        "losses finite": bool(np.isfinite(L_g).all()),
    }
    if per_iteration[1] or per_iteration[4]:
        checks["graph equals eager bit for bit ({})".format("K2" if per_iteration[1] else "K5")] = bits
    else:
        checks["graph equals eager within {}".format(GRAPH_RTOL)] = loss_gap <= GRAPH_RTOL and out_gap <= GRAPH_RTOL
    record_checks(failed, key, checks)
    print(json.dumps({"graph_" + key: res}), flush=True)
    return res


def graph_batch_row(failed):
    """batch_separate over AuxLaplaceIVA IP x 30 on 8 x 2 x 2049 x 469:
    mixtures/s through the captured loop (one capture) and the eager one."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    shape = (BATCH, 2, FFT_SIZE // 2 + 1, -(-N_SAMPLES // HOP_SIZE) + 1)
    Xs = torch.complex(torch.randn(shape, generator=gen, device="cuda"), torch.randn(shape, generator=gen, device="cuda"))
    res, outputs = {}, {}
    captured = AuxLaplaceIVA()
    for mode, solver in (("eager", eager_only(AuxLaplaceIVA())), ("graph", captured), ("graph_again", captured)):
        counts_zero()
        torch.cuda.synchronize()
        start = time.perf_counter()
        outputs[mode], _ = batch_separate(solver, Xs, iteration=ITERS_BATCH, host=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        res[mode] = {"mixtures_per_s": BATCH / wall, "wall_s": wall, **counts(),
                     "captures": len(step_graphs(solver))}
    gap = rel_err(outputs["graph"], outputs["eager"])
    res["output_max_rel_gap"] = gap
    record_checks(failed, "graph_batch", {
        "one capture for the batch": res["graph"]["captures"] == 1 and res["graph_again"]["captures"] == 1,
        "K2 240 in 240": all(res[m]["k2_launches"] == BATCH * ITERS_BATCH for m in ("eager", "graph", "graph_again")),
        "members bit for bit the eager loop's (K2)": bool(torch.equal(outputs["graph"], outputs["eager"])),
    })
    return res


def graph_phase(X2, X3, failed):
    """Phase 15 (module docstring)."""
    start = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
    F, T = X2.shape[1:]
    inputs = {
        "X2": X2, "X3": X3, "X4": random_mixture(gen, 4, F, T), **factor_targets(X2, X3),
        **{"gram{}".format(k): torch.as_tensor(gram_target(k, T), dtype=torch.float32, device="cuda") for k in (2, 3)},
    }
    W1, W2 = variance_mlp_weights(F)
    calls = {"idlma_mlp_c2": {"dnn": torch_dnn(VarianceMLP(W1, W2).to("cuda"))}}
    out = {
        key: graph_row(key, make, inputs[name], per, failed, calls.get(key)) for key, make, name, per in GRAPH_CASES
    }
    out["batch_laplace_ip_c2"] = graph_batch_row(failed)
    bench = {}
    for mode in ("graph", "eager"):
        solver = AuxLaplaceIVA() if mode == "graph" else eager_only(AuxLaplaceIVA())
        counts_zero()
        ips, first_s = benchmark_solver(solver, X2, iteration=BENCH_ITERS, short=BENCH_SHORT)
        bench[mode] = {"ms": 1e3 / ips, "first_call_s": first_s, **counts()}
    runs = 1 + BENCH_SHORT + 4 * (BENCH_ITERS + BENCH_SHORT)
    record_checks(failed, "graph_benchmark_solver", {
        "K2 once an iteration, both loops": bench["graph"]["k2_launches"] == runs
        and bench["eager"]["k2_launches"] == runs + BENCH_ITERS - 1,
    })
    out["benchmark_solver_main_path"] = bench
    out["phase_s"] = time.perf_counter() - start
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
    script_start = time.perf_counter()
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
    # phase 13's shard of 1025 of 2050 padded bins, the whole count passed
    k2_shard = [k2_case(gen, 1025, T, contrast=c, n_bins=2050) for c in ("laplace", "gauss")]
    print(json.dumps({"k1_pair": k1_pair, "k2_gauss": k2_gauss, "k2_gauss_long": k2_gauss_long,
                      "k2_shard": k2_shard}), flush=True)
    # per-bin (N, F, T) weights, ILRMA's: IP at C = 2 and 3, IP2's pair at
    # C = 3, the generic instance, the frame axis split, odd F T
    k1_per_bin = [
        k1_case(gen, C, F_, T_, N=N, per_bin=True)
        for C, N, F_, T_ in [(2, 2, F, T), (3, 3, F, T), (3, 2, F, T), (5, 5, F, T), (2, 2, 513, 7501),
                             (3, 3, 129, 7001)]
    ]
    print(json.dumps({"k1_per_bin": k1_per_bin}), flush=True)
    start = time.perf_counter()
    k3 = [k3_case(gen, *case) for case in K3_CASES]
    print(json.dumps({"k3_cases": k3, "k3_phase_s": time.perf_counter() - start}), flush=True)
    k4 = [k4_case(gen, C, dtype) for C, dtype in K4_CASES]
    print(json.dumps({"k4_cases": k4}), flush=True)
    k5 = [k5_case(gen, C, dtype, K=K) for C, K, dtype in K5_CASES]
    print(json.dumps({"k5_cases": k5}), flush=True)

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
    routes = block["routes"]
    route_keys = [key for key in routes if key != "phase_s"]
    block_keys = [key for key in block if key not in ("phase_s", "routes")]
    block_k1_no_kernel = sum(block[key]["k1_launches"] for key in block_keys if not key.startswith("kondo")) + sum(
        routes[key]["k1_launches"] for key in route_keys if not key.startswith("kondo")
    )
    block_k2 = sum(block[key]["k2_launches"] for key in block_keys)
    block_k2 += sum(routes[key]["k2_launches"] for key in route_keys)
    start = time.perf_counter()
    phase12_failed = []
    phase12 = harness_and_batch(phase12_failed)
    X2_cpu = stft(mix2[0], fft_size=FFT_SIZE, hop_size=HOP_SIZE, device="cpu")
    phase12["auxiva_ip_step_components"] = components_row(X2, X2_cpu, phase12_failed)
    phase12["phase_s"] = time.perf_counter() - start
    print(json.dumps({"harness_and_batch": phase12}), flush=True)
    assert not phase12_failed, phase12_failed
    mesh_failed = []
    mesh = mesh_phase(X2, c2, mesh_failed)
    print(json.dumps({"mesh": mesh}), flush=True)
    assert not mesh_failed, mesh_failed
    mesh_w1, mesh_w2 = mesh["world_1_nccl"], mesh["world_2_gloo"]
    w1_10c = mesh_w1["slice_10c"]
    w1_10c_keys = [key for key in w1_10c if key != "phase_s"]
    cost_failed = []
    X3 = stft(mix3[0].astype(np.float32), fft_size=FFT_SIZE, hop_size=HOP_SIZE)
    costs = cost_model(X2, X3, mesh["profiling"]["memory_bandwidth_gb_s"], cost_failed)
    print(json.dumps({"cost_model": costs}), flush=True)
    assert not cost_failed, cost_failed
    cost_k1 = sum(row["launches_during_count"]["K1"] for row in costs.values() if isinstance(row, dict))
    graph_failed = []
    graphs = graph_phase(X2, X3, graph_failed)
    print(json.dumps({"graph_phase": {key: graphs[key] for key in ("batch_laplace_ip_c2", "benchmark_solver_main_path",
                                                                   "phase_s")}}), flush=True)
    assert not graph_failed, graph_failed
    graph_k1 = sum(graphs[key]["launches_graph"]["k1_launches"] for key, *_ in GRAPH_CASES)
    graph_k2 = sum(graphs[key]["launches_graph"]["k2_launches"] for key, *_ in GRAPH_CASES)
    graph_k3 = sum(graphs[key]["launches_graph"]["k3_launches"] for key, *_ in GRAPH_CASES)
    if args.profile:
        prof = profile_c2(X2, ROOT / "chiprun_out" / "profile_c2.txt")
        print(json.dumps({"profile_c2": prof}), flush=True)

    k1_main = k1[1]  # C = 3, the shape of the K1 main path
    k1_all = k1 + [k1_long, k1_long_c3, k1_pair] + k1_any + k1_per_bin

    def k2_entry(name, case, case_long, case_shard, launches, launches_by_path, rtol):
        cases = (case, case_long, case_shard)
        return {
            "name": name, "route": "cuda",
            "source": "audio_source_separation_tpu_torch/csrc/fused_auxiva_ip.cu",
            "replaces": "audio_source_separation_tpu/ops/pallas_fused.py:231",
            "launches": launches, "launches_by_path": launches_by_path,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "max_rel_err": max(max(c["rel_err"].values()) for c in cases),
            "tolerance": "W, psum max_rel_err <= {}; NLL <= {}".format(rtol, K2_RTOL),
            "ms": case["ms"], "plain_ms": case["plain_ms"], "ms_long": case_long["ms"],
            "bound_ms": case["bound_ms"], "bound_us": case["bound_ms"] * 1e3, "bound_by": case["bound_by"],
            "library_ms": None, "shape": [2, F, T],
        }

    k3_main = k3[0]  # Kondo's R at 1024 blocks, the block-PSD main path's batch
    k3_paths = {
        **{"factorisation_" + key: factor[key]["k3_launches"] for key, *_ in FACTOR_CASES},
        **{"mnmf_" + key: mnmf_runs[key]["k3_launches"] for key in mnmf_keys},
        **{"block_psd_" + key: block[key]["k3_launches"] for key in block_keys},
        **{"block_psd_route_" + key: routes[key]["k3_launches"] for key in route_keys},
        "cost_model": sum(row["launches_during_count"]["K3"] for row in costs.values() if isinstance(row, dict)),
        "graph_phase": graph_k3,
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
                "ipsdta_kondo_planes_c2": routes["kondo_planes"]["k1_launches"],
                "ipsdta_kondo_pencil_c2": routes["kondo_pencil"]["k1_launches"],
                "ipsdta_ikeshita_t_psdtf": block_k1_no_kernel,
                "batch_ilrma_c2": phase12["batch_ilrma_c2"]["k1_launches"],
                "batch_fast_mnmf_c2": phase12["batch_fast_mnmf_c2"]["k1_launches"],
                "sharded_auxiva_ip_step": phase12["sharded_auxiva_ip_step"]["k1_launches"],
                "examples_walkthrough_ilrma": phase12["examples_walkthrough"]["k1_launches"],
                "batch_laplace_ip_c2": phase12["batch_laplace_ip_c2"]["k1_launches"],
                "harness_laplace_ip_c2": phase12["harness_laplace_ip_c2"]["k1_launches"],
                "mesh_w1_laplace_ip_frames": mesh_w1["laplace_ip_frames"]["k1_launches"],
                "mesh_w1_gauss_ilrma_bins": mesh_w1["gauss_ilrma_bins"]["k1_launches"],
                "mesh_w1_laplace_ip_bins": mesh_w1["laplace_ip_bins"]["k1_launches"],
                "mesh_w2_laplace_ip_frames_rank0": mesh_w2["laplace_ip_frames"]["k1_launches"],
                "mesh_w2_kondo_bins_rank0": mesh_w2["kondo_bins"]["k1_launches"],
                **{"mesh_w1_" + key: w1_10c[key]["k1_launches"] for key in w1_10c_keys},
                "mesh_w2_fastmnmf_bins_rank0": mesh_w2["fastmnmf_bins"]["k1_launches"],
                "mesh_w2_idlma_frames_rank0": mesh_w2["idlma_frames"]["k1_launches"],
                "mesh_w2_cov_isnmf_prox_ldpsdtf_rank0": sum(
                    mesh_w2[key]["k1_launches"] for key in ("cov_isnmf_bins", "prox_bins", "ldpsdtf_frames")
                ),
                "cost_model": cost_k1,
                "graph_phase": graph_k1,
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
            "fused_auxiva_ip (K2, Laplace contrast)", k2, k2_long, k2_shard[0], c2["k2_launches"],
            {"laplace_ip_c2": c2["k2_launches"], "laplace_ip_c2_long": c2_long["k2_launches"],
             "over_4to2": over["k2_launches"], "factorisation": factor_launches["k2"],
             "fdica_prox_beamformers": slice5_launches["k2"], "mnmf": mnmf_k2, "block_psd": block_k2,
             "batch_laplace_ip_c2": phase12["batch_laplace_ip_c2"]["k2_launches"],
             "harness_laplace_ip_c2": phase12["harness_laplace_ip_c2"]["k2_launches"],
             "examples_separate_auxiva": phase12["examples_separate_auxiva"]["k2_launches"],
             "batch_ilrma_c2": phase12["batch_ilrma_c2"]["k2_launches"],
             "batch_fast_mnmf_c2": phase12["batch_fast_mnmf_c2"]["k2_launches"],
             "sharded_auxiva_ip_step": phase12["sharded_auxiva_ip_step"]["k2_launches"],
             "mesh_w1_laplace_ip_bins": mesh_w1["laplace_ip_bins"]["k2_launches"],
             "mesh_w1_laplace_ip_frames": mesh_w1["laplace_ip_frames"]["k2_launches"],
             "mesh_w1_batch_separate_1x1": mesh_w1["batch_separate_1x1"]["k2_launches"],
             "mesh_w2_laplace_ip_bins_pad_rank0": mesh_w2["laplace_ip_bins_pad"]["k2_launches"],
             "mesh_w2_laplace_ip_frames_rank0": mesh_w2["laplace_ip_frames"]["k2_launches"],
             "mesh_w1_slice_10c": sum(w1_10c[key]["k2_launches"] for key in w1_10c_keys),
             "held_against_auxiva_ip_step_components": phase12["auxiva_ip_step_components"]["k2_launches"],
             "cost_model_laplace_ip_c2": costs["laplace_ip_c2"]["launches_during_count"]["K2"],
             "graph_phase": graph_k2},
            K2_RTOL,
        ),
        k2_entry(
            "fused_auxiva_ip (K2, Gauss contrast)", k2_gauss, k2_gauss_long, k2_shard[1],
            fam2["gauss_ip"]["k2_launches"],
            {"gauss_ip_c2": fam2["gauss_ip"]["k2_launches"], "factorisation": factor_launches["k2"],
             "fdica_prox_beamformers": slice5_launches["k2"], "mnmf": mnmf_k2, "block_psd": block_k2,
             "mesh_w1_gauss_ip_bins": mesh_w1["gauss_ip_bins"]["k2_launches"],
             "mesh_w2_gauss_ip_bins_rank0": mesh_w2["gauss_ip_bins"]["k2_launches"],
             "cost_model_gauss_ip_c2": costs["gauss_ip_c2"]["launches_during_count"]["K2"]},
            K2_GAUSS_RTOL,
        ),
        {
            "name": "batched_eigh (K3)", "route": "cuda",
            "source": "audio_source_separation_tpu_torch/csrc/batched_eigh.cu",
            # no pl.pallas_call: the eigh that XLA compiles into the JAX scan
            "replaces": "audio_source_separation_tpu/models/ipsdta.py:159",
            "launches": block["kondo"]["k3_launches"], "launches_by_path": k3_paths,
            "max_abs_err": max(c["max_abs_err"] for c in k3),
            "max_rel_err": max(c["eig_rel_err"] for c in k3),
            "tolerance": "eigenvalues within {} (single) / {} (double) of the largest; residual and "
                         "orthogonality within ten times that".format(K3_RTOL[torch.complex64], K3_RTOL[torch.complex128]),
            "ms": k3_main["ms"], "plain_ms": k3_main["plain_ms"], "bound_ms": k3_main["bound_ms"],
            "bound_us": k3_main["bound_ms"] * 1e3, "bound_by": k3_main["bound_by"],
            "library_ms": k3_main["library_ms"], "shape": k3_main["batch"] + [3, 3],
            "cases": k3,
        },
        {
            "name": "fastmnmf_rows (K4)", "route": "cuda",
            "source": "audio_source_separation_tpu_torch/csrc/fastmnmf_rows.cu",
            # no pl.pallas_call: the elementwise chain XLA fuses in the JAX step
            "replaces": "audio_source_separation_tpu/models/mnmf.py (FastMultichannelISNMF's row sweep and "
                        "power normalisation)",
            "launches": mnmf_runs["fast_mnmf"]["k4_launches"],
            "launches_by_path": {
                "fast_mnmf_c2": mnmf_runs["fast_mnmf"]["k4_launches"],
                "fast_mnmf_c3": mnmf_runs["fast_mnmf_c3"]["k4_launches"],
                "batch_fast_mnmf_c2": phase12["batch_fast_mnmf_c2"]["k4_launches"],
                "cost_model_fast_mnmf_10": costs["fast_mnmf_10"]["launches_during_count"]["K4"],
                "graph_phase": sum(graphs[key]["launches_graph"]["k4_launches"] for key, *_ in GRAPH_CASES),
            },
            "max_rel_err": {case["dtype"] + "_c" + str(case["C"]): max(case["rel_err"].values()) for case in k4},
            "tolerance": {str(k).replace("torch.", ""): v for k, v in K4_RTOL.items()},
            "ms": k4[1]["ms"], "plain_ms": k4[1]["plain_ms"], "bound_ms": k4[1]["bound_ms"],
            "bound_us": k4[1]["bound_us"], "bound_by": k4[1]["bound_by"], "shape": [3, 2049, 3],
            "cases": k4,
        },
        {
            "name": "fastmnmf_mu (K5)", "route": "cuda",
            "source": "audio_source_separation_tpu_torch/csrc/fastmnmf_mu.cu",
            # no pl.pallas_call: the model and ratio chains XLA fuses in the JAX step
            "replaces": "audio_source_separation_tpu/models/mnmf.py (FastMultichannelISNMF's MU sweeps, K1's "
                        "weights and the NLL's fit)",
            "launches": mnmf_runs["fast_mnmf"]["k5_launches"],
            "launches_by_path": {
                "fast_mnmf_c2": mnmf_runs["fast_mnmf"]["k5_launches"],
                "fast_mnmf_c3": mnmf_runs["fast_mnmf_c3"]["k5_launches"],
                "batch_fast_mnmf_c2": phase12["batch_fast_mnmf_c2"]["k5_launches"],
                "cost_model_fast_mnmf_10": costs["fast_mnmf_10"]["launches_during_count"]["K5"],
                "graph_phase": sum(graphs[key]["launches_graph"]["k5_launches"] for key, *_ in GRAPH_CASES),
            },
            "max_rel_err": {
                "{}_c{}".format(case["dtype"], case["C"]): max(e["rel_err"] for e in case["entries"].values())
                for case in k5
            },
            "tolerance": {str(k).replace("torch.", ""): v for k, v in K5_RTOL.items()},
            "ms": sum(e["ms"] for e in k5[0]["entries"].values()),
            "plain_ms": sum(e["plain_ms"] for e in k5[0]["entries"].values()),
            "bound_ms": sum(e["bound_ms"] for e in k5[0]["entries"].values()), "shape": [2, 2049, 470],
            "cases": k5,
        },
    ]
    print(json.dumps({"chip_smoke_s": time.perf_counter() - script_start}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print("card: " + card, flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
