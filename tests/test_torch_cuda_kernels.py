"""The port's CUDA kernels against their plain versions on the card.

Needs an NVIDIA GPU with ``nvcc``; each test skips without one.  This file
imports neither JAX nor ``conftest``, so on a machine without JAX it runs
on its own:

    python -m pytest tests/test_torch_cuda_kernels.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from audio_source_separation_tpu_torch.ops.cov_kernel import (
    k1_launch_plan,
    weighted_covariance_planes,
    weighted_covariance_planes_plain,
)
from audio_source_separation_tpu_torch import (
    TILRMA,
    AuxGaussIVA,
    AuxLaplaceIVA,
    ConsistentGaussILRMA,
    GaussILRMA,
    OverAuxLaplaceIVA,
)
from audio_source_separation_tpu_torch.ops.fused_ip import (
    fused_auxiva_ip_iter,
    fused_auxiva_ip_iter_plain,
)
from audio_source_separation_tpu_torch.ops.ip_components import separate_components

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _mixture(seed, C, F, T, device):
    rng = np.random.RandomState(seed)
    X = (rng.randn(C, F, T) + 1j * rng.randn(C, F, T)) * (np.abs(rng.randn(C, 1, T)) + 0.1)
    return torch.as_tensor(X.astype(np.complex64), device=device)


@pytest.mark.parametrize(
    "C,N,F,T",
    [
        (2, 2, 70, 33), (3, 3, 129, 100), (4, 4, 257, 469), (3, 1, 31, 7), (4, 4, 33, 16_384), (3, 2, 2049, 469),
        # C = 1, and the generic instance: C > 4, N > 4 and N past one unit of
        # 8 rows; (2, 9) packs 4 bins a block; (6, 9) and (7, 9) have 12 and
        # 14 units, so each warp walks two per chunk (frame axis split, whole)
        (1, 1, 70, 33), (5, 5, 2049, 469), (5, 2, 129, 100), (2, 6, 31, 7), (6, 9, 33, 3000),
        (2, 9, 129, 100), (7, 9, 300, 50),
        # the frame axis split across blocks (k1_launch_plan): a 120 s
        # recording at stft(1024, 256), C = N = 3 and IP2's pairs; generic
        # and split; C = N = 1 at small F; odd F T, so rows start 8 bytes off 16
        (3, 3, 513, 7501), (2, 2, 513, 7501), (5, 5, 65, 16_384), (1, 1, 33, 20_000), (3, 3, 129, 7001),
    ],
)
def test_k1_matches_plain(cuda, C, N, F, T):
    X = _mixture(C + N, C, F, T, cuda)
    w = torch.as_tensor((np.abs(np.random.RandomState(1).randn(N, T)) + 0.1).astype(np.float32), device=cuda)
    launches = weighted_covariance_planes.launches
    out = weighted_covariance_planes(X, w)
    assert weighted_covariance_planes.launches == launches + 1
    ref = weighted_covariance_planes_plain(X, w)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5 * float(ref.abs().max()))


@pytest.mark.parametrize("C,N,F,T", [(3, 3, 2049, 469), (3, 3, 513, 7501), (6, 9, 33, 3000)])
def test_k1_is_deterministic(cuda, C, N, F, T):
    """Two launches give the same bits: unsplit, split with a ticket per
    group, and split with several units per warp."""
    X = _mixture(5, C, F, T, cuda)
    w = torch.as_tensor((np.abs(np.random.RandomState(2).randn(N, T)) + 0.1).astype(np.float32), device=cuda)
    assert (k1_launch_plan(C, N, F, T).splits > 1) == (F < 2049)
    assert torch.equal(weighted_covariance_planes(X, w), weighted_covariance_planes(X, w))


def _per_bin_weights(seed, N, F, T, device):
    """1/R-like per-bin weights spanning three decades."""
    w = 10.0 ** (3 * np.random.RandomState(seed).rand(N, F, T) - 1.5)
    return torch.as_tensor(w.astype(np.float32), device=device)


@pytest.mark.parametrize(
    "C,N,F,T",
    [
        # ILRMA at 60 s, stft(4096, 2048): IP at C = 2 (one stage), C = 3
        # and IP2's pair at C = 3 (the ring), the generic instance at C = 5
        (2, 2, 2049, 469), (3, 3, 2049, 469), (3, 2, 2049, 469), (5, 5, 2049, 469),
        # the frame axis split; odd F T (rows start off 16 bytes); C = N = 1;
        # N past one generic unit; small odd shapes
        (2, 2, 513, 7501), (3, 3, 129, 7001), (1, 1, 33, 2000), (2, 9, 129, 100), (4, 4, 31, 7), (3, 1, 9, 3),
    ],
)
def test_k1_per_bin_matches_plain(cuda, C, N, F, T):
    X = _mixture(C + N, C, F, T, cuda)
    w = _per_bin_weights(C, N, F, T, cuda)
    launches = weighted_covariance_planes.launches
    out = weighted_covariance_planes(X, w)
    again = weighted_covariance_planes(X, w)
    assert weighted_covariance_planes.launches == launches + 2
    assert torch.equal(out, again)
    ref = weighted_covariance_planes_plain(X, w)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5 * float(ref.abs().max()))


def test_k1_per_bin_is_not_per_frame(cuda):
    """Per-bin weights that differ only across bins give per-bin results:
    each bin's covariance scales with its own weight."""
    C, N, F, T = 2, 2, 64, 300
    X = _mixture(3, C, F, T, cuda)
    scale = torch.arange(1, F + 1, dtype=torch.float32, device=cuda)
    ones = torch.ones((N, T), device=cuda)
    flat = weighted_covariance_planes(X, ones)
    per_bin = weighted_covariance_planes(X, (scale[None, :, None] * torch.ones((N, F, T), device=cuda)).contiguous())
    torch.testing.assert_close(per_bin, flat * scale[None, :, None], rtol=1e-5, atol=1e-6 * float(per_bin.abs().max()))


def test_k1_rejects_bad_operands(cuda):
    X = _mixture(0, 2, 9, 16, cuda)
    w = torch.ones((2, 16), device=cuda)
    with pytest.raises(ValueError):
        weighted_covariance_planes(X.to(torch.complex128), w)
    with pytest.raises(ValueError):
        weighted_covariance_planes(X, w.double())
    with pytest.raises(ValueError):
        weighted_covariance_planes(X, torch.ones((2, 15), device=cuda))
    with pytest.raises(ValueError):
        weighted_covariance_planes(X, torch.ones((2, 8, 16), device=cuda))  # F = 9
    with pytest.raises(ValueError):
        weighted_covariance_planes(X, torch.ones((2, 16, 9), device=cuda).transpose(1, 2))  # not contiguous


def _k2_operands(F, T, device):
    X = _mixture(7, 2, F, T, device)
    X[:, 3] = 0
    rng = np.random.RandomState(2)
    W = np.eye(2)[:, :, None] + 0.3 * (rng.randn(2, 2, F) + 1j * rng.randn(2, 2, F))
    W[:, :, 3] = np.eye(2)
    W = torch.as_tensor(W.astype(np.complex64), device=device)
    psum = torch.sum(torch.abs(separate_components([[W[s, c] for c in range(2)] for s in range(2)], X)) ** 2, dim=1)
    return X, W, psum


def _check_k2(X, W, psum, contrast):
    out = fused_auxiva_ip_iter(X, W, psum, contrast=contrast)
    again = fused_auxiva_ip_iter(X, W, psum, contrast=contrast)
    ref = fused_auxiva_ip_iter_plain(X, W, psum, contrast=contrast)
    for a, b in zip(out, again):
        assert torch.equal(a, b)
    assert torch.equal(out[0][:, :, 3], W[:, :, 3])
    torch.testing.assert_close(out[0], ref[0], rtol=0, atol=1e-4 * float(ref[0].abs().max()))
    torch.testing.assert_close(out[1], ref[1], rtol=1e-4, atol=1e-6 * float(ref[1].abs().max()))
    torch.testing.assert_close(out[3], ref[3], rtol=1e-4, atol=0)


# every layout of the launch plan: (2049, 469) 8 bins resident; (33, 3000)
# 4 bins resident; (33, 6145) 2 bins resident, just past the old 6144-frame
# cap; (33, 6943) the largest resident slab; (33, 9000) streamed; (257, 469)
# odd F T, so channel 1's runs start 8 bytes off 16; each for both contrasts
@pytest.mark.parametrize("contrast", ["laplace", "gauss"])
@pytest.mark.parametrize(
    "F,T", [(200, 37), (2049, 469), (33, 3000), (33, 6145), (33, 6943), (33, 9000), (257, 469)]
)
def test_k2_matches_plain_and_is_deterministic(cuda, F, T, contrast):
    _check_k2(*_k2_operands(F, T, cuda), contrast)


def _solver_launches(C, F, T, iterations, counter, solver_cls=AuxLaplaceIVA, **kwargs):
    X = _mixture(C, C, F, T, "cuda")
    counter.launches = 0
    solver = solver_cls(**kwargs)
    Y = solver(X, iteration=iterations)
    torch.cuda.synchronize()
    assert torch.isfinite(Y).all() and np.isfinite(solver.loss).all()
    return counter.launches, solver.loss


def test_solver_runs_long_recordings_through_the_kernels(cuda):
    """C = 2 past 6144 frames goes through K2 once per iteration and C = 4
    at 16,384 frames through K1: no length-based detour."""
    launches, loss = _solver_launches(2, 33, 7000, 3, fused_auxiva_ip_iter)
    assert launches == 3
    assert np.all(np.diff(loss) <= 1e-5 * np.abs(loss[:-1]))
    launches, _ = _solver_launches(4, 33, 16_384, 2, weighted_covariance_planes)
    assert launches >= 2


def test_family_runs_through_the_kernels(cuda):
    """AuxGaussIVA at C = 2 is one K2 launch per iteration; IP2 at C = 3
    runs K1 every iteration."""
    launches, loss = _solver_launches(2, 257, 469, 5, fused_auxiva_ip_iter, AuxGaussIVA)
    assert launches == 5
    assert np.all(np.diff(loss) <= 1e-5 * np.abs(loss[:-1]))
    launches, _ = _solver_launches(3, 257, 469, 5, weighted_covariance_planes, algorithm_spatial="IP2")
    assert launches >= 5


@pytest.mark.parametrize("algorithm", ["IP", "IP2"])
def test_five_channels_run_through_k1(cuda, algorithm):
    """C = 5 (the matrix IP and pair updates) takes K1 every iteration."""
    launches, loss = _solver_launches(5, 257, 469, 5, weighted_covariance_planes, algorithm_spatial=algorithm)
    assert launches == 5
    assert loss[-1] < loss[0]


def test_overdetermined_to_one_source_runs_through_k1(cuda):
    X = _mixture(3, 3, 129, 200, cuda)
    weighted_covariance_planes.launches = 0
    Y = OverAuxLaplaceIVA("IP", n_sources=1)(X, iteration=3)
    torch.cuda.synchronize()
    assert weighted_covariance_planes.launches == 3
    assert Y.shape == (1, 129, 200) and torch.isfinite(Y).all()


@pytest.mark.parametrize(
    "make,C,per_iteration",
    [
        (lambda: GaussILRMA(n_basis=4), 2, 1),
        (lambda: GaussILRMA(n_basis=4), 3, 1),
        (lambda: GaussILRMA(n_basis=4, algorithm_spatial="IP2"), 3, 1),
        (lambda: GaussILRMA(n_basis=4, guard="svd"), 2, 1),
        (lambda: GaussILRMA(n_basis=4), 5, 1),
        (lambda: GaussILRMA(n_basis=4, normalize="projection-back"), 2, 1),
        (lambda: TILRMA(n_basis=4, nu=1000), 2, 1),
        (lambda: ConsistentGaussILRMA(n_basis=4, fft_size=512), 2, 1),
        (lambda: GaussILRMA(n_basis=4, partitioning=True), 2, 1),
        (lambda: TILRMA(n_basis=4, nu=1000, partitioning=False, normalize=False), 3, 1),
    ],
    ids=["ip-c2", "ip-c3", "ip2-c3", "svd", "ip-c5", "projection-back", "t", "consistent", "partitioning",
         "t-c3-unnormalised"],
)
def test_ilrma_runs_through_k1_per_bin(cuda, make, C, per_iteration):
    """Every ILRMA iteration on the card forms its covariance by one K1
    launch with per-bin weights (IP2's pair in one launch); the loss stays
    finite and falls."""
    X = _mixture(C, C, 257, 469, cuda)
    np.random.seed(111)
    solver = make()
    weighted_covariance_planes.launches = 0
    Y = solver(X, iteration=5)
    torch.cuda.synchronize()
    assert weighted_covariance_planes.launches == 5 * per_iteration
    assert torch.isfinite(Y).all() and np.isfinite(solver.loss).all()
    assert solver.loss[-1] < solver.loss[0]


def test_ilrma_iss_launches_no_kernel(cuda):
    X = _mixture(2, 2, 257, 469, cuda)
    np.random.seed(111)
    with pytest.warns(UserWarning):
        solver = GaussILRMA(n_basis=4, algorithm_spatial="ISS")
    weighted_covariance_planes.launches = fused_auxiva_ip_iter.launches = 0
    solver(X, iteration=3)
    torch.cuda.synchronize()
    assert weighted_covariance_planes.launches == fused_auxiva_ip_iter.launches == 0
    assert np.isfinite(solver.loss).all()
