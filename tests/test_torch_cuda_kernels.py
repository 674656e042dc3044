"""The port's CUDA kernels against their plain versions on the card.

Needs an NVIDIA GPU with ``nvcc``; each test skips without one.  This file
imports neither JAX nor ``conftest``, so on a machine without JAX it runs
on its own:

    python -m pytest tests/test_torch_cuda_kernels.py --noconftest -q
"""

import warnings

import numpy as np
import pytest
import torch

from audio_source_separation_tpu_torch.ops.cov_kernel import (
    k1_launch_plan,
    weighted_covariance_planes,
    weighted_covariance_planes_plain,
)
from audio_source_separation_tpu_torch import (
    EUCNMF,
    EUCNTF,
    ISNMF,
    TILRMA,
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
    LDPSDTF,
    MaxSNRBeamformer,
    MultichannelISNMF,
    MVDRBeamformer,
    NaturalGradLaplaceFDICA,
    OverAuxLaplaceIVA,
    ProxLaplaceIVA,
    TIPSDTA,
    build_optimal_window,
    build_window,
    torch_dnn,
    whitening,
)
from audio_source_separation_tpu_torch.algorithm.permutation import solve_permutation
from audio_source_separation_tpu_torch.models.psdtf import nonparallel_inv
from audio_source_separation_tpu_torch.ops.fused_ip import (
    fused_auxiva_ip_iter,
    fused_auxiva_ip_iter_plain,
)
from audio_source_separation_tpu_torch.ops.ip_components import separate_components

from chip_smoke import VarianceMLP, at_complex128

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


@pytest.mark.parametrize(
    "make,target",
    [
        (lambda **kw: EUCNMF(n_basis=4, **kw), "power"),
        (lambda **kw: ISNMF(n_basis=4, algorithm="me", **kw), "power"),
        (lambda **kw: CauchyNMF(n_basis=4, algorithm="mm", **kw), "power"),
        (lambda **kw: ComplexEUCNMF(n_basis=4, regularizer=0.0, **kw), "spectrogram"),
        (lambda **kw: EUCNTF(n_basis=4, **kw), "power_tensor"),
        (lambda **kw: CovarianceISNMF(n_basis=4, **kw), "covariance"),
        (lambda **kw: CovarianceISNMF(n_basis=4, **kw), "covariance_c3"),
    ],
    ids=["eucnmf", "isnmf-me", "cauchy-mm", "complex", "eucntf", "covariance-c2", "covariance-c3"],
)
def test_factorisation_on_the_card(cuda, make, target):
    """The factorisation models on the card: no kernel, one finite loss per
    update, the CPU's float32 losses from the same init, and the caller's
    TF32 setting off inside the loop and back after the call."""
    X = _mixture(3, 3, 129, 100, cuda) + 0.1
    # full-rank covariances: a rank-1 one's small eigenvalue is rounding
    # noise at float32, which the card and the CPU round differently
    eye = 0.1 * torch.eye(3, device=cuda)
    targets = {
        "power": X[0].abs() ** 2,
        "spectrogram": X[0],
        "power_tensor": X.abs() ** 2,
        "covariance": torch.einsum("cft,dft->ftcd", X[:2], X[:2].conj()) + eye[:2, :2],
        "covariance_c3": torch.einsum("cft,dft->ftcd", X, X.conj()) + eye,
    }
    Z = targets[target]
    np.random.seed(111)
    init = make(device="cpu").prepare_state_kwargs(Z.cpu(), {})
    reference = make(device="cpu")
    reference(Z.cpu(), iteration=5, **init)
    seen = []
    weighted_covariance_planes.launches = fused_auxiva_ip_iter.launches = 0
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        model = make()
        out = model(Z, iteration=5, callbacks=[lambda m: seen.append(torch.backends.cuda.matmul.allow_tf32)], **init)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert seen == [False] * 6
    assert weighted_covariance_planes.launches == fused_auxiva_ip_iter.launches == 0
    assert all(f.device.type == "cuda" and torch.isfinite(f).all() for f in out)
    assert len(model.loss) == 5 and np.isfinite(model.loss).all()
    np.testing.assert_allclose(model.loss, reference.loss, rtol=1e-4)


@pytest.mark.parametrize("C", [2, 3, 5])
def test_idlma_runs_through_k1_per_bin(cuda, C):
    """Every GaussIDLMA iteration on the card runs its network and forms its
    covariance by one K1 launch with per-bin ``(S, F, T)`` weights (the
    component form at C <= 4, the matrix form at C = 5); the losses track
    the CPU float32 run from the same network."""
    X = _mixture(C, C, 257, 469, cuda)
    r = np.random.RandomState(3)
    W1, W2 = (r.randn(32, 257) * 0.01).astype(np.float32), (r.randn(257, 32) * 0.01).astype(np.float32)
    weighted_covariance_planes.launches = fused_auxiva_ip_iter.launches = 0
    solver = GaussIDLMA()
    Y = solver(X, iteration=5, dnn=torch_dnn(VarianceMLP(W1, W2).to(cuda)))
    torch.cuda.synchronize()
    assert weighted_covariance_planes.launches == 5 and fused_auxiva_ip_iter.launches == 0
    assert Y.device.type == "cuda" and torch.isfinite(Y).all() and np.isfinite(solver.loss).all()
    reference = GaussIDLMA(device="cpu")
    reference(X.cpu(), iteration=5, dnn=torch_dnn(VarianceMLP(W1, W2)))
    np.testing.assert_allclose(solver.loss, reference.loss, rtol=1e-3)


@pytest.mark.parametrize(
    "make,C",
    [(NaturalGradLaplaceFDICA, 2), (GradLaplaceFDICA, 3), (GradLaplaceFDICA, 5), (ProxLaplaceIVA, 2),
     (ProxLaplaceIVA, 3)],
)
def test_fdica_and_prox_launch_no_kernel(cuda, make, C):
    X = _mixture(C + 7, C, 257, 469, cuda)
    weighted_covariance_planes.launches = fused_auxiva_ip_iter.launches = 0
    solve_permutation.route = None
    solver = make()
    Y = solver(X, iteration=5)
    torch.cuda.synchronize()
    assert weighted_covariance_planes.launches == fused_auxiva_ip_iter.launches == 0
    assert Y.device.type == "cuda" and torch.isfinite(Y).all() and np.isfinite(solver.loss).all()
    if make is not ProxLaplaceIVA:
        assert solve_permutation.route == "native"


def test_whitening_numpy_input_runs_on_the_card(cuda):
    x = np.random.RandomState(13).randn(3, 4000)
    out = whitening(x.astype(np.float32))
    assert out.device.type == "cuda" and out.dtype == torch.float32
    eye = (out @ out.T).cpu().numpy()
    np.testing.assert_allclose(eye, np.eye(3), atol=1e-4)


def test_beamformers_on_the_card(cuda):
    """Each beamformer on the card against its CPU float64 run, no kernel."""
    X = _mixture(11, 3, 129, 200, cuda)
    r = np.random.RandomState(12)
    A = np.exp(2j * np.pi * r.rand(129, 3, 2)) / np.sqrt(3)
    Rs = np.einsum("fc,fd->fcd", A[..., 0], A[..., 0].conj())
    Rn = np.einsum("fc,fd->fcd", A[..., 1], A[..., 1].conj()) + 0.1 * np.eye(3)
    cases = [
        (lambda d: DelaySumBeamformer(steering_vector=A, device=d), {}),
        (lambda d: MVDRBeamformer(steering_vector=A, device=d), {}),
        (lambda d: MaxSNRBeamformer(device=d), {"signal_covariance": Rs, "noise_covariance": Rn}),
    ]
    weighted_covariance_planes.launches = fused_auxiva_ip_iter.launches = 0
    for make, kwargs in cases:
        Y = make(None)(X, **kwargs)
        assert Y.device.type == "cuda" and Y.dtype == torch.complex64
        expected = make("cpu")(X.cpu().to(torch.complex128), **kwargs)
        err = (Y.cpu().to(torch.complex128) - expected).abs().max() / expected.abs().max()
        assert err <= 1e-4, err
    assert weighted_covariance_planes.launches == fused_auxiva_ip_iter.launches == 0


@pytest.mark.parametrize("C", [2, 3])
def test_fast_mnmf_runs_through_k1_per_bin(cuda, C):
    """Every FastMNMF iteration on the card forms its diagonaliser
    covariances by one K1 launch with per-bin ``(C, F, T)`` weights; the
    losses hold the port's CPU float64 run from the same draws at 1e-4."""
    X = _mixture(C + 20, C, 129, 300, cuda)
    weighted_covariance_planes.launches = fused_auxiva_ip_iter.launches = 0
    np.random.seed(111)
    solver = FastMultichannelISNMF(n_basis=4)
    Y = solver(X, iteration=10)
    torch.cuda.synchronize()
    assert weighted_covariance_planes.launches == 10 and fused_auxiva_ip_iter.launches == 0
    assert Y.device.type == "cuda" and torch.isfinite(Y).all() and np.isfinite(solver.loss).all()
    np.random.seed(111)
    reference = FastMultichannelISNMF(n_basis=4, device="cpu")
    reference(X.cpu().to(torch.complex128), iteration=10)
    np.testing.assert_allclose(solver.loss, reference.loss, rtol=1e-4)


@pytest.mark.parametrize("author", ["Sawada", "Ozerov"])
def test_mnmf_on_the_card(cuda, author):
    """Sawada and Ozerov at C = 2 on the card: finite, the loss falls, no
    kernel launched."""
    X = _mixture(23, 2, 129, 300, cuda)
    weighted_covariance_planes.launches = fused_auxiva_ip_iter.launches = 0
    np.random.seed(111)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # Ozerov's "in progress"
        solver = MultichannelISNMF(n_basis=4, author=author)
    Y = solver(X, iteration=10)
    torch.cuda.synchronize()
    assert weighted_covariance_planes.launches == fused_auxiva_ip_iter.launches == 0
    assert Y.device.type == "cuda" and tuple(Y.shape) == tuple(X.shape) and torch.isfinite(Y).all()
    assert np.isfinite(solver.loss).all() and solver.loss[-1] < solver.loss[0]


def test_build_window_runs_on_the_card(cuda):
    w = build_window(64)
    assert w.device.type == "cuda" and w.dtype == torch.float64
    optimal = build_optimal_window(np.hanning(64), hop_size=16)
    assert optimal.device.type == "cuda"
    np.testing.assert_allclose(
        build_optimal_window(w, hop_size=16).cpu().numpy(),
        build_optimal_window(w.cpu(), hop_size=16).numpy(),
        rtol=1e-12,
    )


@pytest.mark.parametrize("C,n_blocks", [(2, 64), (2, 16), (3, 64)])  # B = 3 (compact), B = 9 (matrix), C = 3
def test_ipsdta_kondo_runs_through_k1_per_bin(cuda, C, n_blocks):
    """Every Kondo iteration on the card forms its VCD covariances by one K1
    launch with per-bin ``(S, F, T)`` weights; K1's ``Q`` on the solver's
    weights matches the plain version at 1e-4 of the largest entry, and the
    losses hold the port's CPU float64 run from the same draws at 1e-4."""
    X = _mixture(C + 30, C, 129, 300, cuda)
    weighted_covariance_planes.launches = fused_auxiva_ip_iter.launches = 0
    np.random.seed(111)
    solver = GaussIPSDTA(n_basis=2, n_blocks=n_blocks)
    Y = solver(X, iteration=5)
    torch.cuda.synchronize()
    assert weighted_covariance_planes.launches == 5 and fused_auxiva_ip_iter.launches == 0
    assert Y.device.type == "cuda" and torch.isfinite(Y).all() and np.isfinite(solver.loss).all()
    np.random.seed(111)
    reference = GaussIPSDTA(n_basis=2, n_blocks=n_blocks, device="cpu")
    reference(X.cpu().to(torch.complex128), iteration=5)
    np.testing.assert_allclose(solver.loss, reference.loss, rtol=1e-4)

    state = solver.init_state(X, **solver.prepare_state_kwargs(X, {}))
    layout = solver._layout(X.shape[1])
    inv_R = solver._source_inverse_matrix(state, layout)
    weights = layout.scatter(torch.diagonal(inv_R, dim1=-2, dim2=-1).real).transpose(1, 2).contiguous()
    plain = weighted_covariance_planes_plain(X, weights)
    err = (weighted_covariance_planes(X, weights) - plain).abs().max() / plain.abs().max()
    assert err <= 1e-4, err


@pytest.mark.parametrize("make", [
    lambda: GaussIPSDTA(n_basis=2, author="Ikeshita", n_blocks=64),
    lambda: TIPSDTA(n_basis=2, nu=1000, n_blocks=64),
], ids=["ikeshita", "t"])  # fmt: skip
def test_other_block_psd_solvers_launch_no_kernel(cuda, make):
    X = _mixture(33, 2, 129, 300, cuda)
    weighted_covariance_planes.launches = fused_auxiva_ip_iter.launches = 0
    np.random.seed(111)
    solver = make()
    Y = solver(X, iteration=5)
    torch.cuda.synchronize()
    assert weighted_covariance_planes.launches == fused_auxiva_ip_iter.launches == 0
    assert torch.isfinite(Y).all() and np.isfinite(solver.loss).all()


def test_ikeshita_at_float64_on_the_card_matches_the_cpu(cuda):
    """Ikeshita's EM and fixed-point steps at float64: the card's loss
    trajectory through its transient, and its output, hold the CPU's at
    1e-9 (at float32 the transient amplifies rounding past any useful
    tolerance)."""
    X = _mixture(33, 2, 129, 300, cuda).to(torch.complex128)
    outputs, losses = [], []
    for device in ("cuda", "cpu"):
        np.random.seed(111)
        solver = GaussIPSDTA(n_basis=2, author="Ikeshita", n_blocks=64, device=device)
        solver = at_complex128(solver) if device == "cuda" else solver
        outputs.append(solver(X.to(device), iteration=8).cpu().numpy())
        losses.append(np.asarray(solver.loss))
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-9)
    np.testing.assert_allclose(outputs[0], outputs[1], rtol=0, atol=1e-9 * np.abs(outputs[1]).max())


@pytest.mark.parametrize("n_basis", [2, 3])
def test_ldpsdtf_on_the_card(cuda, n_basis):
    """LDPSDTF at float32 on the card: finite, falling, no kernel launched;
    the first losses within 1e-4 of the CPU float32 run and within 1e-2 of
    the CPU float64 one (the float32 ridges, 100 eps_machine, move the loss
    by about 2e-3 at float32 on either)."""
    rng = np.random.RandomState(7)
    bases = [rng.randn(16, 16) for _ in range(n_basis)]
    target = np.einsum("kij,kt->ijt", np.stack([a @ a.T + 0.5 * np.eye(16) for a in bases]),
                       np.abs(rng.randn(n_basis, 200)) + 0.2)  # fmt: skip
    weighted_covariance_planes.launches = fused_auxiva_ip_iter.launches = 0
    np.random.seed(111)
    model = LDPSDTF(n_basis=n_basis)
    V, H = model(target, iteration=10)
    torch.cuda.synchronize()
    assert weighted_covariance_planes.launches == fused_auxiva_ip_iter.launches == 0
    assert V.device.type == "cuda" and V.dtype == torch.float32 and torch.isfinite(V).all()
    for dtype, rtol in ((np.float32, 1e-4), (np.float64, 1e-2)):
        np.random.seed(111)
        reference = LDPSDTF(n_basis=n_basis, device="cpu")
        reference(target.astype(dtype), iteration=10)
        np.testing.assert_allclose(model.loss[:5], reference.loss[:5], rtol=rtol)
    assert model.loss[-1] < model.loss[0]


@pytest.mark.parametrize("use_cholesky", [True, False])
def test_nonparallel_inv_runs_on_the_card(cuda, use_cholesky):
    """NumPy input goes to the card by default, a card tensor stays there;
    both match the CPU float64 loop at 1e-10."""
    rng = np.random.RandomState(5)
    A = rng.randn(3, 2, 6, 6) + 1j * rng.randn(3, 2, 6, 6)
    X = A @ np.conj(np.swapaxes(A, -1, -2)) + np.eye(6)
    expected = nonparallel_inv(X, use_cholesky=use_cholesky, device="cpu").numpy()
    for X_ in (X, torch.as_tensor(X, device=cuda)):
        ours = nonparallel_inv(X_, use_cholesky=use_cholesky)
        assert ours.device.type == "cuda" and ours.dtype == torch.complex128
        np.testing.assert_allclose(ours.cpu().numpy(), expected, rtol=1e-10, atol=1e-12)


# --------------------------------------------------------------------------- #
# slices 9 and 10a: the harness, batch_separate and the sharded steps
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("make,counter", [
    (lambda: AuxLaplaceIVA(), fused_auxiva_ip_iter),
    (lambda: GaussILRMA(n_basis=2), weighted_covariance_planes),
    (lambda: FastMultichannelISNMF(n_basis=2), weighted_covariance_planes),
])  # fmt: skip
def test_batch_separate_launches_what_each_call_launches(cuda, make, counter):
    """3 mixtures x 4 iterations: K2 (IVA IP, C = 2) or K1 per bin (ILRMA,
    FastMNMF) once an iteration for each member, and each member equals its
    own call."""
    from audio_source_separation_tpu_torch.parallel import batch_separate

    Xs = torch.stack([_mixture(seed, 2, 129, 100, cuda) for seed in range(3)])
    np.random.seed(111)
    counter.launches = 0
    outputs, losses = batch_separate(make(), Xs, iteration=4, host=False)
    torch.cuda.synchronize()
    assert counter.launches == 12
    assert outputs.device.type == "cuda" and outputs.shape == (3, 2, 129, 100) and losses.shape == (3, 4)
    np.random.seed(111)
    single = make()
    for b in range(3):
        single.loss = []
        Y = single(Xs[b], iteration=4)
        torch.testing.assert_close(outputs[b], Y, rtol=0, atol=1e-6 * float(Y.abs().max()))
        np.testing.assert_allclose(losses[b].cpu().numpy(), single.loss[-4:], rtol=1e-6)


def test_auxiva_ip_step_with_use_pallas_runs_through_k1(cuda):
    from audio_source_separation_tpu_torch.parallel import auxiva_ip_step

    X = _mixture(4, 2, 2049, 469, cuda)
    W = torch.eye(2, dtype=torch.complex64, device=cuda).expand(2049, 2, 2).contiguous()
    W_cpu = W.cpu().to(torch.complex128)
    weighted_covariance_planes.launches = 0
    for _ in range(3):
        W, nll = auxiva_ip_step(X, W, use_pallas=True)
        W_cpu, nll_cpu = auxiva_ip_step(X.cpu().to(torch.complex128), W_cpu, use_pallas=True)
        np.testing.assert_allclose(float(nll), float(nll_cpu), rtol=1e-4)
    assert weighted_covariance_planes.launches == 3


def test_bss_eval_sources_on_the_card_matches_the_cpu(cuda):
    from audio_source_separation_tpu_torch.utils import bss_eval_sources

    rng = np.random.RandomState(6)
    refs = rng.randn(2, 16000)
    ests = refs[::-1] + 0.2 * refs + 0.3 * rng.randn(2, 16000)
    card = bss_eval_sources(refs, ests)
    cpu = bss_eval_sources(refs, ests, device="cpu")
    assert all(a.device.type == "cuda" and a.dtype == torch.float64 for a in card[:3])
    for a, b in zip(card[:3], cpu[:3]):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0, atol=1e-4)
    assert list(card[3]) == list(cpu[3]) == [1, 0]


def test_new_entry_points_default_to_the_card(cuda, tmp_path):
    from audio_source_separation_tpu_torch import utils
    from audio_source_separation_tpu_torch.examples import separate
    from audio_source_separation_tpu_torch.parallel import batch_separate
    from audio_source_separation_tpu_torch.utils.synthesis import mird_geometry_rirs

    rng = np.random.RandomState(7)
    refs, ests = rng.randn(2, 500), rng.randn(2, 500)
    assert utils.si_sdr(ests, refs).device.type == "cuda"
    assert utils.pairwise_si_sdr(ests, refs).device.type == "cuda"
    rirs = utils.synthetic_room_impulse_responses(2, 2, taps=16)
    assert rirs.device.type == "cuda" and mird_geometry_rirs(45, samples=800).device.type == "cuda"
    mixture, images = utils.convolutive_mixture(refs, rirs.cpu().numpy())
    assert mixture.device.type == "cuda" and images.device.type == "cuda"
    outputs, _ = batch_separate(AuxLaplaceIVA(), rng.randn(2, 2, 9, 16) + 0j, iteration=2, host=False)
    assert outputs.device.type == "cuda" and outputs.dtype == torch.complex64
    wav = str(tmp_path / "mix.wav")
    utils.write_wav(wav, 0.1 * rng.randn(2, 6000), 16000, channel_last=False)
    summary = separate.main(["--input", wav, "--iterations", "2", "--fft-size", "256", "--out", str(tmp_path / "sep")])
    assert summary["device"] == "cuda"
