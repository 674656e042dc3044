"""The port imports neither JAX nor the JAX package: only the tests import
both."""

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "audio_source_separation_tpu_torch"
FORBIDDEN = ("jax", "audio_source_separation_tpu")


def is_forbidden(module):
    """Exact-name rule: ``jax``/``audio_source_separation_tpu`` or a
    submodule of either; ``audio_source_separation_tpu_torch`` is allowed."""
    return any(module == name or module.startswith(name + ".") for name in FORBIDDEN)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module


def test_exact_name_rule():
    assert is_forbidden("jax") and is_forbidden("jax.numpy")
    assert is_forbidden("audio_source_separation_tpu")
    assert is_forbidden("audio_source_separation_tpu.ops.ip")
    assert not is_forbidden("audio_source_separation_tpu_torch")
    assert not is_forbidden("audio_source_separation_tpu_torch.ops")
    assert not is_forbidden("jaxlib_free") and not is_forbidden("jaxtyping")


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py", REPO / "tests" / "_torch_mesh_worker.py"],
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_no_forbidden_import(path):
    bad = [(line, name) for line, name in _imports(path) if is_forbidden(name)]
    assert not bad, "{} imports {}".format(path, bad)


def test_port_imports_with_jax_blocked():
    code = textwrap.dedent(
        """
        import sys
        sys.modules["jax"] = None
        sys.modules["audio_source_separation_tpu"] = None
        import numpy as np
        import audio_source_separation_tpu_torch as port
        from audio_source_separation_tpu_torch.models import AuxLaplaceIVA
        from audio_source_separation_tpu_torch.ops import cov_kernel, eig2, fused_ip, ip, iss, _build
        from audio_source_separation_tpu_torch.transform import pca
        X = np.random.RandomState(0).randn(2, 5, 8) + 0j
        Y = AuxLaplaceIVA(device="cpu")(X, iteration=2)
        assert Y.shape == (2, 5, 8)
        X4 = np.random.RandomState(1).randn(4, 5, 8) + 0j
        for solver in (
            port.AuxGaussIVA(device="cpu"),
            port.AuxLaplaceIVA(algorithm_spatial="ISS", device="cpu"),
            port.AuxLaplaceIVA(algorithm_spatial="IP2", device="cpu"),
            port.NaturalGradLaplaceIVA(device="cpu"),
            port.GradLaplaceIVA(device="cpu"),
        ):
            assert solver(X, iteration=2).shape == (2, 5, 8)
        assert port.OverAuxLaplaceIVA("IP", n_sources=2, device="cpu")(X4, iteration=2).shape == (2, 5, 8)
        import warnings
        warnings.simplefilter("ignore")
        for solver in (
            port.GaussILRMA(n_basis=2, device="cpu"),
            port.GaussILRMA(n_basis=2, algorithm_spatial="ISS", device="cpu"),
            port.GaussILRMA(n_basis=2, algorithm_spatial="IP2", device="cpu"),
            port.GaussILRMA(n_basis=2, partitioning=True, device="cpu"),
            port.GaussILRMA(n_basis=2, normalize="projection-back", device="cpu"),
            port.TILRMA(n_basis=2, device="cpu"),
            port.ConsistentGaussILRMA(n_basis=2, fft_size=8, device="cpu"),
        ):
            assert solver(X, iteration=2).shape == (2, 5, 8)
        from audio_source_separation_tpu_torch import criterion
        from audio_source_separation_tpu_torch.ops import ip_update, spatial_covariance
        P = np.abs(X[0]) ** 2
        for solver in (
            port.EUCNMF(device="cpu"),
            port.KLNMF(device="cpu"),
            port.ISNMF(algorithm="me", device="cpu"),
            port.tNMF(device="cpu"),
            port.CauchyNMF(algorithm="mm_fast", device="cpu"),
        ):
            assert solver(P, iteration=2)[0].shape == (5, 2)
        assert port.ComplexEUCNMF(device="cpu")(X[0], iteration=2)[2].shape == (5, 2, 8)
        assert port.EUCNTF(device="cpu")(np.abs(X) ** 2, iteration=2)[0].shape == (2, 2)
        covariance = np.einsum("cft,dft->ftcd", X, X.conj())
        assert port.CovarianceISNMF(n_basis=2, device="cpu")(covariance, iteration=2)[0].shape == (5, 2, 2, 2)
        for solver in (
            port.MultichannelISNMF(n_basis=2, device="cpu"),
            port.MultichannelISNMF(n_basis=2, author="Ozerov", device="cpu"),
            port.FastMultichannelISNMF(n_basis=2, device="cpu"),
        ):
            assert solver(X, iteration=2).shape == (2, 5, 8)
        port.MultichanneltNMF(device="cpu")
        import torch
        from audio_source_separation_tpu_torch.algorithm import permutation
        for solver in (
            port.GradLaplaceFDICA(device="cpu"),
            port.NaturalGradLaplaceFDICA(device="cpu"),
            port.ProxLaplaceIVA(device="cpu"),
        ):
            assert solver(X, iteration=2).shape == (2, 5, 8)
        assert permutation.solve_permutation.route in ("native", "numpy")

        class Net(torch.nn.Module):
            def __init__(self):
                super().__init__()
                self.linear = torch.nn.Linear(5, 5)

            def forward(self, amplitude):
                return torch.nn.functional.softplus(self.linear(amplitude.transpose(1, 2))).transpose(1, 2)

        assert port.GaussIDLMA(device="cpu")(X, iteration=2, dnn=port.torch_dnn(Net())).shape == (2, 5, 8)
        A = np.ones((5, 2, 2), dtype=complex)
        assert port.DelaySumBeamformer(steering_vector=A, device="cpu")(X).shape == (2, 5, 8)
        assert port.MVDRBeamformer(steering_vector=A + np.eye(2), device="cpu")(X).shape == (2, 5, 8)
        R = np.tile(np.eye(2, dtype=complex), (5, 1, 1))
        assert port.MaxSNRBeamformer(device="cpu")(X, signal_covariance=R, noise_covariance=R).shape == (1, 5, 8)
        from audio_source_separation_tpu_torch import parallel, utils
        from audio_source_separation_tpu_torch.examples import beamform, decompose_nmf, prepare_mixture, separate, walkthrough
        from audio_source_separation_tpu_torch.ops import pair_products, weighted_covariance_from_pairs
        outputs, losses = parallel.batch_separate(AuxLaplaceIVA(device="cpu"), np.stack([X, X]), iteration=2)
        assert outputs.shape == (2, 2, 5, 8) and losses.shape == (2, 2)
        X2 = np.stack([X.real, X.imag])
        W2 = np.stack([np.tile(np.eye(2), (5, 1, 1)), np.zeros((5, 2, 2))])
        assert parallel.auxiva_ip_step_stacked(torch.as_tensor(X2), torch.as_tensor(W2))[0].shape == (2, 5, 2, 2)
        refs = np.random.RandomState(2).randn(2, 300)
        assert utils.bss_eval_sources(refs, refs[::-1] + 0.1, filter_length=8, device="cpu")[0].shape == (2,)
        rirs = utils.synthetic_room_impulse_responses(2, 2, taps=8, device="cpu")
        assert utils.convolutive_mixture(refs, rirs)[0].shape == (2, 300)
        from audio_source_separation_tpu_torch.parallel import mesh, make_mesh_2d, make_sharded_train_step
        from audio_source_separation_tpu_torch.runtime import profiling, benchmark_solver, measure_memory_bandwidth
        from audio_source_separation_tpu_torch.runtime import cost_model, scan_cost_analysis
        from audio_source_separation_tpu_torch.ops.cov_kernel import k1_cost
        from audio_source_separation_tpu_torch.ops.fused_ip import k2_cost
        assert scan_cost_analysis(AuxLaplaceIVA(device="cpu"), X) == tuple(map(float, k2_cost(5, 8, 16)))
        assert scan_cost_analysis(port.GaussILRMA(n_basis=2, device="cpu"), X)[0] > k1_cost(2, 2, 5, 8, True, 16, 8)[0]
        from audio_source_separation_tpu_torch.tools import dryrun_multichip
        sys.path.insert(0, "tests")
        import _torch_mesh_worker
        assert not [m for m in sys.modules if m.startswith("jax.")]
        print("ok")
        """
    )
    result = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert result.returncode == 0, result.stderr
    assert result.stdout.strip() == "ok"
