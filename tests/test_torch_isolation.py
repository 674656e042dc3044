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
    sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"],
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
        assert not [m for m in sys.modules if m.startswith("jax.")]
        print("ok")
        """
    )
    result = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert result.returncode == 0, result.stderr
    assert result.stdout.strip() == "ok"
