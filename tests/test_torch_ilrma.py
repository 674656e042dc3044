"""The port's ILRMA family against the JAX package on the CPU at float64.

Each case runs both packages from the same seeded mixture and the same
``basis``/``activation`` (and ``latent``) and compares the whole loss
trajectory (rtol 1e-9), the final demixing filter, basis and activation, and
the output (atol 1e-8).  The JAX package runs its power-only scan here (no
callbacks), the form the port's power state mirrors.  Init, warm start,
callbacks, checkpoints and the raises are in ``test_torch_ilrma_state.py``.
"""

import numpy as np
import pytest
import torch

import audio_source_separation_tpu.models as jax_models
import audio_source_separation_tpu_torch as port

from conftest import make_mixture

ITERATIONS = 8
N_BINS, N_FRAMES, N_BASIS = 13, 40, 3


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def source_model(n_channels, partitioning=False, seed=5):
    """Seeded non-negative ``basis``/``activation`` (and ``latent``)."""
    r = np.random.RandomState(seed)
    if partitioning:
        Z = r.rand(n_channels, N_BASIS) + 0.5
        return {"latent": Z / Z.sum(axis=0), "basis": r.rand(N_BINS, N_BASIS), "activation": r.rand(N_BASIS, N_FRAMES)}
    return {"basis": r.rand(n_channels, N_BINS, N_BASIS), "activation": r.rand(n_channels, N_BASIS, N_FRAMES)}


CASES = [
    ("GaussILRMA", {}, 2),
    ("GaussILRMA", {}, 3),
    ("GaussILRMA", {"domain": 1.5}, 2),
    ("GaussILRMA", {"normalize": "projection-back"}, 2),
    ("GaussILRMA", {"normalize": False}, 3),
    ("GaussILRMA", {"partitioning": True}, 2),
    ("GaussILRMA", {"partitioning": True}, 3),
    ("GaussILRMA", {"algorithm_spatial": "IP2"}, 2),
    ("GaussILRMA", {"algorithm_spatial": "IP2"}, 3),
    ("GaussILRMA", {"algorithm_spatial": "IP2"}, 4),  # the matrix pair update
    ("GaussILRMA", {"algorithm_spatial": "ISS"}, 2),
    ("GaussILRMA", {"algorithm_spatial": "ISS", "iss_compat": True, "normalize": "projection-back"}, 3),
    ("GaussILRMA", {"guard": "svd"}, 2),
    ("GaussILRMA", {}, 5),  # the matrix IP sweep
    ("TILRMA", {"nu": 1000}, 2),
    ("TILRMA", {"nu": 1}, 2),
    ("TILRMA", {"nu": 1}, 3),
    ("ConsistentGaussILRMA", {"fft_size": 32}, 2),
    ("ConsistentGaussILRMA", {"fft_size": 32, "hop_size": 8, "reference_id": 1}, 3),
]


def _case_id(case):
    name, kwargs, n_channels = case
    return "-".join([name] + ["{}={}".format(k, v) for k, v in kwargs.items()] + ["C{}".format(n_channels)])


@pytest.mark.filterwarnings("ignore:in progress")
@pytest.mark.parametrize("name,kwargs,n_channels", CASES, ids=[_case_id(c) for c in CASES])
def test_matches_jax_trajectory(rng, name, kwargs, n_channels):
    X = make_mixture(rng, n_channels=n_channels, n_bins=N_BINS, n_frames=N_FRAMES)
    init = source_model(n_channels, partitioning=kwargs.get("partitioning", False))
    ref = getattr(jax_models, name)(n_basis=N_BASIS, **kwargs)
    Y_ref = np.asarray(ref(X, iteration=ITERATIONS, **init))
    ours = getattr(port, name)(n_basis=N_BASIS, device="cpu", **kwargs)
    Y = ours(X, iteration=ITERATIONS, **init)
    assert len(ours.loss) == ITERATIONS + 1
    np.testing.assert_allclose(ours.loss, ref.loss, rtol=1e-9)
    np.testing.assert_allclose(_np(Y), Y_ref, atol=1e-8)
    for field in ("basis", "activation") + (("latent",) if kwargs.get("partitioning") else ()):
        np.testing.assert_allclose(_np(getattr(ours, field)), np.asarray(getattr(ref, field)), atol=1e-8)
    if kwargs.get("algorithm_spatial") == "ISS":
        assert ours.demix_filter is None and ref.demix_filter is None  # no callbacks: no fit
    else:
        np.testing.assert_allclose(_np(ours.demix_filter), np.asarray(ref.demix_filter), atol=1e-8)


def test_talias_and_exports():
    assert port.tILRMA is port.TILRMA
    for name in jax_models.__all__:
        if "ILRMA" in name:
            assert hasattr(port, name), name


@pytest.mark.parametrize(
    "name,kwargs",
    [("GaussILRMA", {}), ("GaussILRMA", {"algorithm_spatial": "IP2"}), ("TILRMA", {"nu": 1})],
    ids=["gauss-ip", "gauss-ip2", "t-nu1"],
)
def test_monotone_on_complex64(rng, name, kwargs):
    """The CPU at complex64 (the card's precision): the loss stays finite
    and falls over the run."""
    X = make_mixture(rng, n_channels=2, n_bins=17, n_frames=64, dtype=np.complex64)
    np.random.seed(111)
    solver = getattr(port, name)(n_basis=4, device="cpu", **kwargs)
    Y = solver(X, iteration=10)
    loss = np.asarray(solver.loss)
    assert Y.dtype == torch.complex64 and torch.isfinite(Y).all() and np.isfinite(loss).all()
    assert loss[-1] < loss[0]
